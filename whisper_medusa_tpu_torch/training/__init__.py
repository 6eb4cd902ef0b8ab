"""Medusa training of the port: losses, optimizers, the train step and the
trainer (counterparts of whisper_medusa_tpu/training/)."""
