"""Data- and tensor-parallel serving and training on ``torch.distributed``
(counterpart of whisper_medusa_tpu/parallel/)."""
