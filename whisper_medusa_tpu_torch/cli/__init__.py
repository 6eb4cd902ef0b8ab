"""Command-line entry points of the port (``python -m whisper_medusa_tpu_torch.cli.train``)."""
