"""Logger, seed and parameter-count helpers — the port's counterpart of
whisper_medusa_tpu/utils/logging_utils.py."""

from __future__ import annotations

import logging
import random

import numpy as np
import torch

WANDB_UNPORTED = ("--wandb-logging is not ported to whisper_medusa_tpu_torch (no wandb on "
                  "the GPU host); metrics go to the standard logger")


def set_logger(level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger("whisper_medusa_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)
    return logger


def set_seed(seed: int = 42) -> None:
    """Seed ``random``, numpy and torch (every device's default generator)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def count_parameters(params) -> int:
    """Elements of every tensor in a nested dict / list of tensors (an int8
    weight counts its values and its scales, as the JAX tree's leaves)."""
    if isinstance(params, dict):
        return sum(count_parameters(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_parameters(v) for v in params)
    return int(params.numel()) if isinstance(params, torch.Tensor) else int(np.size(params))


def make_wandb_logger(project: str, run_name: str = None, config: dict = None,
                      resume_id: str = None):
    """The JAX package's Weights & Biases hook has no port: raises, as the
    CLIs' ``--wandb-logging`` does."""
    del project, run_name, config, resume_id
    raise NotImplementedError(WANDB_UNPORTED)
