"""Training loop with checkpoints, per-head logging, eval and resume —
counterpart of whisper_medusa_tpu/training/trainer.py.

Per step it logs ``loss``, ``step_time`` and ``MedusaHead_{i}_loss``; every
``eval_steps`` it evaluates and keeps the best eval loss; every
``save_steps`` it writes ``output_dir/checkpoints/<step>/state.pt``
(``torch.save`` of the parameters, the optimizer state and the step; orbax
is the JAX package's format) and keeps the newest ``save_total_limit``, with
``trainer_state.json`` beside them as in the JAX package.
``resume_from_checkpoint`` restores the newest checkpoint;
``load_best_model_at_end`` restores the best one when it was kept.

``mesh=`` (``parallel/mesh.py``, JAX's ``mesh=``) trains data- and
tensor-parallel: every rank draws the same global batch from its iterator
and takes its data rank's rows, the step's gradients are the global
batch's (``train.masked_grads``), so parameters and optimizer state stay
alike on every rank, and only the primary process writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from whisper_medusa_tpu_torch.config import ModelConfig
from whisper_medusa_tpu_torch.models.bridge import flatten
from whisper_medusa_tpu_torch.parallel import distributed
from whisper_medusa_tpu_torch.training import train as train_mod

logger = logging.getLogger("whisper_medusa_tpu_torch")


@dataclasses.dataclass
class TrainingArgs:
    """The live subset of the reference Seq2SeqTrainingArguments (the JAX
    package's ``TrainingArgs``, same fields and defaults)."""

    output_dir: str = "out"
    batch_size: int = 2
    gradient_accumulation_steps: int = 1
    lr: float = 1e-4
    warmup_steps: int = 100
    max_steps: int = 1000
    eval_steps: int = 100
    save_steps: int = 100
    save_total_limit: int = 2
    logging_steps: int = 1
    optim: str = "adafactor"
    lr_scheduler_type: str = "linear"
    parts_to_freeze: Optional[str] = None
    load_best_model_at_end: bool = True
    eval_batches: int = 8           # batches per evaluation pass


class MedusaTrainer:
    def __init__(self, config: ModelConfig, params: Dict[str, Any], args: TrainingArgs,
                 train_iter: Iterator[Dict[str, np.ndarray]],
                 eval_iter_fn: Optional[Callable[[], Iterator[Dict[str, np.ndarray]]]] = None,
                 log_fn: Optional[Callable[[Dict[str, float], int], None]] = None,
                 mesh=None):
        if mesh is not None and args.batch_size % mesh.dp != 0:
            raise ValueError(f"batch_size {args.batch_size} must divide by dp={mesh.dp}")
        train_mod.require_trainable_dtype(params)
        self.mesh = mesh
        self.config = config
        self.args = args
        self.train_iter = train_iter
        self.eval_iter_fn = eval_iter_fn
        self.log_fn = log_fn
        self.optimizer = train_mod.make_optimizer(
            args.optim, args.lr, args.warmup_steps, args.max_steps,
            args.lr_scheduler_type, args.gradient_accumulation_steps)
        self.state = train_mod.init_train_state(params, self.optimizer)
        self._step_fn = train_mod.make_train_step(config, self.optimizer, args.parts_to_freeze,
                                                  mesh=mesh)
        self._ckpt_dir = os.path.abspath(os.path.join(args.output_dir, "checkpoints"))
        self.best_eval_loss = float("inf")
        self.best_step = -1
        self.history: list = []

    # ---------------------------------------------------------------- ckpt
    def _saved_steps(self):
        if not os.path.isdir(self._ckpt_dir):
            return []
        return sorted(int(n) for n in os.listdir(self._ckpt_dir) if n.isdigit())

    def _rows(self, x):
        """This data rank's rows of a global batch array."""
        if self.mesh is None:
            return x
        return distributed.local_rows(x, self.mesh.data_index, self.mesh.dp)

    def save_checkpoint(self, step: int) -> None:
        """Written by the primary process alone (every rank holds the same
        state); the others wait for it."""
        if distributed.is_primary():
            self._write_checkpoint(step)
        distributed.sync()

    def _write_checkpoint(self, step: int) -> None:
        path = os.path.join(self._ckpt_dir, str(step))
        os.makedirs(path, exist_ok=True)
        torch.save({"params": {k: v.detach().cpu() for k, v in flatten(self.state.params).items()},
                    "opt_state": self.state.opt_state.state_dict(),
                    "step": step}, os.path.join(path, "state.pt"))
        for old in self._saved_steps()[:-self.args.save_total_limit]:
            shutil.rmtree(os.path.join(self._ckpt_dir, str(old)))
        with open(os.path.join(self._ckpt_dir, "trainer_state.json"), "w") as f:
            json.dump({"best_eval_loss": self.best_eval_loss, "best_step": self.best_step}, f)

    def restore_checkpoint(self, step: Optional[int] = None) -> bool:
        saved = self._saved_steps()
        step = step if step is not None else (saved[-1] if saved else None)
        if step is None:
            return False
        path = os.path.join(self._ckpt_dir, str(step), "state.pt")
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        ck = torch.load(path, map_location="cpu")
        with torch.no_grad():
            for k, t in flatten(self.state.params).items():
                t.copy_(ck["params"][k])
        self.state.opt_state.load_state_dict(ck["opt_state"])
        self.state.step = int(ck["step"])
        meta_path = os.path.join(self._ckpt_dir, "trainer_state.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.best_eval_loss = meta.get("best_eval_loss", float("inf"))
            self.best_step = meta.get("best_step", -1)
        logger.info("resumed from checkpoint step %d", step)
        return True

    # ---------------------------------------------------------------- loops
    def evaluate(self) -> float:
        assert self.eval_iter_fn is not None, "no eval dataset configured"
        losses = []
        it = self.eval_iter_fn()
        for _ in range(self.args.eval_batches):
            try:
                batch = next(it)
            except StopIteration:
                break
            feats, labels = batch["input_features"], batch["labels"]
            # A last batch that dp does not divide runs whole on every rank
            # (the JAX trainer leaves it unsharded).
            whole = self.mesh is not None and feats.shape[0] % self.mesh.dp != 0
            if not whole:
                feats, labels = self._rows(feats), self._rows(labels)
            loss, _ = train_mod.eval_loss(self.config, self.state.params, feats, labels,
                                          mesh=self.mesh, whole_batch=whole)
            losses.append(float(loss))
        return float(np.mean(losses)) if losses else float("nan")

    def train(self, resume_from_checkpoint: bool = False) -> Dict[str, Any]:
        if resume_from_checkpoint:
            self.restore_checkpoint()
        args = self.args
        t0 = time.time()
        start = int(self.state.step)
        for step in range(start, args.max_steps):
            batch = next(self.train_iter)
            self.state, metrics = self._step_fn(self.state, self._rows(batch["input_features"]),
                                                self._rows(batch["labels"]))
            if (step + 1) % args.logging_steps == 0:
                scalars = {"loss": float(metrics["loss"]),
                           "step_time": (time.time() - t0) / max(step - start + 1, 1)}
                per_head = metrics["per_head_ce"].float().cpu().numpy()
                valid = metrics["valid_heads"].cpu().numpy()
                for i, (v, ok) in enumerate(zip(per_head, valid)):
                    if ok:
                        scalars[f"MedusaHead_{i}_loss"] = float(v)
                self._log(scalars, step + 1)
            if self.eval_iter_fn and (step + 1) % args.eval_steps == 0:
                eval_loss = self.evaluate()
                self._log({"eval_validation_loss": eval_loss}, step + 1)
                if eval_loss < self.best_eval_loss:
                    self.best_eval_loss = eval_loss
                    self.best_step = step + 1
            if (step + 1) % args.save_steps == 0:
                self.save_checkpoint(step + 1)
        if args.load_best_model_at_end and self.best_step > 0:
            if self.best_step in self._saved_steps():
                self.restore_checkpoint(self.best_step)
            else:      # rotated out by save_total_limit
                logger.warning("best checkpoint %d unavailable; keeping last", self.best_step)
        return {"final_step": int(self.state.step), "best_eval_loss": self.best_eval_loss}

    def _log(self, scalars: Dict[str, float], step: int) -> None:
        self.history.append((step, scalars))
        if self.log_fn:
            self.log_fn(scalars, step)
        else:
            logger.info("step %d: %s", step,
                        " ".join(f"{k}={v:.4f}" for k, v in scalars.items()))
