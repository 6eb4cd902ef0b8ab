"""The training CLI's flags — the port's copy of whisper_medusa_tpu/cli/args.py
(``add_model_args``, ``add_training_args``: the same flags and defaults), plus
``--device``.  The distributed and mesh flags are accepted and refused when
set (``refuse_unported``)."""

from __future__ import annotations

import argparse


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def str_int_list(v: str):
    return [int(x) for x in v.replace(",", " ").split()]


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--whisper-model-name", default="openai/whisper-large-v2")
    p.add_argument("--whisper-size", default="large-v2",
                   help="preset when training from scratch (tiny/base/.../large-v2)")
    p.add_argument("--medusa-num-heads", type=int, default=10)
    p.add_argument("--medusa-num-layers", type=int, default=1)
    p.add_argument("--medusa-hidden-size", type=int, default=1280)
    p.add_argument("--medusa-heads-type", default="base_head",
                   choices=["base_head", "medusa_block"])
    p.add_argument("--medusa-choices", type=str_int_list, default=[1] * 11)
    p.add_argument("--medusa-loss-on-original", type=str2bool, default=False)
    p.add_argument("--medusa-kl-loss", type=str2bool, default=False)
    p.add_argument("--medusa-kl-weight", type=float, default=0.01)
    p.add_argument("--output-whisper-original", type=str2bool, default=False)
    p.add_argument("--param-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda trains either --param-dtype; cpu runs the "
                        "kernels' plain versions)")


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dp", type=int, default=0)
    p.add_argument("--tp", type=int, default=0)
    p.add_argument("--coordinator-address", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def refuse_unported(args) -> None:
    """The JAX CLI's distributed/mesh and wandb flags have no port yet."""
    if (args.dp or args.tp or args.coordinator_address or args.num_processes
            or args.process_id is not None):
        raise NotImplementedError(
            "--dp/--tp/--coordinator-address/--num-processes/--process-id are not "
            "ported to whisper_medusa_tpu_torch yet (ROADMAP queue 1, item 17: "
            "DP/DDP training)")
    if args.wandb_logging:
        raise NotImplementedError(
            "--wandb-logging is not ported to whisper_medusa_tpu_torch yet (ROADMAP "
            "queue 1, item 18: wandb logging)")


def add_training_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--train-data-path", required=True)
    p.add_argument("--validation-data-path", required=True)
    p.add_argument("--test-data-path", default=None)
    p.add_argument("--output-path", required=True)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--gradient-accumulation-steps", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--max-steps", type=int, default=1000)
    p.add_argument("--eval-steps", type=int, default=100)
    p.add_argument("--save-steps", type=int, default=100)
    p.add_argument("--optim", default="adafactor", choices=["adafactor", "adamw"])
    p.add_argument("--lr-scheduler-type", default="linear", choices=["linear", "constant"])
    p.add_argument("--parts-to-freeze", default="whisper",
                   choices=["whisper", "all_but_last", "none"])
    p.add_argument("--max-label-length", type=int, default=224)
    p.add_argument("--resume-from-checkpoint", type=str2bool, default=False)
    p.add_argument("--language", default="en")
    p.add_argument("--tokenizer-path", default=None,
                   help="local tokenizer dir; defaults to whisper-model-name")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--wandb-logging", type=str2bool, default=False)
    p.add_argument("--wandb-project", default="whisper-medusa-tpu")
    p.add_argument("--wandb-run-name", default=None)
    p.add_argument("--wandb-resume-id", default=None)
    add_mesh_args(p)
