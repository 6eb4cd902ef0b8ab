"""The CLIs' flags — the port's copy of whisper_medusa_tpu/cli/args.py
(``add_model_args``, ``add_training_args``, ``add_eval_args``: the same flags
and defaults), plus ``--device`` and ``--dist-backend``.  The mesh flags
(``--dp/--tp``) and the multi-process flags (``--coordinator-address``,
``--num-processes``, ``--process-id``; or torchrun's variables) run the CLIs
over ``torch.distributed`` (``parallel/``); ``--wandb-logging`` is refused
(``refuse_unported``)."""

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
    """The (data, model) mesh flags and the multi-process bootstrap (the JAX
    CLI's), plus ``--dist-backend``."""
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh size (0 = one process)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel mesh size (0 = one process)")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 (or torchrun's MASTER_ADDR / MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count (or WORLD_SIZE)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (or RANK)")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="nccl: a card per rank; gloo: CPU ranks, or ranks sharing one card")


def maybe_init_distributed(args) -> None:
    """Join ``torch.distributed`` when the multi-process flags or torchrun's
    variables are present (``parallel.distributed.initialize``)."""
    import os

    from whisper_medusa_tpu_torch.parallel import distributed

    if (args.coordinator_address or args.num_processes
            or os.environ.get("MASTER_ADDR")):
        distributed.initialize(coordinator_address=args.coordinator_address,
                               num_processes=args.num_processes,
                               process_id=args.process_id, backend=args.dist_backend)


def make_mesh_from_args(args):
    """The (dp, tp) mesh that --dp/--tp ask for, or None when unset.  It
    must span the world; a mesh wider than the world raises."""
    dp, tp = args.dp or 0, args.tp or 0
    if dp <= 0 and tp <= 0:
        return None
    from whisper_medusa_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.make_mesh((dp or 1) * (tp or 1), dp=dp or 1, tp=tp or 1)


def refuse_unported(args) -> None:
    """The JAX CLI's wandb flag has no port."""
    if getattr(args, "wandb_logging", False):
        from whisper_medusa_tpu_torch.utils.logging_utils import make_wandb_logger

        make_wandb_logger(args.wandb_project)


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


def add_eval_args(p: argparse.ArgumentParser) -> None:
    """The evaluation CLI's flags (the JAX ``add_eval_args``) and ``--device``."""
    p.add_argument("--model-name", required=True,
                   help="checkpoint directory (the framework's format or the reference's)")
    p.add_argument("--data-path", required=True)
    p.add_argument("--out-file-path", required=True)
    p.add_argument("--language", default="en")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-length", type=int, default=448)
    p.add_argument("--disable-medusa", type=str2bool, default=False,
                   help="vanilla greedy baseline (for speedup measurement)")
    p.add_argument("--regulation-start", type=int, default=140)
    p.add_argument("--regulation-factor", type=float, default=1.0)
    p.add_argument("--tokenizer-path", default=None)
    p.add_argument("--param-dtype", default="bfloat16")
    p.add_argument("--num-beams", type=int, default=1,
                   help=">1 switches to vanilla beam search (beyond reference)")
    p.add_argument("--int8", type=str2bool, default=False,
                   help="int8 weight-only serving mode (model.quantize())")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain versions)")
    add_mesh_args(p)
