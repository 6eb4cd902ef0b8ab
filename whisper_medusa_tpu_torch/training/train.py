"""Teacher-forced Medusa training: forward, freeze policies, train step —
counterpart of whisper_medusa_tpu/training/train.py.

Freezing is structural, as in the JAX package: under ``"whisper"`` the
encoder and decoder run under ``torch.no_grad()``; under ``"all_but_last"``
the encoder and decoder layers 0..L-2 do, and the last layer reads the live
slice of the stacked leaves (``decode_train(grad_last_only=True)``); the
tied projection is detached whenever the backbone is frozen.  The gradient
mask of :func:`trainable_mask` is applied on top.

Training on the card takes all-bf16 or all-f32 parameters (``param_dtype``
``"float32"`` is ModelConfig's default, as in the JAX package): K1 and K9
have both modes, and an f32 step's projections are full-f32 cuBLAS
products, so f32 training refuses ``torch.backends.cuda.matmul.allow_tf32``.
On the CPU either dtype trains, through the plain versions of the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from whisper_medusa_tpu_torch.config import ModelConfig
from whisper_medusa_tpu_torch.models import whisper
from whisper_medusa_tpu_torch.models.bridge import flatten
from whisper_medusa_tpu_torch.models.medusa import apply_heads_train
from whisper_medusa_tpu_torch.training import losses as losses_mod
from whisper_medusa_tpu_torch.training.optim import OptimizerSpec, warmup_schedule

Params = Dict[str, Any]

FREEZE_POLICIES = ("whisper", "all_but_last")


def shift_tokens_right(labels: torch.Tensor, pad_token_id: int,
                       decoder_start_token_id: int) -> torch.Tensor:
    """labels -> decoder_input_ids (HF semantics): prepend the start token,
    drop the last, -100 -> pad."""
    start = torch.full((labels.shape[0], 1), decoder_start_token_id, dtype=labels.dtype,
                       device=labels.device)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(shifted == losses_mod.IGNORE_INDEX, pad_token_id, shifted)


@dataclasses.dataclass
class TrainForwardOut:
    loss: torch.Tensor
    per_head_ce: torch.Tensor
    per_head_kl: Optional[torch.Tensor]
    valid_heads: torch.Tensor


def _check_policy(policy: Optional[str]) -> None:
    if policy is not None and policy not in FREEZE_POLICIES:
        raise ValueError(f"parts_to_freeze {policy!r} is not supported, select from "
                         f"{list(FREEZE_POLICIES)}")


def _detached(tree: Params) -> Params:
    return {k: _detached(v) if isinstance(v, dict) else v.detach() for k, v in tree.items()}


def medusa_train_forward(params: Params, config: ModelConfig, input_features: torch.Tensor,
                         labels: torch.Tensor,
                         decoder_input_ids: Optional[torch.Tensor] = None,
                         freeze_policy: Optional[str] = None, remat: Any = True,
                         decoder_remat: Any = None) -> TrainForwardOut:
    """Teacher-forced forward with per-head losses (JAX ``medusa_train_forward``).

    ``freeze_policy`` prunes the graph to the trainable set (see the module
    docstring); ``None`` is a full fine-tune, with ``remat`` (and
    ``decoder_remat`` for the decoder, when given) choosing the backbone's
    recompute policy.  Losses stream through T-chunked vocab projections
    (``losses.medusa_losses_streaming``)."""
    dims, med = config.dims, config.medusa
    wp, mp = params["whisper"], params["medusa"]
    _check_policy(freeze_policy)
    if decoder_input_ids is None:
        decoder_input_ids = shift_tokens_right(labels, pad_token_id=50257,
                                               decoder_start_token_id=50258)
    frozen_bb = freeze_policy is not None
    need_teacher = med.output_whisper_original
    feats = input_features.to(wp["encoder"]["conv1_w"].device)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen_bb):
        enc_out = whisper.encode(wp, dims, feats, remat=False if frozen_bb else remat)
    with torch.set_grad_enabled(torch.is_grad_enabled() and freeze_policy != "whisper"):
        dec = whisper.decode_train(
            wp, dims, decoder_input_ids, enc_out, collect_penultimate=need_teacher,
            remat=False if frozen_bb else (remat if decoder_remat is None else decoder_remat),
            grad_last_only=freeze_policy == "all_but_last")
    nh = dims.decoder_attention_heads
    wp_proj = _detached(wp) if frozen_bb else wp

    # Per-head hidden rows (H', B, T, D): the base row 0, then the drafts.
    if med.medusa_heads_type == "base_head":
        head_stack = apply_heads_train(mp, dec.hidden)
    else:
        block_out = whisper.decoder_layer_full(mp["block"], dec.hidden, enc_out, nh)
        head_stack = torch.cat([dec.hidden[None], apply_heads_train(mp, block_out)])

    ce_rows = head_stack if med.medusa_loss_on_original else head_stack[1:]
    teacher_hidden = None
    if med.medusa_kl_loss:
        if need_teacher:
            # Frozen replay of the last decoder layer's original weights on
            # the penultimate hidden state.
            with torch.no_grad():
                th = whisper.decoder_layer_full(_detached(mp["teacher_layer"]),
                                                dec.penultimate.detach(),
                                                enc_out.detach(), nh)
                teacher_hidden = whisper.layer_norm(th, wp["decoder"]["ln_post"]["scale"],
                                                    wp["decoder"]["ln_post"]["bias"])
        else:
            teacher_hidden = head_stack[0].detach()

    per_head_ce, valid, per_head_kl = losses_mod.medusa_losses_streaming(
        lambda h: whisper.project_logits_train(wp_proj, h), ce_rows,
        labels.to(head_stack.device), med.medusa_loss_on_original,
        teacher_hidden=teacher_hidden, kl_lamda=med.medusa_kl_weight)
    loss = torch.where(valid, per_head_ce, 0.0).sum() / valid.sum().clamp(min=1)
    if per_head_kl is not None:
        loss = loss + per_head_kl.mean()
    return TrainForwardOut(loss=loss, per_head_ce=per_head_ce, per_head_kl=per_head_kl,
                           valid_heads=valid)


# ---------------------------------------------------------------------------
# Freeze policies
# ---------------------------------------------------------------------------

def trainable_mask(params: Params, policy: Optional[str]) -> Params:
    """Per-leaf gradient mask of a freeze policy: 1.0 (trained), 0.0 (frozen)
    or, under ``"all_but_last"``, an (L, 1, ...) 0/1 tensor on the stacked
    decoder leaves that trains only the last layer.  The teacher replay
    layer is always frozen."""
    _check_policy(policy)

    def const(tree, v):
        return {k: const(a, v) if isinstance(a, dict) else v for k, a in tree.items()}

    mask: Params = {"whisper": const(params["whisper"], 1.0),
                    "medusa": const(params["medusa"], 1.0)}
    if "teacher_layer" in params["medusa"]:
        mask["medusa"]["teacher_layer"] = const(params["medusa"]["teacher_layer"], 0.0)
    if policy is None:
        return mask
    mask["whisper"] = const(params["whisper"], 0.0)
    if policy == "all_but_last":
        def last_only(tree):
            out = {}
            for k, a in tree.items():
                if isinstance(a, dict):
                    out[k] = last_only(a)
                else:
                    m = torch.zeros((a.shape[0],) + (1,) * (a.dim() - 1), device=a.device)
                    m[-1] = 1.0
                    out[k] = m
            return out
        mask["whisper"]["decoder"]["layers"] = last_only(params["whisper"]["decoder"]["layers"])
    return mask


def is_frozen(m) -> bool:
    """A leaf's mask entry freezes the whole leaf."""
    return not torch.is_tensor(m) and m == 0.0


def apply_mask(grads: Params, mask: Params) -> Params:
    """grads * mask, leaf by leaf (a None grad stays None)."""
    out = {}
    for k, g in grads.items():
        m = mask[k]
        if isinstance(g, dict):
            out[k] = apply_mask(g, m)
        elif g is None or (not torch.is_tensor(m) and m == 1.0):
            out[k] = g
        elif is_frozen(m):
            out[k] = torch.zeros_like(g)
        else:
            out[k] = g * m.to(g.dtype)
    return out


# ---------------------------------------------------------------------------
# Optimizer and train step
# ---------------------------------------------------------------------------

def make_optimizer(name: str = "adafactor", lr: float = 1e-4, warmup_steps: int = 100,
                   total_steps: int = 10000, schedule: str = "linear",
                   gradient_accumulation_steps: int = 1) -> OptimizerSpec:
    """The reference's Seq2SeqTrainingArguments surface: ``adafactor`` or
    ``adamw``, linear warmup then linear decay or constant, optional
    gradient accumulation (``training/optim.py``)."""
    if name not in ("adafactor", "adamw"):
        raise ValueError(f"unknown optimizer {name!r}")
    return OptimizerSpec(name, warmup_schedule(schedule, lr, warmup_steps, total_steps),
                         gradient_accumulation_steps)


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: Any             # the optimizer over ``leaves(params)``
    step: int


def leaves(params: Params) -> List[torch.Tensor]:
    """The parameter tensors in checkpoint-key order (the optimizer's order)."""
    return list(flatten(params).values())


def init_train_state(params: Params, optimizer: OptimizerSpec) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(leaves(params)), step=0)


def require_trainable_dtype(params: Params) -> None:
    """Training on a CUDA device takes one floating dtype, bf16 or f32 (K9,
    the attention backward, has both modes); parameters that mix dtypes, or
    another dtype, raise before anything runs, and so do f32 parameters
    while ``torch.backends.cuda.matmul.allow_tf32`` is True (the f32 step's
    projections, im2col stem and vocab projection are cuBLAS f32 products,
    and TF32 keeps about three decimal digits).  CPU training takes any
    dtype."""
    floats = {t.dtype for t in leaves(params) if t.is_cuda and t.is_floating_point()}
    if len(floats) > 1:
        raise ValueError(f"training on the card takes parameters of one dtype, got mixed "
                         f"dtypes {sorted(str(d) for d in floats)}: cast the model to "
                         "bfloat16 or float32")
    if not floats <= {torch.bfloat16, torch.float32}:
        raise ValueError(f"training on the card takes bfloat16 or float32 parameters, "
                         f"got {floats.pop()}")
    if torch.float32 in floats and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError(
            "f32 training on the card takes full-f32 products, but "
            "torch.backends.cuda.matmul.allow_tf32 is True (TF32 keeps about three "
            "decimal digits); set it to False")


def masked_grads(params: Params, config: ModelConfig, input_features, labels,
                 freeze_policy: Optional[str], remat: Any = "attn",
                 decoder_remat: Any = None) -> Tuple[TrainForwardOut, Dict[str, Any]]:
    """(forward out, {checkpoint key: gradient * mask}) of the leaves
    ``freeze_policy`` trains (None for a leaf the loss does not reach).  It
    turns on ``requires_grad`` for those leaves for the length of the call
    and off again, so the params serve unchanged afterwards."""
    require_trainable_dtype(params)
    mask = flatten(trainable_mask(params, freeze_policy))
    flat = flatten(params)
    live = [k for k in flat if not is_frozen(mask[k])]
    dev = flat[live[0]].device
    feats = torch.as_tensor(input_features, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels, device=dev).long()
    for k in live:
        flat[k].requires_grad_(True)
    try:
        with torch.enable_grad():
            out = medusa_train_forward(params, config, feats, labels,
                                       freeze_policy=freeze_policy, remat=remat,
                                       decoder_remat=decoder_remat)
            grads = torch.autograd.grad(out.loss, [flat[k] for k in live],
                                        allow_unused=True)
    finally:
        for k in live:
            flat[k].requires_grad_(False)
    return out, apply_mask(dict(zip(live, grads)), mask)


def make_train_step(config: ModelConfig, optimizer: OptimizerSpec,
                    freeze_policy: Optional[str], remat: Any = "attn",
                    decoder_remat: Any = None):
    """The train step: ``step(state, input_features, labels) -> (state,
    metrics)``: :func:`masked_grads`, then the optimizer in place.
    ``optimizer`` must be the spec the state's optimizer was made from."""
    _check_policy(freeze_policy)

    def train_step(state: TrainState, input_features, labels):
        out, grads = masked_grads(state.params, config, input_features, labels,
                                  freeze_policy, remat, decoder_remat)
        flat = flatten(state.params)
        for k, g in grads.items():
            flat[k].grad = g
        state.opt_state.step()
        for k in grads:
            flat[k].grad = None
        metrics = {"loss": out.loss.detach(), "per_head_ce": out.per_head_ce.detach(),
                   "valid_heads": out.valid_heads}
        if out.per_head_kl is not None:
            metrics["per_head_kl"] = out.per_head_kl.detach()
        state.step += 1
        return state, metrics

    return train_step


def eval_loss(config: ModelConfig, params: Params, input_features,
              labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, per_head_ce) of the full forward, without a graph."""
    dev = leaves(params)[0].device
    with torch.no_grad():
        out = medusa_train_forward(
            params, config, torch.as_tensor(input_features, dtype=torch.float32, device=dev),
            torch.as_tensor(labels, device=dev).long())
    return out.loss, out.per_head_ce
