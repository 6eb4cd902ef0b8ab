"""A (data, model) grid of ranks and the tensor-parallel pieces — the
counterpart of whisper_medusa_tpu/parallel/mesh.py on ``torch.distributed``.

The JAX package lays its devices out on a ``Mesh`` with axes ``("data",
"model")`` and lets GSPMD insert the collectives.  Here the mesh is the
world's ranks reshaped (dp, tp), the model axis contiguous as in JAX, with a
process group for each row (the model group: the ranks that share one
data shard) and each column (the data group).  The weights stay plain
local tensors: :func:`shard_params` cuts each leaf by the JAX spec tree
(:func:`model_param_specs`, the same tree as JAX's, as data) and returns
this rank's shard, which the hand-written kernels take as they are.

Sharding rules (JAX's): q/k/v and fc1 with their biases on their output
axis, o and fc2 on their input axis; the tied embedding by rows when the
vocabulary divides by tp, else by its d_model columns (whisper's 51865 rows
divide by no tp > 1); norms, convs, positions and the Medusa heads
replicated; the Medusa-Block and teacher layers as a decoder layer; an
int8 ``{"q", "s"}`` weight keeps the surviving axis on its scales.

Tensor parallelism runs under :func:`use_mesh` (JAX's ``jax.set_mesh``):
``models/whisper.py`` reads :func:`model_parallel` and runs each layer on
this rank's heads and FFN columns, summing the row-parallel outputs over
the model group with :func:`reduce_from_model` (forward all-reduce,
backward identity) and marking the column-parallel inputs with
:func:`copy_to_model` (forward identity, backward all-reduce), Megatron's
pair, so a loss that every model rank computes alike gets each weight's
gradient once.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from whisper_medusa_tpu_torch.parallel import distributed

Params = Dict[str, Any]

DATA_AXIS = "data"
MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one axis name (or None) per leading tensor axis,
    as JAX's ``PartitionSpec``; ``tuple(jax_spec) == port_spec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(eq=False)
class Mesh:
    """(dp, tp) ranks, this rank's coordinates and its two groups (None for
    an axis of size 1, where no collective is needed)."""

    devices: np.ndarray            # (dp, tp) global ranks, as JAX's mesh.devices
    data_index: int
    model_index: int
    data_group: Any = None
    model_group: Any = None

    @property
    def dp(self) -> int:
        return int(self.devices.shape[0])

    @property
    def tp(self) -> int:
        return int(self.devices.shape[1])


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over the world's ranks, JAX's defaults: tp 4
    when n % 8 == 0, 2 when n is even, else 1; dp = n / tp.  Every rank
    calls it (the groups are made collectively); the mesh spans the whole
    world."""
    world = distributed.process_count()
    if max(n_devices or 1, (dp or 1) * (tp or 1)) > world:
        raise ValueError(
            f"a mesh of {n_devices or (dp or 1) * (tp or 1)} ranks (dp={dp}, tp={tp}) "
            f"needs that many processes and the world has {world}: start one process "
            "per rank (torchrun, or --coordinator-address / --num-processes / "
            "--process-id) and call parallel.distributed.initialize first")
    n = n_devices or world
    if dp is None and tp is None:
        tp = 4 if n % 8 == 0 else 2 if n % 2 == 0 else 1
        dp = n // tp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != n_devices={n}")
    if n != world:
        raise ValueError(f"the mesh must span the world: {n} ranks asked, {world} running")
    grid = np.arange(n).reshape(dp, tp)
    rank = distributed.process_index()
    di, mi = (int(v[0]) for v in np.nonzero(grid == rank))
    groups: Dict[str, Any] = {"data": None, "model": None}
    timeout = distributed.group_timeout()
    # new_group is collective: every rank makes every group, in one order.
    for axis, rows in (("model", [list(r) for r in grid] if tp > 1 else []),
                       ("data", [list(c) for c in grid.T] if dp > 1 else [])):
        for ranks in rows:
            g = dist.new_group([int(r) for r in ranks], timeout=timeout)
            if rank in ranks:
                groups[axis] = g
    return Mesh(grid, di, mi, groups["data"], groups["model"])


# ---------------------------------------------------------------------------
# Spec trees (JAX's, as data)
# ---------------------------------------------------------------------------

def _attn_spec() -> Dict[str, P]:
    return {"q_w": P(None, None, MODEL_AXIS), "q_b": P(None, MODEL_AXIS),
            "k_w": P(None, None, MODEL_AXIS), "v_w": P(None, None, MODEL_AXIS),
            "v_b": P(None, MODEL_AXIS), "o_w": P(None, MODEL_AXIS, None),
            "o_b": P(None, None)}


def _layer_specs() -> Dict[str, Any]:
    reps2 = {"scale": P(None, None), "bias": P(None, None)}
    return {"self_ln": reps2, "self": _attn_spec(), "cross_ln": reps2,
            "cross": _attn_spec(), "ffn_ln": reps2,
            "fc1_w": P(None, None, MODEL_AXIS), "fc1_b": P(None, MODEL_AXIS),
            "fc2_w": P(None, MODEL_AXIS, None), "fc2_b": P(None, None)}


def _unstacked(tree):
    """A stacked layer's specs without the layer axis (the Medusa-Block and
    teacher layers)."""
    if isinstance(tree, P):
        return P(*tree[1:])
    return {k: _unstacked(v) for k, v in tree.items()}


def _rows(w) -> int:
    return (w["q"] if _is_qdict(w) else w).shape[0]


def whisper_param_specs(params: Params, tp: int = 1) -> Params:
    """The spec tree of a whisper params tree (JAX ``whisper_param_specs``):
    the tied embedding by rows when tp divides the vocabulary, else by its
    d_model columns."""
    emb = (params or {}).get("decoder", {}).get("embed_tokens")
    vocab = None if emb is None else _rows(emb)
    embed_spec = (P(MODEL_AXIS, None) if vocab is None or tp <= 1 or vocab % tp == 0
                  else P(None, MODEL_AXIS))
    enc_layers = {k: v for k, v in _layer_specs().items() if k not in ("cross", "cross_ln")}
    return {
        "encoder": {"conv1_w": P(), "conv1_b": P(), "conv2_w": P(), "conv2_b": P(),
                    "pos_embed": P(), "layers": enc_layers,
                    "ln_post": {"scale": P(), "bias": P()}},
        "decoder": {"embed_tokens": embed_spec, "pos_embed": P(), "layers": _layer_specs(),
                    "ln_post": {"scale": P(), "bias": P()}},
    }


def medusa_param_specs(medusa_params: Params) -> Params:
    specs: Params = {"heads": {"w": P(), "b": P()}}
    if "block" in medusa_params:
        specs["block"] = _unstacked(_layer_specs())
    if "teacher_layer" in medusa_params:
        specs["teacher_layer"] = _unstacked(_layer_specs())
    return specs


def model_param_specs(params: Params, tp: int = 1) -> Params:
    specs: Params = {"whisper": whisper_param_specs(params["whisper"], tp)}
    if "medusa" in params:
        specs["medusa"] = medusa_param_specs(params["medusa"])
    return specs


def _is_qdict(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "s"}


def _quantized_specs(params, specs, key=None):
    """Specs over int8 ``{"q", "s"}`` dicts (JAX ``_quantized_specs``): the
    int8 tensor keeps the weight's spec, the scales the axes that survive
    the dropped one (the last for the row-quantized embedding, else the
    contraction axis)."""
    if isinstance(specs, P):
        if not _is_qdict(params):
            return specs
        q, s = params["q"], params["s"]
        padded = list(specs) + [None] * (q.dim() - len(specs))
        drop = -1 if key == "embed_tokens" else -2
        expect = tuple(q.shape[:q.dim() + drop]) + tuple(q.shape[q.dim() + drop + 1:])
        if tuple(s.shape) == expect:
            s_spec = P(*(padded[:q.dim() + drop] + padded[q.dim() + drop + 1:]))
        else:
            s_spec = P()
        return {"q": specs, "s": s_spec}
    if isinstance(specs, dict):
        return {k: _quantized_specs(params.get(k) if isinstance(params, dict) else None,
                                    v, k) for k, v in specs.items()}
    return specs


def param_specs(params: Params, tp: int) -> Params:
    """The spec tree of a model (``{"whisper", "medusa"}``) or whisper
    params tree, int8 leaves expanded."""
    specs = (model_param_specs(params, tp) if "whisper" in params
             else whisper_param_specs(params, tp))
    return _quantized_specs(params, specs)


def _map(fn, params, specs, path=""):
    if isinstance(params, dict):
        return {k: _map(fn, v, specs[k], f"{path}/{k}" if path else k)
                for k, v in params.items()}
    return fn(params, specs, path)


def _model_axis(spec) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_params(params: Params, mesh: Mesh) -> Params:
    """This rank's shard of ``params`` (bf16, f32 or int8 trees): each leaf
    cut along its spec's model axis at this rank's model index, as a
    contiguous tensor.  The cut is differentiable, so a loss on the shard
    gives the full leaf a gradient that is zero outside this rank's
    slice (the trainer sums those over the model group)."""
    specs = param_specs(params, mesh.tp)

    def cut(a, spec, path):
        axis = _model_axis(spec)
        if axis is None or mesh.tp == 1:
            return a
        if a.shape[axis] % mesh.tp:
            raise ValueError(f"{path}: axis {axis} of {tuple(a.shape)} does not divide "
                             f"by tp={mesh.tp}")
        n = a.shape[axis] // mesh.tp
        return a.narrow(axis, mesh.model_index * n, n).contiguous()

    return _map(cut, params, specs)


def gather_params(shard: Params, specs: Params, mesh: Mesh) -> Params:
    """The inverse of :func:`shard_params` on a subtree: each leaf
    all-gathered over the model group along its spec's model axis."""
    def gather(a, spec, path):
        axis = _model_axis(spec)
        if axis is None or mesh.tp == 1:
            return a
        return distributed.all_gather(a, mesh.model_group, dim=axis)

    return _map(gather, shard, specs)


def sharded_leaves(params: Params, tp: int) -> List[str]:
    """Checkpoint keys (``bridge.flatten``'s) of the leaves cut over the
    model axis."""
    out: List[str] = []

    def visit(a, spec, path):
        if tp > 1 and _model_axis(spec) is not None:
            out.append(path)
        return a

    _map(visit, params, param_specs(params, tp))
    return out


# ---------------------------------------------------------------------------
# The ambient mesh and the tensor-parallel collectives
# ---------------------------------------------------------------------------

_ACTIVE: List[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the enclosed calls on ``mesh`` (JAX ``jax.set_mesh``)."""
    if mesh is None:
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def model_parallel() -> Optional[Mesh]:
    """The ambient mesh when its model axis is split, else None."""
    m = active()
    return m if m is not None and m.tp > 1 else None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return distributed.all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_reduce(grad, ctx.group), None


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel layer's partial output summed over the model group
    (the backward passes the gradient through: every model rank holds the
    same downstream loss)."""
    m = model_parallel()
    return x if m is None else _ReduceFromModel.apply(x, m.model_group)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """A column-parallel layer's replicated input: the identity forward,
    its gradient (each rank's part from its own columns) summed over the
    model group in the backward."""
    m = model_parallel()
    if m is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, m.model_group)


def gather_heads(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-head tensors (attention probabilities) of this rank's heads ->
    every head, along ``dim`` in model-rank order (no gradient)."""
    m = model_parallel()
    return x if m is None else distributed.all_gather(x, m.model_group, dim=dim)
