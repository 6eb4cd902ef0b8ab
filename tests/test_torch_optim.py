"""The port's optimizers (training/optim.py, through train.make_optimizer)
against the JAX package's make_optimizer (optax 0.2.6): Adafactor on
factored 2-D, stacked 3-D and unfactored leaves, AdamW, the warmup
schedules and gradient accumulation, f32 parameters within 1e-6 after each
step; a zero-gradient slice comes out unchanged, bit for bit."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.training import train as JT
from whisper_medusa_tpu_torch.training import optim as TO
from whisper_medusa_tpu_torch.training import train as TT

SHAPES = {"factored": (256, 128), "stacked": (2, 128, 160), "small_2d": (3, 40),
          "vector": (64,)}


def _run(name, steps, **kw):
    """(optax params, port params) after each of ``steps`` updates on the
    same seeded gradients; the stacked leaf's first slice gets zero grads."""
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(steps)]
    for g in grads:
        g["stacked"][0] = 0.0
    jopt = JT.make_optimizer(name, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    jupdate = jax.jit(lambda g, st, p: jopt.update(g, st, p))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = TT.make_optimizer(name, **kw).init(list(tp.values()))
    out = []
    for g in grads:
        upd, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        topt.step()
        out.append(({k: np.asarray(v) for k, v in jp.items()},
                    {k: t.numpy().copy() for k, t in tp.items()}))
    return params, out


@pytest.mark.parametrize("name,kw", [
    ("adafactor", dict(lr=1e-2, warmup_steps=0, total_steps=10, schedule="constant")),
    ("adafactor", dict(lr=1e-2, warmup_steps=1, total_steps=4, schedule="linear")),
    ("adamw", dict(lr=1e-3, warmup_steps=2, total_steps=10, schedule="linear")),
    ("adafactor", dict(lr=1e-2, warmup_steps=0, total_steps=10, schedule="constant",
                       gradient_accumulation_steps=2)),
    ("adamw", dict(lr=1e-3, warmup_steps=0, total_steps=10, schedule="constant",
                   gradient_accumulation_steps=2)),
])
def test_steps_match_optax(name, kw):
    steps = 4 if kw.get("gradient_accumulation_steps", 1) > 1 else 3
    start, out = _run(name, steps, **kw)
    for jp, tp in out:
        for k in SHAPES:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=1e-6, err_msg=k)
    last = out[-1][1]
    assert np.array_equal(last["stacked"][0], start["stacked"][0])
    assert not np.array_equal(last["stacked"][1], start["stacked"][1])
    assert all(not np.array_equal(last[k], start[k]) for k in SHAPES)


def test_adafactor_factors_as_optax():
    assert TO.factored_dims((256, 128)) == (1, 0)
    assert TO.factored_dims((2, 128, 160)) == (1, 2)
    assert TO.factored_dims((3, 40)) is None and TO.factored_dims((64,)) is None
    p = torch.zeros((2, 128, 160), requires_grad=False)
    opt = TO.Adafactor([p], lr=1e-2)
    p.grad = torch.ones_like(p)
    opt.step()
    st = opt.state[p]
    assert st["v_row"].shape == (2, 128) and st["v_col"].shape == (2, 160)


@pytest.mark.parametrize("kind,warmup,total", [("linear", 3, 10), ("linear", 0, 5),
                                               ("constant", 4, 10), ("constant", 0, 1)])
def test_schedules_match_optax(kind, warmup, total):
    lr = 3e-4
    if kind == "linear":
        ref = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warmup),
             optax.linear_schedule(lr, 0.0, max(total - warmup, 1))], [warmup])
    else:
        ref = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warmup), optax.constant_schedule(lr)], [warmup])
    got = TO.warmup_schedule(kind, lr, warmup, total)
    for count in range(total + 3):
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-6, atol=1e-12)


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        TT.make_optimizer("sgd")
    with pytest.raises(ValueError):
        TT.make_optimizer("adamw", schedule="cosine")
