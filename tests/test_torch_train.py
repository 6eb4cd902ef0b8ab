"""The port's teacher-forced train forward (training/train.py) against the JAX
package's: the loss, the per-head CE (and KL) and the gradient of every
trainable leaf from ``jax.value_and_grad`` of ``medusa_train_forward``, f32
at 1e-4, for both Medusa variants under the three freeze policies and with
the KL loss (test_torch_train_kl.py, which also holds the gradients
across ``remat`` and the frozen leaves across a step)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_medusa_tpu.config import tiny_test_config as jax_tiny_config
from whisper_medusa_tpu.models import medusa as JM
from whisper_medusa_tpu.models import whisper as JW
from whisper_medusa_tpu.training import train as JT
from whisper_medusa_tpu_torch.config import tiny_test_config
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.training import train as TT

KL = dict(medusa_kl_loss=True, medusa_kl_weight=0.5, medusa_loss_on_original=True)


def configs(variant, **medusa_kw):
    jc = jax_tiny_config(medusa_num_heads=3, medusa_heads_type=variant)
    tc = tiny_test_config(medusa_num_heads=3, medusa_heads_type=variant)
    return (jc.replace(medusa=dataclasses.replace(jc.medusa, **medusa_kw)),
            tc.replace(medusa=dataclasses.replace(tc.medusa, **medusa_kw)))


def param_tree(jc, seed=1):
    """The JAX initializers' tree (teacher and block layers included) with
    every leaf moved off its init by seeded N(0, 0.05) noise, as numpy."""
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    wp = JW.init_whisper_params(r1, jc.dims)
    mp = JM.init_medusa_params(r2, jc.dims, jc.medusa, wp)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + rng.normal(size=a.shape).astype(np.float32) * 0.05,
                        {"whisper": wp, "medusa": mp})


def batch(dims, b=2, t=10, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, dims.num_mel_bins, dims.num_frames)).astype(np.float32)
    labels = rng.integers(6, dims.vocab_size, size=(b, t))
    labels[0, -2:] = -100
    return feats, labels


def flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat_np(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def torch_grads(tc, tree, feats, labels, policy, remat=False):
    """(forward out, {leaf: masked grad as numpy}) of the port, for the
    policy's trainable leaves."""
    params = bridge.params_from_numpy(tree, device="cpu")
    out, grads = TT.masked_grads(params, tc, feats, labels, policy, remat=remat)
    flat = bridge.flatten(params)
    return out, {k: (torch.zeros_like(flat[k]) if g is None else g).numpy()
                 for k, g in grads.items()}


@pytest.mark.parametrize("variant,policy,medusa_kw", [
    ("base_head", "whisper", {}),
    ("base_head", "all_but_last", {}),         # the Medusa-Linear recipe
    ("base_head", None, {}),
    ("medusa_block", "whisper", {}),           # the Medusa-Block recipe
    ("medusa_block", "all_but_last", {}),
    ("medusa_block", None, {}),
])
def test_forward_and_grads_match_jax(variant, policy, medusa_kw):
    check_against_jax(variant, policy, medusa_kw)


def check_against_jax(variant, policy, medusa_kw, remat=False):
    """Both packages' loss, per-head losses and masked gradients, each
    package under the recompute policy ``remat``."""
    jc, tc = configs(variant, **medusa_kw)
    tree = param_tree(jc)
    feats, labels = batch(jc.dims)

    def loss_fn(p):
        out = JT.medusa_train_forward(p, jc, jnp.asarray(feats), jnp.asarray(labels),
                                      freeze_policy=policy, remat=remat)
        return out.loss, out

    jp = jax.tree.map(jnp.asarray, tree)
    (jloss, jout), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    jg = flat_np(JT.apply_mask(jg, JT.trainable_mask(jp, policy)))
    out, got = torch_grads(tc, tree, feats, labels, policy, remat=remat)

    np.testing.assert_allclose(float(out.loss.detach()), float(jloss), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.per_head_ce.detach().numpy(), np.asarray(jout.per_head_ce),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out.valid_heads.numpy(), np.asarray(jout.valid_heads))
    assert (out.per_head_kl is None) == (jout.per_head_kl is None)
    if out.per_head_kl is not None:
        np.testing.assert_allclose(out.per_head_kl.detach().numpy(),
                                   np.asarray(jout.per_head_kl), rtol=1e-4, atol=1e-5)
    assert {k for k, g in jg.items() if np.any(g != 0)} <= set(got)
    for k, g in got.items():
        scale = max(float(np.abs(jg[k]).max()), 1e-3)
        np.testing.assert_allclose(g, jg[k], rtol=1e-4, atol=1e-4 * scale, err_msg=k)
    frozen = [k for k in jg if k not in got]
    assert all(not np.any(jg[k]) for k in frozen)
    if policy == "whisper":
        assert all(k.startswith("medusa/") for k in got)
    if "output_whisper_original" in medusa_kw:
        assert not any(k.startswith("medusa/teacher_layer") for k in got)
