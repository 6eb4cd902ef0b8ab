"""The port's train forward against the JAX package's with the KL loss (the
base head's and the frozen teacher layer's targets); the gradients do not
depend on ``remat``, and remat "dots" matches JAX's "dots" and keeps fewer
tensors than no recompute; a train step leaves frozen leaves and frozen
slices bit-identical.  Helpers in test_torch_train.py."""

import collections

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_train import KL, batch, check_against_jax, configs, param_tree, torch_grads
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models import whisper as W
from whisper_medusa_tpu_torch.training import train as TT


@pytest.mark.parametrize("variant,policy,medusa_kw", [
    ("base_head", "whisper", KL),              # KL against the base head
    ("medusa_block", "all_but_last", dict(KL, output_whisper_original=True)),
    ("base_head", None, dict(KL, output_whisper_original=True)),
])
def test_kl_forward_and_grads_match_jax(variant, policy, medusa_kw):
    check_against_jax(variant, policy, medusa_kw)


@pytest.mark.parametrize("variant,policy", [("base_head", None), ("medusa_block", None)])
def test_grads_do_not_depend_on_remat(variant, policy):
    jc, tc = configs(variant)
    tree = param_tree(jc, seed=2)
    feats, labels = batch(jc.dims, seed=1)
    _, ref = torch_grads(tc, tree, feats, labels, policy, remat=False)
    for remat in (True, "full", "attn", "dots"):
        _, got = torch_grads(tc, tree, feats, labels, policy, remat=remat)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=f"{remat} {k}")


@pytest.mark.parametrize("variant", ["base_head", "medusa_block"])
def test_dots_grads_match_jax_dots(variant):
    """A full fine-tune under remat "dots" in both packages (JAX's
    dots_with_no_batch_dims_saveable, the port's selective checkpoint)."""
    check_against_jax(variant, None, {}, remat="dots")


@pytest.mark.parametrize("variant", ["base_head", "medusa_block"])
def test_dots_keeps_fewer_tensors(monkeypatch, variant):
    """The tensors a full fine-tune's forward keeps for the backward: under
    remat=False every one goes through autograd's saved-tensor hooks; under
    "dots" only those outside the layers do, plus the outputs the policy
    keeps inside them, which are exactly the layers' weight projections (6
    an encoder layer, 10 a decoder layer).  Fewer in all, the same loss."""
    jc, tc = configs(variant)
    tree = param_tree(jc, seed=2)
    feats, labels = batch(jc.dims, seed=1)
    kept = collections.Counter()
    policy = W._dots_policy

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            kept[(str(op), str(decision).rsplit(".", 1)[-1])] += 1
        return decision

    monkeypatch.setattr(W, "_dots_policy", spy)

    def saved(remat):
        n = [0]

        def pack(t):
            n[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out, _ = torch_grads(tc, tree, feats, labels, None, remat=remat)
        return n[0], float(out.loss.detach())

    n_none, loss_none = saved(False)
    assert not kept
    n_dots, loss_dots = saved("dots")
    d = jc.dims
    projections = 6 * d.encoder_layers + 10 * d.decoder_layers
    must = sum(n for (_, decision), n in kept.items() if decision == "MUST_SAVE")
    assert must == kept[("aten.mm.default", "MUST_SAVE")] == projections
    assert n_dots + must < n_none
    assert loss_dots == loss_none


@pytest.mark.parametrize("variant,policy", [("base_head", "all_but_last"),
                                            ("medusa_block", "whisper"),
                                            ("base_head", "whisper")])
def test_step_keeps_frozen_leaves_bit_identical(variant, policy):
    """One Adafactor step: frozen leaves and the frozen slices of the
    stacked decoder leaves are bit-identical, the trained ones moved, the
    teacher layer untouched, and no leaf is left requiring grad."""
    jc, tc = configs(variant, **dict(KL, output_whisper_original=True))
    params = bridge.params_from_numpy(param_tree(jc, seed=3), device="cpu")
    before = {k: v.clone() for k, v in bridge.flatten(params).items()}
    opt = TT.make_optimizer("adafactor", lr=1e-2, warmup_steps=0, schedule="constant")
    state = TT.init_train_state(params, opt)
    feats, labels = batch(jc.dims, seed=2)
    state, metrics = TT.make_train_step(tc, opt, policy)(state, feats, labels)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert "per_head_kl" in metrics
    after = bridge.flatten(state.params)
    assert not any(t.requires_grad or t.grad is not None for t in after.values())
    for k, a in after.items():
        b = before[k]
        if k.startswith("medusa/heads") or (k.startswith("medusa/block")):
            assert not torch.equal(a, b), k
        elif k.startswith("whisper/decoder/layers/") and policy == "all_but_last":
            assert torch.equal(a[:-1], b[:-1]) and not torch.equal(a[-1], b[-1]), k
        else:
            assert torch.equal(a, b), k
