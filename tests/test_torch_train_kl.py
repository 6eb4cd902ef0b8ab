"""The port's train forward against the JAX package's with the KL loss (the
base head's and the frozen teacher layer's targets); the gradients do not
depend on ``remat``; a train step leaves frozen leaves and frozen slices
bit-identical.  Helpers in test_torch_train.py."""

import numpy as np
import pytest
import torch

from tests.test_torch_train import KL, batch, check_against_jax, configs, param_tree, torch_grads
from whisper_medusa_tpu_torch.models import bridge
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
    for remat in (True, "full", "attn"):
        _, got = torch_grads(tc, tree, feats, labels, policy, remat=remat)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=f"{remat} {k}")
    with pytest.raises(NotImplementedError, match="dots"):
        torch_grads(tc, tree, feats, labels, policy, remat="dots")


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
