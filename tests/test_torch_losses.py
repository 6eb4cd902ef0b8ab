"""The port's Medusa losses (training/losses.py) against the JAX package's
(medusa_cross_entropy, medusa_kl, medusa_losses_streaming), and both against
an oracle of the reference's loss semantics written here from its
description (SURVEY.md section 2.1, row 18): per-head shifted cross-entropy
that stops at the first head whose loss is NaN (no supervised position
left), and torch's batchmean KL against the detached teacher."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.training import losses as JL
from whisper_medusa_tpu_torch.training import losses as TL

# The JAX side jitted: one compile per shape instead of one per op.
_jce = jax.jit(JL.medusa_cross_entropy, static_argnums=2)
_jkl = jax.jit(JL.medusa_kl, static_argnums=(2, 3))


def _oracle_ce(logits, labels, loss_on_original):
    """Reference MedusaCrossEntropyLoss: head i against labels shifted by
    shift + i, mean over non-ignored labels; the loop breaks on NaN."""
    shift = 0 if loss_on_original else 1
    out = []
    for i in range(logits.shape[0]):
        s = shift + i
        lg = logits[i, :, : logits.shape[2] - s]
        loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels[:, s:].reshape(-1),
                               ignore_index=-100)
        if torch.isnan(loss):
            break
        out.append(loss)
    return torch.stack(out)


def _oracle_kl(logits, teacher, lamda, loss_on_original):
    """Reference MedusaKLDivLoss: KLDivLoss(batchmean) of each head's
    log-softmax against the teacher's softmax at the shifted positions."""
    shift = 0 if loss_on_original else 1
    out = []
    for i in range(logits.shape[0]):
        s = shift + i
        logp = F.log_softmax(logits[i, :, : logits.shape[2] - s], dim=-1)
        tp = F.softmax(teacher[:, s:], dim=-1)
        out.append(F.kl_div(logp, tp, reduction="batchmean") * lamda)
    return torch.stack(out)


def _data(h=4, b=2, t=12, v=32, seed=0, ignored_tail=2):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(h, b, t, v)).astype(np.float32)
    teacher = rng.normal(size=(b, t, v)).astype(np.float32)
    labels = rng.integers(0, v, size=(b, t))
    labels[:, t - ignored_tail:] = -100
    return logits, teacher, labels


@pytest.mark.parametrize("loss_on_original", [False, True])
def test_ce_and_kl_match_jax(loss_on_original):
    logits, teacher, labels = _data(seed=1)
    jce, jvalid = _jce(jnp.asarray(logits), jnp.asarray(labels), loss_on_original)
    tce, tvalid = TL.medusa_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                          loss_on_original)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tce.numpy(), np.asarray(jce), atol=1e-5, rtol=1e-5)
    jkl = _jkl(jnp.asarray(logits), jnp.asarray(teacher), 0.7, loss_on_original)
    tkl = TL.medusa_kl(torch.from_numpy(logits), torch.from_numpy(teacher), 0.7,
                       loss_on_original)
    np.testing.assert_allclose(tkl.numpy(), np.asarray(jkl), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("loss_on_original", [False, True])
@pytest.mark.parametrize("chunk", [5, 64])
def test_streaming_matches_jax(loss_on_original, chunk):
    """Values and gradients (projection weight and head rows) of the
    streamed CE + KL; chunk 5 gives several chunks and a ragged tail."""
    rng = np.random.default_rng(3)
    h, b, t, d, v = 4, 2, 10, 8, 32
    head = rng.normal(size=(h, b, t, d)).astype(np.float32)
    teacher = rng.normal(size=(b, t, d)).astype(np.float32)
    w = (rng.normal(size=(v, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, size=(b, t))
    labels[:, -2:] = -100

    def jtotal(w_, head_):
        ce, valid, kl = JL.medusa_losses_streaming(
            lambda x: jnp.einsum("...d,vd->...v", x, w_), head_, jnp.asarray(labels),
            loss_on_original, teacher_hidden=jnp.asarray(teacher), kl_lamda=0.7, chunk=chunk)
        total = jnp.sum(jnp.where(valid, ce, 0.0)) / jnp.maximum(jnp.sum(valid), 1)
        return total + jnp.mean(kl), (ce, valid, kl)

    (jtot, (jce, jvalid, jkl)), jg = jax.jit(
        jax.value_and_grad(jtotal, argnums=(0, 1), has_aux=True))(
        jnp.asarray(w), jnp.asarray(head))
    tw, th = torch.from_numpy(w).requires_grad_(), torch.from_numpy(head).requires_grad_()
    ce, valid, kl = TL.medusa_losses_streaming(
        lambda x: x @ tw.t(), th, torch.from_numpy(labels), loss_on_original,
        teacher_hidden=torch.from_numpy(teacher), kl_lamda=0.7, chunk=chunk)
    total = torch.where(valid, ce, 0.0).sum() / valid.sum().clamp(min=1) + kl.mean()
    total.backward()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(jce), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(kl.detach().numpy(), np.asarray(jkl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(total.detach()), float(jtot), atol=1e-5, rtol=1e-5)
    for got, ref in ((tw.grad, jg[0]), (th.grad, jg[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("loss_on_original", [False, True])
@pytest.mark.parametrize("ignored_tail", [3, 6])
def test_ce_follows_the_reference_oracle(loss_on_original, ignored_tail):
    """Heads up to the first one left with no supervised label agree with
    the oracle; that head and every later one are flagged invalid, where the
    reference's loop breaks (10 heads over 12 positions)."""
    logits, _, labels = _data(h=10, seed=2, ignored_tail=ignored_tail)
    ref = _oracle_ce(torch.from_numpy(logits), torch.from_numpy(labels), loss_on_original)
    assert 0 < len(ref) < 10
    jce, jvalid = _jce(jnp.asarray(logits), jnp.asarray(labels), loss_on_original)
    tce, tvalid = TL.medusa_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                          loss_on_original)
    sce, svalid, _ = TL.medusa_losses_streaming(
        lambda x: x, torch.from_numpy(logits), torch.from_numpy(labels), loss_on_original,
        chunk=5)
    for ce, valid in ((np.asarray(jce), np.asarray(jvalid)), (tce.numpy(), tvalid.numpy()),
                      (sce.numpy(), svalid.numpy())):
        assert valid[: len(ref)].all() and not valid[len(ref):].any()
        np.testing.assert_allclose(ce[: len(ref)], ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("loss_on_original", [False, True])
def test_kl_follows_the_reference_oracle(loss_on_original):
    logits, teacher, _ = _data(h=3, t=10, v=16, seed=4)
    ref = _oracle_kl(torch.from_numpy(logits), torch.from_numpy(teacher), 0.7,
                     loss_on_original)
    jkl = _jkl(jnp.asarray(logits), jnp.asarray(teacher), 0.7, loss_on_original)
    tkl = TL.medusa_kl(torch.from_numpy(logits), torch.from_numpy(teacher), 0.7,
                       loss_on_original)
    for got in (np.asarray(jkl), tkl.numpy()):
        np.testing.assert_allclose(got, ref.numpy(), atol=1e-5, rtol=1e-5)
