"""Branching ``medusa_choices`` trees, port vs the JAX package.

The fixtures of test_torch_generate.py and test_torch_block_generate.py
(tiny_test_config(vocab_size=51865, medusa_num_heads=3), float32 on the CPU,
nonzero heads), and a 4-head model for the five-level tree.  A tree takes
the unfused route in both packages (materialized logits, per-level top-k
drafts, the accepted path's cache rows gathered into place); the port calls
neither ``verify_hidden`` (K4) nor ``verify_rows`` (K5).  Trees (1,2,2,1),
(1,2,1,3), (1,3,2) and (1,1,2,2,1) at B = 1, 3 and 9 (past K2's batch: the
per-op step's mask), Medusa-Block, int8 and ``return_timestamps=True``:
sequences, lengths, steps and accepted drafts are equal, token log-probs
agree to 1e-4 (5e-3 at int8, the bar of test_torch_int8_generate.py).  A
tree with fewer levels than the model has heads drafts from the first
heads: the port's (1,3,2) on the 3-head model equals the JAX package's on
the same model cut to its first two draft heads.  ``_compact_tree_cache``
is held bitwise to the JAX one on random bf16 and int8 slabs (scales and
the Medusa-Block slot included); ``chunk_bits`` past 32 columns against the
mask; the mask mode's plain version at TC > 32, in 16-row blocks, against
JAX ``attention`` under ``make_step_mask`` at 1e-5 (float32).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_block_generate import block_models  # noqa: F401
from tests.test_torch_generate import _assert_same, _feats, models  # noqa: F401
from tests.test_torch_generate_timestamps import _same as _same_ts
from tests.test_torch_logits_processor import verify_calls  # noqa: F401
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.decoding import speculative as jspec
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.decoding import speculative as tspec
from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel as TModel
from whisper_medusa_tpu_torch.ops import decode_ops as tdo

NO_FUSED = {"verify_hidden": 0, "verify_rows": 0}


@pytest.mark.parametrize("choices,b", [
    ((1, 2, 2, 1), 1), ((1, 2, 2, 1), 3), ((1, 2, 2, 1), 9), ((1, 2, 1, 3), 1),
    ((1, 2, 1, 3), 3)])
def test_tree_generate_matches_jax(models, verify_calls, choices, b):
    jm, tm = models
    f = _feats(jm.config, seed=60 + b, b=b)
    kw = dict(language="en", max_length=24, medusa_choices=choices)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    _assert_same(a, c)
    assert int(c.accepted.sum()) > 0
    assert verify_calls == NO_FUSED


def test_tree_with_fewer_levels_than_heads(models, verify_calls):
    """(1,3,2) on 3 draft heads drafts from heads 1 and 2: the JAX package
    on the model cut to those heads gives the same output (its own loop
    refuses the uncut model's third head here)."""
    jm, tm = models
    cut = copy.copy(jm)
    cut._jit_cache = {}
    heads = jm.params["medusa"]["heads"]
    cut.params = {"whisper": jm.params["whisper"],
                  "medusa": {"heads": {"w": heads["w"][:3], "b": heads["b"][:3]}}}
    f = _feats(jm.config, seed=64, b=2)
    kw = dict(language="en", max_length=24, medusa_choices=(1, 3, 2))
    a, c = cut.generate(f, **kw), tm.generate(f, **kw)
    _assert_same(a, c)
    assert verify_calls == NO_FUSED


@pytest.fixture(scope="module")
def models4():
    cfg = tiny_test_config(vocab_size=51865, medusa_num_heads=4)
    jm = JModel.from_random(cfg, seed=1)
    w = jm.params["medusa"]["heads"]["w"]
    jm.params["medusa"]["heads"]["w"] = jnp.asarray(
        0.3 * np.random.default_rng(1).standard_normal(w.shape), jnp.float32)
    tm = TModel(tconfig.ModelConfig.from_dict(cfg.to_dict()),
                bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu"),
                device="cpu")
    return jm, tm


def test_five_level_tree_matches_jax(models4):
    jm, tm = models4
    f = _feats(jm.config, seed=65, b=2)
    kw = dict(language="en", max_length=28, medusa_choices=(1, 1, 2, 2, 1))
    _assert_same(jm.generate(f, **kw), tm.generate(f, **kw))


@pytest.mark.parametrize("b", [1, 2])
def test_tree_block_generate_matches_jax(block_models, verify_calls, b):
    jm, tm = block_models
    f = _feats(jm.config, seed=66 + b, b=b)
    kw = dict(language="en", max_length=24, medusa_choices=(1, 2, 2, 1))
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    _assert_same(a, c)
    assert int(c.accepted.sum()) > 0
    assert verify_calls == NO_FUSED


@pytest.mark.parametrize("b", [1, 3])
def test_tree_int8_generate_matches_jax(models, b):
    jm, tm = models
    jq, tq = jm.quantize(), tm.quantize()
    f = _feats(jm.config, seed=68 + b, b=b)
    kw = dict(language="en", max_length=24, medusa_choices=(1, 2, 2, 1))
    a, c = jq.generate(f, **kw), tq.generate(f, **kw)
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(c.lengths, np.asarray(a.lengths))
    np.testing.assert_array_equal(c.accepted, np.asarray(a.accepted))
    assert c.steps == a.steps
    np.testing.assert_allclose(c.token_logprobs, a.token_logprobs, rtol=0, atol=5e-3)


@pytest.mark.parametrize("choices,b", [((1, 2, 2, 1), 1), ((1, 2, 1, 3), 3)])
def test_tree_timestamps_match_jax(models, choices, b):
    jm, tm = models
    f = _feats(jm.config, seed=72 + b, b=b)
    kw = dict(language="en", max_new_tokens=20, return_timestamps=True,
              medusa_choices=choices)
    _same_ts(jm.generate(f, **kw), tm.generate(f, **kw))


@pytest.mark.parametrize("int8,block", [(False, False), (False, True), (True, True)])
def test_compact_tree_cache_matches_jax(int8, block):
    """Random slabs of 2 layers (+1 block slot), B = 3, per-example offsets
    and best paths of the (1,2,2,1) tree: the port's in-place gather is
    bitwise the JAX one (bf16 slabs, or int8 slabs with their bf16 scale
    slab)."""
    rng = np.random.default_rng(7 + 2 * int8 + block)
    n, b, s, d, h = 2 + block, 3, 40, 64, 2
    buffers = generate_medusa_buffers((1, 2, 2, 1))
    offs = np.array([0, 13, s - buffers.num_nodes], np.int32)
    paths = buffers.retrieve_indices[rng.integers(0, buffers.num_paths, b)]
    if int8:
        sk, sv = (rng.integers(-127, 128, (n, b, s, d)).astype(np.int8) for _ in range(2))
        to_j, to_t = jnp.asarray, lambda a: torch.from_numpy(a.copy())
    else:
        sk, sv = (rng.standard_normal((n, b, s, d)).astype(np.float32) for _ in range(2))
        to_j = lambda a: jnp.asarray(a, jnp.bfloat16)
        to_t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    ss = (0.01 + rng.random((n, b, s, 2 * h))).astype(np.float32) if int8 else None
    cross = np.zeros((n, b, h, d // h, 4), np.float32)
    want = jspec._compact_tree_cache(
        jw.KVCache(self_k=to_j(sk), self_v=to_j(sv), cross_k=jnp.asarray(cross),
                   cross_v=jnp.asarray(cross),
                   self_s=None if ss is None else jnp.asarray(ss, jnp.bfloat16)),
        jnp.asarray(offs), jnp.asarray(paths))
    tcache = tw.KVCache(self_k=to_t(sk), self_v=to_t(sv), cross_k=torch.from_numpy(cross),
                        cross_v=torch.from_numpy(cross),
                        self_s=None if ss is None else torch.from_numpy(ss).to(torch.bfloat16))
    got = tspec._compact_tree_cache(tcache, torch.from_numpy(offs), torch.from_numpy(paths))
    assert got is tcache
    for name in ("self_k", "self_v") + (("self_s",) if int8 else ()):
        ref = np.asarray(jnp.asarray(getattr(want, name), jnp.float32))
        np.testing.assert_array_equal(getattr(got, name).float().numpy(), ref, err_msg=name)
    # The paths move rows: the gather is not the identity here.
    assert not np.array_equal(to_t(sk).float().numpy(), got.self_k.float().numpy())


@pytest.mark.parametrize("choices", [(1, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1),
                                     (1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1), (1, 3, 3, 3, 2)])
def test_chunk_bits_of_wide_trees(choices):
    """The ancestor masks of trees of 39, 71 and 121 nodes as W = 2, 3 and 4
    words a row: every bit is the mask's."""
    mask = generate_medusa_buffers(choices).attn_mask
    t = mask.shape[0]
    words = tdo.chunk_bits(torch.from_numpy(mask), t, "cpu").to(torch.int64) & 0xFFFFFFFF
    assert words.shape == (t, -(-t // 32))
    got = np.array([[(int(words[i, j // 32]) >> (j % 32)) & 1 for j in range(t)]
                    for i in range(t)], bool)
    np.testing.assert_array_equal(got, mask)


@pytest.mark.parametrize("choices", [(1, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1),
                                     (1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1)])
def test_wide_mask_mode_plain_matches_jax_attention(choices):
    """The mask mode's plain version, one 16-row launch at a time
    (``self_attention_blocked`` over ``self_attention_block_plain`` with the
    rows' words), against JAX ``attention`` under ``make_step_mask`` with the
    tree's ancestor mask, B = 2, 2 heads, a 160-row slab, float32."""
    mask = generate_medusa_buffers(choices).attn_mask
    t = mask.shape[0]
    rng = np.random.default_rng(t)
    b, h, s = 2, 2, 160
    q = (0.125 * rng.standard_normal((b, t, h, 64))).astype(np.float32)
    k, v = (rng.standard_normal((b, s, h * 64)).astype(np.float32) for _ in range(2))
    offs = np.array([0, s - t], np.int32)
    qt, kt, vt, ot = (torch.from_numpy(a) for a in (q, k, v, offs))
    bits = tdo.chunk_bits(torch.from_numpy(mask), t, "cpu", s)
    got = tdo.self_attention_blocked(
        qt, bits, lambda qb, bb, tc: tdo.self_attention_block_plain(qb, kt, vt, ot, bb, tc))
    jmask = jw.make_step_mask(jnp.asarray(offs), t, s, jnp.asarray(mask))
    split = lambda a: jnp.asarray(a).reshape(b, s, h, 64)
    ref = jw.attention(jnp.asarray(q), split(k), split(v), jmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
