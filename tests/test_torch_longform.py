"""Longform (> 30 s) generation and ``generate_stream`` of the port vs the
JAX package's.

tiny_test_config(vocab_size=51865, medusa_num_heads=3,
max_source_positions=1500): the tiny width with Whisper's 3000-frame (30 s)
window, float32 on the CPU, nonzero head weights.  75 s of seeded noise
(7500 frames, from the port's ``ops/mel.py::log_mel_spectrogram``, both
sides fed the same features) through the seek loop: B = 1 without
timestamps (stripped) and with; B = 1 sequential with
``condition_on_prev_tokens`` and a 20-token first-segment prompt (its
window prompt passes 16 tokens: the pieced prefill); B = 2 batched with an
``attention_mask`` that ends example 1 at 40 s; "all-segments" prompts.
Sequences, lengths, steps and accepted drafts are equal, segment times
within 1e-9, token log-probs within 1e-4.  ``generate_stream`` yields what
the JAX package's does, and its last yield is ``generate``'s tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _feats, models  # noqa: F401
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel as TModel
from whisper_medusa_tpu_torch.ops.mel import log_mel_spectrogram


@pytest.fixture(scope="module")
def long_models():
    cfg = tiny_test_config(vocab_size=51865, medusa_num_heads=3, max_source_positions=1500)
    jm = JModel.from_random(cfg, seed=0)
    rng = np.random.default_rng(0)
    w = jm.params["medusa"]["heads"]["w"]
    jm.params["medusa"]["heads"]["w"] = jnp.asarray(0.3 * rng.standard_normal(w.shape),
                                                    jnp.float32)
    tm = TModel(tconfig.ModelConfig.from_dict(cfg.to_dict()),
                bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu"),
                device="cpu")
    wav = (0.1 * np.random.default_rng(11).normal(size=(2, 16000 * 75))).astype(np.float32)
    feats = log_mel_spectrogram(torch.from_numpy(wav), n_mels=cfg.dims.num_mel_bins).numpy()
    assert feats.shape[-1] == 7500
    return jm, tm, feats


def _same(a, c):
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(c.lengths, np.asarray(a.lengths))
    np.testing.assert_array_equal(c.accepted, np.asarray(a.accepted))
    assert c.steps == a.steps
    assert c.mean_accept_length == pytest.approx(a.mean_accept_length, abs=1e-12)
    np.testing.assert_allclose(c.token_logprobs, a.token_logprobs, rtol=0, atol=1e-4)
    if a.segments is None:
        assert c.segments is None
        return
    assert len(c.segments) == len(a.segments)
    for sa, sc in zip(a.segments, c.segments):
        assert len(sa) == len(sc)
        for x, y in zip(sa, sc):
            assert x["tokens"] == y["tokens"]
            assert abs(x["start"] - y["start"]) <= 1e-9
            assert (x["end"] is None) == (y["end"] is None)
            if x["end"] is not None:
                assert abs(x["end"] - y["end"]) <= 1e-9


@pytest.mark.parametrize("timestamps", [False, True], ids=["stripped", "timestamps"])
def test_longform_matches_jax(long_models, timestamps):
    jm, tm, feats = long_models
    kw = dict(language="en", max_new_tokens=20, return_timestamps=timestamps)
    a, c = jm.generate(feats[:1], **kw), tm.generate(feats[:1], **kw)
    _same(a, c)
    assert c.steps > 20      # several windows
    if not timestamps:
        assert (c.sequences[0, :c.lengths[0]] < 50364).all()
    else:
        assert c.segments[0] and c.segments[0][-1]["start"] >= 30.0


def test_longform_condition_on_prev_matches_jax(long_models, monkeypatch):
    jm, tm, feats = long_models
    pids = [tm.special.start_of_prev] + list(range(400, 419))
    import whisper_medusa_tpu_torch.models.api as tapi

    real, prompts = tapi.speculative_generate, []

    def spy(*args, **kw):
        prompts.append(int(args[7].shape[1]))
        return real(*args, **kw)

    monkeypatch.setattr(tapi, "speculative_generate", spy)
    kw = dict(language="en", max_new_tokens=20, condition_on_prev_tokens=True,
              prompt_ids=pids, return_timestamps=True)
    _same(jm.generate(feats[:1], **kw), tm.generate(feats[:1], **kw))
    assert len(prompts) >= 3 and prompts[0] == 23      # two prefill pieces


def test_longform_batched_attention_mask_matches_jax(long_models):
    jm, tm, feats = long_models
    mask = np.ones((2, feats.shape[-1]), np.int32)
    mask[1, 4000:] = 0
    kw = dict(language="en", max_new_tokens=20, attention_mask=mask, return_timestamps=True)
    a, c = jm.generate(feats, **kw), tm.generate(feats, **kw)
    _same(a, c)


@pytest.mark.parametrize("kind", ["first-segment", "all-segments"])
def test_longform_prompt_condition_types_match_jax(long_models, kind):
    jm, tm, feats = long_models
    st = tm.special
    kw = dict(language="en", max_new_tokens=16, prompt_ids=[st.start_of_prev, 11, 12, 13],
              prompt_condition_type=kind, condition_on_prev_tokens=kind == "all-segments")
    _same(jm.generate(feats[:1], **kw), tm.generate(feats[:1], **kw))


def test_generate_stream_matches_jax(models):
    jm, tm = models
    f = _feats(jm.config, seed=23, b=2)
    kw = dict(language="en", max_length=28, chunk_tokens=6)
    ja = list(jm.generate_stream(f, **kw))
    tc = list(tm.generate_stream(f, **kw))
    assert len(tc) == len(ja) >= 2
    for (at, al, af), (ct, cl, cf) in zip(ja, tc):
        np.testing.assert_array_equal(ct, np.asarray(at))
        np.testing.assert_array_equal(cl, np.asarray(al))
        assert cf == af
    ref = tm.generate(f, language="en", max_length=28)
    toks, lengths, finished = tc[-1]
    assert finished
    np.testing.assert_array_equal(toks, ref.sequences)
    np.testing.assert_array_equal(lengths, ref.lengths)
