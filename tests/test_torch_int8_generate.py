"""int8 serving as a whole: the port's ``model.quantize().generate`` vs the
JAX package's ``quantize().generate`` on the same weights.

The fixture of test_torch_generate.py (tiny_test_config(vocab_size=51865,
medusa_num_heads=3), float32 on the CPU, nonzero heads), each side quantized
by its own ``quantize()`` (the two trees are bit-equal, test_torch_qmm.py).
Medusa and vanilla at B=1 and B=3: tokens, lengths, accepted drafts, steps
and mean_accept_length are equal.  Token log-probs agree within 5e-3: the
JAX package runs its int8 decode under one ``jit``, where XLA keeps f32
values that its code rounds to bf16 (the dequantized self-KV rows and the
attention probabilities; allowed excess precision), which moves its hidden
state by up to ~7e-3 from the same step run op by op; the port follows the
code.  The port's int8 decode at B=3 gives each example its B=1 tokens.
"""

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _feats, models  # noqa: F401
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.decoding import speculative as tspec
from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig


@pytest.fixture(scope="module")
def qmodels(models):
    jm, tm = models
    return jm.quantize(), tm.quantize()


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("disable_medusa", [False, True], ids=["medusa", "vanilla"])
def test_int8_generate_matches_jax(qmodels, disable_medusa, b):
    jq, tq = qmodels
    assert tq.params["whisper"]["decoder"]["embed_tokens"]["q"].dtype == torch.int8
    f = _feats(jq.config, seed=8 + b, b=b)
    kw = dict(language="en", max_length=24, disable_medusa=disable_medusa)
    a, c = jq.generate(f, **kw), tq.generate(f, **kw)
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(c.lengths, np.asarray(a.lengths))
    np.testing.assert_array_equal(c.accepted, np.asarray(a.accepted))
    assert c.steps == a.steps
    assert c.mean_accept_length == pytest.approx(a.mean_accept_length, abs=1e-12)
    if not disable_medusa:
        assert int(c.accepted.sum()) > 0
    np.testing.assert_allclose(c.token_logprobs, a.token_logprobs, rtol=0, atol=5e-3)
    np.testing.assert_allclose(c.no_speech_probs, a.no_speech_probs, rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("variant", ["base_head", "vanilla"])
def test_int8_decode_is_batch_invariant(qmodels, variant):
    """Each example's int8 tokens at B = 3 equal its tokens decoded alone
    from the same encoder output row."""
    _, tq = qmodels
    f = _feats(tq.config, seed=7, b=3)
    enc = tq.encode(f)
    st, cfg, gd = tq.special, tq.config, tq.generation_config
    prompt = torch.tensor([[st.sot, st.first_language, st.transcribe,
                            st.no_timestamps]] * 3, dtype=torch.int32)
    pcfg = ProcessorConfig(vocab_size=cfg.dims.vocab_size,
                           suppress_tokens=gd.suppress_tokens,
                           begin_suppress_tokens=gd.begin_suppress_tokens,
                           begin_index=4, eos_token_id=st.eos)
    gen = tconfig.GenerationConfig(max_length=28, eos_token_id=st.eos, pad_token_id=st.eos)
    vanilla = variant == "vanilla"
    buffers = generate_medusa_buffers((1,) if vanilla else cfg.medusa.medusa_choices)
    med = None if vanilla else tq.params["medusa"]
    run = lambda e, p: tspec.speculative_generate(
        tq.params["whisper"], med, cfg.dims, buffers, pcfg, gen, e, p, variant=variant)
    batched = run(enc, prompt)
    for e in range(3):
        alone = run(enc[e:e + 1], prompt[e:e + 1])
        torch.testing.assert_close(batched.tokens[e:e + 1], alone.tokens, rtol=0, atol=0)
        assert int(batched.lengths[e]) == int(alone.lengths[0])
