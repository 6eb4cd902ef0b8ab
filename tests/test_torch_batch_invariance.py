"""Batch invariance of the port on the CPU: an example's tokens do not
depend on the batch it is decoded in, and do not change when every draft is
corrupted.  The fixture of test_torch_generate.py: tiny_test_config(
vocab_size=51865, medusa_num_heads=3), float32."""

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _feats, models  # noqa: F401
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.decoding import speculative as tspec
from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig


def test_batched_tokens_invariant_under_draft_corruption(models):
    _, tm = models
    f = _feats(tm.config, seed=4, b=3)
    outs = [tm.generate(f, language="en", max_length=24, draft_corruption=c)
            for c in (None, 1.0)]
    for e in range(3):
        n = int(min(outs[0].lengths[e], outs[1].lengths[e]))
        np.testing.assert_array_equal(outs[1].sequences[e, :n], outs[0].sequences[e, :n])
    assert outs[1].steps >= outs[0].steps
    assert outs[0].accepted.sum() > 0 and outs[1].accepted.sum() == 0


@pytest.mark.parametrize("variant", ["base_head", "vanilla"])
def test_decode_is_batch_invariant(models, variant):
    """Each example's tokens at B = 3 equal its tokens decoded alone from the
    same encoder output row."""
    _, tm = models
    f = _feats(tm.config, seed=7, b=3)
    enc = tm.encode(f)
    st = tm.special
    cfg = tm.config
    prompt = torch.tensor([[st.sot, st.first_language, st.transcribe,
                            st.no_timestamps]] * 3, dtype=torch.int32)
    gd = tm.generation_config
    pcfg = ProcessorConfig(vocab_size=cfg.dims.vocab_size,
                           suppress_tokens=gd.suppress_tokens,
                           begin_suppress_tokens=gd.begin_suppress_tokens,
                           begin_index=4, eos_token_id=st.eos)
    gen = tconfig.GenerationConfig(max_length=28, eos_token_id=st.eos,
                                   pad_token_id=st.eos)
    vanilla = variant == "vanilla"
    buffers = generate_medusa_buffers((1,) if vanilla else cfg.medusa.medusa_choices)
    med = None if vanilla else tm.params["medusa"]
    run = lambda e, p: tspec.speculative_generate(
        tm.params["whisper"], med, cfg.dims, buffers, pcfg, gen, e, p, variant=variant)
    batched = run(enc, prompt)
    for e in range(3):
        alone = run(enc[e:e + 1], prompt[e:e + 1])
        torch.testing.assert_close(batched.tokens[e:e + 1], alone.tokens, rtol=0, atol=0)
        assert int(batched.lengths[e]) == int(alone.lengths[0])
