"""The port alone, past K2's batch: each example's tokens decoded at B = 16
(the per-op step) equal its tokens decoded at B = 1 from the same encoder
row.  The fixture of test_torch_generate.py (tiny_test_config(vocab_size=
51865, medusa_num_heads=3), float32 on the CPU), whose width K2 does not
take, so both batch sizes run the per-op step's plain versions: the check is
that no op of the step mixes rows."""

import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _feats, models  # noqa: F401
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.decoding import speculative as tspec
from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig


@pytest.fixture
def one_thread():
    """One intra-op thread for the test's many small CPU ops (17 decodes),
    which otherwise contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_b16_decode_gives_each_example_its_b1_tokens(models, one_thread):
    _, tm = models
    b = 16
    enc = tm.encode(_feats(tm.config, seed=23, b=b))
    st, cfg, gd = tm.special, tm.config, tm.generation_config
    prompt = torch.tensor([[st.sot, st.first_language, st.transcribe,
                            st.no_timestamps]] * b, dtype=torch.int32)
    pcfg = ProcessorConfig(vocab_size=cfg.dims.vocab_size,
                           suppress_tokens=gd.suppress_tokens,
                           begin_suppress_tokens=gd.begin_suppress_tokens,
                           begin_index=4, eos_token_id=st.eos)
    gen = tconfig.GenerationConfig(max_length=16, eos_token_id=st.eos, pad_token_id=st.eos)
    buffers = generate_medusa_buffers(cfg.medusa.medusa_choices)
    run = lambda e, p: tspec.speculative_generate(
        tm.params["whisper"], tm.params["medusa"], cfg.dims, buffers, pcfg, gen, e, p)
    batched = run(enc, prompt)
    assert int(batched.accepted.sum()) > 0
    for e in range(b):
        alone = run(enc[e:e + 1], prompt[e:e + 1])
        torch.testing.assert_close(batched.tokens[e:e + 1], alone.tokens, rtol=0, atol=0)
        assert int(batched.lengths[e]) == int(alone.lengths[0])
