"""Typical acceptance and sampling (temperature > 0), port vs the JAX package.

``_typical_accept`` is held to the JAX one on random logits over the
(1,2,2) and (1,2,2,1) trees and a chain, with matches planted so that
acceptance happens and with duplicated paths so that the accepted prefixes
tie (the tie goes to the first path by summed log-probability in both), at
temperatures 0.7 and 1.3: equal best path and accept length.

``speculative_generate`` at temperature > 0 without a generator verifies by
typical acceptance and takes each node's argmax as its next token, which
both packages do deterministically: on the fixture of test_torch_generate.py
(tiny_test_config(vocab_size=51865, medusa_num_heads=3), float32 on the
CPU) the chain and the (1,2,2,1) tree at B = 1 and 3 give the JAX package's
tokens, lengths, steps and accepted drafts, log-probs within 1e-4.  The
posterior threshold is set where this random model's flat distributions
accept some drafts and reject others (3e-5 with alpha 1e6), besides the
default (0.09, 0.3), which accepts every draft here.

Sampling cannot match the JAX package's threefry draws, so it is held to
its own contract: the same seed gives the same tokens, another seed other
tokens, temperature 0 ignores the seed, a segmented sampled decode gives
the tokens of one call, and the Gumbel-max sampler's frequencies over
20 000 draws from a fixed 8-token ``proc`` lie within 0.02 of
``softmax(proc / T)`` (about six standard deviations of a frequency).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _feats, models  # noqa: F401
from whisper_medusa_tpu.config import GenerationConfig as JGen
from whisper_medusa_tpu.decoding import speculative as jspec
from whisper_medusa_tpu.decoding.buffers import generate_medusa_buffers as jbuffers
from whisper_medusa_tpu.decoding.processors import ProcessorConfig as JProc
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.decoding import speculative as tspec
from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig as TProc


@pytest.mark.parametrize("temperature", [0.7, 1.3])
@pytest.mark.parametrize("choices", [(1, 2, 2), (1, 2, 2, 1), (1, 1, 1, 1)])
def test_typical_accept_matches_jax(temperature, choices):
    buffers = generate_medusa_buffers(choices)
    retrieve = buffers.retrieve_indices
    rng = np.random.default_rng(int(10 * temperature) + len(choices))
    for trial in range(24):
        b, v = 3, 16
        chunk = rng.integers(0, v, size=(b, buffers.num_nodes)).astype(np.int32)
        logits = (2.0 * rng.normal(size=(b, buffers.num_nodes, v))).astype(np.float32)
        for e in range(b):
            if trial % 3:       # plant a path the distributions favour
                nodes = retrieve[rng.integers(0, buffers.num_paths)]
                for i in range(len(nodes) - 1):
                    logits[e, nodes[i], chunk[e, nodes[i + 1]]] += 6.0
            if trial % 4 == 0 and buffers.num_paths > 1:
                # Siblings with the same token: their paths tie.
                lvl1 = retrieve[:, 1]
                chunk[e, lvl1.max()] = chunk[e, lvl1.min()]
        nxt = np.argmax(logits, -1).astype(np.int32)
        jb, ja, _, _ = jspec._typical_accept(
            jnp.asarray(chunk), jnp.asarray(logits), jnp.asarray(nxt), jnp.asarray(retrieve),
            temperature, 0.09, 0.3)
        tb, ta, ptok, pnxt = tspec._typical_accept(
            torch.from_numpy(chunk), torch.from_numpy(logits), torch.from_numpy(nxt),
            torch.from_numpy(retrieve).long(), temperature, 0.09, 0.3)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=f"trial {trial}")
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb), err_msg=f"trial {trial}")
        np.testing.assert_array_equal(ptok.numpy(), chunk[:, retrieve])
        np.testing.assert_array_equal(pnxt.numpy(), nxt[:, retrieve])


def _decode_both(jm, tm, b, choices, temperature, thr, alpha, seed):
    """Both packages' ``speculative_generate`` on the same request (English
    transcription, the default suppress lists, 24 tokens), no generator."""
    st, gd, cfg = tm.special, tm.generation_config, jm.config
    f = _feats(cfg, seed=seed, b=b)
    prompt = np.tile(np.array([[st.sot, st.sot + 1, st.transcribe, st.no_timestamps]],
                              np.int32), (b, 1))
    pkw = dict(vocab_size=cfg.dims.vocab_size, suppress_tokens=gd.suppress_tokens,
               begin_suppress_tokens=gd.begin_suppress_tokens, begin_index=4,
               eos_token_id=st.eos)
    gkw = dict(max_length=24, temperature=temperature, eos_token_id=st.eos,
               pad_token_id=st.eos, posterior_threshold=thr, posterior_alpha=alpha)
    a = jspec.speculative_generate(
        jm.params["whisper"], jm.params["medusa"], cfg.dims, jbuffers(choices),
        JProc(**pkw), JGen(**gkw), jm.encode(f), jnp.asarray(prompt), variant="base_head")
    c = tspec.speculative_generate(
        tm.params["whisper"], tm.params["medusa"], tm.config.dims,
        generate_medusa_buffers(choices), TProc(**pkw), tconfig.GenerationConfig(**gkw),
        tm.encode(f), torch.as_tensor(prompt), variant="base_head")
    return a, c


@pytest.mark.parametrize("choices,b,temperature,thr,alpha", [
    ((1, 1, 1, 1), 1, 0.7, 0.09, 0.3), ((1, 1, 1, 1), 3, 1.3, 3e-5, 1e6),
    ((1, 2, 2, 1), 1, 0.7, 3e-5, 1e6), ((1, 2, 2, 1), 3, 0.7, 3e-5, 1e6),
    ((1, 1, 1, 1), 1, 1.3, 2.5e-5, 1e6)])
def test_typical_decode_matches_jax(models, choices, b, temperature, thr, alpha):
    jm, tm = models
    a, c = _decode_both(jm, tm, b, choices, temperature, thr, alpha, seed=90 + b)
    np.testing.assert_array_equal(c.tokens.numpy(), np.asarray(a.tokens))
    np.testing.assert_array_equal(c.lengths.numpy(), np.asarray(a.lengths))
    np.testing.assert_array_equal(c.accepted.numpy(), np.asarray(a.accepted))
    assert c.steps == int(a.steps)
    np.testing.assert_allclose(c.logprobs.numpy(), np.asarray(a.logprobs), rtol=0, atol=1e-4)
    if thr < 0.09:      # partial acceptance: some drafts in, some out
        n_gen = int(c.lengths.sum()) - 5 * b
        assert 0 < int(c.accepted.sum()) < n_gen


def test_sampled_generate_follows_its_seed(models):
    """The port's form of the JAX test_sampled_retries_differ."""
    _, tm = models
    f = _feats(tm.config, seed=5, b=2)
    kw = dict(language="en", max_length=32)
    a = tm.generate(f, temperature=0.9, seed=0, **kw)
    b = tm.generate(f, temperature=0.9, seed=1, **kw)
    c = tm.generate(f, temperature=0.9, seed=0, **kw)
    np.testing.assert_array_equal(a.sequences, c.sequences)
    np.testing.assert_array_equal(a.accepted, c.accepted)
    assert not np.array_equal(a.sequences, b.sequences)
    g0 = tm.generate(f, seed=0, **kw)
    g1 = tm.generate(f, seed=99, **kw)
    np.testing.assert_array_equal(g0.sequences, g1.sequences)


@pytest.mark.parametrize("choices", [(1, 1, 1, 1), (1, 2, 2, 1)])
def test_sampled_segments_equal_one_call(models, choices):
    """A sampled decode paused and resumed (the state carries the sampler's
    generator) commits the tokens of one call with an equal generator."""
    _, tm = models
    st, cfg = tm.special, tm.config
    f = _feats(cfg, seed=7, b=2)
    prompt = torch.tensor([[st.sot, st.sot + 1, st.transcribe, st.no_timestamps]] * 2,
                          dtype=torch.int32)
    pcfg = TProc(vocab_size=cfg.dims.vocab_size, begin_index=4, eos_token_id=st.eos)
    gen = tconfig.GenerationConfig(max_length=30, temperature=0.8, eos_token_id=st.eos,
                                   pad_token_id=st.eos)
    enc = tm.encode(f)

    def run(**kw):
        rng = torch.Generator()
        rng.manual_seed(3)
        return tspec.speculative_generate(tm.params["whisper"], tm.params["medusa"], cfg.dims,
                                          generate_medusa_buffers(choices), pcfg, gen, enc,
                                          prompt, rng=rng, **kw)

    whole = run()
    part, state = run(stop_len=12, return_state=True)
    while not bool(state.finished.all()):
        part, state = tspec.speculative_generate(
            tm.params["whisper"], tm.params["medusa"], cfg.dims,
            generate_medusa_buffers(choices), pcfg, gen, enc, prompt, resume_state=state,
            stop_len=int(part.lengths.max()) + 6, return_state=True)
    np.testing.assert_array_equal(part.tokens.numpy(), whole.tokens.numpy())
    np.testing.assert_array_equal(part.accepted.numpy(), whole.accepted.numpy())


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_gumbel_sampler_frequencies(temperature):
    proc = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, -float("inf")])
    n = 20000
    rng = torch.Generator()
    rng.manual_seed(11)
    draws = tspec._sample(proc.expand(n, 8).contiguous(), temperature, rng)
    assert draws.dtype == torch.int32 and draws.shape == (n,)
    freq = torch.bincount(draws.long(), minlength=8).double() / n
    want = torch.softmax(proc.double() / temperature, dim=0)
    assert float(freq[7]) == 0.0
    assert float((freq - want).abs().max()) < 0.02
