"""K4 at the JAX row scope: the plain version of ``verify_hidden`` against the
JAX ``_kernel_hidden`` in interpret mode at R > 128 rows.

The 11-draft-head chain (12 stacked heads x 12 nodes, R = 144), the 16-head
chain with identity0 rows (17 x 17 = 289) and one head over 200 source rows
(past one 192-row stage-A block of the card's kernel), at V = 8192 + 665,
d = 128, with the timestamp rules on (``ts_begin`` straddling a vocab tile,
``n_verif`` the verification rows), bf16 and int8 heads and embeddings.
Argmax exact; max, lse and the gathered value within 3e-2, the tolerance of
tests/test_torch_verify.py for rows built in bf16.  ``hidden_available``
takes each of these shapes, as JAX's gate does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_timestamps import (BEGIN, EOS, NO_TS, TS_BEGIN, V, _check, _heads,
                                         _history, _pcfg, _q, _rows)
from whisper_medusa_tpu.decoding import processors as jproc
from whisper_medusa_tpu.ops import verify as jverify
from whisper_medusa_tpu_torch.decoding import processors as tproc
from whisper_medusa_tpu_torch.ops import verify as tverify


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jverify, "_INTERPRET", True)
    monkeypatch.setattr(jverify, "_ENABLED", True)


@pytest.mark.parametrize("nh,n,identity0,quant,ts", [
    (12, 12, False, False, True),      # R = 144: the 11-draft-head chain
    (16, 17, True, True, True),        # R = 289: 16 heads + the identity rows, int8
    (1, 200, False, False, False),     # R = 200 source rows: two stage-A blocks on the card
], ids=["R144-bf16-ts", "R289-id0-int8-ts", "R200-bf16"])
def test_verify_hidden_wide_matches_jax_kernel(nh, n, identity0, quant, ts):
    d = 128
    rng = np.random.default_rng(nh * 1000 + n)
    hid = _rows(n, 3, 0.5, 2.5)[None]
    src = _rows(n, 4, 0.5, 2.5)[None] if identity0 else hid
    emb = (rng.standard_normal((V, d)) * 0.2).astype(np.float32)
    jhw, thw, jhb, thb = _heads(rng, nh, d, quant)
    kp1 = nh + int(identity0)
    r = kp1 * n
    assert r > 128
    assert tverify.hidden_available(1, n, nh, identity0, V, d)
    assert jverify.hidden_available(1, n, nh, identity0, V, d)
    pos = (BEGIN + np.arange(n)[None, :] + np.arange(kp1)[:, None]).reshape(-1).astype(np.int32)
    gcol = rng.integers(0, V, (r,)).astype(np.int32)
    gcol[:4] = (EOS, TS_BEGIN + 9, 17, NO_TS)
    kw = dict(identity0=identity0, begin_index=BEGIN, eos_id=EOS, decay=(6, 1.2))
    jcfg, tcfg = _pcfg(jproc), _pcfg(tproc)
    jts, tts = {}, {}
    if ts:
        _, last, penult, maxts = _history(r)
        jts = dict(ts_cfg=jverify.ts_cfg_for(jcfg), last=jnp.asarray(last),
                   penult=jnp.asarray(penult), maxts=jnp.asarray(maxts), n_verif=n)
        tts = dict(ts_cfg=tverify.ts_cfg_for(tcfg), last=torch.from_numpy(last),
                   penult=torch.from_numpy(penult), maxts=torch.from_numpy(maxts), n_verif=n)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).bfloat16()
    if quant:
        jemb, temb = _q(emb, 1)
    else:
        jemb, temb = bf(emb), tb(emb)
    ref = jverify.verify_hidden(bf(hid), bf(src), jhw, jhb, jemb, jnp.asarray(pos),
                                jnp.asarray(gcol), jverify.masks_for(jcfg), **jts, **kw)
    got = tverify.verify_hidden(tb(hid), tb(src), thw, thb, temb, torch.from_numpy(pos),
                                torch.from_numpy(gcol), tverify.masks_for(tcfg), **tts, **kw)
    assert got[0].shape == (r,)
    _check(got, ref, 3e-2)
