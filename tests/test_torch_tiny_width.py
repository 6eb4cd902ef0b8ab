"""Whisper tiny at its full width (d_model 384, 4 + 4 layers, 6 heads, the
real vocabulary) against the JAX package on the CPU: f32 random weights
made by the JAX package and carried across by the bridge; ``generate`` with
10 base_head heads at B=1 and B=3, ``max_new_tokens=12`` (one verification
step: the loop stops where the ten heads would draft past the limit), and
at B=1 with ``max_new_tokens=40`` (several steps), gives the JAX package's
tokens, lengths, accepted drafts and steps.  d_model 384 is not a
multiple of 256, so on the card every decode call takes the per-op step,
whose kernels (K11, head_rows, K4) are held against these plain versions by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from whisper_medusa_tpu.config import WHISPER_PRESETS, MedusaConfig, ModelConfig
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel as TModel


@pytest.fixture(scope="module")
def models():
    cfg = ModelConfig(dims=WHISPER_PRESETS["tiny"],
                      medusa=MedusaConfig(medusa_hidden_size=384))
    assert cfg.dims.d_model == 384 and cfg.medusa.medusa_num_heads == 10
    jm = JModel.from_random(cfg, seed=0)
    w = jm.params["medusa"]["heads"]["w"]
    jm.params["medusa"]["heads"]["w"] = jnp.asarray(
        0.02 * np.random.default_rng(0).standard_normal(w.shape), jnp.float32)
    tm = TModel(tconfig.ModelConfig.from_dict(cfg.to_dict()),
                bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu"),
                device="cpu")
    return jm, tm


@pytest.mark.parametrize("b,new_tokens", [(1, 12), (3, 12), (1, 40)])
def test_tiny_generate_matches_jax(models, b, new_tokens):
    jm, tm = models
    f = np.random.default_rng(b).standard_normal(
        (b, jm.config.dims.num_mel_bins, jm.config.dims.num_frames)).astype(np.float32)
    kw = dict(language="en", max_new_tokens=new_tokens)
    a, t = jm.generate(f, **kw), tm.generate(f, **kw)
    assert a.steps >= (2 if new_tokens > 12 else 1) and int(np.asarray(a.accepted).sum()) > 0
    np.testing.assert_array_equal(t.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(t.lengths, np.asarray(a.lengths))
    np.testing.assert_array_equal(t.accepted, np.asarray(a.accepted))
    assert t.steps == a.steps
