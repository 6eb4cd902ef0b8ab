"""The port's mesh module against the JAX package's, in one process.

``parallel/mesh.py``'s spec trees equal JAX's leaf by leaf (whisper and
Medusa trees, base_head and medusa_block with its teacher layer, bf16 and
int8 leaves, vocabularies that tp divides and one it does not); each
rank's ``shard_params`` cut is the slice JAX's ``NamedSharding`` gives that
rank's device; ``shard``'s refusals match JAX's; a one-rank mesh serves
the unsharded tokens; the data ranks' outputs merge into the whole
batch's (shortform and longform).  The multi-process worlds are in the other
``test_torch_parallel_*.py`` files.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu.parallel import mesh as jmesh
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel as TModel
from whisper_medusa_tpu_torch.parallel import mesh as tmesh


def _models(vocab, heads_type="base_head", teacher=False):
    cfg = tiny_test_config(vocab_size=vocab, medusa_num_heads=2, medusa_heads_type=heads_type)
    if teacher:
        cfg = cfg.replace(medusa=dataclasses.replace(
            cfg.medusa, output_whisper_original=True, medusa_kl_loss=True))
    jm = JModel.from_random(cfg, seed=0)
    tm = TModel(tconfig.ModelConfig.from_dict(cfg.to_dict()),
                bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu"),
                device="cpu")
    return jm, tm


def _assert_same_tree(j, t, path=""):
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), path
        for k in j:
            _assert_same_tree(j[k], t[k], f"{path}/{k}")
    else:
        assert isinstance(t, tmesh.P), path
        assert tuple(j) == tuple(t), (path, j, t)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


@pytest.mark.parametrize("vocab,tp", [(51865, 1), (51865, 2), (51865, 4), (256, 2),
                                      (256, 4)])
@pytest.mark.parametrize("kind", ["base_head", "medusa_block", "teacher", "int8"])
def test_spec_trees_equal_jax_leaf_by_leaf(kind, vocab, tp):
    jm, tm = _models(vocab, "medusa_block" if kind in ("medusa_block", "teacher")
                     else "base_head", teacher=kind == "teacher")
    if kind == "int8":
        jm, tm = jm.quantize(), tm.quantize()
    jspec = jmesh._quantized_specs(jm.params, jmesh.model_param_specs(jm.params, tp))
    _assert_same_tree(jspec, tmesh.param_specs(tm.params, tp))
    whisper_only = jmesh._quantized_specs(jm.params["whisper"], jmesh.whisper_param_specs(
        jm.params["whisper"], tp))
    _assert_same_tree(whisper_only, tmesh.param_specs(tm.params["whisper"], tp))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("vocab", [51865, 256])
def test_shard_params_cut_is_the_jax_shard_of_each_rank(vocab, int8):
    """On a (2, 2) JAX mesh the device at (d, m) holds, of each leaf, the
    slice ``devices_indices_map`` names; the port's rank at (d, m) cuts
    exactly that slice (bf16 / f32 and int8 scales alike)."""
    jm, tm = _models(vocab, "medusa_block")
    if int8:
        jm, tm = jm.quantize(), tm.quantize()
    mesh = jmesh.make_mesh(4, dp=2, tp=2)
    specs = dict(_leaves(jmesh._quantized_specs(jm.params, jmesh.model_param_specs(
        jm.params, 2))))
    full = dict(_leaves(tm.params))
    for d in range(2):
        for m in range(2):
            rank_mesh = tmesh.Mesh(np.arange(4).reshape(2, 2), d, m)
            cut = dict(_leaves(tmesh.shard_params(tm.params, rank_mesh)))
            for k, spec in specs.items():
                a = full[k].numpy()
                idx = NamedSharding(mesh, spec).devices_indices_map(a.shape)[
                    mesh.devices[d, m]]
                np.testing.assert_array_equal(cut[k].numpy(), a[idx], err_msg=k)
                assert cut[k].is_contiguous()


@pytest.mark.parametrize("field,tp", [("d_model", 2), ("decoder_ffn_dim", 2)])
def test_indivisible_tp_raises_jax_error(field, tp):
    cfg = tiny_test_config(vocab_size=256, medusa_num_heads=2)
    dims = dataclasses.replace(cfg.dims, **{field: getattr(cfg.dims, field) + 1})
    cfg = cfg.replace(dims=dims, medusa=dataclasses.replace(
        cfg.medusa, medusa_hidden_size=dims.d_model))
    jm = JModel(cfg, {})
    tm = TModel(tconfig.ModelConfig.from_dict(cfg.to_dict()), {}, device="cpu")
    with pytest.raises(ValueError) as je:
        jm.shard(jmesh.make_mesh(tp, dp=1, tp=tp))
    with pytest.raises(ValueError) as te:
        tm.shard(tmesh.Mesh(np.arange(tp).reshape(1, tp), 0, 0))
    assert str(te.value) == str(je.value)


def test_tp_that_splits_a_head_is_refused():
    """JAX's check passes d_model 32 at tp=4, where GSPMD lets a head of
    whisper's 2 straddle shards; the port's per-op attention does not split
    a head, so it raises NotImplementedError naming its ROADMAP item."""
    jm, tm = _models(256)
    jm.shard(jmesh.make_mesh(4, dp=1, tp=4))
    with pytest.raises(NotImplementedError, match="queue 1, item 24"):
        tm.shard(tmesh.Mesh(np.arange(4).reshape(1, 4), 0, 0))


def test_one_rank_mesh_serves_the_unsharded_tokens():
    jm, tm = _models(51865)
    feats = np.random.default_rng(3).standard_normal(
        (2, 16, tm.config.dims.num_frames)).astype(np.float32)
    a = tm.generate(feats, language="en", max_length=16)
    tm.shard(tmesh.make_mesh())
    assert tm.mesh.dp == tm.mesh.tp == 1
    b = tm.generate(feats, language="en", max_length=16)
    np.testing.assert_array_equal(a.sequences, b.sequences)
    np.testing.assert_array_equal(a.accepted, b.accepted)
    torch.testing.assert_close(tm.encode(feats), _models(51865)[1].encode(feats),
                               rtol=0, atol=0)


def _out(rng, b, width, steps, longform=False):
    from whisper_medusa_tpu_torch.models.api import GenerateOutput

    acc = rng.integers(0, 5, (1,) if longform else (b,))
    per = None if longform else rng.integers(1, steps + 1, (b,))
    return GenerateOutput(
        sequences=rng.integers(0, 100, (b, width)).astype(np.int32),
        lengths=rng.integers(4, width, (b,)), steps=steps, accepted=acc,
        mean_accept_length=(float(acc[0]) / steps if longform
                            else float(np.sum(acc / np.maximum(per, 1)))),
        detected_language=[f"l{i}" for i in range(b)], steps_per_example=per,
        token_logprobs=rng.standard_normal((b, width)).astype(np.float32),
        segments=[[{"i": i}] for i in range(b)],
        cross_attentions=None if longform else rng.standard_normal((2, b, 3, width, 5)))


@pytest.mark.parametrize("longform", [False, True])
def test_merge_outputs_gives_the_whole_batch(longform):
    """``_merge_outputs`` (the data ranks' GenerateOutputs in rank order):
    per-example rows concatenated (capture maps on axis 1), a narrower
    rank's rows padded (sequences with the pad id, log-probs with 0),
    ``steps`` the largest, ``mean_accept_length`` the per-example sum, or
    for longform the summed accepts over the steps."""
    from whisper_medusa_tpu_torch.models.api import _merge_outputs

    rng = np.random.default_rng(0)
    a = _out(rng, 2, 6, 5, longform)
    b = _out(rng, 3, 6 if not longform else 9, 7, longform)
    m = _merge_outputs([a, b], pad_id=99, longform=longform)
    w = 9 if longform else 6
    assert m.sequences.shape == (5, w) and m.steps == 7
    np.testing.assert_array_equal(m.sequences[:2, :6], a.sequences)
    np.testing.assert_array_equal(m.sequences[2:], b.sequences)
    assert (m.sequences[:2, 6:] == 99).all() and (m.token_logprobs[:2, 6:] == 0).all()
    np.testing.assert_array_equal(m.lengths, np.concatenate([a.lengths, b.lengths]))
    assert m.detected_language == a.detected_language + b.detected_language
    assert m.segments == a.segments + b.segments
    if longform:
        assert m.accepted.tolist() == [int(a.accepted[0] + b.accepted[0])]
        assert m.mean_accept_length == pytest.approx(m.accepted[0] / 7)
        assert m.cross_attentions is None and m.steps_per_example is None
    else:
        np.testing.assert_array_equal(m.accepted, np.concatenate([a.accepted, b.accepted]))
        np.testing.assert_array_equal(m.steps_per_example,
                                      np.concatenate([a.steps_per_example,
                                                      b.steps_per_example]))
        assert m.mean_accept_length == pytest.approx(a.mean_accept_length
                                                     + b.mean_accept_length)
        np.testing.assert_array_equal(m.cross_attentions, np.concatenate(
            [a.cross_attentions, b.cross_attentions], axis=1))
