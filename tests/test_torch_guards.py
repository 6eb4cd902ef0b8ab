"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
runs on the card unless asked for the CPU and refuses to run on the CPU when
CUDA was asked for, and has no stub when the kernels cannot be built."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
import whisper_medusa_tpu_torch
from whisper_medusa_tpu_torch.config import tiny_test_config
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel
from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.processor import WhisperMedusaProcessor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = whisper_medusa_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))


def _chip_smoke_imports():
    """Every module chip_smoke.py imports, at top level or inside a function."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return sorted(mods)


def test_port_imports_no_jax():
    mods = _port_modules()
    assert {"whisper_medusa_tpu_torch.models.api", "whisper_medusa_tpu_torch.ops.qmm",
            "whisper_medusa_tpu_torch.training.train", "whisper_medusa_tpu_torch.training.optim",
            "whisper_medusa_tpu_torch.training.trainer", "whisper_medusa_tpu_torch.cli.train",
            "whisper_medusa_tpu_torch.data.dataset"} <= set(mods)
    assert len(mods) >= 30
    smoke = _chip_smoke_imports()
    assert "whisper_medusa_tpu_torch.models.api" in smoke
    code = ("import importlib, sys\n"
            f"for m in {mods + smoke!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "top = ('jax', 'optax', 'orbax', 'pandas', 'whisper_medusa_tpu')\n"
            "bad = sorted(m for m in sys.modules if m in top\n"
            "             or m.startswith(tuple(t + '.' for t in top)))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_parallel_worker_helper_imports_no_jax():
    """The gloo ranks of tests/test_torch_parallel_*.py run this module as
    fresh interpreters: it, parallel/ and data/native.py load without JAX."""
    mods = ["tests.torch_parallel_worker", "whisper_medusa_tpu_torch.parallel.mesh",
            "whisper_medusa_tpu_torch.parallel.distributed",
            "whisper_medusa_tpu_torch.data.native", "whisper_medusa_tpu_torch.cli.evaluate"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'optax', 'whisper_medusa_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_shard_in_a_world_of_one_raises():
    """shard(dp=2) without a second process raises; it never serves
    unsharded in its place."""
    from whisper_medusa_tpu_torch.parallel import distributed

    assert distributed.process_count() == 1
    model = WhisperMedusaModel.from_random(tiny_test_config(), device="cpu")
    for kw in (dict(dp=2), dict(tp=2), dict(dp=2, tp=2)):
        with pytest.raises(ValueError, match="the world has 1"):
            model.shard(**kw)
    assert model.mesh is None


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"],
                                   ["--coordinator-address", "127.0.0.1:1"]])
def test_refuse_unported_takes_mesh_flags_and_refuses_wandb(flags):
    """The mesh and multi-process flags are ported (parallel/); only
    --wandb-logging is refused."""
    import argparse

    from whisper_medusa_tpu_torch.cli import args as cargs

    p = argparse.ArgumentParser()
    cargs.add_model_args(p)
    cargs.add_training_args(p)
    base = ["--train-data-path", "a", "--validation-data-path", "b", "--output-path", "c"]
    cargs.refuse_unported(p.parse_args(base + flags))
    with pytest.raises(NotImplementedError, match="--wandb-logging is not ported"):
        cargs.refuse_unported(p.parse_args(base + flags + ["--wandb-logging", "true"]))


def test_initialize_never_guesses_a_backend(monkeypatch):
    """A multi-process start names its backend; none is picked for it."""
    from whisper_medusa_tpu_torch.parallel import distributed

    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert not distributed.is_initialized()
    with pytest.raises(ValueError, match="pass 'nccl' when each rank has a card"):
        distributed.initialize("127.0.0.1:1", 2, 0)
    with pytest.raises(ValueError, match="pass 'nccl'"):
        distributed.initialize("127.0.0.1:1", 2, 0, backend="mpi")
    assert not distributed.is_initialized()


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the request is legitimate here")
    with pytest.raises(RuntimeError, match="does not fall back"):
        WhisperMedusaModel.from_random(tiny_test_config(), device="cuda")
    with pytest.raises(RuntimeError, match="does not fall back"):
        bridge.params_from_numpy({"w": [1.0]}, device="cuda")


def test_entry_points_default_to_the_card():
    """With no device argument every entry point asks for CUDA, so on a host
    without a GPU it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is legitimate here")
    for make in (lambda: WhisperMedusaModel.from_random(tiny_test_config()),
                 lambda: WhisperMedusaModel(tiny_test_config(), {}),
                 lambda: bridge.from_random(tiny_test_config()),
                 lambda: bridge.params_from_numpy({"w": [1.0]}),
                 lambda: WhisperMedusaProcessor(),
                 lambda: WhisperMedusaProcessor(use_kernel=True),
                 lambda: WhisperMedusaProcessor.from_pretrained("/nonexistent")):
        with pytest.raises(RuntimeError, match="does not fall back"):
            make()


def test_quantize_stays_on_the_model_device():
    """quantize() quantizes on the model's device and keeps the copy there:
    a CPU model gives a CPU int8 model, and a model made without a device
    asks for the card, so on a host without a GPU it raises."""
    model = WhisperMedusaModel.from_random(tiny_test_config(), device="cpu")
    q = model.quantize()
    assert q.device == torch.device("cpu") and q.config is model.config
    dec = q.params["whisper"]["decoder"]
    assert dec["embed_tokens"]["q"].dtype == torch.int8
    assert dec["layers"]["fc1_w"]["s"].dtype == torch.float32
    assert q.params["medusa"]["heads"]["w"]["q"].device.type == "cpu"
    assert q.params["whisper"]["encoder"] is not dec and \
        q.params["whisper"]["encoder"] is model.params["whisper"]["encoder"]
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is legitimate here")
    with pytest.raises(RuntimeError, match="does not fall back"):
        WhisperMedusaModel.from_random(tiny_test_config()).quantize()


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_ext

    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(cuda_lib, "_LIB", None)
    assert cuda_lib.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.lib()
    assert cuda_lib._LIB is None


def test_kernel_sources_are_packaged():
    names = sorted(os.listdir(cuda_lib.CSRC_DIR))
    assert {"attention.cu", "megastep.cu", "logits.cu", "verify.cu", "qmm.cu",
            "mel.cu", "common.cuh"} <= set(names)
    assert {"wm_qmm", "wm_qmm_nt", "wm_log_mel"} <= set(cuda_lib._SIGNATURES)
    for entry in cuda_lib._SIGNATURES:
        assert any(f"int {entry}(" in open(os.path.join(cuda_lib.CSRC_DIR, n)).read()
                   for n in names if n.endswith(".cu")), entry


def test_mel_kernel_raises_on_cpu_tensors():
    """K8's wrapper launches on the card or raises; only the dispatching
    function takes the plain version, and only for a CPU tensor."""
    from whisper_medusa_tpu_torch.ops import mel_fused

    audio = torch.zeros((1, 16000), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        mel_fused.mel_kernel(audio)
    assert mel_fused.launches == 0


def test_forward_only_kernels_refuse_grad():
    """A kernel without a backward refuses an operand that requires grad
    under grad mode (its output would carry no gradient), before any device
    check; under no_grad, or on tensors that do not require grad, the usual
    checks apply."""
    from whisper_medusa_tpu_torch.ops import logits, verify

    x = torch.zeros((4, 64), dtype=torch.bfloat16, requires_grad=True)
    embed = torch.zeros((128, 64), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        logits.project_kernel(x, embed)
    with pytest.raises(RuntimeError, match="no backward"):
        verify.head_rows_kernel(x, torch.zeros((1, 64, 64), dtype=torch.bfloat16),
                                torch.zeros((1, 64), dtype=torch.bfloat16))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        logits.project_kernel(x, embed)


class _FakeCuda:
    """A leaf that reports a CUDA device (no card here)."""
    is_cuda = True
    device = "cuda:0"

    def __init__(self, dtype):
        self.dtype = dtype

    def is_floating_point(self):
        return self.dtype.is_floating_point


_TRAINABLE = {
    "f32 on cuda": ({"w": _FakeCuda(torch.float32), "b": _FakeCuda(torch.float32)}, None),
    "bf16 on cuda": ({"w": _FakeCuda(torch.bfloat16)}, None),
    "int leaf beside f32 on cuda": (
        {"w": _FakeCuda(torch.float32), "ids": _FakeCuda(torch.int32)}, None),
    "mixed on cuda": ({"w": _FakeCuda(torch.float32), "b": _FakeCuda(torch.bfloat16)},
                      "mixed dtypes"),
    "f16 on cuda": ({"w": _FakeCuda(torch.float16)}, "bfloat16 or float32"),
    "f32 on cpu": ({"w": torch.zeros(2)}, None),
    "mixed on cpu": ({"w": torch.zeros(2), "b": torch.zeros(2, dtype=torch.bfloat16)}, None),
}


@pytest.mark.parametrize("case", list(_TRAINABLE))
def test_training_on_cuda_takes_bf16(case):
    """The training dtype check (checked on the leaves' devices, before
    anything runs): all-f32 (ModelConfig's default) and all-bf16 CUDA
    leaves train, leaves that mix the two or take another float dtype raise
    ValueError; CPU training takes any dtype."""
    from whisper_medusa_tpu_torch.training import train as TT

    params, error = _TRAINABLE[case]
    if error is None:
        TT.require_trainable_dtype(params)
        return
    with pytest.raises(ValueError, match=error):
        TT.require_trainable_dtype(params)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_training_refuses_tf32(monkeypatch, dtype):
    """f32 training on the card takes full-f32 cuBLAS products: with TF32
    allowed it raises ValueError before anything runs; bf16 training and
    CPU training do not care."""
    from whisper_medusa_tpu_torch.training import train as TT

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="allow_tf32"):
            TT.require_trainable_dtype({"w": _FakeCuda(dtype)})
    else:
        TT.require_trainable_dtype({"w": _FakeCuda(dtype)})
    TT.require_trainable_dtype({"w": torch.zeros(2)})


_F32 = {"whisper": {"w": torch.zeros(2, dtype=torch.float32)}}
_INT8 = {"whisper": {"w": {"q": torch.zeros(2, dtype=torch.int8),
                           "s": torch.ones(2, dtype=torch.float32)}}}
_SERVABLE = {
    "f32 on cuda": (_F32, "cuda", None),
    "f32 int8 copy on cuda": (
        {"whisper": {**_INT8["whisper"], "b": torch.zeros(2, dtype=torch.float32)}}, "cuda",
        None),
    "bf16 on cuda": ({"whisper": {"w": torch.zeros(2, dtype=torch.bfloat16)}}, "cuda", None),
    "bf16 int8 copy on cuda": (
        {"whisper": {**_INT8["whisper"], "b": torch.zeros(2, dtype=torch.bfloat16)}}, "cuda",
        None),
    "mixed on cuda": ({"whisper": {"w": torch.zeros(2, dtype=torch.float32),
                                   "b": torch.zeros(2, dtype=torch.bfloat16)}}, "cuda",
                      "mixed dtypes"),
    "f32 on cpu": (_F32, "cpu", None),
    "f32 int8 copy on cpu": (
        {"whisper": {**_INT8["whisper"], "b": torch.zeros(2, dtype=torch.float32)}}, "cpu",
        None),
}


@pytest.mark.parametrize("case", list(_SERVABLE))
def test_serving_on_cuda_takes_bf16(case):
    """generate's dtype check: all-f32 weights (the JAX package's default)
    and all-bf16 weights are served on the card, and so are the int8 copies
    of a bf16 and of an f32 model (their f32 scales belong to them); weights
    that mix bf16 and f32 raise, before anything runs; CPU serving takes
    any dtype."""
    from whisper_medusa_tpu_torch.models.api import require_servable_dtype

    params, device, error = _SERVABLE[case]
    if error is None:
        require_servable_dtype(params, device=device)
        return
    with pytest.raises(NotImplementedError, match=error):
        require_servable_dtype(params, device=device)


def test_f32_serving_refuses_tf32(monkeypatch):
    """f32 serving on the card takes full-f32 cuBLAS products: with TF32
    allowed it raises before anything runs; bf16 serving does not care."""
    from whisper_medusa_tpu_torch.models.api import require_servable_dtype

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(ValueError, match="allow_tf32"):
        require_servable_dtype(_F32, device="cuda")
    require_servable_dtype(_SERVABLE["bf16 on cuda"][0], device="cuda")
    require_servable_dtype(_F32, device="cpu")


def test_f32_int8_copy_serving_refuses_tf32(monkeypatch):
    """The int8 copy of an f32 model keeps the f32 encoder on cuBLAS: with
    TF32 allowed it raises ValueError before anything runs, as f32 weights
    do; the int8 copy of a bf16 model does not care."""
    from whisper_medusa_tpu_torch.models.api import require_servable_dtype

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(ValueError, match="allow_tf32"):
        require_servable_dtype(_SERVABLE["f32 int8 copy on cuda"][0], device="cuda")
    require_servable_dtype(_SERVABLE["bf16 int8 copy on cuda"][0], device="cuda")
