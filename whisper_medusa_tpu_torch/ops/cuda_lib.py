"""Build and load the port's CUDA kernels (``csrc/*.cu``) for Hopper.

The kernels are compiled by nvcc at first use, for ``sm_90a`` — one nvcc
process per source, all started together, then one link — into one shared
library with a plain C interface, and loaded with ``ctypes``.  Every pointer
and the stream are passed as ``c_void_p``; every C entry returns
``cudaGetLastError()`` and :func:`launch` raises when that is not 0.
K1 and K6 load their tiles through TMA tensor maps, encoded on the host by
the CUDA driver's ``cuTensorMapEncodeTiled``; the library links only the CUDA
runtime and fetches that function through ``cudaGetDriverEntryPoint*``
(``csrc/hopper.cuh``), so no ``-lcuda`` is needed.  A map the CUDA driver
refuses (an address or stride not 16-byte aligned) makes the entry return
``TENSOR_MAP_ERROR`` + the CUDA driver's error, and :func:`launch` raises.

The library goes to ``build/whisper_medusa_tpu_torch/`` under the checkout,
named by a hash of the sources and flags, so an edited source rebuilds and a
second process reuses the first one's build; the build holds a file lock,
so ranks that start together (``parallel/``) run nvcc once.  There is no fallback: without
nvcc, or when the build fails, :func:`lib` raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "whisper_medusa_tpu_torch")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo")
LINK_FLAGS = (*_ARCH, "-shared")

TENSOR_MAP_ERROR = 100000   # csrc/hopper.cuh: + the CUDA driver's CUresult

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_vp = ctypes.c_void_p
_ci = ctypes.c_int
_ptrs = ctypes.POINTER(ctypes.c_void_p)
_ints = ctypes.POINTER(ctypes.c_int)

# C signatures of every entry (see csrc/*.cu).
_SIGNATURES = {
    "wm_attention_fwd": [_vp] * 5 + [_ci] * 7 + [_vp],
    "wm_attention_bwd": [_vp] * 11 + [_ci] * 7 + [_vp],
    "wm_megastep_step": [_ptrs, _ints, _vp],
    "wm_megastep_clusters": [_ci] * 5 + [_ints],
    "wm_logits": [_vp] * 3 + [_ci] * 3 + [_vp],
    "wm_verify_hidden": [_ptrs, _ints, ctypes.c_float, _vp],
    "wm_verify_rows": [_ptrs, _ints, ctypes.c_float, _vp],
    "wm_head_rows": [_vp] * 5 + [_ci] * 3 + [_vp],
    "wm_qmm": [_vp] * 5 + [_ci] * 3 + [_vp],
    "wm_qmm_scratch": [_ci] * 3,
    "wm_qmm_nt": [_vp] * 4 + [_ci] * 3 + [_vp],
    "wm_log_mel": [_vp] * 7 + [_ci] * 4 + [_vp],
    "wm_cross_decode": [_vp] * 6 + [_ci] * 5 + [_vp],
    "wm_self_decode": [_vp] * 6 + [_ci] * 5 + [_vp],
    "wm_ffn_decode": [_vp] * 7 + [_ci] * 3 + [_vp],
    # The f32 modes (FFMA on the CUDA cores).
    "wm_attention_fwd_f32": [_vp] * 5 + [_ci] * 7 + [_vp],
    "wm_attention_bwd_f32": [_vp] * 11 + [_ci] * 7 + [_vp],
    "wm_logits_f32": [_vp] * 3 + [_ci] * 3 + [_vp],
    "wm_verify_hidden_f32": [_ptrs, _ints, ctypes.c_float, _vp],
    "wm_verify_rows_f32": [_ptrs, _ints, ctypes.c_float, _vp],
    "wm_cross_decode_f32": [_vp] * 5 + [_ci] * 5 + [_vp],
    "wm_self_decode_f32": [_vp] * 7 + [_ci] * 5 + [_vp],
    "wm_ffn_decode_f32": [_vp] * 8 + [_ci] * 3 + [_vp],
    "wm_gemm_f32": [_vp] * 6 + [_ci] * 5 + [_vp],
    # The W8A32 modes (f32 rows, int8 weights and caches: FFMA, int8 -> f32).
    "wm_megastep_w8a32": [_ptrs, _ints, _vp],
    "wm_cross_decode_w8a32": [_vp] * 7 + [_ci] * 5 + [_vp],
    "wm_gemm_w8a32": [_vp] * 7 + [_ci] * 5 + [_vp],
}


def find_nvcc() -> Optional[str]:
    """nvcc from $CUDA_HOME / $CUDA_PATH, $PATH, or torch's CUDA_HOME."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    try:
        from torch.utils.cpp_extension import CUDA_HOME
    except Exception:                                    # pragma: no cover
        CUDA_HOME = None
    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    return None


def _sources():
    names = sorted(n for n in os.listdir(CSRC_DIR)
                   if n.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC_DIR, n) for n in names]


def _digest() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def _build() -> str:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "Hopper kernels are built from whisper_medusa_tpu_torch/csrc at "
            "first use and have no substitute")
    out = os.path.join(BUILD_DIR, f"libwm_kernels_{_digest()}.so")
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libwm_kernels.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.isfile(out):
            _compile(nvcc, out)
    return out


def _compile(nvcc: str, out: str) -> None:
    tmp = f"{out}.{os.getpid()}.tmp"
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(cu)}.o" for cu in cus]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj, cu],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cu, obj in zip(cus, objs)]
    outs = [p.communicate() for p in procs]
    failed = [(cu, p.returncode, so, se) for cu, p, (so, se) in zip(cus, procs, outs)
              if p.returncode != 0]
    if not failed:
        res = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            failed = [("link", res.returncode, res.stdout, res.stderr)]
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed building {out}:\n" + "\n".join(
            f"{os.path.basename(what)} ({rc}):\n{so}{se}" for what, rc, so, se in failed))
    os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    """The loaded kernel library; builds it on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(_build())
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


def launch(entry: str, device, *args) -> None:
    """Call C entry ``entry`` with ``args`` and the current stream of
    ``device`` (made the current device for the call); raise when it reports
    a CUDA error."""
    import torch

    with torch.cuda.device(device):
        err = getattr(lib(), entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"{entry}: TMA tensor-map encode failed (CUresult "
                           f"{err - TENSOR_MAP_ERROR})")
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def require_cuda(name: str, *tensors, dtype=None, device=None, aligned=True) -> None:
    """Shared wrapper checks: no operand that requires grad under grad mode
    (a kernel's output has no ``grad_fn``, so a loss built on it would lose
    its gradient silently; K1 and K9 are reached through
    ``ops/attention.py::AttentionFn``, which passes detached tensors), one
    CUDA device (``device``, else the first operand's), ``dtype`` (default
    bf16; the f32 modes' wrappers pass f32), contiguous, 16-byte aligned
    (unless ``aligned`` is False: small operands a kernel reads element by
    element)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an operand requires grad, but this kernel has no backward; "
            "training calls the differentiable functions (project_logits_train, "
            "apply_heads_train, full_attention_bhsd) or runs under torch.no_grad()")
    dtype = dtype or torch.bfloat16
    dev = device if device is not None else tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{name}: operands must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
