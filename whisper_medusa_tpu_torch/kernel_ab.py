"""Time this checkout's K1 and K6 against another checkout's build of them, on
one CUDA card, in turns.

    python -m whisper_medusa_tpu_torch.kernel_ab --other DIR

DIR is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``).  Its kernels are built from
its own ``whisper_medusa_tpu_torch/csrc`` into its own ``build/`` by its own
``ops/cuda_lib.py``, loaded beside this checkout's, and both C entries are
called on the same seeded inputs and output buffers (allocated once), so the
times exclude the wrappers' checks and allocations:

  * K1, ``wm_attention_fwd``, at (1, 20, 1500, 64) and (8, 20, 1500, 64),
    the encoder's self-attention at B=1 and B=8;
  * K6, ``wm_qmm``, at (M, K, N) = (1500, 1280, 1280) (init_cache's cross
    K/V projection) and the per-op step's (176, 1280, 5120), (176, 5120,
    1280), (176, 1280, 1280) and (16, 1280, 1280), and whisper tiny's
    (11, 384, 1536).  A build whose ``wm_qmm`` takes a scratch buffer gets
    one of the size its ``wm_qmm_scratch`` asks for.

Each shape runs in the order other, this, this, other; each turn prints the
median of 20 calls between CUDA events (``device_profile._cuda_ms``) and the
device time per call under torch.profiler (``device_profile._by_kernel``:
the kernels' own time, which the events exceed where the host's launch
overhead is the longer).  The two builds' outputs are compared first (K1
within 2e-2, K6 within 1e-3 of max |y|).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess

import torch

from whisper_medusa_tpu_torch.device_profile import _by_kernel, _cuda_ms
from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import qmm as QM

SEED = 0
K1_SHAPES = ((1, 20, 1500), (8, 20, 1500))
K6_SHAPES = ((1500, 1280, 1280), (176, 1280, 5120), (176, 5120, 1280), (176, 1280, 1280),
             (16, 1280, 1280), (11, 384, 1536))


def _other_lib(root: str):
    """The other checkout's ``ops/cuda_lib.py`` as a module of its own."""
    path = os.path.join(root, "whisper_medusa_tpu_torch", "ops", "cuda_lib.py")
    spec = importlib.util.spec_from_file_location("other_cuda_lib", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if os.path.realpath(mod.CSRC_DIR) == os.path.realpath(cuda_lib.CSRC_DIR):
        raise SystemExit("--other names this checkout")
    return mod


def _turns(what, calls):
    """calls: {"other": fn, "this": fn}; run other, this, this, other."""
    out = []
    for who in ("other", "this", "this", "other"):
        ev = _cuda_ms(calls[who])
        dev = sum(us for us, _ in _by_kernel(calls[who], 20).values()) / 1e3
        out.append(f"{who} {ev:.4f} / {dev:.4f}")
    print(f"{what}: events / device ms: " + ", ".join(out), flush=True)


def _qmm_call(mod, x, wq, s, y, m, k, n):
    if len(mod._SIGNATURES["wm_qmm"]) == 8:          # no scratch argument
        return lambda: mod.launch("wm_qmm", x.device, x.data_ptr(), wq.data_ptr(),
                                  s.data_ptr(), y.data_ptr(), m, k, n)
    floats = mod.lib().wm_qmm_scratch(m, k, n)
    scratch = torch.empty((max(floats, 1),), dtype=torch.float32, device=x.device)
    return lambda: mod.launch("wm_qmm", x.device, x.data_ptr(), wq.data_ptr(),
                              s.data_ptr(), y.data_ptr(), scratch.data_ptr(), m, k, n)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--other", required=True, help="root of the other checkout")
    root = parser.parse_args(argv).other
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"gpu: {smi.stdout.strip()}; torch {torch.__version__}", flush=True)
    libs = {"other": _other_lib(root), "this": cuda_lib}
    for mod in libs.values():
        mod.lib()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)

    for b, h, s in K1_SHAPES:
        q, k, v = ((torch.randn((b, h, s, 64), generator=g, device="cuda") * scale)
                   .to(torch.bfloat16) for scale in (0.25, 1.0, 1.0))
        outs = {who: torch.empty_like(q) for who in libs}
        calls = {who: (lambda mod=mod, o=outs[who]: mod.launch(
            "wm_attention_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), None, b, h, s, s, 64, s, 0)) for who, mod in libs.items()}
        for fn in calls.values():
            fn()
        diff = float((outs["this"].float() - outs["other"].float()).abs().max())
        if diff > 2e-2:
            raise AssertionError(f"K1 ({b},{h},{s},64): the builds differ by {diff}")
        _turns(f"K1 ({b},{h},{s},64), builds differ by {diff:.3e}", calls)
        del q, k, v, outs

    for m, k, n in K6_SHAPES:
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        wq, sc = QM.quantize_array(torch.randn((k, n), generator=g, device="cuda") * 0.05)
        ys = {who: torch.empty((m, n), dtype=torch.float32, device="cuda") for who in libs}
        calls = {who: _qmm_call(mod, x, wq, sc, ys[who], m, k, n) for who, mod in libs.items()}
        for fn in calls.values():
            fn()
        diff = float((ys["this"] - ys["other"]).abs().max())
        tol = 1e-3 * float(ys["other"].abs().max())
        if diff > tol:
            raise AssertionError(f"K6 ({m},{k},{n}): the builds differ by {diff} > {tol}")
        _turns(f"K6 ({m},{k},{n}), builds differ by {diff:.3e}", calls)


if __name__ == "__main__":
    main()
