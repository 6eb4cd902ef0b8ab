"""Time this checkout's K1, K6, K8, K10, K7 and K2 against another checkout's
build of them, on one CUDA card, in turns.

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
    one of the size its ``wm_qmm_scratch`` asks for;
  * K8, ``wm_log_mel``, on 30 s of seeded noise at B=1 and B=8, 80 mels.
    Each build gets its own operands: a build whose entry takes the dense
    windowed bases (nine arguments) gets cos and sin zero-padded to 256
    frequencies and the dense filter bank, one that takes the factored
    DFT's tables gets ``ops/mel.py::device_fft_tables``;
  * K10, ``wm_cross_decode``, at (16, 20, 11, 64) x 1500, bf16 and int8 K/V
    (the per-op step's cross-attention at B=16 on the Medusa chain);
  * K7, ``wm_qmm_nt``, at M = 10 and 80 rows against large-v2's int8 tied
    embedding (the B=1 and B=8 draft projections), with ``x @ E.T`` on a
    bf16 copy timed beside it;
  * K2, ``wm_megastep_step``, over 32 seeded large-v2 layers at (B, T) =
    (1, 11), (8, 11) and (8, 1), bf16 and int8, and in block mode at
    (1, 11), called through ``ops/megastep.py`` with each build's library
    (the entry's pointer table is the same in both), with the C entry's
    host time (CPU clock around the ctypes call, no synchronize) beside its
    CUDA-event and device times.

Each shape runs in the order other, this, this, other; each turn prints the
median of 20 calls between CUDA events (``device_profile._cuda_ms``) and the
device time per call under torch.profiler (``device_profile._by_kernel``:
the time the device is busy with the call's kernels, which the events
exceed where the host's launch overhead is the longer).  The two builds'
outputs are compared first (K1 within 2e-2, K6 and K7 within 1e-3 of max
|y|, K8's normalized features within 1e-3, K10 within 1e-2 + 1e-2 |x|, K2's
hidden states at cosine >= 0.999).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess

import numpy as np
import torch

from whisper_medusa_tpu_torch.device_profile import _by_kernel, _cuda_ms
from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import mel as M
from whisper_medusa_tpu_torch.ops import qmm as QM

SEED = 0
K1_SHAPES = ((1, 20, 1500), (8, 20, 1500))
K6_SHAPES = ((1500, 1280, 1280), (176, 1280, 5120), (176, 5120, 1280), (176, 1280, 1280),
             (16, 1280, 1280), (11, 384, 1536))
K7_ROWS = (10, 80)
K2_ROWS = ((1, 11), (8, 11), (8, 1))


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


def _mel_call(mod, x, out, n_mels=80):
    b, n = x.shape
    if len(mod._SIGNATURES["wm_log_mel"]) == 9:      # the dense windowed bases
        cos_b, sin_b, fb = (torch.from_numpy(a).to(x.device) for a in M.dft_mel_basis(n_mels))
        pad = lambda a: torch.nn.functional.pad(a, (0, 256 - a.shape[1])).contiguous()
        ops = (pad(cos_b), pad(sin_b), fb.contiguous())
        return lambda: mod.launch("wm_log_mel", x.device, x.data_ptr(),
                                  *[o.data_ptr() for o in ops], out.data_ptr(), b, n, n_mels)
    tab = M.device_fft_tables(x.device, n_mels)
    ptrs = [tab[k].data_ptr() for k in ("window", "dft20", "twiddle", "mel_span", "mel_w")]
    return lambda: mod.launch("wm_log_mel", x.device, x.data_ptr(), *ptrs, out.data_ptr(),
                              b, n, n_mels, tab["mel_w"].numel())


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

    rng = np.random.default_rng(SEED)
    for b in (1, 8):
        x = torch.from_numpy((0.1 * rng.standard_normal((b, M.N_SAMPLES)))
                             .astype(np.float32)).cuda()
        outs = {who: torch.empty((b, M.N_FRAMES, 80), device="cuda") for who in libs}
        calls = {who: _mel_call(mod, x, outs[who]) for who, mod in libs.items()}
        for fn in calls.values():
            fn()
        diff = float((M.normalize_log_mel(outs["this"])
                      - M.normalize_log_mel(outs["other"])).abs().max())
        if diff > 1e-3:
            raise AssertionError(f"K8 B={b}: the builds' features differ by {diff}")
        _turns(f"K8 B={b}, features differ by {diff:.3e}", calls)

    b, h, t, s_len = 16, 20, 11, 1500
    for int8 in (False, True):
        q = (torch.randn((b, h, t, 64), generator=g, device="cuda") * 0.125).to(torch.bfloat16)
        if int8:
            i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device="cuda",
                                              dtype=torch.int8)
            scl = lambda: 0.004 + 0.012 * torch.rand((b, h, s_len), generator=g, device="cuda")
            k, v, ks, vs = i8(b, h, 64, s_len), i8(b, s_len, h * 64), scl(), scl()
        else:
            rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
            k, v, ks, vs = rnd(b, h, 64, s_len), rnd(b, s_len, h * 64), None, None
        outs = {who: torch.empty_like(q) for who in libs}
        calls = {who: (lambda mod=mod, o=outs[who]: mod.launch(
            "wm_cross_decode", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
            o.data_ptr(), b, h, t, s_len, s_len)) for who, mod in libs.items()}
        for fn in calls.values():
            fn()
        a, o = outs["this"].float(), outs["other"].float()
        if not bool(((a - o).abs() <= 1e-2 + 1e-2 * o.abs()).all()):
            raise AssertionError(f"K10 int8={int8}: the builds differ by "
                                 f"{float((a - o).abs().max())}")
        _turns(f"K10 ({b},{h},{t},64) x {s_len} {'int8' if int8 else 'bf16'}, builds "
               f"differ by {float((a - o).abs().max()):.3e}", calls)
    del q, k, v, outs

    _k7(libs, g)
    _k2(libs, g)


def _k7(libs, g):
    """K7, ``wm_qmm_nt``, on a seeded int8 embedding at large-v2's (51865,
    1280), M = 10 and 80, beside ``x @ E.T`` on a bf16 copy (device ms)."""
    v, d = 51865, 1280
    eq = torch.randint(-127, 128, (v, d), generator=g, device="cuda", dtype=torch.int8)
    es = 0.001 + 0.01 * torch.rand((v,), generator=g, device="cuda")
    for m in K7_ROWS:
        x = torch.randn((m, d), generator=g, device="cuda").to(torch.bfloat16)
        ys = {who: torch.empty((m, v), device="cuda") for who in libs}
        calls = {who: (lambda mod=mod, y=ys[who]: mod.launch(
            "wm_qmm_nt", x.device, x.data_ptr(), eq.data_ptr(), es.data_ptr(), y.data_ptr(),
            m, v, d)) for who, mod in libs.items()}
        for fn in calls.values():
            fn()
        ref = QM.qmm_nt_plain(x, eq, es)
        errs = {who: float((y - ref).abs().max()) for who, y in ys.items()}
        if max(errs.values()) > 1e-3 * float(ref.abs().max()):
            raise AssertionError(f"K7 M={m}: a build is off the plain version: {errs}")
        e16 = eq.to(torch.bfloat16)
        lib = sum(us for us, _ in _by_kernel(lambda: x @ e16.T, 20).values()) / 1e3
        del e16
        _turns(f"K7 qmm_nt M={m} x ({v},{d}) (x @ E.T on a bf16 copy: device {lib:.4f} "
               f"ms), max error this {errs['this']:.3e} other {errs['other']:.3e}", calls)


def _random_layers(g, nl, d=1280, f=5120):
    """A seeded (nl, ...) stack of decoder layers at large-v2's widths."""
    rnd = lambda *shape, scale=0.02: (torch.randn(shape, generator=g, device="cuda")
                                      * scale).to(torch.bfloat16)
    attn = lambda: {"q_w": rnd(nl, d, d), "q_b": rnd(nl, d), "k_w": rnd(nl, d, d),
                    "v_w": rnd(nl, d, d), "v_b": rnd(nl, d), "o_w": rnd(nl, d, d),
                    "o_b": rnd(nl, d)}
    ln = lambda *lead: {"scale": (1 + rnd(*lead, d, scale=0.1).float()).to(torch.bfloat16),
                        "bias": rnd(*lead, d, scale=0.1)}
    return {"self_ln": ln(nl), "self": attn(), "cross_ln": ln(nl), "cross": attn(),
            "ffn_ln": ln(nl), "fc1_w": rnd(nl, d, f), "fc1_b": rnd(nl, f),
            "fc2_w": rnd(nl, f, d), "fc2_b": rnd(nl, d)}, ln()


def _k2(libs, g):
    """K2, ``wm_megastep_step``, through ``ops/megastep.py::megastep_kernel``
    with each build's library in turn: 32 seeded large-v2 layers, bf16 and
    int8 (``quantize_layers``), at (B, T) in K2_ROWS, offsets 20 on a
    460-row cache; the block mode once, bf16 at (1, 11).  Besides events
    and device ms, each turn prints the C entry's host time
    (``device_profile._entry_host_ms``).  The builds' hidden states must
    agree at cosine >= 0.999 (their K sums differ in order, and 32 layers
    compound the roundings)."""
    from whisper_medusa_tpu_torch.device_profile import _entry_host_ms
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS

    nl, h, s_enc, s_len, d = 32, 20, 1500, 460, 1280
    layers, ln_post = _random_layers(g, nl)
    qlayers = QM.quantize_layers(layers)
    block = whisper.layer_params(_random_layers(g, 1)[0], 0)
    for quant, b, t, blk in [(q, b, t, None) for q in (False, True) for b, t in K2_ROWS] + [
            (False, 1, 11, block)]:
        n = nl + (blk is not None)
        if quant:
            i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device="cuda",
                                              dtype=torch.int8)
            scl = lambda *shape: 0.004 + 0.012 * torch.rand(shape, generator=g, device="cuda")
            sk, sv, ck, cv = i8(n, b, s_len, d), i8(n, b, s_len, d), i8(n, b, h, 64, s_enc), \
                i8(n, b, s_enc, d)
            kw = dict(self_s=scl(n, b, s_len, 2 * h).to(torch.bfloat16),
                      cross_k_s=scl(n, b, h, s_enc), cross_v_s=scl(n, b, h, s_enc))
        else:
            rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(
                torch.bfloat16)
            sk, sv, ck, cv = rnd(n, b, s_len, d), rnd(n, b, s_len, d), rnd(n, b, h, 64, s_enc), \
                rnd(n, b, s_enc, d)
            kw = {}
        x = torch.randn((b, t, d), generator=g, device="cuda").to(torch.bfloat16)
        offs = torch.full((b,), 20, dtype=torch.int32, device="cuda")
        lay = qlayers if quant else layers
        run = lambda: MS.megastep_kernel(lay, ln_post, x, sk, sv, ck, cv, offs, None, s_enc, h,
                                         block=blk, **kw)
        outs, cells = {}, []
        try:
            for who in ("other", "this", "this", "other"):
                MS.cuda_lib = libs[who]
                outs.setdefault(who, run()[1].float())
                ev = _cuda_ms(run)
                dev = sum(us for us, _ in _by_kernel(run, 5).values()) / 1e3
                host = _entry_host_ms(run, "wm_megastep_step", lib=libs[who])
                cells.append(f"{who} {ev:.4f} / {dev:.4f} / {host:.4f}")
        finally:
            MS.cuda_lib = cuda_lib
        cos = float(torch.nn.functional.cosine_similarity(
            outs["this"].reshape(1, -1), outs["other"].reshape(1, -1)))
        if cos < 0.999:
            raise AssertionError(f"K2 ({b},{t}): the builds' hidden states at cosine {cos}")
        mode = ("int8" if quant else "bf16") + (" block" if blk is not None else "")
        print(f"K2 megastep {mode} (B, T) = ({b}, {t}), 32 layers, builds at cosine "
              f"{cos:.6f}: events / device / C-entry host ms: " + ", ".join(cells), flush=True)
        del sk, sv, ck, cv


if __name__ == "__main__":
    main()
