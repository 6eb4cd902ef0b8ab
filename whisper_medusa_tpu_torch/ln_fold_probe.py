"""What K2's fused layer norms cost, piece by piece, on one CUDA card.

    python -m whisper_medusa_tpu_torch.ln_fold_probe --parent DIR

The q/k/v, cross-q and fc1 GEMMs of K2 (``csrc/wgemm.cuh``, LN mode) take
each row's statistics over their K slice from L2, combine the slices across
the cluster, and rewrite every X tile in shared memory before its products.
This builds three variants of this checkout's kernels, each with one of
those parts taken out (their outputs are wrong; only their time counts):

  * ``no-pass``: no L2 pass over the rows (zero partials), the cluster
    exchange and the rewrite kept;
  * ``no-stats``: neither the pass nor the exchange (mean 0, rstd 1), the
    rewrite kept;
  * ``no-rewrite``: the statistics as they are, the X tiles left raw;

and times one K2 step over 32 seeded large-v2 layers, bf16, at (B, T) =
(1, 11), (8, 11) and (8, 1), in the other checkout DIR (for example the
parent, whose norms are ``ln_rows_kernel`` launches), this checkout and the
variants, in turns (each order, then the reverse): device ms by kernel group
under torch.profiler (``device_profile._by_kernel``).  The variants are
built from copies under ``build/ln_fold_probe/`` of this checkout.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

import torch

from whisper_medusa_tpu_torch import kernel_ab as KA
from whisper_medusa_tpu_torch.device_profile import _by_kernel
from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import megastep as MS

_PKG = os.path.dirname(os.path.abspath(__file__))
_PASS = "    for (int m0 = 0; m0 < m_rows; m0 += G_THREADS / G_LN_LANES) {"
_EXCHANGE = "    cluster_arrive();   // this rank's partials, released to the cluster"
_STATS_END = "    __syncthreads();\n  }\n\n  float acc[MT * 8];"
_REWRITE = "      if constexpr (LN) ln_tile(st, it);"


def _patch(name: str, src: str) -> str:
    """wgemm.cuh with one part of the LN mode taken out."""
    for anchor in (_PASS, _EXCHANGE, _STATS_END, _REWRITE):
        if anchor not in src:
            raise SystemExit(f"ln_fold_probe: wgemm.cuh no longer has {anchor.strip()!r}")
    if name == "no-pass":
        a, b = src.index(_PASS), src.index(_EXCHANGE)
        return (src[:a] + "    for (int m = threadIdx.x; m < m_rows; m += G_THREADS)\n"
                "      ln_part[m] = make_float2(0.0f, cnt);\n    (void)gl;\n" + src[b:])
    if name == "no-stats":
        a, b = src.index(_PASS), src.index(_STATS_END)
        return (src[:a] + "    for (int m = threadIdx.x; m < m_rows; m += G_THREADS)\n"
                "      ln_row[m] = make_float2(0.0f, 1.0f);\n    (void)gl; (void)k; (void)cnt;\n"
                + src[b:])
    return src.replace(_REWRITE, "      if constexpr (LN) (void)ln_tile;")


def _variant(root: str, name: str) -> str:
    dst = os.path.join(root, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_PKG, os.path.join(dst, "whisper_medusa_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "whisper_medusa_tpu_torch", "csrc", "wgemm.cuh")
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(_patch(name, src))
    return dst


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True, help="root of the other checkout")
    other = parser.parse_args(argv).parent
    if not torch.cuda.is_available():
        raise SystemExit("ln_fold_probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"gpu: {smi.stdout.strip()}; torch {torch.__version__}", flush=True)
    out = os.path.join(os.path.dirname(cuda_lib.BUILD_DIR), "ln_fold_probe")
    roots = {"other": other, "this": None}
    roots.update({n: _variant(out, n) for n in ("no-pass", "no-stats", "no-rewrite")})
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from whisper_medusa_tpu_torch.ops import cuda_lib; cuda_lib.lib()")
    procs = [subprocess.Popen([sys.executable, "-c", build, r]) for r in roots.values() if r]
    cuda_lib.lib()
    if any(p.wait() for p in procs):
        raise SystemExit("ln_fold_probe: a build failed")
    libs = {w: KA._other_lib(r) if r else cuda_lib for w, r in roots.items()}
    mods = {w: KA._other_ops(r, "megastep", libs[w]) if r else MS for w, r in roots.items()}
    g = torch.Generator(device="cuda")
    g.manual_seed(KA.SEED)
    nl, h, s_enc, s_len, d = 32, 20, 1500, 460, 1280
    layers, ln_post = KA._random_layers(g, nl)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    order = list(roots)
    for b, t in KA.K2_ROWS:
        sk, sv = rnd(nl, b, s_len, d), rnd(nl, b, s_len, d)
        ck, cv = rnd(nl, b, h, 64, s_enc), rnd(nl, b, s_enc, d)
        x = rnd(b, t, d)
        offs = torch.full((b,), 20, dtype=torch.int32, device="cuda")
        for who in order + order[::-1]:
            run = lambda m=mods[who]: m.megastep_kernel(layers, ln_post, x, sk, sv, ck, cv,
                                                       offs, None, s_enc, h)
            run()
            rows = _by_kernel(run, 5)
            part = lambda f: sum(us for k, (us, _) in rows.items() if f(k)) / 1e3
            ln = [(us, n) for k, (us, n) in rows.items()
                  if k.startswith("wgemm_kernel<") and k.endswith(", true>") and k.count(",") == 2]
            ln_ms, ln_n = sum(us for us, _ in ln) / 1e3, sum(n for _, n in ln)
            print(f"({b}, {t}) {who:10s} device {part(lambda k: True):.4f} ms: GEMMs "
                  f"{part(lambda k: k.startswith('wgemm_kernel<')):.4f} (LN mode {ln_ms:.4f} "
                  f"in {ln_n:.0f} launches, {1e3 * ln_ms / max(ln_n, 1):.2f} us a launch), "
                  f"attention {part(lambda k: k.startswith('cross_decode_kernel<')):.4f}, "
                  f"ln_rows_kernel {part(lambda k: k.startswith('ln_rows_kernel')):.4f}",
                  flush=True)
        del sk, sv, ck, cv


if __name__ == "__main__":
    main()
