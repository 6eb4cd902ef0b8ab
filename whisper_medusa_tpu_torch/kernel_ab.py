"""Time this checkout's K1, K6, K8, K10, K7, K3, K2, K11, K5, K4,
``wm_head_rows``, K3's and K9's f32 modes, K1's f32 mode, the f32 GEMM
(alone, and inside K11, ``wm_head_rows`` and K4's stage A at f32), K10's
f32, mask and W8A32 modes, the W8A32 GEMM (alone, in ``wm_head_rows`` and
K4's stage A on int8 heads), K2's W8A32 mode and K4 / K5's f32 and W8A32
modes against another checkout's build of them, on one CUDA card, in
turns.

    python -m whisper_medusa_tpu_torch.kernel_ab --other DIR [--only K4K5,head_rows]

DIR is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``).  Its kernels are built from
its own ``whisper_medusa_tpu_torch/csrc`` into its own ``build/`` by its own
``ops/cuda_lib.py``, loaded beside this checkout's, and both C entries are
called on the same seeded inputs and output buffers (allocated once), so the
times exclude the wrappers' checks and allocations.  First, the SASS of the
bf16 and int8 kernels of K1, K2, K3, K4, K5, K7, K10 and K11 — the
weight-streaming GEMM's instantiations (``wgemm_kernel<MT, W8, LN,
HEADS>``: K2's, K11's and the heads mode of K4's stage A), K4 / K5's vocab
stream in every mode (``vocab_stream_kernel<MT, Q, TS>``) and its two
combines, the cluster attention body of K2 and K10
(``cross_decode_kernel<KT, SELF, K2>``), K1's ``attention_kernel`` and the
tied-embedding stream of K3 and K7 (``nt_stream_kernel<MT, W8>``) — is
compared between the builds (``cuobjdump -sass``), instruction for
instruction, and whether it is the same is printed (the f32 and W8A32
modes are kernels of their own beside them); then every other function of
the library outside the kernels a build may change (``_CHANGED``: the f32
weight stream of K3 f32 and K4 / K5's f32 and W8A32 modes, with the f32
vocab stream it replaced; K1's and K9's f32 kernels, the f32 GEMM, the
f32 decode attention and ``ln_rows_f32_kernel`` stay held) is compared by
name the same way.  Then:

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
    (the per-op step's cross-attention at B=16 on the Medusa chain), and its
    mask mode, ``wm_self_decode``, at (16, T=11, 20 heads) x 460 (the per-op
    step's self-attention; the builds also held bitwise equal at T=11 on a
    tree mask and at TC = 24 and 32 in 16-row launches);
  * K7, ``wm_qmm_nt``, at M = 10 and 80 rows against large-v2's int8 tied
    embedding (the B=1 and B=8 draft projections), with ``x @ E.T`` on a
    bf16 copy timed beside it; the builds' outputs bitwise equal;
  * K3, ``wm_logits``, at M = 10 and 80 rows against a seeded bf16 tied
    embedding at large-v2's (51865, 1280), with ``x @ E.T`` timed beside it
    (the builds may sum in other orders: each within 1e-3 of max |y| of
    the plain version);
  * K2, ``wm_megastep_step``, over 32 seeded large-v2 layers at (B, T) =
    (1, 11), (8, 11) and (8, 1), bf16, int8 and bf16 block mode, called
    through each checkout's own ``ops/megastep.py`` (its pointer table may
    differ) with that checkout's library, with the C entry's host time (CPU
    clock around the ctypes call, no synchronize) beside its CUDA-event and
    device times, and the device time a step of its attention kernels, of
    ``ln_rows_kernel`` and of the GEMM by name, with their launches;
  * K11, ``wm_ffn_decode``, at large-v2's (D, F) = (1280, 5120) for M = 16,
    88 and 176 rows and whisper tiny's (384, 1536) for M = 11 and 88 (the
    builds' outputs bitwise equal); K5,
    ``wm_verify_rows``, at R = 8, 88, 176 and 1024 against large-v2's bf16
    and int8 tied embedding; K4, ``wm_verify_hidden``, at R = 121 (11 heads
    x 11 nodes, or 10 heads and the ``identity0`` rows), bf16 and int8
    (``quant``: int8 embedding and heads), and bf16 at whisper tiny's D =
    384, with the device time of its stage A (the heads' rows) by kernel
    name; ``wm_head_rows`` (K4's stage A alone), bf16 and int8 heads: head 0
    at M = 88 (pass A at B=8), the 10 draft heads at M = 8 (pass B) and M =
    1 (the prefill at B=1), every head at M = 11 (K4's stage A at B=1), and
    head 0 at M = 88 and the 10 heads at M = 8 at D = 384, beside the
    three-call yardstick (``torch.baddbmm``, silu, add).  Each is
    called through its checkout's own wrapper (``ops/decode_ops.py``,
    ``ops/verify.py`` loaded from that checkout, calling that checkout's
    library), so a build's row blocking and staging copies count, and the C
    entry's host time (summed over its calls in one wrapper call) is printed
    beside the events and device times;
  * K3's f32 mode, ``wm_logits_f32``, at M = 1, 10, 80, 121 and 300 rows
    against a seeded f32 embedding at (51865, 1280), with ``x @ E.T`` timed
    beside it (the builds' outputs bitwise equal or not, printed);
  * K9's f32 mode, ``wm_attention_bwd_f32``, at the training paths' (2, 20,
    224^2) causal, (2, 20, 224 x 1500) and (2, 20, 1500^2) and the smoke's
    three off-path cases, from K1 f32's output and log-sum-exp, beside the
    SDPA f32 backward (dK and dV bitwise equal between the builds or not,
    printed; a build whose entry takes the dQ partials gets the scratch);
  * K1's f32 mode, ``wm_attention_fwd_f32``, at the smoke's six ``K1_F32``
    shapes (the encoder at B=1 and B=8, the capture pass's T = 67 causal and
    T x 1500, training's 224^2 causal, a ragged kv_len), each build within
    1e-4 + 1e-4 |y| of attention_plain and its log-sum-exp within 1e-3,
    beside SDPA in f32 (TF32 off; device ms);
  * the f32 GEMM, ``gemm_f32``, at M = 1, 11, 88 and 176 through 1280 x
    1280, 1280 x 5120 and 5120 x 1280 with a bias, each build within 1e-4 +
    1e-4 |y| of ``torch.addmm`` in f32 (TF32 off), beside addmm's device
    time; K11's f32 mode at M = 11, 88 and 176 (1280, 5120); the f32 head
    rows (``head_rows_kernel`` on f32 heads: head 0 x 88, 10 heads x 8,
    11 x 11, the L2 flushed) and K4's f32 mode at R = 121 with its stage A
    (``ffma_gemm_kernel`` and, in older builds, ``ffma_combine_kernel``) by
    name.  Each through its checkout's own ``ops/decode_ops.py`` /
    ``ops/verify.py`` (the verify module's GEMM wrapper its own checkout's),
    so a build's scratch allocations count;
  * K10's f32, W8A32 and f32 mask modes through each build's
    ``ops/decode_ops.py`` at (B, 20, T, 64) x 1500 and (B, T, 20 heads) x
    460, B = 16, 8, 1, T = 11 and 1, beside f32 SDPA (``K10f32``); the
    W8A32 GEMM alone (``gemm_w8a32_launch``) at M = 1, 11, 88 through the
    three weight shapes beside ``addmm`` on the dequantized copy and this
    build's f32 GEMM on it (``GEMMw8a32``); the int8 head rows at
    HEAD32_SHAPES and K4 at R = 121 on int8 heads and embedding
    (``heads_w8a32``); K2's W8A32 mode over 32 seeded layers at K2_ROWS and
    its block mode at (1, 11), its GEMM, attention and norms by kernel with
    their launches a layer (``K2w8a32``);
  * K4 / K5's f32 and W8A32 modes (``K4K5f32``): K5 at R = 1, 8, 88, 176
    and 1024 (the timestamp mode too at 88) beside this build's K3 f32 and
    f32 ``x @ E.T`` on the same rows, K4 at R = 121 plain, with
    ``identity0`` and in the timestamp mode, and at R = 1024, the vocab
    stream's kernel by name; the builds' statistics bitwise equal.

Each shape runs in the order other, this, this, other; each turn prints the
median of 20 calls between CUDA events (``device_profile._cuda_ms``) and the
device time per call under torch.profiler (``device_profile._by_kernel``:
the time the device is busy with the call's kernels, which the events
exceed where the host's launch overhead is the longer).  The two builds'
outputs are compared first (K1 within 2e-2, K6 and K3 within 1e-3 of max
|y|, K8's normalized features within 1e-3, K10, its mask mode, K7 and K11
bitwise, K2's hidden states at cosine >= 0.999 (whether they are bitwise
equal is printed), K5's and K4's max / lse / gathered within 1e-2 and
their argmax on all but 1 % of the rows, the head rows elementwise within
3e-2 of each other (bitwise equality printed): the builds may sum in other
orders).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib.util
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from whisper_medusa_tpu_torch.device_profile import _by_kernel, _cold_ms, _cuda_ms
from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import mel as M
from whisper_medusa_tpu_torch.ops import qmm as QM

SEED = 0
K1_SHAPES = ((1, 20, 1500), (8, 20, 1500))
K6_SHAPES = ((1500, 1280, 1280), (176, 1280, 5120), (176, 5120, 1280), (176, 1280, 1280),
             (16, 1280, 1280), (11, 384, 1536))
K7_ROWS = (10, 80)
K3_ROWS = (10, 80)
K3F32_ROWS = (1, 10, 80, 121, 300)
# K9 f32: the training paths' self (causal), cross and encoder shapes at
# B = 2, then the smoke's off-path cases (ragged, kv_len < Skv).
K9F32_CASES = (((2, 20, 224, 224), 224, True), ((2, 20, 224, 1500), 1500, False),
               ((2, 20, 1500, 1500), 1500, False), ((1, 4, 300, 300), 257, True),
               ((1, 3, 77, 300), 299, False), ((1, 2, 130, 64), 64, True))
K2_ROWS = ((1, 11), (8, 11), (8, 1))
# K1 f32: the smoke's K1_F32 shapes ((B, H, Sq, Skv), kv_len, causal).
K1F32_CASES = (((1, 20, 1500, 1500), 1500, False), ((8, 20, 1500, 1500), 1500, False),
               ((1, 20, 67, 67), 67, True), ((1, 20, 67, 1500), 1500, False),
               ((2, 20, 224, 224), 224, True), ((1, 4, 300, 300), 257, False))
# The f32 GEMM: the per-op step's rows (B=1 vanilla and Medusa, B=8, B=16)
# through its three weight shapes; K11 f32's rows; the f32 head rows' (first
# head, last head + 1, M) and K4 f32's heads x nodes.
GEMM32_ROWS = (1, 11, 88, 176)
GEMM32_SHAPES = ((1280, 1280), (1280, 5120), (5120, 1280))
K11F32_ROWS = (11, 88, 176)
HEAD32_SHAPES = ((0, 1, 88), (1, 11, 8), (0, 11, 11))
GEMM32_KERNELS = ("ffma_gemm_kernel", "ffma_combine_kernel")
K11_SHAPES = ((1280, 5120, (16, 88, 176)), (384, 1536, (11, 88)))
# The W8A32 GEMM alone (K2 W8A32's projections: M = B T at (1, 1), (1, 11),
# (8, 11)) and its kernels in either build; K10's f32 modes at T = 11 and 1
# and their kernels; K2 W8A32's kernels by family.
W8_ROWS = (1, 11, 88)
# K4 / K5's f32 and W8A32 modes: K5's rows (vanilla B=1 and B=8, B=8's pass
# A, B=16's, the most a launch takes) and the f32 vocab stream's kernel in
# either build (a build before this stream named it vocab_stream_f32...).
K4K5F32_ROWS = (1, 8, 88, 176, 1024)
# K4's: (heads, nodes, identity0, timestamp mode): R = 121 three ways, and
# one head over 1024 source rows (R = 1024, the most a launch takes).
K4F32_CASES = ((11, 11, False, False), (10, 11, True, False), (11, 11, False, True),
               (1, 1024, False, False))
STREAM32 = ("ffma_stream_kernel", "vocab_stream_f32")
K10F32_BATCH = (16, 8, 1)     # the per-op step's B=16 row, and the f32 requests' B=8 and B=1
W8_KERNELS = ("ffma_gemm", "ffma_combine8_kernel")
ATTN32_KERNELS = ("decode_attn_f32_kernel", "decode_combine_f32_kernel")
K2W8_FAMILIES = (("GEMM", W8_KERNELS), ("attention", ATTN32_KERNELS),
                 ("norms", ("ln_rows_f32_kernel",)))
K5_ROWS = (8, 88, 176, 1024)


def _other_lib(root: str):
    """The other checkout's ``ops/cuda_lib.py`` as a module of its own."""
    path = os.path.join(root, "whisper_medusa_tpu_torch", "ops", "cuda_lib.py")
    spec = importlib.util.spec_from_file_location("other_cuda_lib", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if os.path.realpath(mod.CSRC_DIR) == os.path.realpath(cuda_lib.CSRC_DIR):
        raise SystemExit("--other names this checkout")
    return mod


def _turns(what, calls, entry=None, libs=None, part=None, cold=False):
    """calls: {"other": fn, "this": fn}; run other, this, this, other.  With
    ``entry``, also the host time of that C entry of each build
    (``device_profile._entry_host_ms`` on ``libs[who]``); with ``part`` (a
    tuple of kernel-name prefixes), also the device time of those kernels
    alone, with ``cold`` measured with the L2 flushed before each call
    (``device_profile._cold_ms``)."""
    from whisper_medusa_tpu_torch.device_profile import _entry_host_ms

    out = []
    for who in ("other", "this", "this", "other"):
        ev = _cuda_ms(calls[who])
        rows = _by_kernel(calls[who], 20)
        dev = sum(us for us, _ in rows.values()) / 1e3
        cell = f"{who} {ev:.4f} / {dev:.4f}"
        if entry is not None:
            cell += f" / {_entry_host_ms(calls[who], entry, lib=libs[who]):.4f}"
        if part is not None:
            ms = (_cold_ms(calls[who], 20, part) if cold else
                  sum(us for k, (us, _) in rows.items() if k.startswith(part)) / 1e3)
            cell += f" / {ms:.4f}"
        out.append(cell)
    kind = "events / device" + (" / C-entry host" if entry else "") + (
        f" / {'+'.join(part)} device" + (" (L2 flushed)" if cold else "") if part else "") + " ms"
    print(f"{what}: {kind}: " + ", ".join(out), flush=True)


# Instantiations held to the other build's SASS, by family: a mangled-name
# pattern whose groups are the instantiation's key, and a predicate on the
# key that leaves an instantiation out (a mode added later at its default,
# or the one instantiation a change widens; none since the f32 modes, which,
# with the W8A32 modes, are kernels of their own beside these).  K2's and K11's GEMM and the heads
# mode of K4's stage A and wm_head_rows (wgemm_kernel<MT, W8, LN, HEADS>),
# K4 / K5's vocab stream in every mode (vocab_stream_kernel<MT, Q, TS>) and
# its two combines, the cluster attention body of K2 and of K10's cross and
# mask modes (cross_decode_kernel<KT, SELF, K2>), K1's forward
# (attention_kernel) and the tied-embedding stream of K3 and K7
# (nt_stream_kernel<MT, W8>).
_HELD = (("wgemm_kernel<MT, W8, LN, HEADS>",
          re.compile(r"wgemm_kernelILi(\d+)ELb([01])ELb([01])E(?:Lb([01])E)?E"),
          lambda key: False),
         ("vocab_stream_kernel<MT, Q, TS>",
          re.compile(r"vocab_stream_kernelILi(\d+)ELb([01])E(?:Lb([01])E)?E"),
          lambda key: False),
         ("verify_combine_kernel", re.compile(r"21verify_combine_kernel()"), lambda key: False),
         ("verify_combine_ts_kernel", re.compile(r"24verify_combine_ts_kernel()"),
          lambda key: False),
         ("cross_decode_kernel<KT, SELF, K2>",
          re.compile(r"cross_decode_kernelI(\w+?)Lb([01])ELb([01])EE"), lambda key: False),
         ("attention_kernel", re.compile(r"16attention_kernel()"), lambda key: False),
         ("nt_stream_kernel<MT, W8>", re.compile(r"nt_stream_kernelILi(\d+)ELb([01])EE"),
          lambda key: False))


def _sass_functions(funcs):
    """{(family, key): sorted SASS bodies} of the held instantiations among
    a build's functions (``_all_sass``)."""
    out = {}
    for name, bodies in funcs.items():
        for family, pattern, skip in _HELD:
            m = pattern.search(name)
            if m is None or skip(m.groups()):
                continue
            key = tuple(x for x in m.groups() if x is not None)
            out[(family, key)] = sorted(out.get((family, key), []) + bodies)
    return out


def _relabel(body):
    """Branch labels (``.L_x_N``, numbered across the whole object by
    cuobjdump) renumbered in their order within the function, so that
    kernels added elsewhere in the same source do not change its text."""
    names = {}
    return re.sub(r"\.L_x_\d+", lambda m: names.setdefault(m.group(0), f".L{len(names)}"),
                  body)


def _sass_same(all_funcs):
    """Print, per family of _HELD, whether its instantiations are
    instruction for instruction the same in both builds."""
    funcs = {who: _sass_functions(f) for who, f in all_funcs.items()}
    for family, _, _ in _HELD:
        mine = {k: v for k, v in funcs["this"].items() if k[0] == family}
        theirs = {k: v for k, v in funcs["other"].items() if k[0] == family}
        keys = sorted(set(mine) | set(theirs))
        differ = [k[1] for k in keys if mine.get(k) != theirs.get(k)]
        if differ:
            k = next(k for k in keys if k[1] == differ[0])
            a, b = ("\n".join(d.get(k, [""])).splitlines() for d in (mine, theirs))
            at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            print(f"  first difference of {family} {k[1]} at instruction {at} of {len(a)} / "
                  f"{len(b)}: this {a[at:at + 3]}, other {b[at:at + 3]}", flush=True)
        print(f"SASS of {family} ({sum(map(len, mine.values()))} functions here, "
              f"{sum(map(len, theirs.values()))} in the other build): "
              f"{len(keys) - len(differ)} of {len(keys)} instantiations the same "
              f"instruction for instruction" + (f"; differ: {differ}" if differ else ""),
              flush=True)


# The kernels a build may change, by name: the f32 weight stream of K3 f32
# and of K4 / K5's f32 and W8A32 modes (ffma_stream.cuh's ffma_stream_kernel,
# one product loop under two epilogues; the first-cut f32 vocab stream it
# replaced, vocab_stream_f32...).
# Every other function of the library (K1's and K9's f32 kernels, the f32
# GEMM, the f32 decode attention and ln_rows_f32_kernel among them) is held
# to the other build's SASS by _sass_rest.
_CHANGED = re.compile(r"ffma_stream_kernel|vocab_stream_f32")


def _all_sass(so_path):
    """{mangled name: sorted SASS bodies} of every function in a built
    library (a kernel with internal linkage appears once per source that
    instantiates it)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    out = collections.defaultdict(list)
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = chunk.partition("\n")
        ins = [re.sub(r"/\*[^*]*\*/", "", line).strip() for line in body.splitlines()
               if re.match(r"\s*/\*[0-9a-f]+\*/", line)]
        # An internal-linkage name carries a hash of its source's path
        # (_GLOBAL__N__<hash>_<n>_<file>_cu_<hash>), which differs between
        # checkouts: drop the first hash.
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name.strip())
        out[name].append(_relabel("\n".join(ins)))
    return {k: sorted(v) for k, v in out.items()}


def _sass_rest(funcs):
    """Print whether every function of the library outside _CHANGED (K1's
    and K9's f32 kernels, the f32 GEMM, the f32 decode attention,
    ln_rows_f32_kernel, and the families of _HELD) that
    both builds have is instruction for instruction the same, the names
    only one build has (a source that stopped including a header loses the
    unused kernels it instantiated), and the changed kernels each build
    has."""
    held = {who: {n for n in f if not _CHANGED.search(n)} for who, f in funcs.items()}
    both = sorted(held["this"] & held["other"])
    differ = [n for n in both if funcs["this"][n] != funcs["other"][n]]
    for n in differ[:5]:
        print(f"  differs: {n}", flush=True)
    print(f"SASS of every function outside the changed kernels in both builds: "
          f"{len(both) - len(differ)} of {len(both)} names the same instruction for "
          f"instruction ({sum(len(funcs['this'][n]) for n in both)} functions here)"
          + (f"; {len(differ)} differ" if differ else ""), flush=True)
    for who, other in (("this", "other"), ("other", "this")):
        only = sorted(held[who] - held[other])
        if only:
            print(f"  only in the {who} build: {len(only)}: {only}", flush=True)
    for who in ("this", "other"):
        mine = [n for n in funcs[who] if _CHANGED.search(n)]
        print(f"changed kernels in the {who} build: {mine}", flush=True)


def _other_ops(root: str, name: str, lib):
    """The other checkout's ``ops/<name>.py`` as a module of its own whose
    kernels launch through ``lib`` (that checkout's library)."""
    path = os.path.join(root, "whisper_medusa_tpu_torch", "ops", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"other_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.cuda_lib = lib
    return mod


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
    parser.add_argument("--only", default=",".join(SECTIONS),
                        help="comma-separated sections to time, in this order (default: "
                             "all): " + ", ".join(SECTIONS))
    args = parser.parse_args(argv)
    root, only = args.other, args.only.split(",")
    unknown = [x for x in only if x not in SECTIONS]
    if unknown:
        raise SystemExit(f"unknown sections {unknown}; known: {list(SECTIONS)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"gpu: {smi.stdout.strip()}; torch {torch.__version__}", flush=True)
    libs = {"other": _other_lib(root), "this": cuda_lib}
    for mod in libs.values():
        mod.lib()
    funcs = {who: _all_sass(mod.lib()._name) for who, mod in libs.items()}
    _sass_same(funcs)
    _sass_rest(funcs)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    for section in only:
        SECTIONS[section](root, libs, g)


def _k1(root, libs, g):
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


def _k6(root, libs, g):
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


def _k8(root, libs, g):
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


def _k10(root, libs, g):
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
        if not torch.equal(outs["this"], outs["other"]):
            raise AssertionError(f"K10 int8={int8}: the builds differ by "
                                 f"{float((outs['this'].float() - outs['other'].float()).abs().max())}")
        _turns(f"K10 ({b},{h},{t},64) x {s_len} {'int8' if int8 else 'bf16'}, builds "
               f"bitwise equal", calls)
    del q, k, v, outs
    _k10_mask(libs, g)


def _k10_mask(libs, g):
    """K10's mask mode, ``wm_self_decode``, at (16, T, 20 heads) x 460 (the
    per-op step's self-attention at B=16) at offsets 3-400, on chunks of at
    most 32 columns (one word a row of chunk bits, the only width the other
    build may take): T = 11 causal (the Medusa chain) and tree, and TC = 24
    (tree) and 32 (causal) in 16-row launches; the builds' outputs must be
    bitwise equal.  The first case is timed."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    b, h, s_len = 16, 20, 460
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    k, v = rnd(b, s_len, h * 64), rnd(b, s_len, h * 64)
    for tc, tree in ((11, False), (11, True), (24, True), (32, False)):
        q = (torch.randn((b, tc, h, 64), generator=g, device="cuda") * 0.125).to(torch.bfloat16)
        offs = torch.tensor([3 + (37 * e) % (s_len - tc - 3) for e in range(b)],
                            dtype=torch.int32, device="cuda")
        cm = None
        if tree:   # node i sees itself, node 0 and the even nodes before it
            cm = torch.eye(tc, dtype=torch.bool, device="cuda")
            cm[:, 0] = True
            for i in range(tc):
                cm[i, :i:2] = True
        bits = DO.chunk_bits(cm, tc, "cuda")
        blocks = [(q[:, r0:r0 + n].contiguous(), bits[r0:r0 + n].contiguous())
                  for r0, n in DO.row_blocks(tc)]
        outs = {who: [torch.empty_like(qb) for qb, _ in blocks] for who in libs}

        def call(mod, outs_who):
            for (qb, bb), o in zip(blocks, outs_who):
                mod.launch("wm_self_decode", qb.device, qb.data_ptr(), k.data_ptr(),
                           v.data_ptr(), offs.data_ptr(), bb.data_ptr(), o.data_ptr(), b, h,
                           qb.shape[1], s_len, tc)
        calls = {who: (lambda mod=mod, o=outs[who]: call(mod, o)) for who, mod in libs.items()}
        for fn in calls.values():
            fn()
        what = f"K10 mask mode (16, TC={tc}, {'tree' if tree else 'causal'}, {h} heads) x {s_len}"
        if not all(torch.equal(a, c) for a, c in zip(outs["this"], outs["other"])):
            raise AssertionError(f"{what}: the builds differ")
        print(f"{what}: builds bitwise equal ({len(blocks)} launches)", flush=True)
        if (tc, tree) == (11, False):
            _turns(f"{what}, builds bitwise equal", calls)


def _k11(root, libs, g):
    """K11 through each checkout's ``ffn_decode_kernel`` on seeded weights
    (N(0, 0.02)) and rows (N(0, 1)) at K11_SHAPES."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    mods = {"other": _other_ops(root, "decode_ops", libs["other"]), "this": DO}
    rnd = lambda *shape, scale=0.02: (torch.randn(shape, generator=g, device="cuda")
                                      * scale).to(torch.bfloat16)
    for d, f, rows in K11_SHAPES:
        w1, b1, w2, b2 = rnd(d, f), rnd(f), rnd(f, d), rnd(d)
        for m in rows:
            x = rnd(m, d, scale=1.0)
            calls = {who: (lambda mod=mod: mod.ffn_decode_kernel(x, w1, b1, w2, b2))
                     for who, mod in mods.items()}
            a, o = calls["this"](), calls["other"]()
            if not torch.equal(a, o):
                raise AssertionError(f"K11 ({m}, {d}, {f}): the builds differ by "
                                     f"{float((a.float() - o.float()).abs().max())}")
            _turns(f"K11 ffn_decode M={m} D={d} F={f}, builds bitwise equal", calls,
                   "wm_ffn_decode", libs)


def _agree(what, got, ref):
    """K4 / K5 outputs of the two builds: max / lse / gathered within 1e-2,
    argmax equal on at least 99 % of the rows."""
    same = float((got[0] == ref[0]).float().mean())
    err = max(float((a - b).abs().max()) for a, b in zip(got[1:], ref[1:]))
    if err > 1e-2 or same < 0.99:
        raise AssertionError(f"{what}: the builds differ: argmax equal on {same:.4f} of the "
                             f"rows, stats by {err}")
    return f"argmax equal on {same:.4f}, stats differ by {err:.3e}"


def _verify(root, libs, g):
    """K5 at K5_ROWS and K4 at R = 121 (bf16, int8, identity0 rows, and
    whisper tiny's width) through each checkout's ``ops/verify.py``, on a
    seeded tied embedding (N(0, 0.05), and its int8 copy), suppress /
    begin-suppress masks and the EOS decay on."""
    from whisper_medusa_tpu_torch.ops import verify as VF

    mods = {"other": _other_ops(root, "verify", libs["other"]), "this": VF}
    v, d, eos = 51865, 1280, 50257
    rnd = lambda *shape, scale=0.02: (torch.randn(shape, generator=g, device="cuda")
                                      * scale).to(torch.bfloat16)
    emb = rnd(v, d, scale=0.05)
    q, s = QM.quantize_array(emb, axis=-1)
    embeds = {"bf16": emb, "int8": {"q": q.contiguous(), "s": s.contiguous()}}
    masks = torch.zeros((2, v), dtype=torch.int8, device="cuda")
    masks[0, torch.randint(0, v, (300,), generator=g, device="cuda")] = 1
    masks[1, torch.randint(0, v, (40,), generator=g, device="cuda")] = 1
    kw = dict(begin_index=4, eos_id=eos, decay=(9, 1.2))
    meta = lambda r: ((3 + torch.arange(r, device="cuda") % 12).to(torch.int32),
                      torch.randint(0, v, (r,), generator=g, device="cuda").to(torch.int32))
    for mode, e in embeds.items():
        for r in K5_ROWS:
            hs = rnd(r, d, scale=1.0)
            pos, gcol = meta(r)
            calls = {who: (lambda mod=mod: mod.verify_rows_kernel(hs, e, pos, gcol, masks, **kw))
                     for who, mod in mods.items()}
            note = _agree(f"K5 {mode} R={r}", calls["this"](), calls["other"]())
            _turns(f"K5 verify_rows {mode} R={r}, {note}", calls, "wm_verify_rows", libs)
    n = 11
    for width, mode, id0 in ((d, "bf16", False), (d, "int8", False), (d, "bf16", True),
                             (d, "int8", True), (384, "bf16", False)):
        nh = 11 - id0
        hw, hb = rnd(nh, width, width), rnd(nh, width)
        e = embeds[mode]
        if width != d:
            e = rnd(v, width, scale=0.05)
        if mode == "int8":
            q, s = QM.quantize_array(hw, axis=-2)
            hw = {"q": q.contiguous(), "s": s.contiguous()}
        hid, src = rnd(1, n, width, scale=1.0), rnd(1, n, width, scale=1.0)
        if not id0:
            src = hid
        r = (nh + id0) * n
        pos = (5 + torch.arange(n, device="cuda")[None, :]
               + torch.arange(nh + id0, device="cuda")[:, None]).reshape(-1).to(torch.int32)
        gcol = meta(r)[1]
        calls = {who: (lambda mod=mod: mod.verify_hidden_kernel(
            hid, src, hw, hb, e, pos, gcol, masks, identity0=id0, **kw))
            for who, mod in mods.items()}
        what = (f"K4 verify_hidden {'quant' if mode == 'int8' else 'bf16'}"
                f"{' identity0' if id0 else ''}{f' D={width}' if width != d else ''} R={r}")
        note = _agree(what, calls["this"](), calls["other"]())
        _turns(f"{what}, {note}", calls, "wm_verify_hidden", libs, part=STAGE_A)


# Stage A's kernel by name in either build (the WMMA GEMM of the older
# builds, the weight-streaming GEMM's heads mode since).
STAGE_A = ("skinny_gemm_kernel", "wgemm_kernel")
# wm_head_rows: (D, first head, last head + 1, M): head 0 at M = 88 (pass A
# at B=8), the draft heads at M = 8 (pass B) and M = 1 (the prefill at
# B=1), every head at M = 11 (K4's stage A at B=1), and whisper tiny's.
HEAD_SHAPES = ((1280, 0, 1, 88), (1280, 1, 11, 8), (1280, 1, 11, 1), (1280, 0, 11, 11),
               (384, 0, 1, 88), (384, 1, 11, 8))


def _head_rows(root, libs, g):
    """``wm_head_rows`` through each checkout's ``ops/verify.py`` at
    HEAD_SHAPES, bf16 and int8 heads (seeded N(0, 0.02), 11 of them), the
    source rows N(0, 1); the stage-A kernel's device time with the L2
    flushed before each call (11 bf16 heads, 36 MB, would stay in the 50 MB
    L2 across back-to-back calls), beside the three-call yardstick
    (baddbmm, silu, add; on a bf16 copy of int8 heads) the same way.  The
    builds' rows must agree within 3e-2 (3e-2 |x|): they may sum in other
    orders."""
    from whisper_medusa_tpu_torch.ops import verify as VF

    mods = {"other": _other_ops(root, "verify", libs["other"]), "this": VF}
    rnd = lambda *shape, scale=0.02: (torch.randn(shape, generator=g, device="cuda")
                                      * scale).to(torch.bfloat16)
    for d in sorted({d for d, *_ in HEAD_SHAPES}, reverse=True):
        w16, b = rnd(11, d, d), rnd(11, d)
        q, s = QM.quantize_array(w16, axis=-2)
        heads = {"bf16": w16, "int8": {"q": q.contiguous(), "s": s.contiguous()}}
        for mode, w in heads.items():
            for _, lo, hi, m in (x for x in HEAD_SHAPES if x[0] == d):
                hw = QM.wmap(w, lambda a: a[lo:hi])
                hb = b[lo:hi]
                src = rnd(m, d, scale=1.0)
                calls = {who: (lambda mod=mod: mod.head_rows_kernel(src, hw, hb))
                         for who, mod in mods.items()}
                a, o = calls["this"](), calls["other"]()
                bits = torch.equal(a, o)
                diff = float((a.float() - o.float()).abs().max())
                if not bool(((a.float() - o.float()).abs()
                             <= 3e-2 + 3e-2 * o.float().abs()).all()):
                    raise AssertionError(f"head_rows {mode} D={d} M={m}: the builds differ "
                                         f"by {diff}")
                wy = ((hw["q"].float() * hw["s"][:, None, :]).to(torch.bfloat16)
                      if mode == "int8" else hw)
                yard = lambda: src[None] + torch.nn.functional.silu(
                    torch.baddbmm(hb[:, None, :], src[None].expand(hb.shape[0], -1, -1), wy))
                lib = _cold_ms(yard)
                _turns(f"head_rows {mode} D={d} heads {lo}..{hi - 1} M={m} (baddbmm / silu / "
                       f"add: device {lib:.4f} ms, L2 flushed), builds differ by {diff:.3e}, "
                       f"bitwise equal {bits}", calls, "wm_head_rows", libs, part=STAGE_A,
                       cold=True)


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
        if not torch.equal(ys["this"], ys["other"]):
            raise AssertionError(f"K7 M={m}: the builds' outputs differ")
        e16 = eq.to(torch.bfloat16)
        lib = sum(us for us, _ in _by_kernel(lambda: x @ e16.T, 20).values()) / 1e3
        del e16
        _turns(f"K7 qmm_nt M={m} x ({v},{d}) (x @ E.T on a bf16 copy: device {lib:.4f} "
               f"ms), max error this {errs['this']:.3e} other {errs['other']:.3e}, builds "
               f"bitwise equal", calls)


def _k3(libs, g):
    """K3, ``wm_logits``, on a seeded bf16 embedding at large-v2's (51865,
    1280), M = 10 and 80, beside ``x @ E.T`` (device ms)."""
    from whisper_medusa_tpu_torch.ops import logits as LG

    v, d = 51865, 1280
    e = (torch.randn((v, d), generator=g, device="cuda") * 0.05).to(torch.bfloat16)
    for m in K3_ROWS:
        x = torch.randn((m, d), generator=g, device="cuda").to(torch.bfloat16)
        ys = {who: torch.empty((m, v), device="cuda") for who in libs}
        calls = {who: (lambda mod=mod, y=ys[who]: mod.launch(
            "wm_logits", x.device, x.data_ptr(), e.data_ptr(), y.data_ptr(), m, v, d))
            for who, mod in libs.items()}
        for fn in calls.values():
            fn()
        ref = LG.project_plain(x, e)
        errs = {who: float((y - ref).abs().max()) for who, y in ys.items()}
        if max(errs.values()) > 1e-3 * float(ref.abs().max()):
            raise AssertionError(f"K3 M={m}: a build is off the plain version: {errs}")
        lib = sum(us for us, _ in _by_kernel(lambda: x @ e.T, 20).values()) / 1e3
        _turns(f"K3 logits M={m} x ({v},{d}) (x @ E.T: device {lib:.4f} ms), max error "
               f"this {errs['this']:.3e} other {errs['other']:.3e}", calls)


def _k3f32(libs, g):
    """K3's f32 mode, ``wm_logits_f32``, on a seeded f32 embedding at
    large-v2's (51865, 1280), M = 1, 10, 80, 121 and 300, beside ``x @ E.T``
    (device ms); the builds' outputs bitwise equal (or it raises), each
    within 1e-4 + 1e-4 |y| of the plain version."""
    from whisper_medusa_tpu_torch.ops import logits as LG

    v, d = 51865, 1280
    e = torch.randn((v, d), generator=g, device="cuda") * 0.05
    for m in K3F32_ROWS:
        x = torch.randn((m, d), generator=g, device="cuda")
        ys = {who: torch.empty((m, v), device="cuda") for who in libs}
        calls = {who: (lambda mod=mod, y=ys[who]: mod.launch(
            "wm_logits_f32", x.device, x.data_ptr(), e.data_ptr(), y.data_ptr(), m, v, d))
            for who, mod in libs.items()}
        for fn in calls.values():
            fn()
        ref = LG.project_plain(x, e)
        errs = {who: float((y - ref).abs().max()) for who, y in ys.items()}
        if any(not bool(((y - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())
               for y in ys.values()):
            raise AssertionError(f"K3 f32 M={m}: a build is off the plain version: {errs}")
        same = torch.equal(ys["this"], ys["other"])
        if not same:
            raise AssertionError(f"K3 f32 M={m}: the builds' logits are not bitwise equal")
        lib = sum(us for us, _ in _by_kernel(lambda: x @ e.T, 20).values()) / 1e3
        _turns(f"K3 f32 logits M={m} x ({v},{d}) (x @ E.T: device {lib:.4f} ms), max error "
               f"this {errs['this']:.3e} other {errs['other']:.3e}, builds bitwise equal "
               f"{same}", calls)
        del ys, ref


def _k9f32(root, libs, g):
    """K9's f32 mode, ``wm_attention_bwd_f32``, at the training paths' three
    shapes and the smoke's three off-path cases, from this build's K1 f32
    output and log-sum-exp; a build whose entry takes the dQ partials gets
    ``ops/attention.py::bwd_scratch_shape``'s scratch.  dK / dV bitwise
    equal between the builds or not (printed), dQ's relative difference,
    each build within 1e-5 relative of attention_bwd_lse_plain; beside it
    the SDPA f32 backward (efficient-attention) device time."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from whisper_medusa_tpu_torch.ops import attention as A

    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
    for (b, h, sq, skv), kv_len, causal in K9F32_CASES:
        rnd = lambda s, scale=1.0: torch.randn((b, h, s, 64), generator=g, device="cuda") * scale
        q, k, v, do = rnd(sq, 0.25), rnd(skv), rnd(skv), rnd(sq)
        o, lse = A.attention_kernel(q, k, v, kv_len, causal, return_lse=True)
        outs, calls = {}, {}
        for who, mod in libs.items():
            grads = [torch.empty_like(t) for t in (q, k, v)]
            bufs = [torch.empty((b, h, sq), device="cuda")]
            if len(mod._SIGNATURES["wm_attention_bwd_f32"]) == 19:
                bufs.append(torch.empty(A.bwd_scratch_shape(b, h, sq, skv), device="cuda"))
            outs[who] = grads
            calls[who] = (lambda mod=mod, ptrs=[t.data_ptr() for t in (
                q, k, v, o, lse, do, *grads, *bufs)]: mod.launch(
                "wm_attention_bwd_f32", q.device, *ptrs, b, h, sq, skv, 64, kv_len, int(causal)))
        for fn in calls.values():
            fn()
        ref = A.attention_bwd_lse_plain(q, k, v, o, lse, do, kv_len, causal)
        errs = {who: max(rel(a, c) for a, c in zip(got, ref)) for who, got in outs.items()}
        if max(errs.values()) > 1e-5:
            raise AssertionError(f"K9 f32 ({b},{h},{sq}x{skv}): a build is off the plain "
                                 f"version: {errs}")
        same = [torch.equal(outs["this"][i], outs["other"][i]) for i in (1, 2)]
        dq_diff = rel(outs["this"][0], outs["other"][0])
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=1.0,
                                                                   is_causal=causal)
        lib = sum(us for us, _ in _by_kernel(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 20).values()) / 1e3
        _turns(f"K9 f32 attention_bwd ({b},{h},{sq}x{skv},64) kv_len {kv_len} causal {causal} "
               f"(SDPA f32 backward: device {lib:.4f} ms), relative error this {errs['this']:.2e}"
               f" other {errs['other']:.2e}, dK / dV bitwise the other build's {same}, dQ's "
               f"relative difference {dq_diff:.2e}", calls)
        del outs, calls, out, leaves


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


def _attention_ms(rows):
    """K2's attention kernels, its ``ln_rows_kernel`` and its GEMM's
    instantiations in a profile (``_by_kernel`` rows): {name: (ms, launches)
    a step}, by their names in either build (the cluster body's
    ``cross_decode_kernel``, or the chunked cross partials, their combine
    and the self-attention kernel)."""
    keep = ("cross_decode_kernel", "cross_partial_kernel", "cross_combine_kernel",
            "self_attn_kernel", "ln_rows_kernel", "wgemm_kernel")
    return {k: (us / 1e3, n) for k, (us, n) in rows.items() if k.startswith(keep)}


def _k2(root, libs, g):
    """K2, ``wm_megastep_step``, through each checkout's own
    ``ops/megastep.py::megastep_kernel`` (loaded from that checkout, calling
    its library: the pointer tables differ) on the same inputs: 32 seeded
    large-v2 layers, bf16, int8 (``quantize_layers``) and the bf16 block
    mode, at (B, T) in K2_ROWS, offsets 20 on a 460-row cache.  Besides
    events, device ms and the C entry's host time
    (``device_profile._entry_host_ms``), each turn prints its attention
    kernels' device ms a step by name.  The builds' hidden states must
    agree at cosine >= 0.999 (their sums differ in order, and 32 layers
    compound the roundings)."""
    from whisper_medusa_tpu_torch.device_profile import _entry_host_ms
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS

    mods = {"other": _other_ops(root, "megastep", libs["other"]), "this": MS}
    nl, h, s_enc, s_len, d = 32, 20, 1500, 460, 1280
    layers, ln_post = _random_layers(g, nl)
    qlayers = QM.quantize_layers(layers)
    block = whisper.layer_params(_random_layers(g, 1)[0], 0)
    for quant, blk in ((False, None), (True, None), (False, block)):
        for b, t in K2_ROWS:
            n = nl + (blk is not None)
            if quant:
                i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g,
                                                  device="cuda", dtype=torch.int8)
                scl = lambda *shape: 0.004 + 0.012 * torch.rand(shape, generator=g,
                                                                device="cuda")
                sk, sv = i8(n, b, s_len, d), i8(n, b, s_len, d)
                ck, cv = i8(n, b, h, 64, s_enc), i8(n, b, s_enc, d)
                kw = dict(self_s=scl(n, b, s_len, 2 * h).to(torch.bfloat16),
                          cross_k_s=scl(n, b, h, s_enc), cross_v_s=scl(n, b, h, s_enc))
            else:
                rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(
                    torch.bfloat16)
                sk, sv = rnd(n, b, s_len, d), rnd(n, b, s_len, d)
                ck, cv = rnd(n, b, h, 64, s_enc), rnd(n, b, s_enc, d)
                kw = {}
            x = torch.randn((b, t, d), generator=g, device="cuda").to(torch.bfloat16)
            offs = torch.full((b,), 20, dtype=torch.int32, device="cuda")
            lay = qlayers if quant else layers
            outs, cells, attn = {}, [], []
            for who in ("other", "this", "this", "other"):
                mod = mods[who]
                run = lambda mod=mod: mod.megastep_kernel(lay, ln_post, x, sk, sv, ck, cv, offs,
                                                          None, s_enc, h, block=blk, **kw)
                outs.setdefault(who, run()[1].float())
                ev = _cuda_ms(run)
                rows = _by_kernel(run, 5)
                dev = sum(us for us, _ in rows.values()) / 1e3
                host = _entry_host_ms(run, "wm_megastep_step", lib=libs[who])
                cells.append(f"{who} {ev:.4f} / {dev:.4f} / {host:.4f}")
                attn.append(f"{who} " + ", ".join(
                    f"{k} {ms:.4f} ({n:.0f})"
                    for k, (ms, n) in sorted(_attention_ms(rows).items())))
            cos = float(torch.nn.functional.cosine_similarity(
                outs["this"].reshape(1, -1), outs["other"].reshape(1, -1)))
            if cos < 0.999:
                raise AssertionError(f"K2 ({b},{t}): the builds' hidden states at cosine {cos}")
            mode = ("int8" if quant else "bf16") + (" block" if blk is not None else "")
            print(f"K2 megastep {mode} (B, T) = ({b}, {t}), {n} slots, builds at cosine "
                  f"{cos:.6f}, bitwise equal {torch.equal(outs['this'], outs['other'])}: "
                  "events / device / C-entry host ms: " + ", ".join(cells), flush=True)
            print(f"K2 megastep {mode} (B, T) = ({b}, {t}): attention, ln_rows and GEMM "
                  "kernels, device ms a step (launches): " + "; ".join(attn), flush=True)
            del sk, sv, ck, cv



def _close32(y, ref):
    return bool(((y - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())


def _k1f32(libs, g):
    """K1's f32 mode, ``wm_attention_fwd_f32``, at K1F32_CASES through each
    build's C entry on the same inputs and output buffers, beside SDPA in
    f32 (TF32 off).  Each build within 1e-4 + 1e-4 |y| of attention_plain,
    its log-sum-exp within 1e-3 of attention_lse_plain; whether the builds'
    outputs are bitwise equal is printed."""
    from whisper_medusa_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    for (b, h, sq, skv), kv_len, causal in K1F32_CASES:
        q = torch.randn((b, h, sq, 64), generator=g, device="cuda") * 0.125
        k, v = (torch.randn((b, h, skv, 64), generator=g, device="cuda") for _ in range(2))
        outs = {who: (torch.empty_like(q), torch.empty((b, h, sq), device="cuda"))
                for who in libs}
        calls = {who: (lambda mod=mod, o=outs[who]: mod.launch(
            "wm_attention_fwd_f32", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o[0].data_ptr(), o[1].data_ptr(), b, h, sq, skv, 64, kv_len, int(causal)))
            for who, mod in libs.items()}
        for fn in calls.values():
            fn()
        ref, lref = A.attention_plain(q, k, v, kv_len, causal), A.attention_lse_plain(
            q, k, kv_len, causal)
        errs = {who: (float((o - ref).abs().max()), float((lse - lref).abs().max()))
                for who, (o, lse) in outs.items()}
        if any(not _close32(o, ref) or e[1] > 1e-3 for (o, _), e in zip(outs.values(),
                                                                         errs.values())):
            raise AssertionError(f"K1 f32 ({b},{h},{sq},{skv}): a build is off the plain "
                                 f"version: {errs}")
        same = torch.equal(outs["this"][0], outs["other"][0])
        lib = "none"
        if kv_len == skv and (not causal or sq == skv):
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=1.0, is_causal=causal)
            lib = f"{sum(us for us, _ in _by_kernel(sdpa, 20).values()) / 1e3:.4f} ms"
        _turns(f"K1 f32 attention ({b},{h},{sq}x{skv},64) kv_len {kv_len} causal {causal} (SDPA "
               f"f32: device {lib}), max error this {errs['this'][0]:.2e} (lse "
               f"{errs['this'][1]:.2e}) other {errs['other'][0]:.2e} (lse "
               f"{errs['other'][1]:.2e}), builds bitwise equal {same}", calls)
        del outs, calls


def _f32_mods(root, libs):
    """Each build's ``ops/decode_ops.py`` and ``ops/verify.py`` (the other
    checkout's verify module calling the other checkout's decode_ops, so
    that its f32 head rows and its K4 scratch are its own)."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO
    from whisper_medusa_tpu_torch.ops import verify as VF

    odo = _other_ops(root, "decode_ops", libs["other"])
    ovf = _other_ops(root, "verify", libs["other"])
    ovf.decode_ops_mod = odo
    return {"other": (odo, ovf), "this": (DO, VF)}


def _gemm32(root, libs, g):
    """The f32 GEMM through each build's ``decode_ops.gemm_f32`` at
    GEMM32_ROWS x GEMM32_SHAPES (seeded N(0, 0.02) weights and bias, N(0, 1)
    rows), beside ``torch.addmm`` in f32, TF32 off (device ms), each build
    within 1e-4 + 1e-4 |y| of addmm; then K11's f32 mode through each
    build's ``ffn_decode_kernel`` at K11F32_ROWS, each within 1e-4 + 1e-4
    |y| of ffn_decode_plain."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mods = _f32_mods(root, libs)
    for k, n in GEMM32_SHAPES:
        w = torch.randn((k, n), generator=g, device="cuda") * 0.02
        bias = torch.randn((n,), generator=g, device="cuda") * 0.02
        for m in GEMM32_ROWS:
            x = torch.randn((m, k), generator=g, device="cuda")
            calls = {who: (lambda do=do: do.gemm_f32(x, w, bias))
                     for who, (do, _) in mods.items()}
            ref = torch.addmm(bias, x, w)
            ys = {who: fn() for who, fn in calls.items()}
            if any(not _close32(y, ref) for y in ys.values()):
                raise AssertionError(f"f32 GEMM M={m} {k}x{n}: a build is off addmm")
            diff = float((ys["this"] - ys["other"]).abs().max())
            lib = sum(us for us, _ in _by_kernel(lambda: torch.addmm(bias, x, w), 20).values())
            _turns(f"f32 GEMM gemm_f32 M={m} {k}x{n} (addmm f32: device {lib / 1e3:.4f} ms), "
                   f"builds differ by {diff:.2e}", calls, part=GEMM32_KERNELS)
    d, f = 1280, 5120
    w1, b1, w2, b2 = (torch.randn(s, generator=g, device="cuda") * 0.02
                      for s in ((d, f), (f,), (f, d), (d,)))
    for m in K11F32_ROWS:
        x = torch.randn((m, d), generator=g, device="cuda")
        calls = {who: (lambda do=do: do.ffn_decode_kernel(x, w1, b1, w2, b2))
                 for who, (do, _) in mods.items()}
        ref = mods["this"][0].ffn_decode_plain(x, w1, b1, w2, b2)
        ys = {who: fn() for who, fn in calls.items()}
        if any(not _close32(y, ref) for y in ys.values()):
            raise AssertionError(f"K11 f32 M={m}: a build is off ffn_decode_plain")
        _turns(f"K11 f32 ffn_decode M={m} D={d} F={f}, builds differ by "
               f"{float((ys['this'] - ys['other']).abs().max()):.2e}", calls,
               part=GEMM32_KERNELS)


def _heads32(root, libs, g):
    """The f32 head rows (``wm_head_rows``' f32 mode) through each build's
    ``verify.head_rows_kernel`` at HEAD32_SHAPES on 11 seeded f32 heads (N(0,
    0.02)), the L2 flushed before each call, beside the baddbmm / silu / add
    yardstick; then K4's f32 mode at R = 121 (11 heads x 11 nodes, f32
    embedding N(0, 0.05) at large-v2's (51865, 1280)) with its stage A's
    kernels by name.  Rows within 1e-4 + 1e-4 |y| of head_rows_plain; K4's
    statistics as _agree holds them."""
    mods = _f32_mods(root, libs)
    v, d, eos = 51865, 1280, 50257
    hw = torch.randn((11, d, d), generator=g, device="cuda") * 0.02
    hb = torch.randn((11, d), generator=g, device="cuda") * 0.02
    for lo, hi, m in HEAD32_SHAPES:
        src = torch.randn((m, d), generator=g, device="cuda")
        w, b = hw[lo:hi], hb[lo:hi]
        calls = {who: (lambda vf=vf: vf.head_rows_kernel(src, w, b))
                 for who, (_, vf) in mods.items()}
        ref = mods["this"][1].head_rows_plain(src, w, b)
        ys = {who: fn() for who, fn in calls.items()}
        if any(not _close32(y, ref) for y in ys.values()):
            raise AssertionError(f"f32 head rows heads {lo}..{hi - 1} M={m}: a build is off")
        yard = lambda: src[None] + torch.nn.functional.silu(
            torch.baddbmm(b[:, None, :], src[None].expand(b.shape[0], -1, -1), w))
        _turns(f"head_rows f32 heads {lo}..{hi - 1} M={m} (baddbmm / silu / add: device "
               f"{_cold_ms(yard):.4f} ms, L2 flushed), builds differ by "
               f"{float((ys['this'] - ys['other']).abs().max()):.2e}", calls,
               part=GEMM32_KERNELS, cold=True)
    emb = torch.randn((v, d), generator=g, device="cuda") * 0.05
    masks = torch.zeros((2, v), dtype=torch.int8, device="cuda")
    n = 11
    hid = torch.randn((1, n, d), generator=g, device="cuda")
    pos = (5 + torch.arange(n, device="cuda")[None, :]
           + torch.arange(11, device="cuda")[:, None]).reshape(-1).to(torch.int32)
    gcol = torch.randint(0, v, (11 * n,), generator=g, device="cuda").to(torch.int32)
    kw = dict(identity0=False, begin_index=4, eos_id=eos, decay=(9, 1.2))
    calls = {who: (lambda vf=vf: vf.verify_hidden_kernel(hid, hid, hw, hb, emb, pos, gcol,
                                                         masks, **kw))
             for who, (_, vf) in mods.items()}
    note = _agree("K4 f32 R=121", calls["this"](), calls["other"]())
    _turns(f"K4 f32 verify_hidden R=121 (stage A: the f32 GEMM), {note}", calls,
           part=GEMM32_KERNELS)


def _bitwise(what, got, ref):
    """K4 / K5 outputs of the two builds (argmax, max, lse, gathered)
    bitwise equal, their bit patterns compared (a NaN equals the same
    NaN), or raise."""
    names = ("argmax", "max", "lse", "gathered")
    bits = lambda t: t.view(torch.int32)
    differ = [n for n, a, b in zip(names, got, ref) if not torch.equal(bits(a), bits(b))]
    if differ:
        raise AssertionError(f"{what}: the builds' {differ} are not bitwise equal")
    return "statistics bitwise the other build's"


def _k4k5f32(root, libs, g):
    """K5's f32 and W8A32 modes through each build's ``verify_rows_kernel``
    at K4K5F32_ROWS, and K4's at K4F32_CASES (R = 121: 11 heads x 11
    nodes, with ``identity0`` (10 heads + the hidden rows) and in the
    timestamp mode; R = 1024: one head x 1024 rows),
    on a seeded f32 embedding N(0, 0.05) at large-v2's (51865, 1280) and its
    int8 copy, f32 heads N(0, 0.02) (int8 at W8A32), suppress /
    begin-suppress masks and the EOS decay on, the timestamp rules' rows
    from seeded text and timestamp tokens.  The builds' statistics must be
    bitwise equal.  Each turn also prints the vocab stream's device time by
    kernel name (K4: the rest is stage A and the combine); beside K5, this
    build's K3 f32 and ``x @ E.T`` (TF32 off) on the same rows and the same
    f32 embedding (the dequantized copy at W8A32), the product's
    yardsticks: no one call computes the statistics."""
    from whisper_medusa_tpu_torch.ops import logits as LG
    from whisper_medusa_tpu_torch.ops import verify as VF

    torch.backends.cuda.matmul.allow_tf32 = False
    mods = _f32_mods(root, libs)
    v, d, eos, tb, no_ts = 51865, 1280, 50257, 50364, 50363
    emb = torch.randn((v, d), generator=g, device="cuda") * 0.05
    q, s = QM.quantize_array(emb, axis=-1)
    embeds = {"f32": (emb, emb), "W8A32": ({"q": q.contiguous(), "s": s.contiguous()},
                                           q.float() * s[:, None])}
    masks = torch.zeros((2, v), dtype=torch.int8, device="cuda")
    masks[0, torch.randint(0, v, (300,), generator=g, device="cuda")] = 1
    masks[1, torch.randint(0, v, (40,), generator=g, device="cuda")] = 1
    kw = dict(begin_index=4, eos_id=eos, decay=(9, 1.2))
    gcols = lambda r: torch.randint(0, v, (r,), generator=g, device="cuda").to(torch.int32)

    def tokens(r, none=False):
        text = torch.randint(0, eos, (r,), generator=g, device="cuda")
        stamp = tb + torch.randint(0, 1500, (r,), generator=g, device="cuda")
        pick = torch.rand((r,), generator=g, device="cuda") < 0.5
        return torch.where(pick, torch.zeros_like(text) if none else text, stamp).to(torch.int32)

    def ts_args(r, n_verif):
        return VF._ts_args((tb, no_ts, 50), n_verif, tokens(r), tokens(r), tokens(r, True), r,
                           torch.device("cuda"))

    for mode, (e, e32) in embeds.items():
        for r in K4K5F32_ROWS:
            hs = torch.randn((r, d), generator=g, device="cuda")
            pos = (3 + torch.arange(r, device="cuda") % 12).to(torch.int32)
            gcol = gcols(r)
            for ts in (None, ts_args(r, r)) if r == 88 else (None,):
                calls = {who: (lambda vf=vf: vf.verify_rows_kernel(hs, e, pos, gcol, masks,
                                                                   ts=ts, **kw))
                         for who, (_, vf) in mods.items()}
                what = f"K5 {mode} R={r}" + (" timestamp mode" if ts else "")
                note = _bitwise(what, calls["this"](), calls["other"]())
                k3 = sum(us for us, _ in _by_kernel(lambda: LG.project_kernel(hs, e32),
                                                    20).values()) / 1e3
                mm = sum(us for us, _ in _by_kernel(lambda: hs @ e32.T, 20).values()) / 1e3
                _turns(f"{what} (K3 f32: device {k3:.4f} ms, x @ E.T f32: device {mm:.4f} "
                       f"ms), {note}", calls, "wm_verify_rows_f32", libs, part=STREAM32)
            del hs
        for nh, n, id0, ts_on in K4F32_CASES:
            hw = torch.randn((nh, d, d), generator=g, device="cuda") * 0.02
            hb = torch.randn((nh, d), generator=g, device="cuda") * 0.02
            if mode == "W8A32":
                hq, hsc = QM.quantize_array(hw, axis=-2)
                hw = {"q": hq.contiguous(), "s": hsc.contiguous()}
            hid = torch.randn((1, n, d), generator=g, device="cuda")
            src = torch.randn((1, n, d), generator=g, device="cuda") if id0 else hid
            r = (nh + id0) * n
            # Positions within a decode window's (node % 12): past ~480 the
            # EOS decay's factor 1.2^(p - 9) overflows to inf.
            pos = (5 + torch.arange(n, device="cuda")[None, :] % 12
                   + torch.arange(nh + id0, device="cuda")[:, None]).reshape(-1).to(torch.int32)
            gcol = gcols(r)
            ts = ts_args(r, n) if ts_on else None
            calls = {who: (lambda vf=vf: vf.verify_hidden_kernel(
                hid, src, hw, hb, e, pos, gcol, masks, identity0=id0, ts=ts, **kw))
                for who, (_, vf) in mods.items()}
            what = (f"K4 {mode} R={r}" + (" identity0" if id0 else "")
                    + (" timestamp mode" if ts_on else ""))
            note = _bitwise(what, calls["this"](), calls["other"]())
            _turns(f"{what}, {note}", calls, "wm_verify_hidden_f32", libs, part=STREAM32)
            del hw


@contextlib.contextmanager
def _ops_as(name, mod):
    """``whisper_medusa_tpu_torch.ops.<name>`` is ``mod`` for the block: the
    other checkout's modules import their siblings inside functions."""
    import whisper_medusa_tpu_torch.ops as pkg

    key = f"whisper_medusa_tpu_torch.ops.{name}"
    old_mod, old_attr = sys.modules[key], getattr(pkg, name)
    sys.modules[key] = mod
    setattr(pkg, name, mod)
    try:
        yield
    finally:
        sys.modules[key] = old_mod
        setattr(pkg, name, old_attr)


def _k10f32(root, libs, g):
    """K10's f32 modes through each build's ``ops/decode_ops.py`` at T = 11
    and T = 1 and B in K10F32_BATCH: the f32 cross mode and the W8A32 mode
    at (B, 20, T, 64) x 1500 (int8 K/V with f32 scales as chip_smoke.py
    draws them), the f32 mask mode at (B, T, 20 heads) x 460, offsets
    3-400; each build within
    1e-4 + 1e-4 |y| of the plain version, whether their outputs are bitwise
    equal printed, f32 SDPA (on the dequantized, head-major K / V; with the
    step's mask) beside, TF32 off; the kernels by name."""
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    torch.backends.cuda.matmul.allow_tf32 = False
    mods = {"other": _other_ops(root, "decode_ops", libs["other"]), "this": DO}
    for b in K10F32_BATCH:
        _k10f32_batch(mods, g, b)


def _k10f32_batch(mods, g, b):
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    h, s_len, s_self = 20, 1500, 460
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device="cuda") * scale
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device="cuda",
                                      dtype=torch.int8)
    scl = lambda: 0.004 + 0.012 * torch.rand((b, h, s_len), generator=g, device="cuda")
    k, v = rnd(b, h, 64, s_len), rnd(b, s_len, h * 64)
    k8, v8, sc = i8(b, h, 64, s_len), i8(b, s_len, h * 64), (scl(), scl())
    ks, vs = rnd(b, s_self, h * 64), rnd(b, s_self, h * 64)
    offs = torch.linspace(3, 400, b, device="cuda").round().to(torch.int32)
    for t in (11, 1):
        q = rnd(b, h, t, 64, scale=0.125)
        qs = rnd(b, t, h, 64, scale=0.125)
        bits = DO.chunk_bits(None, t, "cuda")
        kd = (k8.float() * sc[0][:, :, None, :]).transpose(2, 3).contiguous()
        vd = (v8.float().reshape(b, s_len, h, 64).transpose(1, 2) * sc[1][..., None]).contiguous()
        kh = k.transpose(2, 3).contiguous()
        vh = v.reshape(b, s_len, h, 64).transpose(1, 2).contiguous()
        mask = whisper.make_step_mask(offs, t, s_self, None)
        qsh = qs.transpose(1, 2).contiguous()
        ksh, vsh = (a.reshape(b, s_self, h, 64).transpose(1, 2).contiguous() for a in (ks, vs))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        cases = (
            ("f32", lambda do: do.cross_attention_decode_kernel(q, k, v, s_len),
             DO.cross_attention_decode_plain(q, k, v, s_len),
             lambda: sdpa(q, kh, vh, scale=1.0)),
            ("w8a32", lambda do: do.cross_attention_decode_kernel(q, k8, v8, s_len, *sc),
             DO.cross_attention_decode_plain(q, k8, v8, s_len, *sc),
             lambda: sdpa(q, kd, vd, scale=1.0)),
            ("f32 mask", lambda do: do.self_attention_decode_kernel(qs, ks, vs, offs, bits),
             DO.self_attention_decode_plain(qs, ks, vs, offs, None),
             lambda: sdpa(qsh, ksh, vsh, attn_mask=mask, scale=1.0)))
        for mode, fn, ref, lib in cases:
            calls = {who: (lambda do=do: fn(do)) for who, do in mods.items()}
            ys = {who: c() for who, c in calls.items()}
            if any(not _close32(y, ref) for y in ys.values()):
                errs = {who: float((y - ref).abs().max()) for who, y in ys.items()}
                raise AssertionError(f"K10 {mode} T={t}: a build is off the plain version: "
                                     f"{errs}")
            lib_ms = sum(us for us, _ in _by_kernel(lib, 20).values()) / 1e3
            shape = (f"({b}, T={t}, 20 heads) x {s_self}" if mode == "f32 mask" else
                     f"({b},20,{t},64) x {s_len}")
            _turns(f"K10 {mode} {shape} (SDPA f32: device {lib_ms:.4f} ms), builds bitwise "
                   f"equal {torch.equal(ys['this'], ys['other'])}", calls, part=ATTN32_KERNELS)


def _w8_weight(g, k, n, nh=None):
    """A seeded N(0, 0.02) f32 weight, (k, n) or (nh, k, n), as int8 values
    and f32 column scales (``qmm.quantize_array``), and its dequantized f32
    copy."""
    w = torch.randn(((nh,) if nh else ()) + (k, n), generator=g, device="cuda") * 0.02
    q, s = QM.quantize_array(w)
    return q.contiguous(), s.contiguous(), (q.float() * s.unsqueeze(-2)).contiguous()


def _gemm_w8(root, libs, g):
    """The W8A32 GEMM alone through each build's
    ``decode_ops.gemm_w8a32_launch`` at W8_ROWS x GEMM32_SHAPES (a bias on),
    each build within 1e-4 + 1e-4 |y| of ``torch.addmm`` in f32 on the
    dequantized copy (TF32 off), whose device time is printed beside with
    this build's f32 GEMM on the same copy (``gemm_f32``)."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    torch.backends.cuda.matmul.allow_tf32 = False
    mods = {"other": _other_ops(root, "decode_ops", libs["other"]), "this": DO}
    for k, n in GEMM32_SHAPES:
        q, s, wd = _w8_weight(g, k, n)
        bias = torch.randn((1, n), generator=g, device="cuda") * 0.02
        for m in W8_ROWS:
            x = torch.randn((m, k), generator=g, device="cuda")
            calls = {who: (lambda do=do: do.gemm_w8a32_launch(x, q[None], s[None], bias,
                                                               DO.EPI_BIAS))
                     for who, do in mods.items()}
            ref = torch.addmm(bias[0], x, wd)
            ys = {who: fn()[0] for who, fn in calls.items()}
            if any(not _close32(y, ref) for y in ys.values()):
                raise AssertionError(f"W8A32 GEMM M={m} {k}x{n}: a build is off addmm")
            lib = sum(us for us, _ in _by_kernel(lambda: torch.addmm(bias[0], x, wd), 20)
                      .values()) / 1e3
            f32 = sum(us for us, _ in _by_kernel(lambda: DO.gemm_f32(x, wd, bias[0]), 20)
                      .values()) / 1e3
            _turns(f"W8A32 GEMM M={m} {k}x{n} (addmm f32 on the dequantized copy: device "
                   f"{lib:.4f} ms; this build's f32 GEMM on it: {f32:.4f} ms), builds bitwise "
                   f"equal {torch.equal(ys['this'], ys['other'])}", calls, part=W8_KERNELS)


def _heads_w8(root, libs, g):
    """The int8 head rows (``wm_head_rows``' W8A32 mode, row 4aq32) through
    each build's ``verify.head_rows_kernel`` at HEAD32_SHAPES on 11 seeded
    int8 heads (N(0, 0.02) quantized), the L2 flushed before each call,
    beside the baddbmm / silu / add yardstick on the dequantized heads; then
    K4 at R = 121 on int8 heads and an int8 embedding (row 4q32) with its
    stage A's kernels by name."""
    mods = _f32_mods(root, libs)
    v, d, eos = 51865, 1280, 50257
    hq, hs, hd = _w8_weight(g, d, d, 11)
    hb = torch.randn((11, d), generator=g, device="cuda") * 0.02
    heads = {"q": hq, "s": hs}
    for lo, hi, m in HEAD32_SHAPES:
        src = torch.randn((m, d), generator=g, device="cuda")
        w = {"q": hq[lo:hi].contiguous(), "s": hs[lo:hi].contiguous()}
        b = hb[lo:hi]
        calls = {who: (lambda vf=vf: vf.head_rows_kernel(src, w, b))
                 for who, (_, vf) in mods.items()}
        ref = mods["this"][1].head_rows_plain(src, w, b)
        ys = {who: fn() for who, fn in calls.items()}
        if any(not _close32(y, ref) for y in ys.values()):
            raise AssertionError(f"int8 head rows heads {lo}..{hi - 1} M={m}: a build is off")
        yard = lambda: src[None] + torch.nn.functional.silu(
            torch.baddbmm(b[:, None, :], src[None].expand(b.shape[0], -1, -1), hd[lo:hi]))
        _turns(f"head_rows w8a32 heads {lo}..{hi - 1} M={m} (baddbmm / silu / add on the "
               f"dequantized heads: device {_cold_ms(yard):.4f} ms, L2 flushed), builds bitwise "
               f"equal {torch.equal(ys['this'], ys['other'])}", calls, part=W8_KERNELS,
               cold=True)
    eq, es = QM.quantize_array(torch.randn((v, d), generator=g, device="cuda") * 0.05, axis=-1)
    emb = {"q": eq.contiguous(), "s": es.contiguous()}
    masks = torch.zeros((2, v), dtype=torch.int8, device="cuda")
    n = 11
    hid = torch.randn((1, n, d), generator=g, device="cuda")
    pos = (5 + torch.arange(n, device="cuda")[None, :]
           + torch.arange(11, device="cuda")[:, None]).reshape(-1).to(torch.int32)
    gcol = torch.randint(0, v, (11 * n,), generator=g, device="cuda").to(torch.int32)
    kw = dict(identity0=False, begin_index=4, eos_id=eos, decay=(9, 1.2))
    calls = {who: (lambda vf=vf: vf.verify_hidden_kernel(hid, hid, heads, hb, emb, pos, gcol,
                                                         masks, **kw))
             for who, (_, vf) in mods.items()}
    note = _agree("K4 W8A32 R=121", calls["this"](), calls["other"]())
    _turns(f"K4 W8A32 verify_hidden R=121 (stage A: the W8A32 GEMM), {note}", calls,
           part=W8_KERNELS)


def _k2w8(root, libs, g):
    """K2's W8A32 mode, ``wm_megastep_w8a32``, through each checkout's own
    ``ops/megastep.py::megastep_kernel`` (its decode_ops the checkout's
    own) on the same inputs: 32 seeded large-v2 layers as the int8 copy of
    an f32 model (f32 norms and biases, int8 streamed weights), int8 caches
    as chip_smoke.py draws them, at (B, T) in K2_ROWS, then the block mode
    at (1, 11); offsets 20 on a 460-row cache.  Each turn prints events /
    device / C-entry host ms, then the device ms a step of the GEMM, the
    attention and the norms with their launches a layer.  The builds'
    hidden states must agree at cosine >= 0.999999."""
    from whisper_medusa_tpu_torch.device_profile import _entry_host_ms
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS

    odo = _other_ops(root, "decode_ops", libs["other"])
    mods = {"other": _other_ops(root, "megastep", libs["other"]), "this": MS}
    nl, h, s_enc, s_len, d = 32, 20, 1500, 460, 1280
    f32 = lambda t: {k: f32(v) if isinstance(v, dict) else v.float() for k, v in t.items()}
    layers, ln_post = _random_layers(g, nl)
    layers, ln_post = QM.quantize_layers(f32(layers)), f32(ln_post)
    block = QM.quantize_layers(f32(whisper.layer_params(_random_layers(g, 1)[0], 0)))
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device="cuda",
                                      dtype=torch.int8)
    scl = lambda *shape: 0.004 + 0.012 * torch.rand(shape, generator=g, device="cuda")
    for (b, t), blk in [(bt, None) for bt in K2_ROWS] + [((1, 11), block)]:
        n = nl + (blk is not None)
        c = dict(self_k=i8(n, b, s_len, d), self_v=i8(n, b, s_len, d),
                 cross_k=i8(n, b, h, 64, s_enc), cross_v=i8(n, b, s_enc, d))
        kw = dict(self_s=scl(n, b, s_len, 2 * h).to(torch.bfloat16),
                  cross_k_s=scl(n, b, h, s_enc), cross_v_s=scl(n, b, h, s_enc))
        x = torch.randn((b, t, d), generator=g, device="cuda")
        offs = torch.full((b,), 20, dtype=torch.int32, device="cuda")
        outs, cells, parts = {}, [], []
        for who in ("other", "this", "this", "other"):
            mod = mods[who]

            def run(mod=mod, who=who):
                with _ops_as("decode_ops", odo if who == "other" else
                             sys.modules["whisper_medusa_tpu_torch.ops.decode_ops"]):
                    return mod.megastep_kernel(layers, ln_post, x, c["self_k"], c["self_v"],
                                               c["cross_k"], c["cross_v"], offs, None, s_enc,
                                               h, block=blk, **kw)
            outs.setdefault(who, run()[1].float())
            ev = _cuda_ms(run)
            rows = _by_kernel(run, 5)
            dev = sum(us for us, _ in rows.values()) / 1e3
            host = _entry_host_ms(run, "wm_megastep_w8a32", lib=libs[who])
            cells.append(f"{who} {ev:.4f} / {dev:.4f} / {host:.4f}")
            fam = []
            for name, prefixes in K2W8_FAMILIES:
                sel = [(us, cnt) for k, (us, cnt) in rows.items() if k.startswith(prefixes)]
                fam.append(f"{name} {sum(u for u, _ in sel) / 1e3:.4f} "
                           f"({sum(cn for _, cn in sel) / n:.0f} a layer)")
            parts.append(f"{who} " + ", ".join(fam))
        cos = float(torch.nn.functional.cosine_similarity(
            outs["this"].reshape(1, -1), outs["other"].reshape(1, -1)))
        if cos < 0.999999:
            raise AssertionError(f"K2 W8A32 ({b},{t}): the builds' hidden states at cosine {cos}")
        mode = "W8A32" + (" block" if blk is not None else "")
        print(f"K2 megastep {mode} (B, T) = ({b}, {t}), {n} slots, builds at cosine {cos:.9f}, "
              f"bitwise equal {torch.equal(outs['this'], outs['other'])}: events / device / "
              "C-entry host ms: " + ", ".join(cells), flush=True)
        print(f"K2 megastep {mode} (B, T) = ({b}, {t}): device ms a step (launches a layer): "
              + "; ".join(parts), flush=True)
        del c, kw


# The sections main runs, in its default order; each draws its inputs from
# the one seeded generator, so a run of a subset gets other (seeded) inputs.
SECTIONS = {"K1": _k1, "K6": _k6, "K8": _k8, "K10": _k10,
            "K7": lambda root, libs, g: _k7(libs, g), "K3": lambda root, libs, g: _k3(libs, g),
            "K2": _k2, "K11": _k11, "K4K5": _verify, "head_rows": _head_rows,
            "K3f32": lambda root, libs, g: _k3f32(libs, g), "K9f32": _k9f32,
            "K1f32": lambda root, libs, g: _k1f32(libs, g), "GEMMf32": _gemm32,
            "heads32": _heads32, "K10f32": _k10f32, "GEMMw8a32": _gemm_w8,
            "heads_w8a32": _heads_w8, "K2w8a32": _k2w8, "K4K5f32": _k4k5f32}

if __name__ == "__main__":
    main()
