"""Where the device time goes, on one CUDA card.

    python -m whisper_medusa_tpu_torch.device_profile [--part serving|heads|per_op|step|train|all]

Six parts, all at full whisper-large-v2 width with bf16 weights drawn from
a seed, and the same again on ``model.quantize()`` (int8 serving) for parts
2, 3, 4 and 6 (``--part serving`` runs parts 1-4 and 6, ``--part heads``
part 3, ``--part per_op`` part 6, ``--part step`` part 6's per-op steps
alone, ``--part train`` part 5).
Run with another checkout's package first on ``PYTHONPATH`` (``PYTHONPATH=DIR
python path/to/this/device_profile.py ...``), it profiles that checkout's
code the same way:

  1. the log-mel frontend at B=1 and B=8 on seeded noise, the default plain
     PyTorch path and the fused kernel K8: device time by kernel beside the
     CUDA-event time of the call;
  2. one K2 call (all 32 decoder layers) at (B, T) in (1, 11), (8, 1) and
     (8, 11), bf16 and int8, and the same with the Medusa-Block layer (K2's
     block mode): device time per call by kernel (torch.profiler), beside
     the CUDA-event time of the call, the C entry's host time (CPU clock
     around the ctypes call, no synchronize), the projections' (the
     weight-streaming GEMM's) share and the kernels' durations added up
     (above the busy time by as much as programmatic dependent launch
     overlaps them), and K2's launches a call: how many GEMMs normalize
     their X themselves (the LN mode) and how many ``ln_rows_kernel``;
  3. the Medusa heads' rows (``wm_head_rows``, K4's stage A alone) at the
     loop's shapes: head 0 at M = 88 (pass A at B=8), the 10 draft heads at
     M = 8 (pass B) and M = 1 (the prefill at B=1), every head at M = 11,
     bf16 and int8; one K4 call at R = 121 (11 heads x 11 nodes) with its
     stage A by kernel; then one verification step at B=8 on the 11-node
     chain: the loop's two passes (K5 over the head-0 rows, then the draft
     heads through K3) against one pass of every (head, node) row through
     K5 (R = 968);
  4. whole requests of ``max_new_tokens=128`` from seeded random features:
     Medusa and vanilla (``disable_medusa=True``) at B=1 and B=8, and
     Medusa-Block at B=1 and B=8, bf16 and int8; then bf16 Medusa at B=1
     with ``return_timestamps=True``, and a longform request (75 s of
     seeded noise, the seek loop, 64 new tokens a window).  For each, the
     wall time without the profiler, then the device time by kernel under
     it, and the device's idle share: 1 - (device time) / (wall time
     without the profiler);
  5. training at B=2, T=224 (seeded features and labels, Adafactor, remat
     off), bf16 then f32 weights: one step of the Medusa-Block recipe and
     one full fine-tune step of base_head, each after a warm-up step: the
     wall time of a step without the profiler, the device time by kernel
     of the next (K1, K9 or their f32 modes, cuBLAS, the elementwise
     kernels), the idle share and the peak memory;
  6. past K2's batch: one per-op decoder step
     (``models/whisper.py::decoder_layers_ops``: cuBLAS or K6 projections,
     K10's mask mode for the self-attention, K10, K11) over all 32 layers at
     (B, T) in
     (8, 11), (16, 1) and (16, 11), bf16 and int8, and the same steps of
     whisper tiny (bf16, 4 layers) — the host wall of a call ending in a
     synchronize, the device time by kernel, the idle share and the
     launches per layer —
     and whole requests at B=16 as in part 4 (Medusa and vanilla bf16,
     Medusa int8, Medusa-Block bf16).

Kernels are listed by name without their template arguments, so PyTorch's
elementwise kernels of one kind share a line.  A kernel's device time is
its share of the device's busy time (``_by_kernel``): K2's kernels start
early under programmatic dependent launch and wait for the previous one,
and only the stretch past the previous kernels' end counts as theirs.  The Medusa heads, and the
Medusa-Block model (``models/bridge.py::random_block_model``), are drawn as
``chip_smoke.py`` draws them.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np
import torch

SEED = 0
MAX_NEW_TOKENS = 128


def _short(name: str) -> str:
    """A kernel's name without its argument list and template arguments (the
    port's kernels keep theirs: row tiles and int8 form, e.g.
    wgemm_kernel<6, true>, cross_decode_kernel<signed char, false, true>)."""
    m = re.search(r"wm::\(anonymous namespace\)::(\w+(?:<[^>]*>)?)\(", name)
    if m:
        return m.group(1)
    if "Memcpy" in name or "Memset" in name:
        return "memcpy / memset"
    return re.split(r"[<(]", name.removeprefix("void "), maxsplit=1)[0][:70]


def is_ln_gemm(name: str) -> bool:
    """Whether a kernel (``_short``'s name) is the weight-streaming GEMM in
    K2's LN mode: ``wgemm_kernel<MT, W8, true>``, or ``wgemm_kernel<MT, W8,
    true, false>`` since the heads mode became its fourth template
    parameter."""
    return re.fullmatch(r"wgemm_kernel<\d+, \w+, true(, false)?>", name) is not None


MARK = "spin_kernel"      # torch.cuda._sleep's kernel: the marker around each run
MARK_CYCLES = 1000        # its spin
LEAD = 1024               # markers before the first run (see _device_runs)
PAD_S = 0.02              # host wait after the profiler starts and before it stops
TRIES = 3                 # each retake waits 4x longer


def _trace(fn, reps: int, pad_s: float = PAD_S):
    """(name, start us, end us) of every kernel, memcpy and memset that
    ``LEAD`` markers, then ``reps`` runs of ``fn`` each followed by a
    marker, put on the card, in start order (torch.profiler, CUDA activity
    only, read from its trace).  The host waits ``pad_s`` after the
    profiler starts and again after the last synchronize."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(LEAD):
            torch.cuda._sleep(MARK_CYCLES)
        for _ in range(reps):
            fn()
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(pad_s)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return sorted(out, key=lambda e: e[1])


def _device_runs(fn, reps: int = 1, tries: int = TRIES):
    """The device events of ``reps`` runs of ``fn`` (``_trace``), one list a
    run, the markers left out.  On the H100 the profiler at times drops the
    first events of a trace while it keeps their launches: a whole request's
    trace lost its first event three times in a row, whatever the host
    waited, a lone kernel's trace lost everything, and in runs of
    chip_smoke.py traces lost up to 6 of 8, or up to 8 of 32, leading
    markers; once it dropped a trace's tail.  With 32 leading markers, 20
    runs of K2's W8A32 step (641 launches each) lost all 32 and ~650 more
    events, three traces in a row (a whole smoke's other traces lost 1-29
    of their 32), so ``LEAD`` is 1024.  A trace is whole when it
    starts with one or more markers (the leading ones may be lost, not all),
    ends with one, and holds one more marker for each run (a run puts at
    least one event on the card); else it is taken again with 4x the host's
    waits, up to ``tries`` times, then RuntimeError."""
    for i in range(tries):
        events = _trace(fn, reps, PAD_S * 4 ** i)
        at = [j for j, e in enumerate(events) if MARK in e[0]]
        lead = next((j for j, k in enumerate(at) if j != k), len(at))
        if lead >= 1 and len(at) - lead == reps and at[-1] == len(events) - 1:
            if lead < LEAD:
                print(f"torch.profiler: the trace lost {LEAD - lead} of its {LEAD} "
                      f"leading markers, none after a run", flush=True)
            at = at[lead - 1:]
            return [events[j0 + 1:j1] for j0, j1 in zip(at[:-1], at[1:])]
        print(f"torch.profiler: trace {i + 1} of {tries} lost events ({len(at)} of "
              f"{LEAD + reps} markers in {len(events)} events, the first "
              f"{events[0][0][:50] if events else None!r}, the last "
              f"{events[-1][0][:50] if events else None!r})", flush=True)
    raise RuntimeError(f"torch.profiler: no whole trace of {reps} runs in {tries} tries")


def _device_events(fn, reps: int = 1):
    """(name, start us, end us) of every kernel, memcpy and memset that
    ``reps`` runs of ``fn`` put on the card, in start order, from a whole
    trace (``_device_runs``)."""
    return [e for run in _device_runs(fn, reps) for e in run]


def _by_kernel(fn, reps: int = 1):
    """Run ``fn`` ``reps`` times under torch.profiler; {kernel: (us per run,
    launches per run)}: each kernel's share of the device's busy time, the
    stretch by which it extends the union of the intervals of the kernels
    that started before it.  A kernel that overlaps no other gets its
    duration; under programmatic dependent launch (K2's step) a kernel
    starts before the previous one ends and waits for it, and only what it
    runs past the previous kernels' end is its own.  The values add up to
    the time the device was busy."""
    return _fold_events(_device_events(fn, reps), reps)


def _fold_events(events, reps: int = 1):
    """_by_kernel's table from a list of (name, start us, end us) events of
    ``reps`` runs."""
    acc = collections.defaultdict(lambda: [0.0, 0.0])
    last = None
    for name, t0, t1 in events:
        k = acc[_short(name)]
        k[0] += max(0.0, t1 - (t0 if last is None else max(t0, last))) / reps
        k[1] += 1.0 / reps
        last = t1 if last is None else max(last, t1)
    return dict(acc)


_FLUSH = []


def _l2_flush():
    """Copy 128 MB from one buffer to another (one device-to-device memcpy,
    "memcpy / memset" in ``_by_kernel``), so that the card's 50 MB L2 holds
    nothing the next call reads: in the decode loop K2's 1.47 GB weight
    stream passes between two calls of a small kernel, whose weights then
    come from HBM."""
    if not _FLUSH:
        _FLUSH.extend(torch.empty(64 * 2**20, dtype=torch.int16, device="cuda") for _ in "ab")
    _FLUSH[1].copy_(_FLUSH[0])


def _cold_ms(fn, reps: int = 20, prefixes=None):
    """Device ms per call of ``fn`` with the L2 flushed before each call
    (``_l2_flush``), the flush's copy left out; with ``prefixes``, only the
    kernels whose names start with one of them."""
    rows = _by_kernel(lambda: (_l2_flush(), fn()), reps)
    return sum(us for k, (us, _) in rows.items()
               if k != "memcpy / memset" and (prefixes is None or k.startswith(prefixes))) / 1e3


def _overlap_ms(fn, reps: int = 1):
    """(the kernels' durations added up, the device's busy time), ms per run
    of ``fn``: the first exceeds the second by the time kernels spent
    running beside the one before them (programmatic dependent launch: a
    kernel's CTAs start early and wait)."""
    return _overlap_events(_device_events(fn, reps), reps)


def _overlap_events(events, reps: int = 1):
    """_overlap_ms from a list of (name, start us, end us) events of
    ``reps`` runs."""
    total = sum(t1 - t0 for _, t0, t1 in events)
    busy, last = 0.0, None
    for _, t0, t1 in events:
        busy += max(0.0, t1 - (t0 if last is None else max(t0, last)))
        last = t1 if last is None else max(last, t1)
    return total / reps / 1e3, busy / reps / 1e3


def _entry_host_ms(run, entry: str, iters: int = 10, lib=None) -> float:
    """Median host milliseconds of the ctypes calls of C entry ``entry`` in
    ``run()`` (CPU clock around ``launch`` of ``lib``, by default
    ``ops/cuda_lib.py``, no synchronize), summed over the entry's calls in
    one run: the time the host takes to issue the entry's launches."""
    if lib is None:
        from whisper_medusa_tpu_torch.ops import cuda_lib as lib
    cuda_lib = lib
    runs, cur, orig = [], [0.0], cuda_lib.launch

    def timed(name, *args):
        t0 = time.perf_counter()
        orig(name, *args)
        if name == entry:
            cur[0] += (time.perf_counter() - t0) * 1e3

    cuda_lib.launch = timed
    try:
        for _ in range(iters):
            cur[0] = 0.0
            run()
            torch.cuda.synchronize()
            runs.append(cur[0])
    finally:
        cuda_lib.launch = orig
    return float(np.median(runs))


def _table(title, rows, extra=""):
    total = sum(us for us, _ in rows.values())
    print(f"=== {title}: device time by kernel{extra}")
    for name, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"  {us:11.1f} us  {n:8.1f} launches  {100 * us / total:5.1f} %  {name}")
    print(f"  total {total:.1f} us of device time")
    return total


def _cuda_ms(fn, warmup=3, iters=20):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profile_frontend():
    """The log-mel frontend on seeded noise at B=1 and B=8: the default plain
    path and K8 (the processor's ``use_kernel=True``)."""
    from whisper_medusa_tpu_torch.ops import mel, mel_fused

    rng = np.random.default_rng(SEED)
    for b in (1, 8):
        audio = torch.from_numpy((0.1 * rng.standard_normal((b, mel.N_SAMPLES)))
                                 .astype(np.float32)).cuda()
        for name, fn in (("plain", mel.log_mel_spectrogram),
                         ("K8", mel_fused.log_mel_spectrogram_fused)):
            run = lambda: fn(audio)
            _table(f"frontend, {name}, B={b}", _by_kernel(run, 5),
                   f" (CUDA events: {_cuda_ms(run):.4f} ms per call)")


def profile_megastep(model, mode, block=None):
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS

    p, dims = model.params["whisper"], model.config.dims
    dec = p["decoder"]
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    what = f"{dims.decoder_layers} layers" + (" + the block" if block is not None else "")
    for b, t in ((1, 11), (8, 1), (8, 11)):
        enc = torch.randn((b, dims.max_source_positions, dims.d_model), generator=g,
                          device="cuda").to(torch.bfloat16)
        cache = whisper.init_cache(p, dims, enc, dims.max_target_positions + 12,
                                   extra_layers=int(block is not None))
        if block is not None:
            whisper.set_block_cross_kv(cache, block, enc, dims.decoder_attention_heads)
        offsets = torch.full((b,), 20, dtype=torch.int32, device="cuda")
        x = torch.randn((b, t, dims.d_model), generator=g, device="cuda").to(torch.bfloat16)
        run = lambda: MS.megastep_kernel(dec["layers"], dec["ln_post"], x, cache.self_k,
                                         cache.self_v, cache.cross_k, cache.cross_v,
                                         offsets, None, dims.max_source_positions,
                                         dims.decoder_attention_heads,
                                         cross_k_s=cache.cross_k_s,
                                         cross_v_s=cache.cross_v_s, self_s=cache.self_s,
                                         block=block)
        ms = _cuda_ms(run)
        rows = _by_kernel(run, 5)
        gemm = sum(us for k, (us, _) in rows.items() if k.startswith("wgemm_kernel"))
        durations, busy = _overlap_ms(run, 5)
        k2 = {k: n for k, (_, n) in rows.items()
              if k.startswith(("wgemm_kernel<", "cross_decode_kernel<", "ln_rows_kernel"))}
        ln_gemms = sum(n for k, n in k2.items() if is_ln_gemm(k))
        _table(f"K2 {mode}, {what}, B={b} T={t}, per call", rows,
               f" (CUDA events: {ms:.4f} ms per call; the C entry's host time "
               f"{_entry_host_ms(run, 'wm_megastep_step'):.4f} ms; the projections "
               f"{gemm / 1e3:.4f} ms of device time; kernel durations add up to "
               f"{durations:.4f} ms in {busy:.4f} ms of busy time; {sum(k2.values()):.0f} K2 "
               f"launches a call, {ln_gemms:.0f} of them GEMMs with the layer norm folded "
               f"in, ln_rows_kernel {k2.get('ln_rows_kernel', 0):.0f})")
        del cache


def profile_verify_passes(model, b=8):
    """One verification step at B=8 on the default 11-node chain, two ways,
    CUDA-event ms and device time by kernel: the two passes the loop runs at
    B >= 2 (head-0 rows through K5 at R = B*N, then the draft heads at the
    accepted node through K3 and the processors), against one pass that
    scores every (head, node) row through K5 at R = (K+1)*B*N."""
    from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig, apply_processors
    from whisper_medusa_tpu_torch.models import medusa, whisper
    from whisper_medusa_tpu_torch.ops import verify as VF

    p, dims, gd = model.params["whisper"], model.config.dims, model.generation_config
    heads = model.params["medusa"]["heads"]
    hw, hb = heads["w"][:, 0], heads["b"][:, 0]
    drafts = {"heads": {"w": heads["w"][1:], "b": heads["b"][1:]}}
    kp1, d = hw.shape[0], dims.d_model
    n = kp1                # the default chain: one node per head
    embed = p["decoder"]["embed_tokens"]
    pcfg = ProcessorConfig(vocab_size=dims.vocab_size, suppress_tokens=gd.suppress_tokens,
                           begin_suppress_tokens=gd.begin_suppress_tokens, begin_index=4,
                           eos_token_id=model.special.eos)
    masks = VF.masks_for(pcfg, "cuda")
    kw = dict(begin_index=4, eos_id=model.special.eos, decay=None)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    flat = torch.randn((b * n, d), generator=g, device="cuda").to(torch.bfloat16)
    pos = 20 + torch.arange(kp1 * b * n, device="cuda", dtype=torch.int32) % 32
    gcol = torch.zeros_like(pos)
    accepted = flat.reshape(b, n, d)[:, 0]

    def two_pass():
        rows = VF.head_rows(flat, hw[:1], hb[:1])[0]
        VF.verify_rows(rows, embed, pos[:b * n], gcol[:b * n], masks, **kw)
        lg = whisper.project_logits(p, medusa.apply_heads(drafts, accepted))
        apply_processors(lg.transpose(0, 1), pos[:b * (kp1 - 1)].reshape(b, kp1 - 1),
                         pcfg).argmax(-1)

    def one_pass():
        rows = VF.head_rows(flat, hw, hb).reshape(-1, d)
        VF.verify_rows(rows, embed, pos, gcol, masks, **kw)

    for name, fn in (("two passes", two_pass), ("one pass", one_pass)):
        _table(f"verification, B={b}, {n} nodes, {name}", _by_kernel(fn, 5),
               f" (CUDA events: {_cuda_ms(fn):.4f} ms per step)")


def profile_head_rows(model, mode):
    """Part 3's head rows and K4 at R = 121, device time by kernel."""
    from whisper_medusa_tpu_torch.ops import qmm as QM
    from whisper_medusa_tpu_torch.ops import verify as VF

    dims = model.config.dims
    heads = model.params["medusa"]["heads"]
    hw, hb = QM.wmap(heads["w"], lambda a: a[:, 0]), heads["b"][:, 0]
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    d = dims.d_model
    for m, lo, hi in ((88, 0, 1), (8, 1, None), (1, 1, None), (11, 0, None)):
        w, b = QM.wmap(hw, lambda a: a[lo:hi]), hb[lo:hi]
        src = torch.randn((m, d), generator=g, device="cuda").to(torch.bfloat16)
        run = lambda: VF.head_rows(src, w, b)
        _table(f"head rows {mode}, {b.shape[0]} head(s) x M={m}", _by_kernel(run, 20),
               f" (CUDA events: {_cuda_ms(run):.4f} ms per call)")
    n, kp1 = 11, hb.shape[0]
    embed = model.params["whisper"]["decoder"]["embed_tokens"]
    hid = torch.randn((1, n, d), generator=g, device="cuda").to(torch.bfloat16)
    pos = (5 + torch.arange(kp1 * n, device="cuda") % 32).to(torch.int32)
    gcol = torch.zeros_like(pos)
    masks = torch.zeros((2, dims.vocab_size), dtype=torch.int8, device="cuda")
    run = lambda: VF.verify_hidden(hid, hid, hw, hb, embed, pos, gcol, masks, identity0=False,
                                   begin_index=4, eos_id=model.special.eos, decay=None)
    _table(f"K4 {mode}, {kp1} heads x {n} nodes (R = {kp1 * n})", _by_kernel(run, 20),
           f" (CUDA events: {_cuda_ms(run):.4f} ms per call)")


def profile_requests(model, mode, paths=(("medusa", {}),
                                          ("vanilla", dict(disable_medusa=True))),
                     batches=(1, 8)):
    rng = np.random.default_rng(SEED)
    dims = model.config.dims
    for b in batches:
        feats = torch.from_numpy(rng.standard_normal(
            (b, dims.num_mel_bins, dims.num_frames)).astype(np.float32)).cuda()
        for name, kw in paths:
            run = lambda: model.generate(feats, language="en",
                                         max_new_tokens=MAX_NEW_TOKENS, **kw)
            run()                                             # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            rows = _by_kernel(run)
            n_gen = int((out.lengths - 4).sum())
            total = _table(
                f"{mode} request ({name}, B={b}, {n_gen} generated tokens, {out.steps} steps, "
                f"mean_accept_length {out.mean_accept_length:.3f})", rows,
                f" (wall without the profiler {wall_ms:.1f} ms)")
            print(f"  device idle share {1 - total / 1e3 / wall_ms:.3f}")


def profile_ts_requests(model, mode):
    """Part 4's timestamp and longform requests: one ``return_timestamps=True``
    Medusa request at B=1 (max_new_tokens=128) from seeded features, and one
    longform request (75 s of seeded noise through ``ops/mel.py``, the seek
    loop, max_new_tokens=64 a window) at B=1: wall time without the
    profiler, device time by kernel, idle share."""
    from whisper_medusa_tpu_torch.ops.mel import log_mel_spectrogram

    rng = np.random.default_rng(SEED)
    dims = model.config.dims
    short = torch.from_numpy(rng.standard_normal(
        (1, dims.num_mel_bins, dims.num_frames)).astype(np.float32)).cuda()
    audio = torch.from_numpy((0.1 * rng.standard_normal((1, 16000 * 75)))
                             .astype(np.float32)).cuda()
    long = log_mel_spectrogram(audio, dims.num_mel_bins)
    for name, feats, new in (("timestamps, B=1", short, MAX_NEW_TOKENS),
                             ("longform 75 s, timestamps, B=1", long, 64)):
        run = lambda: model.generate(feats, language="en", max_new_tokens=new,
                                     return_timestamps=True)
        run()                                             # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = _by_kernel(run)
        total = _table(
            f"{mode} request ({name}, {int(out.lengths.sum())} tokens, {out.steps} steps, "
            f"mean_accept_length {out.mean_accept_length:.3f})", rows,
            f" (wall without the profiler {wall_ms:.1f} ms)")
        print(f"  device idle share {1 - total / 1e3 / wall_ms:.3f}")


def profile_per_op_step(model, mode):
    """Part 6: one per-op decoder step over all layers at (8, 11), (16, 1)
    and (16, 11), from seeded encoder states and inputs, offsets 20."""
    from whisper_medusa_tpu_torch.models import whisper

    p, dims = model.params["whisper"], model.config.dims
    dec = p["decoder"]
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    for b, t in ((8, 11), (16, 1), (16, 11)):
        enc = torch.randn((b, dims.max_source_positions, dims.d_model), generator=g,
                          device="cuda").to(torch.bfloat16)
        cache = whisper.init_cache(p, dims, enc, dims.max_target_positions + 12)
        offsets = torch.full((b,), 20, dtype=torch.int32, device="cuda")
        x = torch.randn((b, t, dims.d_model), generator=g, device="cuda").to(torch.bfloat16)
        run = lambda: whisper.decoder_layers_ops(
            dec["layers"], dec["ln_post"], x, cache.self_k, cache.self_v, cache.cross_k,
            cache.cross_v, offsets, None, dims.max_source_positions,
            dims.decoder_attention_heads, cross_k_s=cache.cross_k_s,
            cross_v_s=cache.cross_v_s, self_s=cache.self_s)
        ms = _cuda_ms(run)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = _by_kernel(run, 3)
        total = _table(f"per-op step {mode}, {dims.decoder_layers} layers, B={b} T={t}, per "
                       f"call", rows,
                       f" (CUDA events: {ms:.4f} ms per call; wall {wall_ms:.1f} ms)")
        launches = sum(n for _, n in rows.values())
        print(f"  device idle share {1 - total / 1e3 / wall_ms:.3f}; {launches:.0f} launches, "
              f"{launches / dims.decoder_layers:.1f} a layer")
        del cache


# K9's kernels behind its one entry, by mode: the row pass, the main pass
# and the pass that adds the dQ partials (a cast to bf16 in the bf16 mode).
K9_KERNELS = {"bfloat16": ("bwd_rows_kernel", "bwd_main_kernel", "bwd_cast_kernel"),
              "float32": ("bwd_rows_f32_kernel", "attention_bwd_f32_kernel",
                          "bwd_sum_f32_kernel")}


def profile_training(b=2, t=224):
    """Part 5: one Medusa-Block recipe step (parts_to_freeze="whisper") and
    one full fine-tune step of base_head, bf16 then f32 weights, each timed
    and profiled after a warm-up step on the same batch."""
    from whisper_medusa_tpu_torch.config import WHISPER_PRESETS, MedusaConfig, ModelConfig
    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.training import train as TT

    rng = np.random.default_rng(SEED)
    dims = WHISPER_PRESETS["large-v2"]
    feats = torch.from_numpy(rng.standard_normal(
        (b, dims.num_mel_bins, dims.num_frames)).astype(np.float32)).cuda()
    labels = rng.integers(0, 50257, size=(b, t))
    for dtype, (name, variant, policy) in itertools.product(
            K9_KERNELS, (("Medusa-Block recipe", "medusa_block", "whisper"),
                         ("full fine-tune", "base_head", None))):
        cfg = ModelConfig(dims=dims, medusa=MedusaConfig(medusa_heads_type=variant),
                          param_dtype=dtype, compute_dtype=dtype)
        params = bridge.from_random(cfg, seed=SEED, device="cuda")
        opt = TT.make_optimizer("adafactor", lr=1e-3, warmup_steps=0, schedule="constant")
        state = TT.init_train_state(params, opt)
        step = TT.make_train_step(cfg, opt, policy, remat=False)
        run = lambda: step(state, feats, labels)
        torch.cuda.reset_peak_memory_stats()
        run()                                                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = _by_kernel(run)
        total = _table(f"train step, {name} ({variant}, parts_to_freeze={policy}), {dtype}, "
                       f"B={b} T={t}", rows, f" (wall without the profiler {wall_ms:.1f} ms)")
        k9 = [rows.get(k, (0.0, 0)) for k in K9_KERNELS[dtype]]
        k9_us = sum(us for us, _ in k9)
        print(f"  K9 ({' + '.join(K9_KERNELS[dtype])}): {k9_us:.1f} us, "
              f"{100 * k9_us / total:.1f} % of device time, {k9[1][1]:g} launches")
        print(f"  device idle share {1 - total / 1e3 / wall_ms:.3f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del params, state, step, run
        torch.cuda.empty_cache()


def profile_heads(model, qmodel):
    """Part 3."""
    for m, mode in ((model, "bf16"), (qmodel, "int8")):
        profile_head_rows(m, mode)
    profile_verify_passes(model)


def profile_serving(model, qmodel, bmodel, bqmodel):
    """Parts 1-4."""
    profile_frontend()
    for m, mode in ((model, "bf16"), (qmodel, "int8")):
        profile_megastep(m, mode)
    for m, mode in ((bmodel, "bf16"), (bqmodel, "int8")):
        profile_megastep(m, mode, block=m.params["medusa"]["block"])
    profile_heads(model, qmodel)
    for m, mode in ((model, "bf16"), (qmodel, "int8")):
        profile_requests(m, mode)
    for m, mode in ((bmodel, "bf16"), (bqmodel, "int8")):
        profile_requests(m, mode, (("medusa_block", {}),))
    profile_ts_requests(model, "bf16")


def main(argv=None):
    import argparse

    from whisper_medusa_tpu_torch.config import WHISPER_PRESETS, MedusaConfig, ModelConfig
    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel

    parser = argparse.ArgumentParser()
    parser.add_argument("--part", choices=("all", "serving", "heads", "per_op", "step", "train"),
                        default="all")
    part = parser.parse_args(argv).part
    if not torch.cuda.is_available():
        raise SystemExit("device_profile needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"gpu: {smi.stdout.strip()}; torch {torch.__version__}")
    if part == "train":
        profile_training()
        return
    cfg = ModelConfig(dims=WHISPER_PRESETS["large-v2"], medusa=MedusaConfig(),
                      param_dtype="bfloat16", compute_dtype="bfloat16")
    model = WhisperMedusaModel.from_random(cfg, seed=SEED)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    model.params["medusa"]["heads"]["w"].normal_(0.0, 0.02, generator=g)
    qmodel = model.quantize()
    if part == "heads":
        profile_heads(model, qmodel)
        return
    bmodel = bridge.random_block_model(model, seed=SEED + 2)
    bqmodel = bmodel.quantize()
    if part not in ("per_op", "step"):
        profile_serving(model, qmodel, bmodel, bqmodel)
    for m, mode in ((model, "bf16"), (qmodel, "int8")):
        profile_per_op_step(m, mode)
    tiny = WhisperMedusaModel.from_random(
        ModelConfig(dims=WHISPER_PRESETS["tiny"], medusa=MedusaConfig(medusa_hidden_size=384),
                    param_dtype="bfloat16", compute_dtype="bfloat16"), seed=SEED)
    profile_per_op_step(tiny, "tiny bf16")
    del tiny
    if part == "step":
        return
    profile_requests(model, "bf16", batches=(16,))
    profile_requests(qmodel, "int8", (("medusa", {}),), batches=(16,))
    profile_requests(bmodel, "bf16", (("medusa_block", {}),), batches=(16,))
    if part == "all":
        del model, qmodel, bmodel, bqmodel
        torch.cuda.empty_cache()
        profile_training()


if __name__ == "__main__":
    main()
