#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU (needs torch with CUDA and nvcc).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  1. versions, and the card's name and power limit from nvidia-smi;
  2. build the Hopper kernels from whisper_medusa_tpu_torch/csrc (one nvcc
     per source, in parallel);
  3. hold each kernel against its plain PyTorch version at the shapes the
     paths give it, bf16 and int8 (K1 at the encoder's shapes at B=1 and
     B=8 and whisper tiny's, training's 224 x 224 causal and 224 x 1500, and
     off the paths, with every example of the B=8 call bitwise its B=1
     call; the TMA guards of K1 and K6: a misaligned operand raises, and so
     does a failed tensor-map encode; K1's log-sum-exp output; K8 log_mel on
     the frontend's audio, every example of the B=8 call bitwise its B=1
     call; the
     int8 modes of K2, K4, K5 and head_rows; K2's Medusa-Block mode and K4's
     identity0 rows, bf16 and int8 (K2's six projections on its
     weight-streaming GEMM, its three layer norms a layer inside the q/k/v,
     cross-q and fc1 GEMMs, its self- and cross-attention on K10's cluster
     body, all launched with programmatic dependent launch; its 2-layer
     checks include chunks that straddle the self-attention's 160-key
     slices; its 32-layer worst cosine against the plain step held at
     K2_COS_FLOOR, every example of its B=8 calls bitwise a B=1 call, and
     8 launches a layer plus one ln_rows_kernel (ln_post) a step required;
     at (1, 11), (8, 11) and (8, 1) its device time, the
     projections' share, the C entry's host time and each attention
     kernel's device time a launch beside its byte bound, SDPA's device time
     on the same work, its launches a layer, how early it starts under
     programmatic dependent launch and how many of its clusters fit the
     card printed); K6 qmm at init_cache's (1500,
     1280, 1280), the per-op step's B=16 shapes and whisper tiny's fc1, its
     first 16 rows bitwise an M=16 call's, and K7 qmm_nt (the TMA-fed weight
     stream; the first 10 rows of its M=80 call bitwise an M=10 call's, its
     device time at M=10 and 80 beside ``x @ E.T`` on a bf16 copy); K10
     decode cross-attention, bf16 and int8 (the (16, 20, 11, 64) call
     bitwise its B=1 calls; T = 17 and 31 in 16-row launches), K10's mask
     mode (the per-op step's self-attention) against ``attention`` under
     ``make_step_mask`` at large-v2's B=16 (causal and a tree chunk mask,
     T=11 and T=1), B=8 at T = 17, 24 (tree) and 31, and whisper tiny's B=8,
     B=8 and B=16 bitwise B=1, and K11 decode FFN (on K2's weight-streaming
     GEMM) at M = 1, 16, 130, 176, 192 and 300 (one full launch, then a
     launch and a tail), its M=176 rows bitwise an M=11 call's, its device
     time at M = 16 and 176 beside the three-call addmm / gelu / addmm
     yardstick's, and the device times of K4 at R=121 (and of its stage A)
     and K5 at R = 8, 88, 176 and 1024 (the vocab stream); head_rows (K4's
     stage A alone: both on the GEMM's heads mode) at the loop's shapes, each
     call's device time beside its byte bound and the baddbmm / silu / add
     yardstick's, head 0 of a 1-head M=88 launch bitwise an 11-head M=11
     launch's, the first 8 rows of an M=88 launch bitwise an M=8 launch's,
     the draft heads of an 11-head launch bitwise a 10-head launch's (bf16,
     int8 and whisper tiny's, bf16 and int8), and K4's statistics bitwise
     K5's over head_rows' rows; K3 (on K7's tied-embedding stream) at
     M = 1 to 240, the first 10 rows of its M=80 call bitwise an M=10
     call's, its device time at M = 10 and 80 beside ``x @ E.T``'s;
     head_rows, K3, K5 and K7 past one
     launch's rows, blocked), and time the kernel, the plain version and,
     where one PyTorch call computes the same function, that call, with
     CUDA events (3 warm-ups, median of 20; K1, K6, K8 and K10 also by device
     time under torch.profiler, beside SDPA's, matmul's and torch.stft's);
     each kernel's bound is
     computed from the bytes and operations of the same call; then the
     per-op decoder step (cuBLAS or K6 projections, K10, K11) against K2 on
     the same inputs and caches at (B, T) = (8, 11) and (8, 1), bf16 and
     int8, 32 layers, cosine >= 0.9998 (printed beside the previous K2
     attention's), with both timed; P3 end to end: one
     per-op step at B=8 against each example's B=1 step, large-v2 bf16 and
     int8 and whisper tiny, every layer's self-attention (K10's mask mode)
     and the step's hidden output bitwise;
  4. the main paths at full whisper-large-v2 width with random bf16 weights,
     each driven with every launch counter set to 0 just before and read
     just after: three Medusa requests at B=1; one vanilla request
     (``disable_medusa=True``) at B=1; one batched Medusa request and one
     batched vanilla request of eight waveforms, and the batched Medusa
     request again under the profiler (its tokens unchanged, no kernel of
     the old K3 on the card, one ln_rows_kernel a K2 call, every K3 launch
     the bf16 stream); then the same four requests
     (one at B=1) on ``model.quantize()``, the int8 serving copy, with the
     share of its tokens equal to the bf16 ones printed, not held; then
     Medusa-Block requests (10 heads and a block layer, sharing the Whisper
     weights) at B=1 and B=8, bf16 and int8, each from waveforms through
     ``WhisperMedusaProcessor(use_kernel=True)`` (K8) inside the driven run;
     then requests of 16 waveforms, past K2's batch (the per-op step, K2 at
     0 launches): base_head bf16 and int8, vanilla bf16, Medusa-Block bf16;
     then B=1 requests past K4's rows and K2's chunk (P4): 11 base_head
     heads (verification in two passes, K4 at 0 launches) and a 16-head
     chain (T = 17: K2 only for the prefill, K10 in two 16-row launches a
     layer on every step), each held to its run under
     ``draft_corruption=1.0``;
  5. the output is unchanged when every draft is corrupted, bf16 and int8,
     base_head and Medusa-Block, and bf16 base_head at B=16;
  6. decode batch invariance, bf16 and int8: speculative_generate at B=8
     gives every example exactly the tokens of its B=1 decode, for Medusa,
     vanilla and Medusa-Block (accepted counts are printed, not held equal);
     whether generate at B=8 gives each example its B=1 tokens end to end,
     and whether the decode at B=16 (per-op step) gives each example its B=1
     tokens (K2), are printed, not required; then whisper tiny (d_model
     384, the per-op step, K2 at 0 launches): K11, head_rows and K4 at
     D=384 against their plain versions (three kernels rows), Medusa at B=1
     and B=8, vanilla at B=1, int8 Medusa and Medusa-Block at B=1 driven as
     in phase 4, and its decode at B=8 held to its B=1 tokens;
  7. training: the grad guard (a kernel without a backward refuses an
     operand that requires grad); K9, the one-pass attention backward from
     K1's output and log-sum-exp, against both plain versions off the path
     and at the three training shapes (dQ, dK and dV bitwise equal over two
     runs; timed against the plain version and SDPA's backward); a 2-layer full-width
     train step of each recipe on the card against a float32 CPU copy; then
     at full large-v2 width, bf16, B=2, T=224, each driven with the launch
     counters as in phase 4: 3 steps of the Medusa-Block recipe, 3 of the
     Medusa-Linear recipe and one full fine-tune step, with their K9 launch
     counts (2, 2 and 96 per step), frozen weights bit-identical and peak
     memory; and the training CLI at whisper tiny, whose saved model
     answers a generate.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
MAX_NEW_TOKENS = 128
BATCH = 8
PROMPT_LEN = 4
# NVIDIA H100 SXM data sheet: HBM rate, dense bf16 tensor-core rate and the
# f32 rate of the CUDA cores (at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


SMI = "not read"          # nvidia-smi's name and power limit (phase_env)
# K2's 32-layer outputs against its plain step (every mode's worst cosine):
# the bound the step has held since its projections moved onto the GEMM,
# recorded to six decimals.
K2_COS_FLOOR = 0.999858


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, warmup=3, iters=20):
    """Median milliseconds of fn() between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops, peak=BF16_FLOPS):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` operations at ``peak`` (bf16 tensor
    cores unless given)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def cosine(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.float().reshape(1, -1), b.float().reshape(1, -1)))


def rel_err(a, b):
    """||a - b|| / ||b|| (Frobenius)."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def _within(a, b, tol):
    """Elementwise |a - b| <= tol + tol * |b| (numpy's allclose at rtol =
    atol), as a bool tensor."""
    b = b.float()
    return (a.float() - b).abs() <= tol + tol * b.abs()


def close(a, b, tol):
    return bool(_within(a, b, tol).all())


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def kernel_record(name, source, replaces, counter, err, ms, plain_ms, bound_ms_by,
                  library_ms):
    b_ms, b_by = bound_ms_by
    log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), library "
        + ("none" if library_ms is None else f"{library_ms:.4f} ms"))
    return dict(name=name, source=source, replaces=replaces, counter=counter,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def phase_env():
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this smoke test needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    global SMI
    SMI = smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from whisper_medusa_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.lib()
    log(f"build + load: {time.perf_counter() - t0:.1f} s -> {cuda_lib.BUILD_DIR}")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# K1 at the paths' shapes: ((B, H, Sq, Skv), kv_len, causal): the encoder at
# B=1 and B=8 (large-v2) and B=1 (whisper tiny, 6 heads), training's decoder
# self-attention (causal) and cross-attention (224 queries, 1500 keys); then
# off the paths: causal with a ragged edge, kv_len < Skv, a short ragged Sq.
K1_PATH = (((1, 20, 1500, 1500), 1500, False), ((8, 20, 1500, 1500), 1500, False),
           ((1, 6, 1500, 1500), 1500, False), ((2, 20, 224, 224), 224, True),
           ((2, 20, 224, 1500), 1500, False))
K1_OFF = (((1, 4, 300, 300), 300, True), ((1, 4, 300, 300), 257, False),
          ((1, 3, 77, 300), 299, False))
K1_SOURCE = "whisper_medusa_tpu_torch/csrc/attention.cu"
K1_REPLACES = "whisper_medusa_tpu/ops/attention.py:71"


def device_ms(fn, reps=20):
    """Device milliseconds per call of fn(): the kernels' time under
    torch.profiler (device_profile._by_kernel) after one warm-up call, so
    that host time between launches does not count."""
    from whisper_medusa_tpu_torch.device_profile import _by_kernel

    fn()
    return sum(us for us, _ in _by_kernel(fn, reps).values()) / 1e3


def check_attention(g):
    """K1 against attention_plain (2e-2 max abs) at every shape of K1_PATH
    and K1_OFF; at B=8 every example's output bitwise its B=1 call's (the
    batch invariance the decode checks rely on).  Timed at (1, 20, 1500, 64)
    and (8, 20, 1500, 64) against the plain version and SDPA (scale 1.0, q
    pre-scaled), with the device time of K1 and SDPA under the profiler
    printed beside; two kernels rows."""
    from whisper_medusa_tpu_torch.ops import attention as A

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for (b, h, sq, skv), kv_len, causal in K1_OFF + K1_PATH:
        rnd = lambda n, scale=1.0: (torch.randn((b, h, n, 64), generator=g, device="cuda")
                                    * scale).to(torch.bfloat16)
        q, k, v = rnd(sq, 0.25), rnd(skv), rnd(skv)
        got = A.attention_kernel(q, k, v, kv_len, causal)
        err = max_err(got, A.attention_plain(q, k, v, kv_len, causal))
        what = f"K1 attention ({b},{h},{sq}x{skv},64) kv_len {kv_len} causal {causal}"
        log(f"{what}: max_abs_err {err:.3e}")
        require(err <= 2e-2, f"{what}: err {err} > 2e-2")
        if b > 1 and sq == skv == 1500:
            same = [torch.equal(got[i:i + 1], A.attention_kernel(
                q[i:i + 1].contiguous(), k[i:i + 1].contiguous(), v[i:i + 1].contiguous(),
                kv_len, causal)) for i in range(b)]
            log(f"{what}: each example bitwise its B=1 output: {sum(same)}/{b}")
            require(all(same), f"{what}: a B=1 call differs from its row of the B={b} call")
        if h != 20 or sq != 1500:
            continue
        ms = cuda_ms(lambda: A.attention_kernel(q, k, v, kv_len, causal))
        plain_ms = cuda_ms(lambda: A.attention_plain(q, k, v, kv_len, causal))
        lib_ms = cuda_ms(lambda: sdpa(q, k, v, scale=1.0))
        log(f"{what}: device time K1 {device_ms(lambda: A.attention_kernel(q, k, v, kv_len, causal)):.4f} "
            f"ms, SDPA {device_ms(lambda: sdpa(q, k, v, scale=1.0)):.4f} ms")
        rows.append(kernel_record("attention" if b == 1 else f"attention B={b}", K1_SOURCE,
                                  K1_REPLACES, (A, "launches"), err, ms, plain_ms,
                                  bound(4 * nbytes(q), 4 * b * h * sq * skv * 64), lib_ms))
        del q, k, v, got
    return rows


def check_tma_guards():
    """K1 and K6 load through TMA tensor maps, which take 16-byte-aligned
    addresses: the wrappers refuse a tensor that is not (ValueError), and a C
    entry handed such an address returns the CUDA driver's refusal to encode the
    map, on which cuda_lib.launch raises.  No plain version stands in."""
    from whisper_medusa_tpu_torch.ops import attention as A
    from whisper_medusa_tpu_torch.ops import cuda_lib
    from whisper_medusa_tpu_torch.ops import qmm as QM

    buf = torch.zeros(64 * 64 * 3 + 8, dtype=torch.bfloat16, device="cuda")
    q = buf[1:1 + 64 * 64].view(1, 1, 64, 64)          # 2 bytes past an aligned address
    ok = buf[64 * 64 + 8:2 * 64 * 64 + 8].view(1, 1, 64, 64)
    for name, fn in (("attention", lambda: A.attention_kernel(q, ok, ok, 64, False)),
                     ("qmm", lambda: QM.qmm_kernel(
                         q.view(64, 64), torch.zeros((64, 64), dtype=torch.int8, device="cuda"),
                         torch.ones(64, device="cuda")))):
        try:
            fn()
        except ValueError as e:
            require("aligned" in str(e), f"{name}: {e}")
        else:
            raise AssertionError(f"{name}: a misaligned operand was accepted")
    out = torch.empty((1, 1, 64, 64), dtype=torch.bfloat16, device="cuda")
    try:
        cuda_lib.launch("wm_attention_fwd", q.device, q.data_ptr(), ok.data_ptr(),
                        ok.data_ptr(), out.data_ptr(), None, 1, 1, 64, 64, 64, 64, 0)
    except RuntimeError as e:
        require("tensor-map" in str(e), f"wm_attention_fwd: {e}")
    else:
        raise AssertionError("wm_attention_fwd took a misaligned address")
    torch.cuda.synchronize()
    log("TMA guards: misaligned operands raise in the wrappers (K1, K6); a failed "
        "tensor-map encode raises from the C entry")


def _log_mel_cost(x, n_mels):
    """(bytes, operations, dense-DFT operations) of log-mel on audio ``x``
    (B, N).  The bound counts what the function needs: the audio read once,
    the filter bank's nonzeros, the features written once; per frame the
    Hann window, a real FFT of 400 points (2.5 N log2 N, half a complex
    FFT's 5 N log2 N), the power, the triangular filter bank at its
    nonzeros (each bin feeds at most two mels) and the log.  The third
    number is a dense DFT's (cos and sin, 400 x 201 MACs each, plus a dense
    201 x n_mels projection), the plain version's and the TPU kernel's
    design."""
    from whisper_medusa_tpu_torch.ops import mel as M

    b, n = x.shape
    frames = n // M.HOP_LENGTH
    nf = M.N_FFT // 2 + 1
    nnz = int((M.device_bases(x.device, n_mels)[2] != 0).sum())
    fft = 2.5 * M.N_FFT * np.log2(M.N_FFT)
    per_frame = M.N_FFT + fft + 3 * nf + 2 * nnz + n_mels
    moved = nbytes(x) + 4 * nnz + 4 * b * frames * n_mels
    dense = b * frames * (2 * 2 * M.N_FFT * nf + 3 * nf + 2 * nf * n_mels)
    return moved, b * frames * per_frame, dense


def check_mel(waves1, waves8):
    """K8 against its plain version on the smoke's waveforms at B=1 and B=8
    and on seeded white noise at B=2, n_mels 80 (and 128 on the noise): the
    normalized features (what users get) within 1e-3 max abs, the JAX
    package's bar for its kernel; the raw log10 error is printed.  Every
    example of the B=8 call is bitwise its B=1 call.  Timed at B=1 and B=8
    against the plain version and, for the DFT part alone, torch.stft
    ("stft only"), with the device time of K8 and torch.stft under the
    profiler printed beside."""
    from whisper_medusa_tpu_torch.ops import mel as M
    from whisper_medusa_tpu_torch.ops import mel_fused as MF

    def batch(waves):
        return torch.from_numpy(np.stack([M.pad_or_trim(w)[0] for w in waves])).cuda()

    noise = np.random.default_rng(SEED + 4).standard_normal((2, M.N_SAMPLES))
    inputs = {"B=1": (batch(waves1), 80), "B=8": (batch(waves8), 80),
              "noise B=2": (torch.from_numpy(0.1 * noise).float().cuda(), 80),
              "noise B=2, 128 mels": (torch.from_numpy(0.1 * noise).float().cuda(), 128)}
    worst = 0.0
    for name, (x, n_mels) in inputs.items():
        raw, ref = MF.mel_kernel(x, n_mels), M.log_mel_plain(x, n_mels)
        feats, rfeats = M.normalize_log_mel(raw), M.normalize_log_mel(ref)
        err = max_err(feats, rfeats)
        log(f"K8 log_mel {name}: features max_abs_err {err:.3e} (raw log10 "
            f"{max_err(raw, ref):.3e}), shape {tuple(feats.shape)}")
        require(feats.shape == rfeats.shape and bool(torch.isfinite(feats).all())
                and err <= 1e-3, f"K8 log_mel {name}: err {err}")
        worst = max(worst, err)
    x8 = inputs["B=8"][0]
    raw8 = MF.mel_kernel(x8, 80)
    same = [torch.equal(raw8[i:i + 1], MF.mel_kernel(x8[i:i + 1].contiguous(), 80))
            for i in range(x8.shape[0])]
    log(f"K8 log_mel B=8: each example bitwise its B=1 output: {sum(same)}/{len(same)}")
    require(all(same), "K8 log_mel: a B=1 call differs from its row of the B=8 call")
    window = torch.hann_window(M.N_FFT, device="cuda")
    timed = {}
    for name in ("B=1", "B=8"):
        x, n_mels = inputs[name]
        stft = lambda: torch.stft(x, M.N_FFT, M.HOP_LENGTH, window=window, center=True,
                                  pad_mode="reflect", return_complex=True)
        ms = cuda_ms(lambda: MF.mel_kernel(x, n_mels))
        plain_ms = cuda_ms(lambda: M.log_mel_plain(x, n_mels))
        stft_ms = cuda_ms(stft)
        moved, flops, dft_flops = _log_mel_cost(x, n_mels)
        b_ms = bound(moved, flops, F32_FLOPS)
        log(f"K8 log_mel {name}: kernel {ms:.4f} ms (device "
            f"{device_ms(lambda: MF.mel_kernel(x, n_mels)):.4f}), plain {plain_ms:.4f} ms, "
            f"stft only {stft_ms:.4f} ms (device {device_ms(stft):.4f}), bound "
            f"{b_ms[0]:.4f} ms ({b_ms[1]}: {moved / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP "
            f"by FFT and sparse filter bank; a dense DFT would be "
            f"{dft_flops / 1e9:.2f} GFLOP, {dft_flops / F32_FLOPS * 1e3:.4f} ms on the f32 "
            f"CUDA cores)")
        timed[name] = (ms, plain_ms, b_ms, stft_ms)
    ms, plain_ms, b_ms, stft_ms = timed["B=1"]
    return kernel_record("log_mel", "whisper_medusa_tpu_torch/csrc/mel.cu",
                         "whisper_medusa_tpu/ops/mel_pallas.py:68", (MF, "launches"),
                         worst, ms, plain_ms, b_ms, stft_ms)


def _random_layers(g, dims, nl):
    d, f = dims.d_model, dims.decoder_ffn_dim

    def rnd(*shape, scale=0.02):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    def attn():
        return {"q_w": rnd(nl, d, d), "q_b": rnd(nl, d), "k_w": rnd(nl, d, d),
                "v_w": rnd(nl, d, d), "v_b": rnd(nl, d), "o_w": rnd(nl, d, d),
                "o_b": rnd(nl, d)}

    def ln(*lead):
        return {"scale": (1 + rnd(*lead, d, scale=0.1).float()).to(torch.bfloat16),
                "bias": rnd(*lead, d, scale=0.1)}

    layers = {"self_ln": ln(nl), "self": attn(), "cross_ln": ln(nl), "cross": attn(),
              "ffn_ln": ln(nl), "fc1_w": rnd(nl, d, f), "fc1_b": rnd(nl, f),
              "fc2_w": rnd(nl, f, d), "fc2_b": rnd(nl, d)}
    return layers, ln(), rnd


def _block_layer(g, dims, int8):
    """A random unstacked decoder layer (the Medusa-Block layer)."""
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import qmm as QM

    layer = whisper.layer_params(_random_layers(g, dims, 1)[0], 0)
    return QM.quantize_layers(layer) if int8 else layer


def _plain_2layer(layers, ln_post, blk, got_hidden, x, sk, sv, ck, cv, offsets, s_enc,
                  h, cks=None, cvs=None, ss=None):
    """The plain reference of a 2-layer K2 call: the layer loop and ln_post
    on slots 0 and 1; with a block, the plain block layer applied to the
    kernel's own hidden (its hand-over input) on slot 2, so that
    block_hidden is held to one layer's rounding as the other outputs are
    to two layers'.  A block that read anything but ``hidden`` would still
    disagree."""
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS

    at = lambda a, i: None if a is None else a[i]
    two = slice(0, 2)
    pre, hid, _ = MS.megastep_plain(layers, ln_post, x, sk[two], sv[two], ck[two], cv[two],
                                    offsets, None, s_enc, h, cross_k_s=at(cks, two),
                                    cross_v_s=at(cvs, two), self_s=at(ss, two))
    if blk is None:
        return pre, hid, None
    mask = whisper.make_step_mask(offsets, x.shape[1], sk.shape[2], None)
    bh = whisper.decoder_layer_step(blk, got_hidden, sk[2], sv[2], ck[2], cv[2], offsets,
                                    mask, h, s_enc, cross_k_s=at(cks, 2),
                                    cross_v_s=at(cvs, 2), self_s=at(ss, 2))
    return pre, hid, bh


def check_megastep_2layer_int8(g, t, offs, block=False):
    """K2's int8 mode, two layers (and the block on slot 2 when ``block``),
    at per-example offsets ``offs``: pre_norm, hidden, block_hidden and the
    written self rows of every slot (dequantized) within 3e-2 + 3e-2 |x|;
    every other row and scale untouched."""
    from whisper_medusa_tpu_torch.config import WhisperDims
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS
    from whisper_medusa_tpu_torch.ops import qmm as QM

    dims = WhisperDims(decoder_layers=2)
    b, d, h, s_enc, s_len = len(offs), dims.d_model, 20, 1500, 460
    layers, ln_post, rnd = _random_layers(g, dims, 2)
    layers = QM.quantize_layers(layers)
    blk = _block_layer(g, dims, True) if block else None
    n = 2 + block
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device="cuda",
                                      dtype=torch.int8)
    scl = lambda *shape: 0.004 + 0.012 * torch.rand(shape, generator=g, device="cuda")
    self_k, self_v = i8(n, b, s_len, d), i8(n, b, s_len, d)
    self_s = scl(n, b, s_len, 2 * h).to(torch.bfloat16)
    cross_k, cross_v = i8(n, b, h, 64, s_enc), i8(n, b, s_enc, d)
    cks, cvs = scl(n, b, h, s_enc), scl(n, b, h, s_enc)
    x = rnd(b, t, d, scale=1.0)
    offsets = torch.tensor(offs, dtype=torch.int32, device="cuda")
    sk2, sv2, ss2 = self_k.clone(), self_v.clone(), self_s.clone()
    got = MS.megastep_kernel(layers, ln_post, x, self_k, self_v, cross_k, cross_v,
                             offsets, None, s_enc, h, self_s=self_s, cross_k_s=cks,
                             cross_v_s=cvs, block=blk)
    ref = _plain_2layer(layers, ln_post, blk, got[1], x, sk2, sv2, cross_k, cross_v,
                        offsets, s_enc, h, cks, cvs, ss2)
    outs = [(a, c) for a, c in zip(got, ref) if c is not None]
    require(len(outs) == 2 + block and (got[2] is None) != block, "K2 outputs")
    err = max(max_err(a, c) for a, c in outs)
    written = torch.zeros((b, s_len), dtype=torch.bool, device="cuda")
    for e, off in enumerate(offs):
        written[e, off:off + t] = True
    rows_ok, cerr = True, 0.0
    for a, c, lanes in ((self_k, sk2, slice(0, h)), (self_v, sv2, slice(h, 2 * h))):
        ra = whisper.dequant_self(a[:, written], self_s[:, written][..., lanes], h)
        rc = whisper.dequant_self(c[:, written], ss2[:, written][..., lanes], h)
        rows_ok &= close(ra, rc, 3e-2)
        cerr = max(cerr, max_err(ra, rc))
    untouched = all(torch.equal(a[:, ~written], c[:, ~written])
                    for a, c in ((self_k, sk2), (self_v, sv2), (self_s, ss2)))
    what = "block mode, 2 layers + block" if block else "2-layer"
    log(f"K2 int8 megastep {what} B={b} T={t} offsets {offs}: pre_norm/hidden"
        f"{'/block_hidden' if block else ''} err {err:.3e}, written rows (dequantized, "
        f"{n} slots) err {cerr:.3e}, other rows equal {untouched}")
    ok = all(close(a, c, 3e-2) for a, c in outs) and rows_ok
    require(ok and untouched,
            f"K2 int8 {what} B={b} T={t}: err {err}, rows {cerr}, untouched {untouched}")
    return err


# In block mode, the output elements (of pre_norm, hidden and block_hidden
# together) that may lie outside the elementwise bound of the plain bf16
# value, each inside it of an f32 run (PERF.md section 6 gives the count seen
# on the card).
BLOCK_F32_HELD_MAX = 4


def check_megastep_2layer(g, t, offs, block=False):
    """Two layers (and the block on slot 2 when ``block``) at per-example
    offsets ``offs`` (B = len(offs)): pre_norm, hidden, block_hidden and the
    written cache rows of every slot elementwise within 3e-2 + 3e-2 |x|;
    every other row untouched.  In block mode only, up to BLOCK_F32_HELD_MAX
    output elements may lie outside that bound of the plain bf16 value, each
    inside it of an f32 run of the same call: where the residual stream
    cancels to a small value the two bf16 paths may round a few ulps of the
    stream's scale apart, and the f32 run shows which one is off.  The plain
    block takes the kernel's own ``hidden``, so block_hidden carries one
    layer's rounding, not three."""
    from whisper_medusa_tpu_torch.config import WhisperDims
    from whisper_medusa_tpu_torch.ops import megastep as MS

    dims = WhisperDims(decoder_layers=2)
    b, d, h, s_enc, s_len = len(offs), dims.d_model, 20, 1500, 460
    layers, ln_post, rnd = _random_layers(g, dims, 2)
    blk = _block_layer(g, dims, False) if block else None
    n = 2 + block
    self_k = rnd(n, b, s_len, d, scale=1.0)
    self_v = rnd(n, b, s_len, d, scale=1.0)
    cross_k = rnd(n, b, h, 64, s_enc, scale=1.0)
    cross_v = rnd(n, b, s_enc, d, scale=1.0)
    x = rnd(b, t, d, scale=1.0)
    offsets = torch.tensor(offs, dtype=torch.int32, device="cuda")
    sk2, sv2 = self_k.clone(), self_v.clone()
    # The f32 run's cache, copied before the kernel writes the slabs.
    slabs32 = (self_k.float(), self_v.float()) if block else None
    got = MS.megastep_kernel(layers, ln_post, x, self_k, self_v, cross_k, cross_v,
                             offsets, None, s_enc, h, block=blk)
    ref = _plain_2layer(layers, ln_post, blk, got[1], x, sk2, sv2, cross_k, cross_v,
                        offsets, s_enc, h)
    require(all(a is not None for a in got[:2]) and (got[2] is None) != block,
            "K2 outputs")
    outs = [(a, c) for a, c in zip(got, ref) if c is not None]
    err = max(max_err(a, c) for a, c in outs)
    held = [0] * len(outs)
    if not block:
        ok = all(close(a, c, 3e-2) for a, c in outs)
    else:
        f32 = lambda tree: {k: f32(v) if isinstance(v, dict) else v.float()
                            for k, v in tree.items()}
        ref32 = _plain_2layer(f32(layers), f32(ln_post), f32(blk), got[1].float(),
                              x.float(), *slabs32, cross_k.float(), cross_v.float(),
                              offsets, s_enc, h)
        del slabs32
        ok = True
        for i, ((a, c), c32) in enumerate(zip(outs, ref32)):
            near, near32 = _within(a, c, 3e-2), _within(a, c32, 3e-2)
            held[i] = int((near32 & ~near).sum())
            ok &= bool((near | near32).all())
        ok &= sum(held) <= BLOCK_F32_HELD_MAX
    written = torch.zeros((b, s_len), dtype=torch.bool, device="cuda")
    for e, off in enumerate(offs):
        written[e, off:off + t] = True
    rows_ok, cerr = True, 0.0
    for a, c in ((self_k, sk2), (self_v, sv2)):
        rows_ok &= close(a[:, written], c[:, written], 3e-2)
        cerr = max(cerr, max_err(a[:, written], c[:, written]))
    untouched = (torch.equal(self_k[:, ~written], sk2[:, ~written])
                 and torch.equal(self_v[:, ~written], sv2[:, ~written]))
    what = "block mode, 2 layers + block" if block else "2-layer"
    log(f"K2 megastep {what} B={b} T={t} offsets {offs}: pre_norm/hidden"
        f"{'/block_hidden' if block else ''} err {err:.3e}"
        + (f" (elements held by the f32 run: pre_norm {held[0]}, hidden {held[1]}, "
           f"block_hidden {held[2]} of {got[2].numel()} each; at most "
           f"{BLOCK_F32_HELD_MAX} in all)" if block else "")
        + f", written rows ({n} slots) err {cerr:.3e}, other rows equal {untouched}")
    require(ok and rows_ok and untouched,
            f"K2 {what} B={b} T={t}: err {err}, held {held}, rows {cerr}, "
            f"untouched {untouched}")
    return err


def check_logits(g, embed):
    from whisper_medusa_tpu_torch.ops import logits as LG

    out = {}
    for m in (1, 8, 10, 80, 160, 240):   # 160: pass B at B=16; 240: two launches
        x = torch.randn((m, embed.shape[1]), generator=g, device="cuda").to(torch.bfloat16)
        got = LG.project_kernel(x, embed)
        ref = LG.project_plain(x, embed)
        err = max_err(got, ref)
        tol = 1e-3 * float(ref.abs().max())
        log(f"K3 logits M={m}: max_abs_err {err:.3e} (bound {tol:.3e})")
        require(err <= tol, f"K3 M={m}: err {err} > {tol}")
        out[m] = (x, err)
    same = torch.equal(LG.project_kernel(out[80][0][:10].contiguous(), embed),
                       LG.project_kernel(out[80][0], embed)[:10])
    log(f"K3 logits: the first 10 rows of the M=80 call bitwise an M=10 call: {same}")
    require(same, "K3 logits: a row's bits depend on M")
    for m in (10, 80):     # 80: pass B at B=8
        x = out[m][0]
        b_ms, b_by = bound(nbytes(x, embed) + m * embed.shape[0] * 4,
                           2 * m * embed.shape[0] * embed.shape[1])
        log(f"K3 logits M={m}: kernel {cuda_ms(lambda: LG.project_kernel(x, embed)):.4f} ms, "
            f"device {device_ms(lambda: LG.project_kernel(x, embed)):.4f} ms; x @ E.T "
            f"{cuda_ms(lambda: x @ embed.T):.4f} ms, device {device_ms(lambda: x @ embed.T):.4f} "
            f"ms; bound {b_ms:.4f} ms ({b_by}); {SMI}")
    x10 = out[10][0]
    ms = cuda_ms(lambda: LG.project_kernel(x10, embed))
    plain_ms = cuda_ms(lambda: LG.project_plain(x10, embed))
    lib_ms = cuda_ms(lambda: x10 @ embed.T)
    m, d, v = x10.shape[0], embed.shape[1], embed.shape[0]
    return kernel_record("logits", "whisper_medusa_tpu_torch/csrc/logits.cu",
                         "whisper_medusa_tpu/ops/logits.py:55", (LG, "launches"),
                         max(e for _, e in out.values()), ms, plain_ms,
                         bound(nbytes(x10, embed) + m * v * 4, 2 * m * v * d), lib_ms)


def check_attention_lse(g):
    """K1's log-sum-exp output (``return_lse=True``, what training saves for
    K9) against attention_lse_plain, within 1e-3 absolute (an f32 log of f32
    sums; the kernel's __expf against torch.exp): at (1, 4, 300, 64) causal
    with kv_len 257, and at (2, 20, 1500, 64).  The output beside it is
    bitwise the output without it (serving's launch)."""
    from whisper_medusa_tpu_torch.ops import attention as A

    worst = 0.0
    for (b, h, s), kv_len, causal in (((1, 4, 300), 257, True), ((2, 20, 1500), 1500, False)):
        q, k, v = (torch.randn((b, h, s, 64), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        q = (q.float() * 0.25).to(torch.bfloat16)
        out, lse = A.attention_kernel(q, k, v, kv_len, causal, return_lse=True)
        ref = A.attention_lse_plain(q, k, kv_len, causal)
        err = max_err(lse, ref)
        same = torch.equal(out, A.attention_kernel(q, k, v, kv_len, causal))
        log(f"K1 log-sum-exp ({b},{h},{s},64) kv_len {kv_len} causal {causal}: "
            f"max_abs_err {err:.3e}; output bitwise the serving launch's {same}")
        require(lse.shape == (b, h, s) and err <= 1e-3 and same,
                f"K1 log-sum-exp ({b},{h},{s}): err {err}, same output {same}")
        worst = max(worst, err)
    return worst


def _verify_inputs(g, model, r):
    """Processor masks, positions and gathered columns for R rows, with
    begin-suppress (begin_index 4) and the EOS decay (from position 9) hit."""
    from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig
    from whisper_medusa_tpu_torch.ops import verify as VF

    embed = model.params["whisper"]["decoder"]["embed_tokens"]
    v = model.config.dims.vocab_size
    st = model.special
    gd = model.generation_config
    pcfg = ProcessorConfig(vocab_size=v, suppress_tokens=gd.suppress_tokens,
                           begin_suppress_tokens=gd.begin_suppress_tokens,
                           begin_index=4, exponential_decay_length_penalty=(9, 1.2),
                           eos_token_id=st.eos)
    masks = VF.masks_for(pcfg, "cuda")
    pos = (3 + torch.arange(r, device="cuda") % 12).to(torch.int32)
    gcol = torch.randint(0, v, (r,), generator=g, device="cuda").to(torch.int32)
    gcol[: min(r, 2)] = st.eos
    kw = dict(begin_index=4, eos_id=st.eos, decay=(9, 1.2))
    return embed, masks, pos, gcol, kw


def _clear_argmax(rows, embed, pos, masks, kw, am, ram, gap):
    """Argmax equal on every row whose plain top-2 gap exceeds ``gap``."""
    from whisper_medusa_tpu_torch.ops import verify as VF

    proc = VF.process_rows(VF.row_logits(rows, embed), pos, masks, **kw)
    top2 = proc.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > gap
    return bool(torch.equal(am[clear], ram[clear])), int(clear.sum())


def _int8(model):
    from whisper_medusa_tpu_torch.ops import qmm as QM

    return QM.is_quantized(model.params["whisper"]["decoder"]["embed_tokens"])


def _stats_ok(model, got, ref):
    """(ok, err): bf16 max / lse / gathered within 1e-2; int8 within
    1e-3 + 1e-3 |x|."""
    err = max(max_err(a, b) for a, b in zip(got[1:], ref[1:]))
    if _int8(model):
        return all(close(a, b, 1e-3) for a, b in zip(got[1:], ref[1:])), err
    return err <= 1e-2, err


def check_verify(g, model, identity0=False, name=None):
    """K4 at R = 121 on the 11-node chain: base_head (row block 0 is head 0
    of the hidden rows; 11 heads) or, with ``identity0``, Medusa-Block (row
    block 0 is the hidden state itself, the 10 heads draft from a second
    source, the block's output).  Argmax equal on rows whose plain top-2
    gap exceeds 1e-2; max / lse / gathered as _stats_ok holds them.  The
    row is called ``name`` where given."""
    from whisper_medusa_tpu_torch.ops import qmm as QM
    from whisper_medusa_tpu_torch.ops import verify as VF

    q = _int8(model)
    heads = model.params["medusa"]["heads"]
    hw, hb = QM.wmap(heads["w"], lambda a: a[:, 0]), heads["b"][:, 0]
    n_nodes, kp1 = 11, hb.shape[0] + identity0
    embed, masks, pos, gcol, kw = _verify_inputs(g, model, kp1 * n_nodes)
    d = model.config.dims.d_model
    # Row (k, n) predicts position cur_len + n + k (cur_len 5).
    pos = (5 + torch.arange(n_nodes, device="cuda")[None, :]
           + torch.arange(kp1, device="cuda")[:, None]).reshape(-1).to(torch.int32)
    hid = torch.randn((1, n_nodes, d), generator=g, device="cuda").to(torch.bfloat16)
    src = (torch.randn((1, n_nodes, d), generator=g, device="cuda").to(torch.bfloat16)
           if identity0 else hid)
    kw4 = dict(identity0=identity0, **kw)
    got = VF.verify_hidden_kernel(hid, src, hw, hb, embed, pos, gcol, masks, **kw4)
    ref = VF.verify_hidden_plain(hid, src, hw, hb, embed, pos, gcol, masks, **kw4)
    rows = VF.build_rows(hid, src, hw, hb, identity0)
    arg_ok, n_clear = _clear_argmax(rows, embed, pos, masks, kw, got[0], ref[0], 1e-2)
    ok, err = _stats_ok(model, got, ref)
    name = name or ("verify_hidden" + ("_id0" if identity0 else "") + ("_int8" if q else ""))
    log(f"K4 {name} R={kp1 * n_nodes}: argmax equal on {n_clear} clear rows: "
        f"{arg_ok}; max/lse/gathered max_abs_err {err:.3e}")
    require(arg_ok and ok and got[0].shape == (kp1 * n_nodes,),
            f"K4 {name}: argmax {arg_ok}, err {err}")
    # Stage A's rows are head_rows' rows bit for bit: K5 (stages B and C as
    # one function) over head_rows' rows gives K4's statistics exactly.
    flat = VF.head_rows_kernel(src.reshape(n_nodes, d), hw, hb).reshape(-1, d)
    if identity0:
        flat = torch.cat([hid.reshape(n_nodes, d), flat])
    k5 = VF.verify_rows_kernel(flat, embed, pos, gcol, masks, **kw)
    same = all(torch.equal(a, b) for a, b in zip(got, k5))
    log(f"K4 {name}: statistics bitwise those of K5 over head_rows' rows: {same}")
    require(same, f"K4 {name}: stage A's rows differ from head_rows'")
    kern = lambda: VF.verify_hidden_kernel(hid, src, hw, hb, embed, pos, gcol, masks, **kw4)
    ms = cuda_ms(kern)
    plain_ms = cuda_ms(lambda: VF.verify_hidden_plain(hid, src, hw, hb, embed, pos,
                                                      gcol, masks, **kw4))
    r, v = kp1 * n_nodes, model.config.dims.vocab_size
    sources = (hid, src) if identity0 else (hid,)
    moved = (nbytes(*sources, *_tensors(hw), hb, *_tensors(embed), pos, gcol, masks)
             + 4 * r * 4)
    nh = hb.shape[0]
    ops = 2 * r * v * d + 2 * nh * n_nodes * d * d
    b = bound(moved, ops)
    by_kernel = _kernel_ms(kern)
    stage_a = sum(t for k, t in by_kernel.items() if k.startswith("wgemm_kernel"))
    ba = bound(nbytes(src, *_tensors(hw), hb) + 2 * nh * n_nodes * d, 2 * nh * n_nodes * d * d)
    log(f"K4 {name} R={r}: kernel {ms:.4f} ms events, {sum(by_kernel.values()):.4f} ms "
        f"device, of it stage A ({nh} heads x {n_nodes} rows) {stage_a:.4f} ms, bound "
        f"{ba[0]:.4f} ms ({ba[1]}); plain {plain_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}); "
        f"{SMI}")
    counter = ("q_" if q else "") + ("id0_launches" if identity0 else "launches")
    return kernel_record(name, "whisper_medusa_tpu_torch/csrc/verify.cu",
                         "whisper_medusa_tpu/ops/verify.py:309", (VF, counter),
                         err, ms, plain_ms, b, None)


def _tensors(w):
    """The tensors of a bf16 weight, or both of an int8 one."""
    from whisper_medusa_tpu_torch.ops import qmm as QM

    return [w["q"], w["s"]] if QM.is_quantized(w) else [w]


def _kernel_ms(fn, reps=20):
    """{kernel: device ms per call of fn()} under torch.profiler
    (device_profile._by_kernel), after one warm-up call."""
    from whisper_medusa_tpu_torch.device_profile import _by_kernel

    fn()
    return {k: us / 1e3 for k, (us, _) in _by_kernel(fn, reps).items()}


def _cold_ms(fn):
    """Device ms per call of fn() with the L2 flushed before each call, as
    the decode loop reads the heads (device_profile._cold_ms)."""
    from whisper_medusa_tpu_torch.device_profile import _cold_ms as cold

    fn()
    return cold(fn)


def _head_weights(model):
    """The model's stacked single-layer heads (nh, D, D) and biases (nh, D)."""
    from whisper_medusa_tpu_torch.ops import qmm as QM

    heads = model.params["medusa"]["heads"]
    return QM.wmap(heads["w"], lambda a: a[:, 0]), heads["b"][:, 0]


def _head_yardstick(src, w16, hb):
    """The heads' rows in three PyTorch calls (no one call computes them):
    torch.baddbmm of the biases and src @ W_k for every head, silu, add."""
    pre = torch.baddbmm(hb[:, None, :], src[None].expand(hb.shape[0], -1, -1), w16)
    return src[None] + torch.nn.functional.silu(pre)


def check_head_invariance(g, model, name):
    """The bits of a head row depend on neither M, the heads of the launch,
    nor the entry (K4's stage A is the same GEMM mode): head 0's rows from a
    1-head launch at M = 88 bitwise head 0's rows from an 11-head launch over
    the same first 11 source rows (K4's stage A at B=1); the first 8 rows of
    an M = 88 launch over every head bitwise an M = 8 launch's; the 10 draft
    heads of an 11-head launch bitwise a 10-head launch's (pass B)."""
    from whisper_medusa_tpu_torch.ops import qmm as QM
    from whisper_medusa_tpu_torch.ops import verify as VF

    w, b = _head_weights(model)
    d = model.config.dims.d_model
    src = torch.randn((88, d), generator=g, device="cuda").to(torch.bfloat16)
    one = VF.head_rows_kernel(src, QM.wmap(w, lambda a: a[:1]), b[:1])[0]
    every11 = VF.head_rows_kernel(src[:11].contiguous(), w, b)
    every88 = VF.head_rows_kernel(src, w, b)
    every8 = VF.head_rows_kernel(src[:8].contiguous(), w, b)
    drafts8 = VF.head_rows_kernel(src[:8].contiguous(), QM.wmap(w, lambda a: a[1:]), b[1:])
    checks = {"head 0, 1-head M=88 vs 11-head M=11": torch.equal(one[:11], every11[0]),
              "every head, M=88's first 8 rows vs M=8": torch.equal(every88[:, :8], every8),
              "draft heads, 11-head vs 10-head launch": torch.equal(every8[1:], drafts8)}
    for what, ok in checks.items():
        log(f"{name} bitwise, {what}: {ok}")
        require(ok, f"{name}: {what} differ")


def check_head_rows(g, model, name=None):
    """K4's stage A alone (wm_head_rows) at the shapes the loop gives it,
    elementwise within 3e-2: head 0 at M = 88 and 176 (the two-pass loop's
    head-0 rows at B=8 and B=16, 11 nodes), the 10 draft heads at M = 8 and
    16 (prefill and pass B at B=8 and 16) and M = 1 (prefill at B=1), every
    head at M = 11 (K4's stage A at B=1) and head 0 at M = 300 (past one
    launch's 192 rows: two launches); each call's device time with the L2
    flushed (_cold_ms) beside its byte bound and the three-call yardstick's
    (_head_yardstick; on a bf16 copy of int8 heads); then
    check_head_invariance.  The row is called
    ``name`` where given."""
    from whisper_medusa_tpu_torch.ops import qmm as QM
    from whisper_medusa_tpu_torch.ops import verify as VF

    q = _int8(model)
    name = name or ("head_rows_int8" if q else "head_rows")
    w, b = _head_weights(model)
    d = model.config.dims.d_model
    err, timed = 0.0, None
    for m, lo, hi in ((88, 0, 1), (8, 1, None), (1, 1, None), (176, 0, 1), (16, 1, None),
                      (11, 0, None), (300, 0, 1)):
        hw, hb = QM.wmap(w, lambda a: a[lo:hi]), b[lo:hi]
        src = torch.randn((m, d), generator=g, device="cuda").to(torch.bfloat16)
        got = VF.head_rows_kernel(src, hw, hb)
        ref = VF.head_rows_plain(src, hw, hb)
        e = max_err(got, ref)
        nh = hb.shape[0]
        require(got.shape == ref.shape and close(got, ref, 3e-2),
                f"{name} M={m} heads={nh}: err {e}")
        err = max(err, e)
        if timed is None:
            timed = (src, hw, hb, got)
        dev = _cold_ms(lambda: VF.head_rows_kernel(src, hw, hb))
        bm = bound(nbytes(src, *_tensors(hw), hb, got), 2 * nh * m * d * d)
        w16 = ((hw["q"].float() * hw["s"][:, None, :]).to(torch.bfloat16)
               if QM.is_quantized(hw) else hw)
        yard = _cold_ms(lambda: _head_yardstick(src, w16, hb))
        launches = len(VF.head_plan(m, d, nh)["blocks"])
        log(f"{name} M={m} heads={nh}: max_abs_err {e:.3e}; device {dev:.4f} ms in "
            f"{launches} launch(es), L2 flushed, bound {bm[0]:.4f} ms ({bm[1]}); baddbmm / "
            f"silu / add device {yard:.4f} ms; {SMI}")
        del w16
    check_head_invariance(g, model, name)
    src, hw, hb, got = timed
    ms = cuda_ms(lambda: VF.head_rows_kernel(src, hw, hb))
    plain_ms = cuda_ms(lambda: VF.head_rows_plain(src, hw, hb))
    m, d = src.shape
    return kernel_record(name, "whisper_medusa_tpu_torch/csrc/verify.cu",
                         "whisper_medusa_tpu/ops/verify.py:309",
                         (VF, "q_head_launches" if q else "head_launches"),
                         err, ms, plain_ms,
                         bound(nbytes(src, *_tensors(hw), hb, got), 2 * m * d * d), None)


def check_verify_rows(g, model, sizes=(1, 8, 16, 88, 176, 1024, 1100)):
    """K5 at R in ``sizes`` (16 and 176: vanilla and pass A at B=16; 1100:
    two launches of the blocked wrapper): argmax equal on rows whose plain
    top-2 gap exceeds 1e-2; max / lse / gathered as _stats_ok holds them."""
    from whisper_medusa_tpu_torch.ops import verify as VF

    q = _int8(model)
    name = "verify_rows_int8" if q else "verify_rows"
    worst = 0.0
    timed = {}
    for r in sizes:
        embed, masks, pos, gcol, kw = _verify_inputs(g, model, r)
        d = model.config.dims.d_model
        hs = torch.randn((r, d), generator=g, device="cuda").to(torch.bfloat16)
        got = VF.verify_rows_kernel(hs, embed, pos, gcol, masks, **kw)
        ref = VF.verify_rows_plain(hs, embed, pos, gcol, masks, **kw)
        arg_ok, n_clear = _clear_argmax(hs, embed, pos, masks, kw, got[0], ref[0], 1e-2)
        ok, err = _stats_ok(model, got, ref)
        log(f"K5 {name} R={r}: argmax equal on {n_clear} clear rows: {arg_ok}; "
            f"max/lse/gathered max_abs_err {err:.3e}")
        require(arg_ok and ok, f"K5 {name} R={r}: argmax {arg_ok}, err {err}")
        worst = max(worst, err)
        if r in (8, 88, 176, 1024):
            args = (hs, embed, pos, gcol, masks)
            kern = lambda: VF.verify_rows_kernel(*args, **kw)
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(lambda: VF.verify_rows_plain(*args, **kw))
            v = model.config.dims.vocab_size
            b = bound(nbytes(hs, *_tensors(embed), pos, gcol, masks) + 4 * r * 4,
                      2 * r * v * d)
            log(f"K5 {name} R={r}: kernel {ms:.4f} ms events, {device_ms(kern):.4f} ms "
                f"device; plain {plain_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}); no one "
                f"PyTorch call computes it; {SMI}")
            timed[r] = (ms, plain_ms, b)
    ms, plain_ms, b = timed[88]       # the batched Medusa path's pass A
    return kernel_record(name, "whisper_medusa_tpu_torch/csrc/verify.cu",
                         "whisper_medusa_tpu/ops/verify.py:183",
                         (VF, "q_rows_launches" if q else "rows_launches"),
                         worst, ms, plain_ms, b, None)


def check_qmm(g, qmodel, enc):
    """K6 against qmm_plain (1e-3 of max |y|) at the paths' shapes: one
    example's encoder output (1500, 1280) through layer 0's int8 cross k
    projection (init_cache), the per-op step's int8 projections at B=16
    (M = 176 Medusa rows, 16 vanilla: q (1280, 1280), fc1 (1280, 5120), fc2
    (5120, 1280) of layer 0) and whisper tiny's fc1 at its decode rows (11,
    384, 1536) on a seeded weight.  Bitwise: the first 16 rows of the M=176
    call (one K slice per CTA, summed by a second kernel) and of the M=1500
    call (the slices summed in registers) equal an M=16 call on those rows.
    Each shape is timed against the plain version and torch.matmul on a bf16
    copy of the weight, with both device times under the profiler printed;
    one kernels row each."""
    from whisper_medusa_tpu_torch.ops import qmm as QM

    layers = qmodel.params["whisper"]["decoder"]["layers"]
    tiny_q, tiny_s = QM.quantize_array(
        torch.randn((384, 1536), generator=g, device="cuda") * 0.05)
    cases = [("qmm", enc[0].contiguous(), layers["cross"]["k_w"], None),
             ("qmm (176,1280,1280)", None, layers["self"]["q_w"], 176),
             ("qmm (176,1280,5120)", None, layers["fc1_w"], 176),
             ("qmm (176,5120,1280)", None, layers["fc2_w"], 176),
             ("qmm (16,1280,1280)", None, layers["self"]["q_w"], 16),
             ("qmm tiny (11,384,1536)", None, {"q": tiny_q[None], "s": tiny_s[None]}, 11)]
    rows = []
    for name, x, w, m in cases:
        wq, s = w["q"][0], w["s"][0]
        if x is None:
            x = torch.randn((m, wq.shape[0]), generator=g, device="cuda").to(torch.bfloat16)
        m, k = x.shape
        n = wq.shape[1]
        got, ref = QM.qmm_kernel(x, wq, s), QM.qmm_plain(x, wq, s)
        err, tol = max_err(got, ref), 1e-3 * float(ref.abs().max())
        log(f"K6 {name} ({m},{k},{n}): max_abs_err {err:.3e} (bound {tol:.3e})")
        require(err <= tol, f"K6 {name}: err {err} > {tol}")
        if m > 16:
            same = torch.equal(got[:16], QM.qmm_kernel(x[:16].contiguous(), wq, s))
            log(f"K6 {name}: its first 16 rows bitwise an M=16 call's: {same}")
            require(same, f"K6 {name}: rows differ from an M=16 call on the same rows")
        w16 = wq.to(torch.bfloat16)    # the library yardstick's weight, cast beforehand
        ms = cuda_ms(lambda: QM.qmm_kernel(x, wq, s))
        plain_ms = cuda_ms(lambda: QM.qmm_plain(x, wq, s))
        lib_ms = cuda_ms(lambda: torch.matmul(x, w16))
        log(f"K6 {name}: device time K6 {device_ms(lambda: QM.qmm_kernel(x, wq, s)):.4f} ms, "
            f"matmul {device_ms(lambda: torch.matmul(x, w16)):.4f} ms")
        rows.append(kernel_record(name, "whisper_medusa_tpu_torch/csrc/qmm.cu",
                                  "whisper_medusa_tpu/ops/qmm.py:43", (QM, "launches"), err,
                                  ms, plain_ms,
                                  bound(nbytes(x, wq, s) + m * n * 4, 2 * m * k * n), lib_ms))
    return rows


def check_qmm_nt(g, qmodel):
    """K7 at M = 1 and 8 (prefill base logits, B=1 and B=8), M = 10 (prefill
    draft heads, B=1), M = 80 and 160 (pass B, B=8 and 16) and M = 240 (two
    launches of the blocked wrapper): within 1e-3 of max |y|; the first 10
    rows of the M = 80 call bitwise the M = 10 call's; at M = 10 and 80 its
    time and device time beside ``x @ E.T`` on a bf16 copy."""
    from whisper_medusa_tpu_torch.ops import qmm as QM

    e = qmodel.params["whisper"]["decoder"]["embed_tokens"]
    eq, es = e["q"], e["s"]
    worst, xs, ys = 0.0, {}, {}
    for m in (1, 8, 10, 80, 160, 240):   # 160: pass B at B=16; 240: two launches
        x = torch.randn((m, eq.shape[1]), generator=g, device="cuda").to(torch.bfloat16)
        got, ref = QM.qmm_nt_kernel(x, eq, es), QM.qmm_nt_plain(x, eq, es)
        err, tol = max_err(got, ref), 1e-3 * float(ref.abs().max())
        log(f"K7 qmm_nt M={m}: max_abs_err {err:.3e} (bound {tol:.3e})")
        require(err <= tol, f"K7 qmm_nt M={m}: err {err} > {tol}")
        worst, xs[m], ys[m] = max(worst, err), x, got
    same = torch.equal(QM.qmm_nt_kernel(xs[80][:10].contiguous(), eq, es), ys[80][:10])
    log(f"K7 qmm_nt: the first 10 rows of the M=80 call bitwise an M=10 call: {same}")
    require(same, "K7 qmm_nt: a row's bits depend on M")
    e16 = eq.to(torch.bfloat16)        # the library yardstick's table, cast beforehand
    for m in (10, 80):
        x = xs[m]
        log(f"K7 qmm_nt M={m}: kernel {cuda_ms(lambda: QM.qmm_nt_kernel(x, eq, es)):.4f} ms, "
            f"device {device_ms(lambda: QM.qmm_nt_kernel(x, eq, es)):.4f} ms; x @ E.T on a "
            f"bf16 copy {cuda_ms(lambda: x @ e16.T):.4f} ms, device "
            f"{device_ms(lambda: x @ e16.T):.4f} ms")
    x = xs[10]
    ms = cuda_ms(lambda: QM.qmm_nt_kernel(x, eq, es))
    plain_ms = cuda_ms(lambda: QM.qmm_nt_plain(x, eq, es))
    lib_ms = cuda_ms(lambda: x @ e16.T)
    m, d, v = x.shape[0], eq.shape[1], eq.shape[0]
    return kernel_record("qmm_nt", "whisper_medusa_tpu_torch/csrc/qmm.cu",
                         "whisper_medusa_tpu/ops/qmm.py:90", (QM, "nt_launches"), worst,
                         ms, plain_ms, bound(nbytes(x, eq, es) + m * v * 4, 2 * m * v * d),
                         lib_ms)


# K10 at the per-op step's shapes: (B, T, S, kv_len), on the path (B=16:
# the Medusa chain, vanilla) and off it (kv_len < S, a ragged tail of four
# keys, T=16, another S; T = 17 and 31, two 16-row launches).
CROSS_PATH = ((16, 11, 1500, 1500), (16, 1, 1500, 1500))
CROSS_OFF = ((2, 5, 1500, 1000), (1, 4, 1500, 1497), (3, 16, 640, 640), (2, 17, 1500, 1500),
             (1, 31, 1500, 1400))
DECODE_OPS_SOURCE = "whisper_medusa_tpu_torch/csrc/decode_ops.cu"


def _cross_inputs(g, b, t, s, int8, h=20):
    """q (B, H, T, 64) bf16 (pre-scaled), K (B, H, 64, S), V (B, S, H * 64):
    bf16, or int8 with f32 (B, H, S) scales in the range K2's checks use."""
    q = (torch.randn((b, h, t, 64), generator=g, device="cuda") * 0.125).to(torch.bfloat16)
    if not int8:
        rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        return q, rnd(b, h, 64, s), rnd(b, s, h * 64), None, None
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device="cuda",
                                      dtype=torch.int8)
    scl = lambda *shape: 0.004 + 0.012 * torch.rand(shape, generator=g, device="cuda")
    return q, i8(b, h, 64, s), i8(b, s, h * 64), scl(b, h, s), scl(b, h, s)


def check_cross_decode(g):
    """K10 against its plain version, bf16 and int8, off the path and at the
    per-op step's shapes: elementwise within 1e-2 + 1e-2 |x| (both round P
    to bf16 and the output once; sums in another order may move a value one
    bf16 step).  Every example of the (16, 20, 11, 64) call is bitwise its
    B=1 call.  Timed at (16, 20, 11, 64) x 1500 against the plain version
    and, bf16, SDPA on the same q with K and V re-laid to (B, H, S, 64)
    before timing (scale 1.0, q is pre-scaled), the device times of K10 and
    SDPA under the profiler printed beside; T=1 kernel times printed."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    rows = []
    for int8 in (False, True):
        name = "cross_decode" + ("_int8" if int8 else "")
        worst, timed = 0.0, {}
        for b, t, s, kv in CROSS_OFF + CROSS_PATH:
            q, k, v, ks, vs = _cross_inputs(g, b, t, s, int8)
            got = DO.cross_attention_decode_kernel(q, k, v, kv, ks, vs)
            ref = DO.cross_attention_decode_plain(q, k, v, kv, ks, vs)
            err = max_err(got, ref)
            log(f"K10 {name} ({b},20,{t},64) x {s} kv_len {kv}: max_abs_err {err:.3e}")
            require(got.shape == ref.shape and close(got, ref, 1e-2),
                    f"K10 {name} ({b},{t},{s},{kv}): err {err}")
            worst = max(worst, err)
            if (b, t, s, kv) in CROSS_PATH:
                timed[t] = (q, k, v, ks, vs, ref)
            if (b, t) == (16, 11):
                one = lambda a, i: None if a is None else a[i:i + 1].contiguous()
                same = [torch.equal(got[i:i + 1], DO.cross_attention_decode_kernel(
                    one(q, i), one(k, i), one(v, i), kv, one(ks, i), one(vs, i)))
                    for i in range(b)]
                log(f"K10 {name} ({b},20,{t},64): each example bitwise its B=1 output: "
                    f"{sum(same)}/{b}")
                require(all(same), f"K10 {name}: a B=1 call differs from its row of the "
                                   f"B={b} call")
        q1, k1, v1, ks1, vs1 = timed[1][:5]
        t1_ms = cuda_ms(lambda: DO.cross_attention_decode_kernel(q1, k1, v1, 1500, ks1, vs1))
        log(f"K10 {name} (16,20,1,64) x 1500: kernel {t1_ms:.4f} ms")
        q, k, v, ks, vs, ref = timed[11]
        kern = lambda: DO.cross_attention_decode_kernel(q, k, v, 1500, ks, vs)
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(lambda: DO.cross_attention_decode_plain(q, k, v, 1500, ks, vs))
        lib_ms = None
        log(f"K10 {name} (16,20,11,64) x 1500: device time {device_ms(kern):.4f} ms")
        if not int8:
            b, h, t, _ = q.shape
            kh = k.transpose(2, 3).contiguous()
            vh = v.reshape(b, -1, h, 64).transpose(1, 2).contiguous()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_err = max_err(sdpa(q, kh, vh, scale=1.0), ref)
            lib_ms = cuda_ms(lambda: sdpa(q, kh, vh, scale=1.0))
            log(f"K10 {name}: SDPA on the re-laid K/V at max_abs_err {lib_err:.3e} from "
                f"the plain version, device time "
                f"{device_ms(lambda: sdpa(q, kh, vh, scale=1.0)):.4f} ms")
        b, h, t, _ = q.shape
        moved = nbytes(q, k, v, *([ks, vs] if int8 else [])) + nbytes(q)
        rows.append(kernel_record(
            name, DECODE_OPS_SOURCE, "tools/decode_kernels_experiment.py:48",
            (DO, "q_cross_launches" if int8 else "cross_launches"), worst, ms, plain_ms,
            bound(moved, 4 * b * h * t * 1500 * 64), lib_ms))
    return rows


# K10's mask mode at the per-op step's shapes: (name, B, T, H, chunk mask),
# max_len 460 (the cache of init_cache(..., max_target_positions + 12)),
# offsets spread over 3-400.
SELF_SHAPES = (("large-v2", 16, 11, 20, "causal"), ("large-v2 vanilla", 16, 1, 20, "causal"),
               ("large-v2 tree", 16, 11, 20, "tree"), ("tiny", 8, 11, 6, "causal"),
               ("large-v2 T=17", 8, 17, 20, "causal"), ("large-v2 T=24 tree", 8, 24, 20, "tree"),
               ("large-v2 T=31", 8, 31, 20, "causal"))
SELF_MAX_LEN = 460


def tree_mask(t):
    """A chunk mask other than the causal one: node i sees itself, node 0
    and the even nodes before it."""
    m = torch.eye(t, dtype=torch.bool, device="cuda")
    m[:, 0] = True
    for i in range(t):
        m[i, :i:2] = True
    return m


def check_self_decode(g):
    """K10's mask mode (the per-op step's self-attention) against its plain
    version, ``models/whisper.py::attention`` under ``make_step_mask``
    (``decode_ops.self_attention_decode_plain``), at SELF_SHAPES: elementwise
    within 1e-2 + 1e-2 |x|; every example of the call, and of a B=8 call on
    its first eight, bitwise its B=1 call.  Timed at large-v2's (16, 11)
    against the plain version and SDPA with the step's boolean mask on q, K
    and V re-laid head-major before timing; the bound counts the keys each
    example sees (offset + T)."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    worst, row = 0.0, None
    for name, b, t, h, chunk in SELF_SHAPES:
        rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=g, device="cuda")
                                         * scale).to(torch.bfloat16)
        q = rnd(b, t, h, 64, scale=0.125)
        k, v = rnd(b, SELF_MAX_LEN, h * 64), rnd(b, SELF_MAX_LEN, h * 64)
        off = torch.linspace(3, 400, b, device="cuda").round().to(torch.int32)
        cm = tree_mask(t) if chunk == "tree" else None
        bits = DO.chunk_bits(cm, t, "cuda")
        got = DO.self_attention_decode_kernel(q, k, v, off, bits)
        ref = DO.self_attention_decode_plain(q, k, v, off, cm)
        err = max_err(got, ref)
        what = f"K10 mask mode {name} (B={b}, T={t}, H={h}) x {SELF_MAX_LEN}, {chunk}"
        log(f"{what}: max_abs_err {err:.3e}")
        require(got.shape == ref.shape and close(got, ref, 1e-2), f"{what}: err {err}")
        worst = max(worst, err)
        one = lambda a, i: a[i:i + 1].contiguous()
        for sub in sorted({b, 8}):
            part = got if sub == b else DO.self_attention_decode_kernel(
                q[:sub].contiguous(), k[:sub].contiguous(), v[:sub].contiguous(),
                off[:sub].contiguous(), bits)
            same = [torch.equal(part[i:i + 1], DO.self_attention_decode_kernel(
                one(q, i), one(k, i), one(v, i), one(off, i), bits)) for i in range(sub)]
            log(f"{what}: B={sub}, each example bitwise its B=1 output: {sum(same)}/{sub}")
            require(all(same), f"{what}: a B=1 call differs from its row of the B={sub} call")
        if name != "large-v2":
            continue
        kern = lambda: DO.self_attention_decode_kernel(q, k, v, off, bits)
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(lambda: DO.self_attention_decode_plain(q, k, v, off, cm))
        from whisper_medusa_tpu_torch.models import whisper

        mask = whisper.make_step_mask(off, t, SELF_MAX_LEN, cm)
        qh = q.transpose(1, 2).contiguous()
        kh = k.reshape(b, -1, h, 64).transpose(1, 2).contiguous()
        vh = v.reshape(b, -1, h, 64).transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=1.0)
        lib_err = max_err(lib().transpose(1, 2), ref)
        lib_ms = cuda_ms(lib)
        log(f"{what}: device time {device_ms(kern):.4f} ms; SDPA with the step's mask at "
            f"max_abs_err {lib_err:.3e} from the plain version, {lib_ms:.4f} ms, device "
            f"{device_ms(lib):.4f} ms")
        keys = int((off.long() + t).sum())
        moved = nbytes(q) * 2 + 2 * keys * h * 64 * 2 + nbytes(off, bits)
        row = (ms, plain_ms, bound(moved, 4 * h * t * keys * 64), lib_ms)
    ms, plain_ms, b_ms, lib_ms = row
    return kernel_record("self_decode", DECODE_OPS_SOURCE,
                         "tools/decode_kernels_experiment.py:48", (DO, "self_launches"),
                         worst, ms, plain_ms, b_ms, lib_ms)


def check_step_invariance(model, enc8, name):
    """P3 end to end: one per-op step (``whisper.decoder_layers_ops``, all
    layers) at B=8, T=11, per-example offsets after a T=4 prompt step, and
    the same two steps for each example alone at B=1 on its encoder row.
    Every layer's self-attention (K10's mask mode) is recorded: its output
    for an example at B=8 is bitwise the kernel's output on that example's
    inputs alone; every layer hands it bitwise the B=1 step's inputs, its
    output is bitwise the B=1 step's, and so is the step's hidden output."""
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    p, dims = model.params["whisper"], model.config.dims
    dec, nh, st = p["decoder"], dims.decoder_attention_heads, model.special
    real = DO.self_attention_decode_kernel
    offs = torch.tensor([4, 2, 4, 3, 1, 4, 0, 2], dtype=torch.int32, device="cuda")

    def two_steps(enc, offsets):
        b = enc.shape[0]
        cache = whisper.init_cache(p, dims, enc, dims.max_target_positions + 12)
        zero = torch.zeros((b,), dtype=torch.int32, device="cuda")

        def run(x, o):
            return whisper.decoder_layers_ops(
                dec["layers"], dec["ln_post"], x, cache.self_k, cache.self_v,
                cache.cross_k, cache.cross_v, o, None, dims.max_source_positions, nh,
                cross_k_s=cache.cross_k_s, cross_v_s=cache.cross_v_s, self_s=cache.self_s)

        prompt = torch.tensor([[st.sot, st.first_language, st.transcribe,
                                st.no_timestamps]] * b, device="cuda")
        run(_embedded(dec, prompt, zero), zero)
        rec = []
        DO.self_attention_decode_kernel = lambda *a: rec.append(
            ([x.clone() for x in a], real(*a))) or rec[-1][1]
        try:
            toks = (100 + torch.arange(11, device="cuda")[None] * 7
                    + offsets[:, None].long()) % dims.vocab_size
            hidden = run(_embedded(dec, toks, offsets), offsets)[1]
        finally:
            DO.self_attention_decode_kernel = real
        return rec, hidden

    rec8, hid8 = two_steps(enc8, offs)
    same_in, hid_same = 0, []
    for i in range(enc8.shape[0]):
        rec1, hid1 = two_steps(enc8[i:i + 1], offs[i:i + 1])
        hid_same.append(torch.equal(hid8[i:i + 1], hid1))
        for (args8, out8), (args1, out1) in zip(rec8, rec1):
            # (q, k, v, offsets) are per example; the chunk bits are shared.
            mine = [a[i:i + 1].contiguous() for a in args8[:4]] + args8[4:]
            require(torch.equal(out8[i:i + 1], real(*mine)),
                    f"P3 {name}: example {i}'s self-attention in the B=8 step differs from "
                    f"the kernel on its inputs alone")
            if all(torch.equal(a, b) for a, b in zip(mine, args1)):
                same_in += 1
                require(torch.equal(out8[i:i + 1], out1),
                        f"P3 {name}: example {i}'s self-attention differs from its B=1 "
                        f"step's on the same inputs")
    n = len(rec8) * enc8.shape[0]
    log(f"P3 {name}, per-op step B=8 vs B=1 ({len(rec8)} layers): every self-attention "
        f"output bitwise the kernel's on its own inputs; {same_in}/{n} (layer, example) "
        f"pairs got bitwise the B=1 step's inputs and gave bitwise its output; hidden "
        f"bitwise equal for {sum(hid_same)}/{len(hid_same)} examples")
    require(same_in == n and all(hid_same),
            f"P3 {name}: the per-op step at B=8 is not bitwise its B=1 steps")


def check_ffn_decode(g, d=1280, f=5120, timed_m=176, name="ffn_decode"):
    """K11 against its plain version at (D, F) (large-v2's 1280, 5120 by
    default; tiny's 384, 1536): M = 176 (the Medusa chain at B=16), 16
    (vanilla at B=16; the Medusa chain's pass at B=1 is 11), 1, 130, 192
    (one full launch) and 300 (a 192-row launch and a 108-row tail)
    elementwise within 2e-2 + 2e-2 |x| (one bf16 rounding of the GELU output
    and of y, sums in another order); the first 11 rows of the M=176 call
    bitwise an M=11 call on them.  Timed at ``timed_m`` against the plain
    version; no one PyTorch call computes the FFN, so the three-call cuBLAS
    + GELU time (addmm, gelu, addmm) is printed beside the kernel's, CUDA
    events and device time, at M = 16 and 176."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    rnd = lambda *shape, scale=0.02: (torch.randn(shape, generator=g, device="cuda")
                                      * scale).to(torch.bfloat16)
    w1, b1, w2, b2 = rnd(d, f), rnd(f), rnd(f, d), rnd(d)
    worst, xs = 0.0, {}
    for m in (176, 16, 1, 130, 192, 300):
        x = rnd(m, d, scale=1.0)
        got = DO.ffn_decode_kernel(x, w1, b1, w2, b2)
        ref = DO.ffn_decode_plain(x, w1, b1, w2, b2)
        err = max_err(got, ref)
        log(f"K11 {name} M={m} D={d} F={f}: max_abs_err {err:.3e}")
        require(got.shape == ref.shape and close(got, ref, 2e-2),
                f"K11 {name} M={m}: err {err}")
        worst, xs[m] = max(worst, err), (x, got)
    x176, y176 = xs[176]
    y11 = DO.ffn_decode_kernel(x176[:11].contiguous(), w1, b1, w2, b2)
    log(f"K11 {name}: the first 11 rows of the M=176 call bitwise an M=11 call: "
        f"{torch.equal(y176[:11], y11)}")
    require(torch.equal(y176[:11], y11), f"K11 {name}: M=176 rows differ from an M=11 call")
    gelu = torch.nn.functional.gelu
    for m in (16, 176):
        xm = xs[m][0]
        kern = lambda: DO.ffn_decode_kernel(xm, w1, b1, w2, b2)
        three = lambda: torch.addmm(b2, gelu(torch.addmm(b1, xm, w1)), w2)
        b_ms, b_by = bound(nbytes(xm, w1, b1, w2, b2) + m * d * 2, 4 * m * d * f)
        log(f"K11 {name} M={m}: kernel {cuda_ms(kern):.4f} ms events, {device_ms(kern):.4f} "
            f"ms device; three PyTorch calls (addmm, gelu, addmm) {cuda_ms(three):.4f} ms "
            f"events, {device_ms(three):.4f} ms device; bound {b_ms:.4f} ms ({b_by}); {SMI}")
    x = xs[timed_m][0]
    ms = cuda_ms(lambda: DO.ffn_decode_kernel(x, w1, b1, w2, b2))
    plain_ms = cuda_ms(lambda: DO.ffn_decode_plain(x, w1, b1, w2, b2))
    m = x.shape[0]
    return kernel_record(name, DECODE_OPS_SOURCE,
                         "tools/decode_kernels_experiment.py:110", (DO, "ffn_launches"),
                         worst, ms, plain_ms,
                         bound(nbytes(x, w1, b1, w2, b2) + m * d * 2, 4 * m * d * f), None)


def _embedded(dec, toks, offsets):
    from whisper_medusa_tpu_torch.models import whisper

    pos = (offsets[:, None] + torch.arange(toks.shape[1], device="cuda")[None]).long()
    return whisper.embed_lookup(dec["embed_tokens"], toks.long()) + dec["pos_embed"][pos]


# The cosines check_per_op_step printed against the previous K2 attention
# (commit c6bde6f: cross-attention as 128-key chunk partials and a combine
# kernel, a scalar self-attention kernel), on an NVIDIA H100 80GB HBM3 at
# 700 W: {(mode, T): (pre_norm, hidden)}.
PER_OP_COS_BEFORE = {("bf16", 11): (0.999894, 0.999892), ("bf16", 1): (0.999905, 0.999902),
                     ("int8", 11): (0.999892, 0.999890), ("int8", 1): (0.999901, 0.999899)}


def check_per_op_step(models, enc8, enc16):
    """The per-op step (whisper.decoder_layers_ops: cuBLAS or K6
    projections, K10, K11) against K2 on the same inputs and copies of one
    cache, at full large-v2 width, 32 layers: after a K2 prefill (T=4), (B,
    T) = (8, 11) and (8, 1) at per-example offsets, bf16 and int8.
    pre_norm and hidden cosine >= 0.9998 (the per-op step rounds each
    cuBLAS product to bf16 before its bias; K2 does not), printed beside
    PER_OP_COS_BEFORE.  Times the per-op step and K2 at (8, 11), the per-op
    step at (16, 11); returns the worst cosine."""
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS

    worst = 1.0
    for model in models:
        q = _int8(model)
        mode = "int8" if q else "bf16"
        p, dims = model.params["whisper"], model.config.dims
        dec, nh, st = p["decoder"], dims.decoder_attention_heads, model.special
        cache = whisper.init_cache(p, dims, enc8, dims.max_target_positions + 12)

        def run(fn, x, offsets, c):
            kw = dict(cross_k_s=c.cross_k_s, cross_v_s=c.cross_v_s, self_s=c.self_s)
            return fn(dec["layers"], dec["ln_post"], x, c.self_k, c.self_v, c.cross_k,
                      c.cross_v, offsets, None, dims.max_source_positions, nh, **kw)

        zero = torch.zeros((8,), dtype=torch.int32, device="cuda")
        prompt = torch.tensor([[st.sot, st.first_language, st.transcribe,
                                st.no_timestamps]] * 8, device="cuda")
        run(MS.megastep_kernel, _embedded(dec, prompt, zero), zero, cache)
        for t, offs in ((11, [4, 2, 4, 3, 1, 4, 0, 2]), (1, [15, 9, 13, 14, 5, 11, 2, 7])):
            offsets = torch.tensor(offs, dtype=torch.int32, device="cuda")
            toks = torch.arange(100, 100 + 8 * t, device="cuda").reshape(8, t)
            x = _embedded(dec, toks, offsets)
            copy = whisper.KVCache(
                self_k=cache.self_k.clone(), self_v=cache.self_v.clone(),
                cross_k=cache.cross_k, cross_v=cache.cross_v, cross_k_s=cache.cross_k_s,
                cross_v_s=cache.cross_v_s,
                self_s=None if cache.self_s is None else cache.self_s.clone())
            k2 = run(MS.megastep_kernel, x, offsets, cache)
            ops = run(whisper.decoder_layers_ops, x, offsets, copy)
            cos = [cosine(a, b) for a, b in zip(k2[:2], ops[:2])]
            old = PER_OP_COS_BEFORE[(mode, t)]
            log(f"per-op step vs K2, {mode}, 32 layers, B=8 T={t} offsets {offs}: pre_norm "
                f"cosine {cos[0]:.6f}, hidden {cos[1]:.6f} (against the previous K2 "
                f"attention: {old[0]:.6f}, {old[1]:.6f})")
            require(min(cos) >= 0.9998, f"per-op step vs K2 {mode} T={t}: cosine {cos}")
            worst = min(worst, *cos)
            if t == 11:
                k2_ms = cuda_ms(lambda: run(MS.megastep_kernel, x, offsets, cache))
                ops_ms = cuda_ms(lambda: run(whisper.decoder_layers_ops, x, offsets, copy))
        del copy
        cache16 = whisper.init_cache(p, dims, enc16, dims.max_target_positions + 12)
        off16 = torch.full((16,), 4, dtype=torch.int32, device="cuda")
        x16 = _embedded(dec, torch.arange(100, 276, device="cuda").reshape(16, 11), off16)
        ops16_ms = cuda_ms(lambda: run(whisper.decoder_layers_ops, x16, off16, cache16))
        log(f"per-op step {mode}, 32 layers, T=11: B=8 {ops_ms:.4f} ms (K2 {k2_ms:.4f} ms), "
            f"B=16 {ops16_ms:.4f} ms")
        del cache, cache16
        torch.cuda.empty_cache()
    return worst


def _megastep_cost(dec_layers, ln_post, cache, offs, t, cross_len, block=None):
    """(bytes, flops) of one K2 call: every weight the kernel takes (not the
    cross k/v projections, which init_cache applies) with its scales, the
    block's too, the cross K/V (and scales) and the self K/V history of
    every slot read once; the chunk's K/V rows and the outputs written.  A
    self row is D elements plus, in int8, its head's bf16 scale."""
    from whisper_medusa_tpu_torch.ops import megastep as MS

    trees = [dec_layers] + ([] if block is None else [block])
    weights = [MS._leaf(tree, path) for tree in trees for path in MS._WEIGHTS]
    nl, _, _, d = cache.self_k.shape          # slots: the block's included
    h = cache.cross_k.shape[2]
    scales = [] if cache.self_s is None else [cache.cross_k_s, cache.cross_v_s]
    row = d * cache.self_k.element_size() + (0 if cache.self_s is None else 2 * h)
    m = len(offs) * t
    hist = sum(off + t for off in offs)
    moved = (nbytes(*[x for w in weights for x in _tensors(w)], ln_post["scale"],
                    ln_post["bias"], cache.cross_k, cache.cross_v, *scales)
             + 2 * nl * hist * row + 2 * nl * m * row + (3 + len(trees) - 1) * m * d * 2)

    def mat_elems(tree, stacked):
        """Elements of one layer's weight matrices."""
        mats = [_tensors(MS._leaf(tree, path))[0] for path in MS._WEIGHTS]
        return sum((w[0] if stacked else w).numel() for w in mats
                   if w.dim() == 2 + stacked)

    n_main = nl - len(trees) + 1
    ops = (2 * m * (mat_elems(dec_layers, True) * n_main
                    + (0 if block is None else mat_elems(block, False)))
           + nl * 4 * t * hist * d + nl * 4 * m * cross_len * d)
    return moved, ops


def k2_attention_times(name, run, rows, cache, offsets, offs, t, quant):
    """K2's self- and cross-attention (the cluster body's K2 instantiations)
    in the profile ``rows`` of one step ``run`` (device_profile._by_kernel):
    device ms a launch and launches a layer, beside the byte bound of one
    launch (the self-attention's history, fresh and committed rows; all
    cross K/V) and, on bf16 caches, SDPA's device time on the same work:
    slot 0's cross K/V re-laid head-major, and its self slab under the
    step's mask.  Also how early each starts under programmatic dependent
    launch (the kernel before it still running: its CTAs found room), from
    the trace, and how many of its clusters the card holds at once."""
    import ctypes

    from whisper_medusa_tpu_torch.device_profile import _device_events, _short
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import cuda_lib

    sdpa = torch.nn.functional.scaled_dot_product_attention
    nl, b, s_len, d = cache.self_k.shape
    nh, s_enc = cache.cross_k.shape[2], cache.cross_k.shape[4]
    es, row_s = cache.self_k.element_size(), 2 * nh if quant else 0
    qo = 2 * b * t * d * 2                       # q read and out written, bf16
    hist = sum(offs)
    self_cost = (2 * hist * (d * es + row_s) + 2 * b * t * d * 2
                 + 2 * b * t * (d * es + row_s) + qo,
                 4 * nh * 64 * sum(t * (off + t) for off in offs))
    cross_cost = (2 * b * s_enc * d * cache.cross_k.element_size()
                  + (2 * b * nh * s_enc * 4 if quant else 0) + qo,
                  4 * b * nh * t * s_enc * 64)
    yard = {"self": None, "cross": None}
    if not quant:
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED)
        q = (torch.randn((b, nh, t, 64), generator=g, device="cuda") * 0.125).to(torch.bfloat16)
        heads = lambda x: x.reshape(b, -1, nh, 64).transpose(1, 2).contiguous()
        kh, vh = cache.cross_k[0].transpose(2, 3).contiguous(), heads(cache.cross_v[0])
        yard["cross"] = device_ms(lambda: sdpa(q, kh, vh, scale=1.0))
        sk, sv = heads(cache.self_k[0]), heads(cache.self_v[0])
        mask = whisper.make_step_mask(offsets, t, s_len, None)
        yard["self"] = device_ms(lambda: sdpa(q, sk, sv, attn_mask=mask, scale=1.0))
        del kh, vh, sk, sv
    events = _device_events(run, 2)
    clusters = (ctypes.c_int * 2)()
    require(cuda_lib.lib().wm_megastep_clusters(b, nh, s_len, s_enc, int(quant), clusters) == 0,
            "wm_megastep_clusters")
    for i, (kind, tag, cost) in enumerate((("self", ", true, true>", self_cost),
                                           ("cross", ", false, true>", cross_cost))):
        match = lambda k: k.startswith("cross_decode_kernel<") and k.endswith(tag)
        found = [(us, n) for k, (us, n) in rows.items() if match(k)]
        require(len(found) == 1, f"K2 {name}: one {kind}-attention kernel in the profile")
        us, n = found[0]
        lead = [events[j - 1][2] - events[j][1] for j in range(1, len(events))
                if match(_short(events[j][0]))]
        b_ms, b_by = bound(*cost)
        log(f"K2 {name} B={b} T={t} {kind}-attention (cluster body): device "
            f"{us / n / 1e3:.4f} ms a launch, {n / nl:.0f} a layer ({us / 1e3:.4f} ms a "
            f"step); bound {b_ms:.4f} ms ({b_by}); SDPA "
            + ("none (int8 caches)" if yard[kind] is None else f"{yard[kind]:.4f} ms device")
            + f"; starts {statistics.mean(lead):.2f} us before the kernel before it ends "
            f"(min {min(lead):.2f}); {clusters[i]} clusters fit the card at once; {SMI}")


# K2's kernels by name (device_profile._short): its GEMM (the LN mode's
# instantiations: device_profile.is_ln_gemm), the attention body, and ln_post.
K2_KERNELS = ("wgemm_kernel<", "cross_decode_kernel<", "ln_rows_kernel")
K2_PER_LAYER = 8          # LN + q/k/v, self, o, LN + cross q, cross, cross o, LN + fc1, fc2


def k2_launches(name, rows, slots, b, t):
    """K2's launches a step in the profile ``rows`` of one step
    (device_profile._by_kernel): 8 a layer over ``slots`` layers (the
    block's included) and exactly one ``ln_rows_kernel`` (ln_post); the
    layer norms run inside the q/k/v, cross-q and fc1 GEMMs (3 a layer)."""
    from whisper_medusa_tpu_torch.device_profile import is_ln_gemm

    count = lambda pre: round(sum(n for k, (_, n) in rows.items() if k.startswith(pre)))
    total = sum(count(k) for k in K2_KERNELS)
    ln_rows = count("ln_rows_kernel")
    ln_gemms = round(sum(n for k, (_, n) in rows.items() if is_ln_gemm(k)))
    log(f"K2 {name} B={b} T={t}: {total} launches a step over {slots} layers "
        f"({(total - ln_rows) / slots:.2f} a layer), ln_rows_kernel {ln_rows} a step, "
        f"LN-mode GEMMs {ln_gemms} a step")
    require(total == K2_PER_LAYER * slots + 1 and ln_rows == 1 and ln_gemms == 3 * slots,
            f"K2 {name} B={b} T={t}: {total} launches a step, ln_rows {ln_rows}, "
            f"LN-mode GEMMs {ln_gemms} over {slots} layers")


def k2_alone(dec, cache, x, offsets, dims, nh, block):
    """Each example of a K2 call run alone, as a B=1 call on copies of its
    cache rows (before the batched call commits its chunk): [(pre_norm,
    hidden, block_hidden)] by example."""
    from whisper_medusa_tpu_torch.ops import megastep as MS

    one = lambda t, e: None if t is None else t[:, e:e + 1].contiguous()
    out = []
    for e in range(x.shape[0]):
        kw = dict(block=block)
        if cache.self_s is not None:
            kw.update(cross_k_s=one(cache.cross_k_s, e), cross_v_s=one(cache.cross_v_s, e),
                      self_s=one(cache.self_s, e))
        out.append(MS.megastep_kernel(dec["layers"], dec["ln_post"], x[e:e + 1],
                                      one(cache.self_k, e), one(cache.self_v, e),
                                      one(cache.cross_k, e), one(cache.cross_v, e),
                                      offsets[e:e + 1], None, dims.max_source_positions, nh,
                                      **kw))
    return out


def check_megastep_full(model, enc1, enc8, block=None):
    """The full 32-layer step (and the block on slot 32, given ``block``)
    against the plain layer loop on copies of one cache: at B=1 prefill T=4
    then the T=11 chain, at B=8 prefill T=4, then T=11 and T=1 at
    per-example offsets that differ.  bf16: pre_norm (and block_hidden)
    cosine >= 0.999; int8 (a quantized model): >= 0.9998, its written rows
    dequantized.  With the block, block_hidden also lies at least 4x closer
    (in 1 - cosine) to the plain block_hidden than the plain hidden does, so
    a kernel that skipped the block cannot pass."""
    from whisper_medusa_tpu_torch.device_profile import _by_kernel, _entry_host_ms, _overlap_ms
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS

    q = _int8(model)
    name = "megastep" + ("_block" if block is not None else "") + ("_int8" if q else "")
    p = model.params["whisper"]
    dims = model.config.dims
    dec = p["decoder"]
    nh = dims.decoder_attention_heads
    st = model.special
    f32 = lambda tree: {k: f32(v) if isinstance(v, dict) else v.float()
                        for k, v in tree.items()}
    worst_cos = 1.0
    timings = {}
    for enc, steps in ((enc1, ((4, [0]), (11, [4]))),
                       (enc8, ((4, [0] * 8), (11, [4, 2, 4, 3, 1, 4, 0, 2]),
                               (1, [15, 9, 13, 14, 5, 11, 2, 7])))):
        b = enc.shape[0]
        # The longest cache generate() builds (max_length 448 + 12 rows): its
        # self-attention scores and V rows need more than 48 KB of shared memory.
        cache = whisper.init_cache(p, dims, enc, dims.max_target_positions + 12,
                                   extra_layers=int(block is not None))
        if block is not None:
            whisper.set_block_cross_kv(cache, block, enc, nh)
        sc = {} if not q else dict(cross_k_s=cache.cross_k_s, cross_v_s=cache.cross_v_s)
        for t, offs in steps:
            toks = (torch.tensor([[st.sot, st.first_language, st.transcribe,
                                   st.no_timestamps]] * b) if t == 4 else
                    torch.arange(100, 100 + b * t).reshape(b, t)).to("cuda", torch.int32)
            offsets = torch.tensor(offs, dtype=torch.int32, device="cuda")
            pos = (offsets[:, None] + torch.arange(t, device="cuda")[None]).long()
            x = whisper.embed_lookup(dec["embed_tokens"], toks.long()) + dec["pos_embed"][pos]
            sk, sv = cache.self_k.clone(), cache.self_v.clone()
            ss = None if cache.self_s is None else cache.self_s.clone()
            args = (x, cache.self_k, cache.self_v, cache.cross_k, cache.cross_v,
                    offsets, None, dims.max_source_positions, nh)
            kkw = dict(sc, self_s=cache.self_s, block=block) if q else dict(block=block)
            pkw = dict(sc, self_s=ss, block=block) if q else dict(block=block)
            alone = k2_alone(dec, cache, x, offsets, dims, nh, block) if b > 1 else None
            got, hid, bh = MS.megastep_kernel(dec["layers"], dec["ln_post"], *args, **kkw)
            if alone is not None:
                same = [all(torch.equal(a[0], bat[e]) for a, bat in zip(alone[e], (got, hid, bh))
                            if bat is not None) for e in range(b)]
                log(f"K2 {name} B={b} T={t}: each example's pre_norm, hidden"
                    + (" and block_hidden" if block is not None else "")
                    + f" bitwise its B=1 call's: {sum(same)}/{b}")
                require(all(same), f"K2 {name} B={b} T={t}: an example's bits depend on B")
            ref, rhid, rbh = MS.megastep_plain(dec["layers"], dec["ln_post"], x, sk, sv,
                                               *args[3:], **pkw)
            cos = cosine(got, ref)
            bcos = 1.0 if block is None else cosine(bh, rbh)
            # A kernel that skipped the block (block_hidden = hidden) must
            # not pass: block_hidden lies at least 4x closer, in 1 - cosine,
            # to the plain block_hidden than the plain hidden does.
            skip = 0.0 if block is None else cosine(rhid, rbh)
            applied = block is None or 4 * (1 - bcos) <= 1 - skip
            extra = ""
            if b == 1 and not q:
                # An f32 run of the same step (weights, cache and input
                # upcast): how far each bf16 path lies from it.
                ref32, _, rbh32 = MS.megastep_plain(
                    f32(dec["layers"]), f32(dec["ln_post"]), x.float(), sk.float(),
                    sv.float(), cache.cross_k.float(), cache.cross_v.float(), offsets,
                    None, dims.max_source_positions, nh,
                    block=None if block is None else f32(block))
                extra = (f" (kernel vs f32 {cosine(got, ref32):.6f}, plain bf16 vs f32 "
                         f"{cosine(ref, ref32):.6f})")
                if block is not None:
                    extra += (f"; block_hidden cosine {bcos:.6f} (kernel vs f32 "
                              f"{cosine(bh, rbh32):.6f}, plain bf16 vs f32 "
                              f"{cosine(rbh, rbh32):.6f})")
            elif block is not None:
                extra = f"; block_hidden cosine {bcos:.6f}"
            if block is not None:
                extra += f"; plain hidden vs plain block_hidden cosine {skip:.6f}"
            lg_k = whisper.project_logits(p, hid)
            lg_p = whisper.project_logits(p, rhid)
            top2 = lg_p.float().topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > 5e-2
            arg_ok = bool(torch.equal(lg_k.argmax(-1)[clear], lg_p.argmax(-1)[clear]))
            written = torch.zeros(cache.self_k.shape[1:3], dtype=torch.bool, device="cuda")
            for e, off in enumerate(offs):
                written[e, off:off + t] = True
            # Written rows per slot, as a relative Frobenius error: over 32
            # layers bf16 rounding differences compound (the 2-layer check
            # holds the elementwise bound), so the deep stack is held to a norm.
            nl = cache.self_k.shape[0]

            def rows(slab, scales, i, lanes):
                if scales is None:
                    return slab[i][written]
                return whisper.dequant_self(slab[i], scales[i][..., lanes], nh)[written]

            per_layer = [max(rel_err(rows(cache.self_k, cache.self_s, i, slice(0, nh)),
                                     rows(sk, ss, i, slice(0, nh))),
                             rel_err(rows(cache.self_v, cache.self_s, i, slice(nh, None)),
                                     rows(sv, ss, i, slice(nh, None))))
                         for i in range(nl)]
            rerr = max(per_layer)
            shown = sorted({0, 1, nl // 8, nl // 2, nl - 1})
            log(f"K2 {name} {nl}-slot B={b} T={t} offsets {offs}: pre_norm cosine "
                f"{cos:.6f}{extra}; argmax equal on {int(clear.sum())}/{b * t} rows with "
                f"top-2 gap > 5e-2: {arg_ok}; written rows relative error by slot "
                + " ".join(f"{i}:{per_layer[i]:.2e}" for i in shown))
            floor = 0.9998 if q else 0.999
            require(min(cos, bcos) >= floor and applied and arg_ok and rerr <= 3e-2
                    and (bh is None) == (block is None),
                    f"K2 {name} {nl}-slot B={b} T={t}: cos {cos}, block cos {bcos}, "
                    f"hidden vs block_hidden {skip}, argmax {arg_ok}, rows {rerr}")
            worst_cos = min(worst_cos, cos, bcos)
            if t != 4:
                run = lambda: MS.megastep_kernel(dec["layers"], dec["ln_post"], *args,
                                                 **kkw)
                ms = cuda_ms(run)
                plain_ms = cuda_ms(lambda: MS.megastep_plain(dec["layers"], dec["ln_post"],
                                                             *args, **kkw))
                cost = _megastep_cost(dec["layers"], dec["ln_post"], cache, offs, t,
                                      dims.max_source_positions, block)
                b_ms = bound(*cost)
                log(f"K2 {name} {nl}-slot B={b} T={t}: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {b_ms[0]:.4f} ms ({b_ms[1]}; "
                    f"{cost[0] / 1e9:.3f} GB, {cost[1] / 1e9:.1f} GFLOP)")
                rows = _by_kernel(run, 5)
                k2_launches(name, rows, nl, b, t)
                k2_attention_times(name, run, rows, cache, offsets, offs, t, q)
                gemm = sum(us for k, (us, _) in rows.items() if k.startswith("wgemm_kernel"))
                durations, busy = _overlap_ms(run, 5)
                log(f"K2 {name} {nl}-slot B={b} T={t}: device "
                    f"{sum(us for us, _ in rows.values()) / 1e3:.4f} ms (the projections "
                    f"{gemm / 1e3:.4f} ms), the C entry's host time "
                    f"{_entry_host_ms(run, 'wm_megastep_step'):.4f} ms; the kernels' "
                    f"durations add up to {durations:.4f} ms in {busy:.4f} ms of busy time "
                    f"(programmatic dependent launch overlaps them)")
                timings[(b, t)] = (ms, plain_ms, b_ms)
            cache.self_k.copy_(sk)      # continue from the plain path's cache
            cache.self_v.copy_(sv)
            if q:
                cache.self_s.copy_(ss)
    ms, plain_ms, b_ms = timings[(1, 11)]
    counter = ("q_" if q else "") + ("block_launches" if block is not None else "launches")
    return kernel_record(name, "whisper_medusa_tpu_torch/csrc/megastep.cu",
                         "whisper_medusa_tpu/ops/megastep.py:342", (MS, counter),
                         None, ms, plain_ms, b_ms, None), worst_cos


# ---------------------------------------------------------------------------
# Phases 4-6: the main paths
# ---------------------------------------------------------------------------

def waveforms(seconds):
    rng = np.random.default_rng(SEED)
    out = []
    for i, secs in enumerate(seconds):
        t = np.arange(int(secs * 16000)) / 16000.0
        f0 = 110.0 * (i % 4 + 1) * (1 + 0.1 * np.sin(2 * np.pi * 0.5 * t))
        wave = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 16000.0)
        wave += 0.05 * rng.standard_normal(t.shape)
        out.append(wave.astype(np.float32))
    return out


def _zero_count(k):
    """Set a row's launch counter to 0: a wrapper's integer, or one key of
    its per-shape Counter (K9)."""
    obj, attr, *key = k["counter"]
    if key:
        getattr(obj, attr).pop(key[0], None)
    else:
        setattr(obj, attr, 0)


def _read_count(k):
    obj, attr, *key = k["counter"]
    value = getattr(obj, attr)
    return value.get(key[0], 0) if key else value


def drive(name, kernels, fn, needs, absent=(), seen=None):
    """Run one main path with every launch counter set to 0 just before and
    read just after; the kernels in ``needs`` must have launched, those in
    ``absent`` must not have.  ``seen``, when given, receives the counts."""
    for k in kernels:
        _zero_count(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k["name"]: _read_count(k) for k in kernels}
    log(f"launches [{name}]: " + ", ".join(f"{n} {c}" for n, c in counts.items()))
    for k in kernels:
        k["launches"] = k.get("launches", 0) + counts[k["name"]]
    for n in needs:
        require(counts[n] > 0, f"{n} never launched on the path {name}")
    for n in absent:
        require(counts[n] == 0, f"{n} launched {counts[n]} times on the path {name}")
    if seen is not None:
        seen.update(counts)
    return result, wall


def drive_traced(name, kernels, fn, needs, absent_kernels):
    """``drive`` with the run under torch.profiler: no device kernel whose
    name starts with one of ``absent_kernels`` may run (the old K3 kernel
    and its tile are gone), K2 launches ``ln_rows_kernel`` once a call (its
    layers' norms run inside its GEMMs), and every K3 launch is the shared
    tied-embedding stream on a bf16 table (``nt_stream_kernel<MT, false>``)."""
    import collections

    from whisper_medusa_tpu_torch.device_profile import _device_events, _short

    box, seen = {}, {}
    run = lambda: box.update(out=fn())
    traced = lambda: box.update(names=collections.Counter(
        _short(n) for n, _, _ in _device_events(run)))
    _, wall = drive(name + " (under the profiler)", kernels, traced, needs, seen=seen)
    names = box["names"]
    found = {k: n for k, n in names.items() if k.startswith(tuple(absent_kernels))}
    k3 = sum(n for k, n in names.items()
             if k.startswith("nt_stream_kernel<") and k.endswith(", false>"))
    log(f"kernels [{name}]: absent {list(absent_kernels)}: found {found or 'none'}; "
        f"ln_rows_kernel {names['ln_rows_kernel']} for {seen['megastep']} K2 calls; "
        f"nt_stream_kernel (bf16) {k3} for {seen['logits']} K3 launches")
    require(not found, f"{name}: {found} ran")
    require(names["ln_rows_kernel"] == seen["megastep"] > 0,
            f"{name}: ln_rows_kernel {names['ln_rows_kernel']} for {seen['megastep']} K2 calls")
    require(k3 == seen["logits"] > 0, f"{name}: {k3} stream launches, {seen['logits']} K3")
    return box["out"], wall


def check_output(out, b, vocab, new_tokens=MAX_NEW_TOKENS):
    n_gen = out.lengths - PROMPT_LEN
    require(out.sequences.shape == (b, PROMPT_LEN + new_tokens), "sequence shape")
    require((n_gen >= 1).all() and (out.sequences >= 0).all()
            and (out.sequences < vocab).all(), "token range")
    require(np.isfinite(out.token_logprobs).all() and np.isfinite(out.no_speech_probs).all()
            and np.isfinite(out.avg_logprobs).all(), "finite outputs")
    require(out.steps_per_example.shape == (b,) and out.accepted.shape == (b,),
            "per-example metrics")
    return int(n_gen.sum())


def report(name, out, wall, n_gen):
    log(f"{name}: {wall * 1e3:.1f} ms, {n_gen} generated tokens, {n_gen / wall:.1f} tok/s, "
        f"{out.steps} steps, mean_accept_length {out.mean_accept_length:.3f}")


def check_batch_invariance(model, enc8, variants=("base_head", "vanilla")):
    """speculative_generate at B=8 on the batched encoder output gives every
    example exactly the tokens of a B=1 decode of its encoder row, for each
    of ``variants`` (whisper tiny: both through the per-op step)."""
    from whisper_medusa_tpu_torch.config import GenerationConfig
    from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
    from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig
    from whisper_medusa_tpu_torch.decoding.speculative import speculative_generate

    st, gd, cfg = model.special, model.generation_config, model.config
    b = enc8.shape[0]
    prompt = torch.tensor([[st.sot, st.first_language, st.transcribe,
                            st.no_timestamps]] * b, dtype=torch.int32, device="cuda")
    pcfg = ProcessorConfig(vocab_size=cfg.dims.vocab_size,
                           suppress_tokens=gd.suppress_tokens,
                           begin_suppress_tokens=gd.begin_suppress_tokens,
                           begin_index=PROMPT_LEN, eos_token_id=st.eos)
    gen = GenerationConfig(max_length=PROMPT_LEN + MAX_NEW_TOKENS, eos_token_id=st.eos,
                           pad_token_id=gd.pad_token_id)
    mode = ("int8" if _int8(model) else "bf16") + f" d_model {cfg.dims.d_model}"
    for variant in variants:
        vanilla = variant == "vanilla"
        choices = (1,) if vanilla else cfg.medusa.medusa_choices
        med = None if vanilla else model.params["medusa"]
        buffers = generate_medusa_buffers(choices)
        run = lambda e, p: speculative_generate(model.params["whisper"], med, cfg.dims,
                                                buffers, pcfg, gen, e, p, variant=variant)
        batched = run(enc8, prompt)
        same, acc1 = [], []
        for e in range(b):
            alone = run(enc8[e:e + 1], prompt[e:e + 1])
            same.append(bool(torch.equal(batched.tokens[e], alone.tokens[0]))
                        and int(batched.lengths[e]) == int(alone.lengths[0]))
            acc1.append(int(alone.accepted[0]))
        # Accepted drafts are not held equal: at B=1 the drafts come from K4's
        # head rows, at B=8 from pass B (K3 or K7), which round differently.
        log(f"{mode} batch invariance [{variant}]: B=8 tokens equal to the B=1 decode for "
            f"{sum(same)}/{b} examples; lengths {batched.lengths.tolist()}, "
            f"B=8 steps {batched.steps}; accepted at B=8 "
            f"{batched.accepted.tolist()}, alone {acc1}")
        require(all(same), f"{mode} decode batch invariance [{variant}]: {same}")


def report_generate_invariance(model, feats8, batched):
    """Reported, not required: whether generate at B=8 gives each example
    its B=1 tokens end to end.  The decode is batch-invariant for a given
    encoder output (check_batch_invariance); the encoder's cuBLAS GEMMs may
    round another way at another batch size."""
    same, enc_err = [], 0.0
    enc8 = model.encode(feats8)
    for e in range(feats8.shape[0]):
        enc_err = max(enc_err, max_err(model.encode(feats8[e:e + 1])[0], enc8[e]))
        alone = model.generate(feats8[e:e + 1], language="en",
                               max_new_tokens=MAX_NEW_TOKENS)
        same.append(bool(np.array_equal(alone.sequences[0], batched.sequences[e])))
    log(f"generate B={feats8.shape[0]} vs B=1 (medusa): encoder output max_abs_err "
        f"{enc_err:.3e}; tokens equal for {sum(same)}/{len(same)} examples {same}")


# Kernels each main path must launch, bf16 and int8.
NEEDS = {
    "bf16": {"medusa B=1": ("attention", "megastep", "logits", "head_rows",
                            "verify_hidden"),
             "vanilla B=1": ("attention", "megastep", "logits", "verify_rows"),
             "medusa B=8": ("attention", "megastep", "logits", "head_rows",
                            "verify_rows"),
             "vanilla B=8": ("attention", "megastep", "logits", "verify_rows")},
    "int8": {"medusa B=1": ("attention", "megastep_int8", "qmm", "qmm_nt",
                            "head_rows_int8", "verify_hidden_int8"),
             "vanilla B=1": ("attention", "megastep_int8", "qmm", "qmm_nt",
                             "verify_rows_int8"),
             "medusa B=8": ("attention", "megastep_int8", "qmm", "qmm_nt",
                            "head_rows_int8", "verify_rows_int8"),
             "vanilla B=8": ("attention", "megastep_int8", "qmm", "qmm_nt",
                             "verify_rows_int8")},
}
# Medusa-Block, from waveforms through the fused frontend (K8).
NEEDS_BLOCK = {
    "bf16": {1: ("log_mel", "attention", "megastep_block", "logits", "verify_hidden_id0"),
             BATCH: ("log_mel", "attention", "megastep_block", "logits", "verify_rows")},
    "int8": {1: ("log_mel", "attention", "megastep_block_int8", "qmm", "qmm_nt",
                 "verify_hidden_id0_int8"),
             BATCH: ("log_mel", "attention", "megastep_block_int8", "qmm", "qmm_nt",
                     "verify_rows_int8")},
}


def phase_requests(mode, model, kernels, feats, waves, feats8, batch_secs):
    """Phase 4 for one model: Medusa at B=1 on each of ``feats``, vanilla at
    B=1 on the first, Medusa and vanilla at B=8; {path: outputs}."""
    vocab = model.config.dims.vocab_size
    needs = NEEDS[mode]
    for f, kw in ((feats[0], {}), (feats[0], dict(disable_medusa=True)),
                  (feats8, {}), (feats8, dict(disable_medusa=True))):
        model.generate(f, language="en", max_new_tokens=8, **kw)      # warm-up
    outs, medusa1_ms = {"medusa B=1": []}, []
    for i, f in enumerate(feats):
        out, wall = drive(f"{mode} medusa B=1 request {i}", kernels,
                          lambda: model.generate(f, language="en",
                                                 max_new_tokens=MAX_NEW_TOKENS),
                          needs["medusa B=1"])
        report(f"{mode} request {i} (medusa, B=1, {waves[i].shape[0] / 16000:.1f} s audio)",
               out, wall, check_output(out, 1, vocab))
        outs["medusa B=1"].append(out)
        medusa1_ms.append(wall * 1e3)
    out, wall = drive(f"{mode} vanilla B=1", kernels,
                      lambda: model.generate(feats[0], language="en",
                                             max_new_tokens=MAX_NEW_TOKENS,
                                             disable_medusa=True),
                      needs["vanilla B=1"])
    report(f"{mode} request 0 (vanilla, B=1, {waves[0].shape[0] / 16000:.1f} s audio; "
           f"medusa B=1 requests took {', '.join(f'{m:.1f}' for m in medusa1_ms)} ms)",
           out, wall, check_output(out, 1, vocab))
    outs["vanilla B=1"] = out
    for name, kw in (("medusa", {}), ("vanilla", dict(disable_medusa=True))):
        path = f"{name} B={BATCH}"
        out, wall = drive(f"{mode} {path}", kernels,
                          lambda: model.generate(feats8, language="en",
                                                 max_new_tokens=MAX_NEW_TOKENS, **kw),
                          needs[path])
        outs[path] = out
        report(f"{mode} batched request ({name}, B={BATCH}, audio "
               f"{', '.join(f'{s:.1f}' for s in batch_secs)} s)", out, wall,
               check_output(out, BATCH, vocab))
        log(f"  per-example steps {out.steps_per_example.tolist()}, accepted "
            f"{out.accepted.tolist()}, lengths {out.lengths.tolist()}")
    return outs


def phase_block_requests(mode, bmodel, kernels, proc_k, wave, batch_waves):
    """Phase 4 for a Medusa-Block model: one request at B=1 and one of eight
    waveforms, each from the waveforms through ``proc_k`` (the processor
    with ``use_kernel=True``) inside the driven run; {B: outputs}."""
    vocab = bmodel.config.dims.vocab_size
    outs = {}
    for b, w in ((1, wave), (BATCH, batch_waves)):
        bmodel.generate(proc_k(w), language="en", max_new_tokens=8)        # warm-up
        out, wall = drive(f"{mode} medusa_block B={b}", kernels,
                          lambda: bmodel.generate(proc_k(w), language="en",
                                                  max_new_tokens=MAX_NEW_TOKENS),
                          NEEDS_BLOCK[mode][b])
        report(f"{mode} request (medusa_block, B={b}, fused frontend)", out, wall,
               check_output(out, b, vocab))
        if b > 1:
            log(f"  per-example steps {out.steps_per_example.tolist()}, accepted "
                f"{out.accepted.tolist()}, lengths {out.lengths.tolist()}")
        outs[b] = out
    return outs


BATCH16 = 16
# Past K2's batch: the per-op step (K10, K11; K6 at int8) and never K2.
K2_ROWS = ("megastep", "megastep_int8", "megastep_block", "megastep_block_int8")
NEEDS_B16 = {
    "bf16 medusa": ("attention", "self_decode", "cross_decode", "ffn_decode", "logits",
                    "head_rows", "verify_rows"),
    "int8 medusa": ("attention", "self_decode", "cross_decode_int8", "qmm", "qmm_nt",
                    "head_rows_int8", "verify_rows_int8"),
    "bf16 vanilla": ("attention", "self_decode", "cross_decode", "ffn_decode", "logits",
                     "verify_rows"),
    "bf16 medusa_block": ("log_mel", "attention", "self_decode", "cross_decode",
                          "ffn_decode", "logits", "verify_rows"),
}


def phase_b16_requests(model, qmodel, bmodel, kernels, feats16, proc_k, waves16, secs16):
    """Phase 4 past K2's batch: requests of 16 waveforms (base_head bf16 and
    int8, vanilla bf16, Medusa-Block bf16 from the waveforms through the K8
    processor inside the driven run), each with K2 at 0 launches;
    {path: outputs}."""
    vocab = model.config.dims.vocab_size
    runs = {"bf16 medusa": (model, lambda: feats16, {}),
            "int8 medusa": (qmodel, lambda: feats16, {}),
            "bf16 vanilla": (model, lambda: feats16, dict(disable_medusa=True)),
            "bf16 medusa_block": (bmodel, lambda: proc_k(waves16), {})}
    outs = {}
    for path, (m, feats, kw) in runs.items():
        m.generate(feats(), language="en", max_new_tokens=8, **kw)       # warm-up
        out, wall = drive(f"{path} B={BATCH16}", kernels,
                          lambda: m.generate(feats(), language="en",
                                             max_new_tokens=MAX_NEW_TOKENS, **kw),
                          NEEDS_B16[path], absent=K2_ROWS)
        report(f"{path} request (B={BATCH16}, per-op step, audio "
               f"{', '.join(f'{s:.1f}' for s in secs16)} s)", out, wall,
               check_output(out, BATCH16, vocab))
        log(f"  per-example steps {out.steps_per_example.tolist()}, accepted "
            f"{out.accepted.tolist()}, lengths {out.lengths.tolist()}")
        outs[path] = out
    return outs


# P4: B=1 requests past K4's rows and K2's chunk (the JAX package serves
# both).  (heads, kernels that must launch, kernels that must not.)
P4_NEW_TOKENS = 24
P4_RUNS = ((11, ("attention", "megastep", "logits", "head_rows", "verify_rows"),
            ("verify_hidden",)),
           (16, ("attention", "megastep", "self_decode", "cross_decode", "ffn_decode",
                 "logits", "head_rows", "verify_rows"), ("verify_hidden",)))


def wide_head_model(model, heads, seed):
    """``model``'s Whisper weights (shared, not copied) with ``heads``
    base_head draft heads on a chain of heads + 1 nodes: N(0, 0.02) weights
    and the identity-init biases, from a generator seeded with ``seed``."""
    import dataclasses

    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel

    cfg = model.config.replace(medusa=dataclasses.replace(
        model.config.medusa, medusa_num_heads=heads, medusa_choices=tuple([1] * (heads + 1))))
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    med = bridge.init_medusa_params(cfg, model.params["whisper"], g,
                                    bridge.torch_dtype(cfg.param_dtype))
    med["heads"]["w"].normal_(0.0, 0.02, generator=g)
    return WhisperMedusaModel(cfg, {"whisper": model.params["whisper"], "medusa": med},
                              device=model.device, generation_config=model.generation_config,
                              special_tokens=model.special)


def phase_p4_requests(model, kernels, feat):
    """P4 on the card, bf16, B=1, ``P4_NEW_TOKENS`` new tokens: an 11-head
    base_head model (12 x 12 = 144 verification rows, past K4's 128: the
    loop verifies in two passes, head_rows + K5, and K4 never launches) and
    a 16-head chain (T = 17: the 4-token prefill runs on K2, every decode
    step on the per-op step, whose K10 calls take two 16-row blocks a layer:
    K2 launches once and K10 2 x 32 times a step, in both modes).  Each is
    driven with the launch counters and its tokens held to those of its own
    run with every draft corrupted (``draft_corruption=1.0``)."""
    vocab, nl = model.config.dims.vocab_size, model.config.dims.decoder_layers
    for heads, needs, absent in P4_RUNS:
        m = wide_head_model(model, heads, SEED + 10 + heads)
        m.generate(feat, language="en", max_new_tokens=8)                 # warm-up
        seen = {}
        out, wall = drive(f"bf16 {heads}-head chain B=1", kernels,
                          lambda: m.generate(feat, language="en",
                                             max_new_tokens=P4_NEW_TOKENS),
                          needs, absent, seen)
        report(f"bf16 request ({heads} base_head heads, B=1)", out, wall,
               check_output(out, 1, vocab, P4_NEW_TOKENS))
        require(seen["verify_rows"] == out.steps,
                f"{heads} heads: {seen['verify_rows']} K5 launches in {out.steps} steps")
        if heads == 16:
            per_op = 2 * nl * out.steps
            log(f"  16 heads: K2 {seen['megastep']} launch (the prefill), K10 "
                f"{seen['cross_decode']} and its mask mode {seen['self_decode']} launches in "
                f"{out.steps} steps of T = 17 ({per_op} expected each)")
            require(seen["megastep"] == 1 and seen["cross_decode"] == per_op
                    and seen["self_decode"] == per_op,
                    "16 heads: a T = 17 step did not take the per-op step's 16-row blocks")
        check_corruption(f"bf16 {heads}-head chain B=1", m, feat, out, P4_NEW_TOKENS)
        del m


# Whisper tiny (d_model 384): every decode call takes the per-op step (K2
# takes d_model % 256 == 0); its K11, head_rows and K4's stage A run the
# weight-streaming GEMM with 6 K slices of one 64-wide chunk each.
TINY_D = 384
TINY_ROWS = ("ffn_decode d384", "head_rows d384", "verify d384")
NEEDS_TINY = {
    "bf16 medusa B=1": ("attention", "self_decode", "cross_decode", "ffn_decode d384",
                        "logits", "head_rows d384", "verify d384"),
    "bf16 vanilla B=1": ("attention", "self_decode", "cross_decode", "ffn_decode d384",
                         "logits", "verify_rows"),
    f"bf16 medusa B={BATCH}": ("attention", "self_decode", "cross_decode", "ffn_decode d384",
                               "logits", "head_rows d384", "verify_rows"),
    "int8 medusa B=1": ("attention", "self_decode", "cross_decode_int8", "qmm", "qmm_nt",
                        "head_rows_int8", "verify_hidden_int8"),
    "bf16 medusa_block B=1": ("attention", "self_decode", "cross_decode", "ffn_decode d384",
                              "logits", "verify_hidden_id0"),
}


def tiny_models():
    """Whisper tiny at full width (d_model 384, 4 + 4 layers, 6 heads),
    random bf16 weights from SEED, 10 base_head heads with N(0, 0.02)
    weights; its int8 copy; a Medusa-Block model on its Whisper weights."""
    from whisper_medusa_tpu_torch.config import WHISPER_PRESETS, MedusaConfig, ModelConfig
    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel

    cfg = ModelConfig(dims=WHISPER_PRESETS["tiny"],
                      medusa=MedusaConfig(medusa_hidden_size=TINY_D),
                      param_dtype="bfloat16", compute_dtype="bfloat16")
    require(cfg.dims.d_model == TINY_D, "tiny preset width")
    model = WhisperMedusaModel.from_random(cfg, seed=SEED)
    hg = torch.Generator(device="cuda")
    hg.manual_seed(SEED + 1)
    model.params["medusa"]["heads"]["w"].normal_(0.0, 0.02, generator=hg)
    return model, model.quantize(), bridge.random_block_model(model, seed=SEED + 2)


def phase_tiny_requests(models, kernels, feats, feats8):
    """Whisper tiny served on the card: Medusa at B=1 and B=8, vanilla at
    B=1, int8 Medusa at B=1 and Medusa-Block at B=1, each driven as in
    phase 4 with K2 at 0 launches (the per-op step serves d_model 384);
    then speculative_generate at B=8 gives every example its B=1 tokens
    (held, as check_batch_invariance holds K2's)."""
    model, qmodel, bmodel = models
    vocab = model.config.dims.vocab_size
    runs = {"bf16 medusa B=1": (model, feats[0], {}),
            "bf16 vanilla B=1": (model, feats[0], dict(disable_medusa=True)),
            f"bf16 medusa B={BATCH}": (model, feats8, {}),
            "int8 medusa B=1": (qmodel, feats[0], {}),
            "bf16 medusa_block B=1": (bmodel, feats[0], {})}
    outs = {}
    for path, (m, f, kw) in runs.items():
        m.generate(f, language="en", max_new_tokens=8, **kw)       # warm-up
        out, wall = drive(f"tiny {path}", kernels,
                          lambda: m.generate(f, language="en",
                                             max_new_tokens=MAX_NEW_TOKENS, **kw),
                          NEEDS_TINY[path], absent=K2_ROWS)
        report(f"tiny {path} request", out, wall, check_output(out, f.shape[0], vocab))
        outs[path] = out
    check_batch_invariance(model, model.encode(feats8), ("base_head",))
    return outs


def report_b16_invariance(model, enc16):
    """Printed, not held: whether speculative_generate at B=16 (the per-op
    step) gives each example its B=1 tokens (K2) from the same encoder row;
    cuBLAS and K2 round differently."""
    from whisper_medusa_tpu_torch.config import GenerationConfig
    from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
    from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig
    from whisper_medusa_tpu_torch.decoding.speculative import speculative_generate

    st, gd, cfg = model.special, model.generation_config, model.config
    b = enc16.shape[0]
    prompt = torch.tensor([[st.sot, st.first_language, st.transcribe,
                            st.no_timestamps]] * b, dtype=torch.int32, device="cuda")
    pcfg = ProcessorConfig(vocab_size=cfg.dims.vocab_size,
                           suppress_tokens=gd.suppress_tokens,
                           begin_suppress_tokens=gd.begin_suppress_tokens,
                           begin_index=PROMPT_LEN, eos_token_id=st.eos)
    gen = GenerationConfig(max_length=PROMPT_LEN + MAX_NEW_TOKENS, eos_token_id=st.eos,
                           pad_token_id=gd.pad_token_id)
    buffers = generate_medusa_buffers(cfg.medusa.medusa_choices)
    run = lambda e, p: speculative_generate(model.params["whisper"], model.params["medusa"],
                                            cfg.dims, buffers, pcfg, gen, e, p)
    batched = run(enc16, prompt)
    same, share = [], []
    for e in range(b):
        alone = run(enc16[e:e + 1], prompt[e:e + 1])
        same.append(bool(torch.equal(batched.tokens[e], alone.tokens[0])))
        share.append(float((batched.tokens[e, PROMPT_LEN:]
                            == alone.tokens[0, PROMPT_LEN:]).float().mean()))
    log(f"bf16 B={b} (per-op step) vs B=1 (K2) decode, printed, not held: tokens equal for "
        f"{sum(same)}/{b} examples; share of equal positions per example "
        + " ".join(f"{x:.3f}" for x in share))


def token_share(a, b):
    """Share of generated positions where two outputs hold the same token."""
    return float((a.sequences[:, PROMPT_LEN:] == b.sequences[:, PROMPT_LEN:]).mean())


def check_corruption(mode, model, feat, clean, new_tokens=MAX_NEW_TOKENS):
    """Phase 5: every draft is wrong, so the loop commits one token per step
    (vanilla decoding); the finish rule may stop it a few tokens apart, so
    each example's common prefix is compared."""
    bad = model.generate(feat, language="en", max_new_tokens=new_tokens,
                         draft_corruption=1.0)
    same, n = [], []
    for e in range(bad.sequences.shape[0]):
        n.append(int(min(bad.lengths[e], clean.lengths[e])))
        same.append(np.array_equal(bad.sequences[e, :n[-1]], clean.sequences[e, :n[-1]]))
    log(f"{mode} draft_corruption=1.0: common prefixes ({min(n)}-{max(n)} tokens) identical "
        f"for {sum(same)}/{len(same)} examples, steps {bad.steps} (clean {clean.steps}), "
        f"accepted {int(bad.accepted.sum())}")
    require(all(same) and bad.steps >= clean.steps,
            f"{mode}: tokens changed under draft_corruption=1.0")


# ---------------------------------------------------------------------------
# Phase 7: training (K1 forward, K9 backward)
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_T = 2, 224
# K9 at the training paths' shapes: (Sq, Skv, causal) -> kernels row.
K9_SHAPES = {(TRAIN_T, TRAIN_T, True): "attention_bwd self",
             (TRAIN_T, 1500, False): "attention_bwd cross",
             (1500, 1500, False): "attention_bwd encoder"}
K9_SOURCE = "whisper_medusa_tpu_torch/csrc/attention.cu"
K9_REPLACES = "whisper_medusa_tpu/ops/attention.py:179"


def _attn_bwd_cost(b, h, sq, skv, kv_len, causal, dh=64):
    """(bytes, operations) of one attention backward from the forward's
    statistics: q, k, v, dO and O read once (bf16) with the f32 log-sum-exp,
    dq, dk and dv written once (bf16); five products of 2 Dh operations over
    the (query, key) pairs this call's masks leave visible."""
    pairs = sum(min(kv_len, i + 1) for i in range(sq)) if causal else sq * kv_len
    return (2 * dh * b * h * (4 * sq + 4 * skv) + 4 * b * h * sq,
            5 * 2 * dh * b * h * pairs)


def check_attention_bwd(g):
    """K9 (the one-pass backward) from K1's output and log-sum-exp: off the
    path (ragged Sq, kv_len < Skv, causal and not), then at the training
    paths' three shapes.  dq, dk and dv each within 1e-2 relative
    (Frobenius) of both plain versions, attention_bwd_plain (the TPU
    kernel's arithmetic: row sums of P dP) and attention_bwd_lse_plain (the
    new kernel's: P from the log-sum-exp, Dsum = dO . O), and the dK/dV rows
    of keys past kv_len exactly 0.  Each main-path shape runs twice on the
    same inputs: dQ, dK and dV must be bitwise equal (dQ is one fixed-order
    sum of the key blocks' partials).  K9 alone (O and the log-sum-exp
    given) is timed against the plain version and SDPA's flash backward,
    and gives one kernels row.  The library time is the one aten call that
    computes the backward from the flash forward's saved outputs (scale
    1.0), held to the plain version like K9: timing SDPA's forward +
    backward through autograd, minus the forward, measures the host's
    autograd launches at these sizes."""
    from whisper_medusa_tpu_torch.ops import attention as A
    from whisper_medusa_tpu_torch.ops import cuda_lib

    flash = torch.ops.aten._scaled_dot_product_flash_attention
    flash_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    cases = [((1, 4, 300, 300), 257, True), ((1, 3, 77, 300), 299, False)]
    cases += [((TRAIN_B, 20, sq, skv), skv, causal) for sq, skv, causal in K9_SHAPES]
    rows = []
    for (b, h, sq, skv), kv_len, causal in cases:
        rnd = lambda n, scale=1.0: (torch.randn((b, h, n, 64), generator=g, device="cuda")
                                    * scale).to(torch.bfloat16)
        q, k, v, do = rnd(sq, 0.25), rnd(skv), rnd(skv), rnd(sq)
        o, lse = A.attention_kernel(q, k, v, kv_len, causal, return_lse=True)
        got = A.attention_bwd_kernel(q, k, v, do, kv_len, causal, o=o, lse=lse)
        ref = A.attention_bwd_plain(q, k, v, do, kv_len, causal)
        ref2 = A.attention_bwd_lse_plain(q, k, v, o, lse, do, kv_len, causal)
        rels = [rel_err(a, c) for a, c in zip(got, ref)]
        rels2 = [rel_err(a, c) for a, c in zip(got, ref2)]
        err = max(max_err(a, c) for a, c in zip(got, ref2))
        zero = not (got[1][:, :, kv_len:].any() or got[2][:, :, kv_len:].any())
        what = f"K9 attention_bwd ({b},{h},{sq}x{skv},64) kv_len {kv_len} causal {causal}"
        log(f"{what}: relative error to attention_bwd_plain dq {rels[0]:.2e} dk "
            f"{rels[1]:.2e} dv {rels[2]:.2e}, to attention_bwd_lse_plain dq {rels2[0]:.2e} "
            f"dk {rels2[1]:.2e} dv {rels2[2]:.2e}, max_abs_err {err:.3e}, dK/dV past "
            f"kv_len zero {zero}")
        require(max(rels + rels2) <= 1e-2 and zero, f"{what}: {rels}, {rels2}, zero {zero}")
        key = (sq, skv, causal)
        if b != TRAIN_B or key not in K9_SHAPES:
            continue
        again = A.attention_bwd_kernel(q, k, v, do, kv_len, causal, o=o, lse=lse)
        same = all(torch.equal(a, c) for a, c in zip(again, got))
        log(f"{what}: a second run on the same inputs: dQ, dK and dV bitwise equal {same}")
        require(same, f"{what}: dQ / dK / dV changed between two runs")
        ms = cuda_ms(lambda: A.attention_bwd_kernel(q, k, v, do, kv_len, causal, o=o,
                                                    lse=lse))
        # The C entry alone on buffers allocated once: the wrapper's checks and
        # allocations are host time that the events above include.
        bufs = [torch.empty_like(t) for t in (q, k, v)] + [
            torch.empty((b, h, sq), dtype=torch.float32, device="cuda"),
            torch.empty((-(-skv // A.BWD_KEYS), b, h, sq, 64), dtype=torch.float32,
                        device="cuda")]
        entry_ms = cuda_ms(lambda: cuda_lib.launch(
            "wm_attention_bwd", q.device, *(t.data_ptr() for t in (q, k, v, o, lse, do)),
            *(t.data_ptr() for t in bufs), b, h, sq, skv, 64, kv_len, int(causal)))
        plain_ms = cuda_ms(lambda: A.attention_bwd_lse_plain(q, k, v, o, lse, do, kv_len,
                                                             causal))
        tpu_plain_ms = cuda_ms(lambda: A.attention_bwd_plain(q, k, v, do, kv_len, causal))
        out, lse_f, cq, ck, mq, mk, seed, offset, _ = flash(q, k, v, 0.0, causal, False,
                                                            scale=1.0)
        lib = lambda: flash_bwd(do, q, k, v, out, lse_f, cq, ck, mq, mk, 0.0, causal,
                                seed, offset, scale=1.0)
        lib_rel = max(rel_err(a, c) for a, c in zip(lib(), ref))
        require(lib_rel <= 1e-2, f"{what}: SDPA's flash backward is {lib_rel} from the plain")
        lib_ms = cuda_ms(lib)
        cost = _attn_bwd_cost(b, h, sq, skv, kv_len, causal)
        log(f"{what}: {cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.2f} GFLOP; SDPA's flash "
            f"backward at relative error {lib_rel:.2e}; attention_bwd_plain "
            f"{tpu_plain_ms:.4f} ms; K9's C entry alone {entry_ms:.4f} ms")
        rows.append(kernel_record(K9_SHAPES[key], K9_SOURCE, K9_REPLACES,
                                  (A, "launches_bwd", key), err, ms, plain_ms,
                                  bound(*cost), lib_ms))
    return rows


def _train_config(variant, **dims_kw):
    from whisper_medusa_tpu_torch.config import WhisperDims, MedusaConfig, ModelConfig

    return ModelConfig(dims=WhisperDims(**dims_kw),
                       medusa=MedusaConfig(medusa_heads_type=variant),
                       param_dtype="bfloat16", compute_dtype="bfloat16")


def _train_batch(feats_b, seed):
    """Seeded labels (B, 224) of text-token ids, the second row's last 24
    positions padded with -100."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 50257, size=(feats_b.shape[0], TRAIN_T))
    labels[1:, -24:] = -100
    return feats_b, labels


def _grads(params, cfg, feats, labels, policy):
    """(loss, {trainable leaf: masked gradient}) of one train forward."""
    from whisper_medusa_tpu_torch.training import train as TT

    out, grads = TT.masked_grads(params, cfg, feats, labels, policy, remat=False)
    return float(out.loss.detach()), grads


def check_train_2layer(variant, policy, feats1):
    """One train forward and backward at full width, 2 encoder and 2 decoder
    layers, B=1, T=224, on the card (K1, K9) and on a float32 CPU copy of
    the same bf16 weights and batch (the plain versions): loss within 1e-2
    relative, every trainable leaf's gradient at cosine >= 0.999."""
    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.ops import attention as A

    cfg = _train_config(variant, encoder_layers=2, decoder_layers=2)
    params = bridge.from_random(cfg, seed=SEED, device="cuda")
    hg = torch.Generator(device="cuda")
    hg.manual_seed(SEED + 5)
    params["medusa"]["heads"]["w"].normal_(0.0, 0.02, generator=hg)   # off identity
    f32 = lambda tree: {k: f32(v) if isinstance(v, dict) else v.float().cpu()
                        for k, v in tree.items()}
    cpu = f32(params)
    feats, labels = _train_batch(feats1.float().cpu().numpy(), SEED + 6)
    n9 = sum(A.launches_bwd.values())
    loss, grads = _grads(params, cfg, feats, labels, policy)
    torch.cuda.synchronize()
    n9 = sum(A.launches_bwd.values()) - n9
    loss_c, grads_c = _grads(cpu, cfg.replace(param_dtype="float32"), feats, labels, policy)
    cos = {k: cosine(grads[k].cpu(), grads_c[k]) for k in grads}
    worst = min(cos, key=cos.get)
    rel = abs(loss - loss_c) / abs(loss_c)
    log(f"train 2-layer {variant} / {policy} B=1 T={TRAIN_T}: loss card {loss:.6f}, CPU f32 "
        f"{loss_c:.6f} (relative {rel:.2e}); K9 launches {n9}; gradient cosine over "
        f"{len(cos)} trainable leaves: worst {cos[worst]:.6f} ({worst}), median "
        f"{statistics.median(cos.values()):.6f}")
    require(rel <= 1e-2 and cos[worst] >= 0.999 and n9 == 2,
            f"train 2-layer {variant} / {policy}: loss {rel}, cosine {cos[worst]} at {worst}, "
            f"K9 launches {n9}")


# Training paths: (name, variant, policy, steps, K9 launches per step).
TRAIN_RUNS = (("Medusa-Block recipe", "medusa_block", "whisper", 3, 2),
              ("Medusa-Linear recipe", "base_head", "all_but_last", 3, 2),
              ("full fine-tune", "base_head", None, 1, 96))


def train_run(kernels, name, variant, policy, steps, k9_per_step, feats2):
    """Train steps at full large-v2 width, bf16, B=2, T=224, random weights
    from SEED, one repeated batch, Adafactor at lr 1e-3 (no warmup, constant
    schedule), remat off.  Finite losses; for a recipe the third loss below
    the first; frozen leaves and frozen slices bit-identical; every trained
    leaf changed but those still at 1.0 (a layer-norm scale of 1.0 does not
    move in bf16 at this lr: half a bf16 ulp of 1.0 is 3.9e-3, the step
    1e-3); K9 launched ``k9_per_step`` times per step.  The weights' copy
    for that comparison lives on the host, so the peak memory printed is the
    training's own."""
    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.ops import attention as A
    from whisper_medusa_tpu_torch.training import train as TT

    cfg = _train_config(variant)
    params = bridge.from_random(cfg, seed=SEED, device="cuda")
    before = {k: v.to("cpu", copy=True) for k, v in bridge.flatten(params).items()}
    opt = TT.make_optimizer("adafactor", lr=1e-3, warmup_steps=0, schedule="constant")
    state = TT.init_train_state(params, opt)
    step = TT.make_train_step(cfg, opt, policy, remat=False)
    feats, labels = _train_batch(feats2, SEED + 7)
    needs = ["attention", "attention_bwd self", "attention_bwd cross"]
    if policy is None:
        needs.append("attention_bwd encoder")

    def run():
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            _, metrics = step(state, feats, labels)
            losses.append(float(metrics["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, times

    torch.cuda.reset_peak_memory_stats()
    (losses, times), _ = drive(f"train {name}", kernels, run, needs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    k1, k9 = A.launches / steps, sum(A.launches_bwd[key] for key in K9_SHAPES) / steps
    mask = bridge.flatten(TT.trainable_mask(params, policy))
    frozen_ok, moved, still, ones = True, 0, [], []
    for k, a in bridge.flatten(params).items():
        a, b, m = a.cpu(), before[k], mask[k]
        if TT.is_frozen(m):
            frozen_ok &= torch.equal(a, b)
            continue
        if torch.is_tensor(m):           # all_but_last: only the last slice trains
            frozen_ok &= torch.equal(a[:-1], b[:-1])
            a, b = a[-1], b[-1]
        if not torch.equal(a, b):
            moved += 1
        elif bool((b == 1).all()):
            ones.append(k)               # a layer-norm scale at 1.0: see above
        else:
            still.append(k)
    log(f"train {name} ({variant}, parts_to_freeze={policy}) B={TRAIN_B} T={TRAIN_T}: "
        f"losses {', '.join(f'{x:.6f}' for x in losses)}; ms per step "
        f"{', '.join(f'{t:.1f}' for t in times)}; peak memory {peak:.2f} GiB; per step "
        f"K1 {k1:g}, K9 {k9:g}; trained leaves changed {moved}, unchanged at 1.0 "
        f"{len(ones)}, otherwise unchanged {still or 'none'}; frozen leaves and slices "
        f"identical {frozen_ok}")
    require(all(np.isfinite(losses)) and (steps < 3 or losses[2] < losses[0])
            and frozen_ok and not still and moved > 0 and k9 == k9_per_step,
            f"train {name}: losses {losses}, frozen {frozen_ok}, unchanged {still}, "
            f"K9 per step {k9}")
    return params


def check_grad_guard(params):
    """project_logits (K3, no backward) refuses a hidden state that requires
    grad under grad mode."""
    from whisper_medusa_tpu_torch.models import whisper

    x = torch.zeros((4, 1280), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    try:
        whisper.project_logits(params["whisper"], x)
    except RuntimeError as e:
        require("no backward" in str(e), f"guard: {e}")
        log(f"guard: project_logits on a hidden state that requires grad raises: {e}")
        return
    raise AssertionError("project_logits accepted a hidden state that requires grad")


def check_cli():
    """The training CLI in-process, on a temporary CSV of generated WAV
    files, at --whisper-size tiny (d_model 384: the generate decodes through
    the per-op step, K11, head_rows and K4), bf16, 2 steps, a checkpoint
    every step; its model_components/ loads through from_pretrained and
    answers a generate."""
    import tempfile
    import wave

    from whisper_medusa_tpu_torch.cli import train as cli
    from whisper_medusa_tpu_torch.data.tokenizer import CharTokenizer
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel
    from whisper_medusa_tpu_torch.processor import WhisperMedusaProcessor

    with tempfile.TemporaryDirectory(prefix="wm_smoke_cli_") as tmp:
        waves = waveforms((3.0, 5.5, 4.0, 7.0))
        rows = ["audio,sentence,language"]
        for i, w in enumerate(waves):
            path = os.path.join(tmp, f"{i}.wav")
            with wave.open(path, "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(16000)
                f.writeframes((np.clip(w, -1, 1) * 32767).astype(np.int16).tobytes())
            rows.append(f"{path},utterance number {i},en")
        data = os.path.join(tmp, "data.csv")
        with open(data, "w") as f:
            f.write("\n".join(rows) + "\n")
        out = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        summary = cli.main(["--train-data-path", data, "--validation-data-path", data,
                            "--output-path", out, "--whisper-size", "tiny",
                            "--param-dtype", "bfloat16", "--max-steps", "2",
                            "--save-steps", "1", "--eval-steps", "2", "--warmup-steps", "0",
                            "--batch-size", "2"])
        cli_s = time.perf_counter() - t0
        saved = sorted(os.listdir(os.path.join(out, "checkpoints")))
        model = WhisperMedusaModel.from_pretrained(os.path.join(out, "model_components"))
        proc = WhisperMedusaProcessor(tokenizer=CharTokenizer())
        res = model.generate(proc(waves[0]), language="en", max_new_tokens=16)
    n_gen = int(res.lengths[0]) - PROMPT_LEN
    log(f"cli.train.main (tiny, bf16, 2 steps): {cli_s:.1f} s, {summary}; checkpoints "
        f"{saved}; model_components loaded and generated {n_gen} tokens "
        f"{res.sequences[0, :PROMPT_LEN + n_gen].tolist()}")
    require(summary["final_step"] == 2 and "trainer_state.json" in saved and n_gen >= 1
            and np.isfinite(res.token_logprobs).all(), "cli train / load / generate")


def main():
    smi = phase_env()
    phase_build()
    from whisper_medusa_tpu_torch.config import WHISPER_PRESETS, MedusaConfig, ModelConfig
    from whisper_medusa_tpu_torch.data.tokenizer import CharTokenizer
    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel
    from whisper_medusa_tpu_torch.processor import WhisperMedusaProcessor

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)

    # ---- phase 3: kernels vs plain versions
    k1 = check_attention(g)
    check_tma_guards()
    check_attention_lse(g)
    # The last shape's chunks straddle the 160-key slices of K2's self-
    # attention over S = 460 (each committed by two cluster ranks).
    steps2 = ((4, [0]), (11, [7]), (1, [0, 17, 100, 5, 300, 440, 2, 63]),
              (11, [7, 0, 120, 33, 448, 5, 260, 90]), (11, [155, 315, 150, 0]))
    err2 = max(check_megastep_2layer(g, t, offs) for t, offs in steps2)
    err2q = max(check_megastep_2layer_int8(g, t, offs) for t, offs in steps2)
    err2b = max(check_megastep_2layer(g, t, offs, block=True) for t, offs in steps2)
    err2bq = max(check_megastep_2layer_int8(g, t, offs, block=True) for t, offs in steps2)
    cfg = ModelConfig(dims=WHISPER_PRESETS["large-v2"], medusa=MedusaConfig(),
                      param_dtype="bfloat16", compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = WhisperMedusaModel.from_random(cfg, seed=SEED)
    # The heads from a generator of their own, so that they do not depend on
    # how many draws the kernel checks above made.
    hg = torch.Generator(device="cuda")
    hg.manual_seed(SEED + 1)
    model.params["medusa"]["heads"]["w"].normal_(0.0, 0.02, generator=hg)
    torch.cuda.synchronize()
    log(f"model: whisper-large-v2 + 10 base_head heads, bf16, random (seed {SEED}), "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    qmodel = model.quantize()
    torch.cuda.synchronize()
    log(f"int8 serving copy (model.quantize()): {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated with both models")
    t0 = time.perf_counter()
    bmodel = bridge.random_block_model(model, seed=SEED + 2)     # a generator of its own
    bqmodel = bmodel.quantize()
    torch.cuda.synchronize()
    log(f"Medusa-Block model (10 heads + block layer, the same Whisper weights) and "
        f"its int8 copy: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated with all four models")
    k3 = check_logits(g, model.params["whisper"]["decoder"]["embed_tokens"])
    k4 = check_verify(g, model)
    k4a = check_head_rows(g, model)
    k5 = check_verify_rows(g, model)
    k7 = check_qmm_nt(g, qmodel)
    k4q = check_verify(g, qmodel)
    k4aq = check_head_rows(g, qmodel)
    k5q = check_verify_rows(g, qmodel, sizes=(1, 8, 16, 88, 176))
    k4b = check_verify(g, bmodel, identity0=True)
    k4bq = check_verify(g, bqmodel, identity0=True)

    proc = WhisperMedusaProcessor(tokenizer=CharTokenizer())
    waves = waveforms((8.0, 17.5, 29.0))
    feats = [proc(w) for w in waves]
    for f in feats:
        require(f.shape == (1, 80, 3000) and bool(torch.isfinite(f).all()),
                "processor output")
    batch_secs = tuple(float(s) for s in np.linspace(4.0, 30.0, BATCH))
    batch_waves = waveforms(batch_secs)
    feats8 = proc(batch_waves)
    require(feats8.shape == (BATCH, 80, 3000) and bool(torch.isfinite(feats8).all()),
            "batched processor output")
    k8 = check_mel(waves[:1], batch_waves)
    enc1, enc8 = model.encode(feats[0]), model.encode(feats8)
    k6 = check_qmm(g, qmodel, enc1)
    k2, worst_cos = check_megastep_full(model, enc1, enc8)
    k2["max_abs_err"] = err2
    k2q, worst_cos_q = check_megastep_full(qmodel, enc1, enc8)
    k2q["max_abs_err"] = err2q
    k2b, worst_cos_b = check_megastep_full(bmodel, enc1, enc8, bmodel.params["medusa"]["block"])
    k2b["max_abs_err"] = err2b
    k2bq, worst_cos_bq = check_megastep_full(bqmodel, enc1, enc8,
                                             bqmodel.params["medusa"]["block"])
    k2bq["max_abs_err"] = err2bq
    worst_k2 = min(worst_cos, worst_cos_q, worst_cos_b, worst_cos_bq)
    log(f"K2 32-layer worst cosine against its plain step, every mode: {worst_k2:.9f} (held "
        f">= {K2_COS_FLOOR} at the six decimals it was recorded with)")
    require(round(worst_k2, 6) >= K2_COS_FLOOR,
            f"K2 32-layer cosine against its plain step {worst_k2} below {K2_COS_FLOOR}")
    k10, k10q = check_cross_decode(g)
    k10m = check_self_decode(g)
    k11 = check_ffn_decode(g)
    secs16 = tuple(float(x) for x in np.linspace(4.0, 30.0, BATCH16))
    waves16 = waveforms(secs16)
    feats16 = proc(waves16)
    require(feats16.shape == (BATCH16, 80, 3000) and bool(torch.isfinite(feats16).all()),
            "B=16 processor output")
    enc16 = model.encode(feats16)
    worst_cos_ops = check_per_op_step((model, qmodel), enc8, enc16)
    for m, name in ((model, "large-v2 bf16"), (qmodel, "large-v2 int8")):
        check_step_invariance(m, enc8, name)
    kernels = [*k1, k2, k2q, k3, k4, k4q, k4a, k4aq, k5, k5q, *k6, k7,
               k8, k2b, k2bq, k4b, k4bq, k10, k10q, k10m, k11]

    # ---- phase 4: the main paths, bf16 then int8
    outs = phase_requests("bf16", model, kernels, feats, waves, feats8, batch_secs)
    out, _ = drive_traced(f"bf16 medusa B={BATCH}", kernels,
                          lambda: model.generate(feats8, language="en",
                                                 max_new_tokens=MAX_NEW_TOKENS),
                          NEEDS["bf16"][f"medusa B={BATCH}"],
                          ("logits_kernel", "vocab_tile"))
    require(np.array_equal(out.sequences, outs[f"medusa B={BATCH}"].sequences),
            "the traced request's tokens")
    qouts = phase_requests("int8", qmodel, kernels, feats[:1], waves, feats8, batch_secs)
    for path, qout in qouts.items():
        out = outs[path][0] if path == "medusa B=1" else outs[path]
        qo = qout[0] if path == "medusa B=1" else qout
        log(f"int8 vs bf16 [{path}]: {token_share(qo, out):.3f} of the generated "
            f"positions hold the same token (printed, not held)")
    proc_k = WhisperMedusaProcessor(tokenizer=CharTokenizer(), use_kernel=True)
    bouts = phase_block_requests("bf16", bmodel, kernels, proc_k, waves[0], batch_waves)
    bqouts = phase_block_requests("int8", bqmodel, kernels, proc_k, waves[0], batch_waves)
    for b in bouts:
        log(f"int8 vs bf16 [medusa_block B={b}]: {token_share(bqouts[b], bouts[b]):.3f} of "
            f"the generated positions hold the same token (printed, not held)")
    outs16 = phase_b16_requests(model, qmodel, bmodel, kernels, feats16, proc_k, waves16,
                                secs16)
    phase_p4_requests(model, kernels, feats[0])
    for k in kernels:
        log(f"launches {k['name']} (all main paths): {k['launches']}")

    # ---- phase 5: invariance under corrupted drafts
    check_corruption("bf16", model, feats[0], outs["medusa B=1"][0])
    check_corruption("int8", qmodel, feats[0], qouts["medusa B=1"][0])
    feat_k = proc_k(waves[0])
    check_corruption("bf16 medusa_block", bmodel, feat_k, bouts[1])
    check_corruption("int8 medusa_block", bqmodel, feat_k, bqouts[1])
    check_corruption(f"bf16 B={BATCH16} (per-op step)", model, feats16,
                     outs16["bf16 medusa"])

    # ---- phase 6: decode batch invariance (the encoder is shared: the same rows)
    check_batch_invariance(model, enc8)
    check_batch_invariance(qmodel, enc8)
    check_batch_invariance(bmodel, enc8, ("medusa_block",))
    check_batch_invariance(bqmodel, enc8, ("medusa_block",))
    report_generate_invariance(model, feats8, outs["medusa B=8"])
    report_b16_invariance(model, enc16)

    # ---- phase 4 at whisper tiny (d_model 384): the per-op step, K2 at 0
    tiny = tiny_models()
    kernels += [check_ffn_decode(g, d=TINY_D, f=4 * TINY_D, timed_m=16,
                                 name="ffn_decode d384"),
                check_head_rows(g, tiny[0], name="head_rows d384"),
                check_verify(g, tiny[0], name="verify d384")]
    check_head_invariance(g, tiny[1], "head_rows_int8 d384")
    check_step_invariance(tiny[0], tiny[0].encode(feats8), "tiny bf16")
    phase_tiny_requests(tiny, kernels, feats, feats8)
    for k in kernels:
        if k["name"] in TINY_ROWS:
            log(f"launches {k['name']} (whisper tiny paths): {k['launches']}")
    del tiny

    # ---- phase 7: training (K9), on fresh models after the serving ones go
    check_grad_guard(model.params)
    del model, qmodel, bmodel, bqmodel, outs, qouts, bouts, bqouts, outs16, enc1, enc8, enc16
    torch.cuda.empty_cache()
    kernels += check_attention_bwd(g)
    for variant, policy in (("medusa_block", "whisper"), ("base_head", "all_but_last")):
        check_train_2layer(variant, policy, feats[0])
    for run in TRAIN_RUNS:
        train_run(kernels, *run, feats8[:TRAIN_B])
        torch.cuda.empty_cache()
    check_cli()
    for k in kernels:
        if k["name"].startswith("attention"):
            log(f"launches {k['name']} (all main paths, training included): {k['launches']}")

    rows = [{"name": k["name"], "route": "cuda", "source": k["source"],
             "replaces": k["replaces"], "launches": k["launches"],
             "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
             "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
             "library_ms": k["library_ms"]}
            for k in kernels]
    log(f"K2 32-layer worst pre_norm cosine: bf16 {worst_cos:.6f}, int8 {worst_cos_q:.6f}; "
        f"block mode (pre_norm and block_hidden): bf16 {worst_cos_b:.6f}, int8 "
        f"{worst_cos_bq:.6f} (held >= {K2_COS_FLOOR}); per-op step vs K2 (pre_norm and "
        f"hidden, bf16 and int8): {worst_cos_ops:.6f}")
    log(f"gpu: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
