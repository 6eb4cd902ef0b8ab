#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU (needs torch with CUDA and nvcc).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  1. versions, and the card's name and power limit from nvidia-smi;
  2. build the Hopper kernels from whisper_medusa_tpu_torch/csrc (one nvcc
     per source, in parallel);
  3. hold each kernel against its plain PyTorch version at the shapes the
     paths give it, bf16 and int8 (K1 at the encoder's shapes at B=1 and
     B=8 and whisper tiny's, training's 224 x 224 causal and 224 x 1500, the
     capture pass's causal T x T and T x 1500 at T = 67 (B=1 and B=8, each
     timed beside SDPA and its bound: the "attention capture" rows), and
     off the paths, with every example of the B=8 calls bitwise its B=1
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
     slices, and trees' ancestor masks at T = 11 and 16, B = 1 and 8; its
     32-layer worst cosine against the plain step held at
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
     B=8 and B=16 bitwise B=1, and past 32 chunk columns (trees of 39, 71
     and 130 nodes, two to five words a row of chunk bits, at B = 1, 8 and
     16, every example bitwise its B=1 call; its device time at 39 nodes
     beside SDPA's and its bound), and K11 decode FFN (on K2's weight-streaming
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
     K5's over head_rows' rows; K4 past 128 rows (R = 144: 12 heads x 12
     rows, also in the timestamp mode; 289: 16 heads + identity0 x 17;
     1024: one head over 1024 source rows, stage A in six blocks of 192)
     against verify_hidden_plain, bf16 and int8 here, f32 in 6b and W8A32
     in 6c, each call's statistics bitwise K5's over head_rows' rows and
     timed (the "... R144" rows); K3 (on K7's tied-embedding stream) at
     M = 1 to 240, the first 10 rows of its M=80 call bitwise an M=10
     call's, its device time at M = 10 and 80 beside ``x @ E.T``'s;
     head_rows, K3, K5 and K7 past one
     launch's rows, blocked; K4 and K5 in the timestamp mode (``ts_cfg``):
     K4 at 11 heads x 11 nodes with n_verif = 11, bf16, int8 and identity0
     rows, K5 at R = 11, 88, 176 and 1024, bf16 and int8, on histories
     that make every rule fire and rows of spread norms, so that forced and
     unforced rows both occur (both required, the forced count printed),
     the R=8 call's rows bitwise the first 8 of the R=88 call's, each
     timed beside the non-ts mode on the same rows), and time the kernel,
     the plain version and,
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
     then B=1 requests on long chains (P4): 11 base_head heads (R = 144,
     one K4 pass a step, K5 at 0 launches) and a 16-head chain (a 55.7 MB
     head stack, past the JAX gate's 40 MiB: two passes, K4 at 0; T = 17:
     K2 only for the prefill, K10 in two 16-row launches a layer on every
     step), each held to its run under
     ``draft_corruption=1.0``; then ``return_timestamps=True`` requests
     (Medusa at B=1 and B=8, bf16 and int8, Medusa-Block B=1, vanilla
     B=1; the non-ts verification modes must not launch), each output held
     to the timestamp grammar (no ``<|notimestamps|>``, a timestamp first,
     timestamps non-decreasing, segments as ``_extract_segments`` reads
     them), the B=8 decode to each example's B=1 tokens on the same encoder
     rows, the B=1 Medusa and Medusa-Block tokens to their runs under
     ``draft_corruption=1.0``; the seek loop on a 75 s waveform at B=1
     with ``condition_on_prev_tokens`` and a 40-token "all-segments"
     prompt (each window's prompt prefilled in pieces of at most 16, each
     a K2 launch, the third from offset 32) and on 75 s and 50 s at B=2
     with an ``attention_mask`` (windows, steps, wall and device time
     printed); prompts of 40 and 70 tokens prefilled in pieces against the
     one-pass plain prefill (cosine >= 0.999); then the logits_processor
     hook: a force-token hook at B=1 bf16 Medusa (every token the forced
     one, K4 and K5 at 0 launches: the unfused route, head_rows and K3; the
     hook given CUDA tensors only; device time printed) and an identity hook
     at B=1 and B=8, bf16 and int8, held to the fused route's tokens (a
     token may differ only at an example's first differing position and
     only where the processed top-2 logit gap is under GAP_TOL); then beam
     search (num_beams=5): the beam-folded per-op step against the per-op
     step over cross K/V repeated 5 times (bf16, int8; a 4-token prefill in
     two K10 launches a layer, then one token; within BEAM_STEP_TOL), beam
     requests at B=1 bf16 and int8 and B=2 bf16 (the per-op step: K2, K4 and
     K5 at 0 launches; wall, steps, tokens, peak memory), num_beams=1 with
     length_penalty=0 against vanilla greedy under the same rule, beams with
     timestamps (the grammar) and a 75 s longform request with num_beams=2;
     then branching trees (48 new tokens; K4 and K5 at 0 launches): the
     11-node (1,2,2,1) tree at B=1 and B=8, bf16 and int8, and Medusa-Block
     at B=1 (K2 with the ancestor mask), the 21- and 39-node trees at B=1
     (the per-op step, two and three K10 mask-mode launches a layer, the
     39-node tree over two words a row), each held to its run under
     ``draft_corruption=1.0`` (under the clear-gap rule), the B=8 tree
     decode to each example's B=1 tokens, steps, accept length and device
     time a step printed beside the chain's; sampled requests
     (``temperature=0.7``, B=1 and B=8 bf16, B=1 int8: two runs at seed 0
     equal); a B=8 temperature ladder (0.0, 0.4, 0.8) whose threshold splits
     the greedy outputs: the rows kept at rung 0 equal the greedy request's,
     each retry rung decodes exactly the failing rows; then the capture
     surfaces (64 new tokens, a base_head copy whose head 0 is the
     identity): B=1 and B=8 bf16 and B=1 int8 requests with the score
     stack, DTW word (a pseudo-word tokenizer) and token times, four
     selected cross-attention heads, every self map and the hidden states,
     Medusa-Block B=1 with the score stack, a 75 s longform request with
     word times and the score stack, and score_sequences on the B=8 output:
     K1 and K3 (K6 and K7 at int8) launch inside the capture; tokens equal
     the requests without captures; the maps and hidden states bit for bit
     those of a direct capture of every head, their rows summing to 1; the
     score stack's gathered rows within SCORE_TOL of the loop's token
     log-probs and its clear rows' argmax the emitted token; word and token
     times monotonic inside the audio; B=8 word times within 0.02 s of each
     example's B=1 capture; the device time of the decode, the capture pass
     and the score stack (with its host copy) and peak memory printed; then
     reference checkpoints and the evaluation CLI (``phase_eval_cli``): the
     bf16 model written in the reference's key layout to a temporary
     directory, ``from_pretrained`` on it bitwise the source tensors, and
     ``cli.evaluate.evaluate_model`` over four synthetic WAVs at
     --batch-size 1 and 4 (K1-K4 at B=1, K5 at B=4 required; the summary and
     the CSV's columns printed); the directory removed;
  5. the output is unchanged when every draft is corrupted, bf16 and int8,
     base_head and Medusa-Block, and bf16 base_head at B=16;
  6. decode batch invariance, bf16 and int8: speculative_generate at B=8
     gives every example exactly the tokens of its B=1 decode, for Medusa,
     vanilla and Medusa-Block (accepted counts are printed, not held equal);
     whether generate at B=8 gives each example its B=1 tokens end to end,
     and whether the decode at B=16 (per-op step) gives each example its B=1
     tokens (K2), are printed, not required; then whisper tiny (d_model
     384): K11, head_rows and K4 at D=384 against their plain versions,
     K2 at D=384 (2 layers at (1, 11), (8, 11), (8, 1) in bf16, int8,
     block and int8 block mode within 3e-2 + 3e-2 |x|; tiny's 4-layer step
     in bf16, int8 and block mode against its plain step, every B=8 example
     bitwise its B=1 call, timed: the "... d384" rows), P3 on its per-op
     step, Medusa at B=1 and B=8, vanilla at B=1, int8 Medusa and
     Medusa-Block at B=1 driven as in phase 4 with K2 launching and the
     per-op step's kernels at 0, its decode at B=8 held to its B=1 tokens,
     and a 16-head chain at B=1 (R = 289: one K4 pass a step, K5 at 0;
     T = 17 on the per-op step);
  6b. f32 serving (ModelConfig's default dtype), its model alone on the
     card after the bf16, int8 and Medusa-Block models are deleted: the f32
     modes of K1, K3, K4, head_rows, K5, K10 (cross and mask) and K11 each
     against its plain version on the card at the paths' shapes, within
     1e-4 + 1e-4 |x| (K4 / K5: argmax on the rows whose top-2 gap exceeds
     1e-4, the timestamp mode too), every example of a B=8 (K1) or B=16
     (K10, at T = 11 and 1, each timed) call bitwise its B=1 call, an M=176 / M=88 call's first rows
     bitwise a small call's (K3, head_rows, K11), K4's statistics bitwise
     K5's over head_rows' rows; P3 on the f32 per-op step (its projections
     on the f32 GEMM); f32 large-v2 requests (Medusa B=1 and B=8, vanilla
     B=1, Medusa-Block B=1, timestamps B=1, an identity hook, num_beams=2,
     a vanilla score stack held to the loop's log-probs) with K2 and every
     bf16 / int8 row at 0 launches, each profiled for its device busy time
     and idle share; the B=1 Medusa request under draft_corruption=1.0; the
     B=8 decode's tokens equal to each example's B=1 decode; an f32 whisper
     tiny request against the CPU port on the same weights (a differing
     token only where the CPU's top-2 gap is under 1e-4 of the top logit);
  6c. the int8 copy of 6b's f32 model (``model.quantize()``, W8A32), before
     that model is freed: K2's W8A32 mode, 2 layers at (1, 11), (8, 11) and
     (8, 1) with offsets and in block mode, within 1e-4 + 1e-4 |x| of its
     plain version (the written self rows within one int8 step, B=8
     bitwise B=1), 32 layers at cosine >= W8A32_COS_FLOOR with its device
     time by kernel and 11 launches a layer (W8A32_PER_LAYER: three norms,
     six GEMMs, two attentions, no combine); K4, head_rows and K5 on the
     int8 embedding and heads at the f32 checks' sizes, K10's W8A32 mode at
     (16, 20, 11, 64) and (16, 20, 1, 64) x 1500 (B=16 bitwise B=1, timed
     beside f32 SDPA on the dequantized K/V, T = 1 too); the W8A32 GEMM
     alone at M = 1, 11, 88 through 1280 x 1280, 1280 x 5120 and 5120 x
     1280 against ``megastep.mm_w8`` (rows bitwise across M, timed beside
     ``addmm`` on the dequantized copy and the f32 GEMM); P3
     on the per-op step at B=8 and B=16; requests (Medusa and vanilla B=1,
     Medusa B=8, B=16 on the per-op step, Medusa-Block B=1, timestamps B=1)
     with only the W8A32 rows, K1 f32, K10's f32 mask mode and K6 / K7
     launching; the B=8 decode held to B=1; K2's W8A32 mode at D = 384
     (2 layers at the same shapes and in block mode, the 4-layer step of
     an f32 whisper tiny's int8 copy, B=8 bitwise B=1) and a Medusa B=1
     request on that copy;
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
     answers a generate;
  8. data- and tensor-parallel serving and training: two ranks
     (``chip_smoke.py --parallel-rank``, gloo: NCCL refuses two ranks on
     one card) each rebuild the large-v2 bf16 model of phase 4 (checksum
     held) and run (a) ``shard(dp=2)`` on the B=8 batch, 4 + 4 examples,
     its tokens on the single-process encoder rows held to the
     single-process B=8 decode on both ranks (K2, head_rows, K5 and K3
     launched on each), the end-to-end tokens and encoder rows printed,
     the wall beside the single-process call's; (b) ``shard(tp=2)``, one
     B=1 Medusa request (K2 at 0 launches; K1, K10, K11 on each rank's
     heads), its token share and one per-op step's hidden cosine against
     the single-process ones printed; (c) one DDP=2 Medusa-Linear recipe
     step (base_head + all_but_last, B=2, T=224, Adafactor), the loss
     within PAR_TRAIN_LOSS_RTOL and the heads' gradient within
     PAR_GRAD_RTOL of the single-process step's; then (d) the native audio
     reader against the plain readers on a WAV and a FLAC written here.
     ``chip_smoke.py --parallel-only`` runs this phase alone.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import collections
import contextlib
import json
import math
import os
import re
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

# The capture requests (phase 4): [sot, en, transcribe] and 64 new tokens, so
# the teacher-forced capture pass runs K1 at T = 67 (not a multiple of 128).
CAPTURE_NEW_TOKENS = 64
CAPTURE_T = 3 + CAPTURE_NEW_TOKENS
# K1 at the paths' shapes: ((B, H, Sq, Skv), kv_len, causal): the encoder at
# B=1 and B=8 (large-v2) and B=1 (whisper tiny, 6 heads), training's decoder
# self-attention (causal) and cross-attention (224 queries, 1500 keys), the
# capture pass's causal T x T and T x 1500 at B=1 and B=8; then off the
# paths: causal with a ragged edge, kv_len < Skv, a short ragged Sq.
K1_CAPTURE = (((1, 20, CAPTURE_T, CAPTURE_T), CAPTURE_T, True),
              ((8, 20, CAPTURE_T, CAPTURE_T), CAPTURE_T, True),
              ((1, 20, CAPTURE_T, 1500), 1500, False), ((8, 20, CAPTURE_T, 1500), 1500, False))
K1_PATH = (((1, 20, 1500, 1500), 1500, False), ((8, 20, 1500, 1500), 1500, False),
           ((1, 6, 1500, 1500), 1500, False), ((2, 20, 224, 224), 224, True),
           ((2, 20, 224, 1500), 1500, False)) + K1_CAPTURE
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


def _attention_cost(b, h, sq, skv, causal, dh=64):
    """(bytes, FLOPs) of one K1 call: q, k, v read and the output written
    once; QK^T and PV over the visible (query, key) pairs only."""
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    return 2 * b * h * dh * (2 * sq + 2 * skv), 4 * b * h * pairs * dh


def check_attention(g):
    """K1 against attention_plain (2e-2 max abs) at every shape of K1_PATH
    and K1_OFF; at B=8 every example's output bitwise its B=1 call's (the
    batch invariance the decode checks rely on; the encoder's and the
    capture pass's shapes).  Timed at (1, 20, 1500, 64), (8, 20, 1500, 64)
    and the capture pass's four shapes against the plain version and SDPA
    (scale 1.0, q pre-scaled; causal where K1 is), with the device time of
    K1 and SDPA under the profiler printed beside; six kernels rows."""
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
        capture = ((b, h, sq, skv), kv_len, causal) in K1_CAPTURE
        if b > 1 and (sq == skv == 1500 or capture):
            same = [torch.equal(got[i:i + 1], A.attention_kernel(
                q[i:i + 1].contiguous(), k[i:i + 1].contiguous(), v[i:i + 1].contiguous(),
                kv_len, causal)) for i in range(b)]
            log(f"{what}: each example bitwise its B=1 output: {sum(same)}/{b}")
            require(all(same), f"{what}: a B=1 call differs from its row of the B={b} call")
        if not (h == 20 and sq == 1500 or capture):
            continue
        lib = lambda: sdpa(q, k, v, scale=1.0, is_causal=causal)
        ms = cuda_ms(lambda: A.attention_kernel(q, k, v, kv_len, causal))
        plain_ms = cuda_ms(lambda: A.attention_plain(q, k, v, kv_len, causal))
        lib_ms = cuda_ms(lib)
        log(f"{what}: device time K1 {device_ms(lambda: A.attention_kernel(q, k, v, kv_len, causal)):.4f} "
            f"ms, SDPA {device_ms(lib):.4f} ms")
        name = "attention" if b == 1 else f"attention B={b}"
        if capture:
            name = f"attention capture {'self' if causal else 'cross'} B={b}"
        rows.append(kernel_record(name, K1_SOURCE, K1_REPLACES, (A, "launches"), err, ms,
                                  plain_ms, bound(*_attention_cost(b, h, sq, skv, causal)),
                                  lib_ms))
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
                  h, cks=None, cvs=None, ss=None, chunk_mask=None):
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
                                    offsets, chunk_mask, s_enc, h, cross_k_s=at(cks, two),
                                    cross_v_s=at(cvs, two), self_s=at(ss, two))
    if blk is None:
        return pre, hid, None
    mask = whisper.make_step_mask(offsets, x.shape[1], sk.shape[2], chunk_mask)
    bh = whisper.decoder_layer_step(blk, got_hidden, sk[2], sv[2], ck[2], cv[2], offsets,
                                    mask, h, s_enc, cross_k_s=at(cks, 2),
                                    cross_v_s=at(cvs, 2), self_s=at(ss, 2))
    return pre, hid, bh


# K2 under a tree's ancestor mask: the (1,2,2,1) tree (11 nodes) and the
# (1,3,4) tree (16 nodes), at B=1 and B=8.
K2_TREES = {11: (1, 2, 2, 1), 16: (1, 3, 4)}
K2_TREE_STEPS = ((11, [7]), (16, [0]), (11, [7, 0, 120, 33, 448, 5, 260, 90]),
                 (16, [3, 0, 120, 33, 444, 5, 260, 90]))


def k2_tree_masks():
    """{T: the (T, T) bool ancestor mask of K2_TREES[T]} on the card."""
    from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers

    return {t: torch.from_numpy(generate_medusa_buffers(c).attn_mask).cuda()
            for t, c in K2_TREES.items()}


def check_megastep_2layer_int8(g, t, offs, block=False, chunk_mask=None, dims=None):
    """K2's int8 mode, two layers (and the block on slot 2 when ``block``),
    at per-example offsets ``offs``: pre_norm, hidden, block_hidden and the
    written self rows of every slot (dequantized) within 3e-2 + 3e-2 |x|;
    every other row and scale untouched.  ``chunk_mask``: a (T, T) tree
    mask in place of the causal one.  ``dims``: the widths (large-v2's by
    default; whisper tiny's for K2 at D = 384)."""
    from whisper_medusa_tpu_torch.config import WhisperDims
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS
    from whisper_medusa_tpu_torch.ops import qmm as QM

    dims = WhisperDims(decoder_layers=2) if dims is None else dims
    b, d, h, s_enc, s_len = len(offs), dims.d_model, dims.decoder_attention_heads, 1500, 460
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
                             offsets, chunk_mask, s_enc, h, self_s=self_s, cross_k_s=cks,
                             cross_v_s=cvs, block=blk)
    ref = _plain_2layer(layers, ln_post, blk, got[1], x, sk2, sv2, cross_k, cross_v,
                        offsets, s_enc, h, cks, cvs, ss2, chunk_mask)
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
    what = ("block mode, 2 layers + block" if block else "2-layer") + (
        "" if chunk_mask is None else ", tree mask") + f" D={d}"
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


def check_megastep_2layer(g, t, offs, block=False, chunk_mask=None, dims=None):
    """Two layers (and the block on slot 2 when ``block``) at per-example
    offsets ``offs`` (B = len(offs)), under the causal chunk mask or the
    (T, T) tree mask ``chunk_mask``: pre_norm, hidden, block_hidden and the
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

    dims = WhisperDims(decoder_layers=2) if dims is None else dims
    b, d, h, s_enc, s_len = len(offs), dims.d_model, dims.decoder_attention_heads, 1500, 460
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
                             offsets, chunk_mask, s_enc, h, block=blk)
    ref = _plain_2layer(layers, ln_post, blk, got[1], x, sk2, sv2, cross_k, cross_v,
                        offsets, s_enc, h, chunk_mask=chunk_mask)
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
                              offsets, s_enc, h, chunk_mask=chunk_mask)
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
    what = ("block mode, 2 layers + block" if block else "2-layer") + (
        "" if chunk_mask is None else ", tree mask") + f" D={d}"
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


# The timestamp mode of K4 and K5 (ts_cfg): histories that make every rule
# fire, cycled over the rows (last, penult, maxts as offsets from
# timestamp_begin where they are timestamps): after text, after one
# timestamp, after two, a running max with text last, a running max after a
# lone timestamp; rows at begin_index 4 take the initial cap.
TS_KINDS = ((50, 40, None), (42, 17, None), ("t3", 55, "t3"), ("t9", "t7", "t9"),
            (99, "t60", "t60"), ("t200", 31, "t200"), ("t2", 7, "t2"))


def _ts_operands(model, r, n_verif):
    """The timestamp mode's operands for R rows (verify._ts_args form)."""
    from whisper_medusa_tpu_torch.ops import verify as VF

    tb = model.special.timestamp_begin
    val = lambda x: 0 if x is None else (tb + int(x[1:]) if isinstance(x, str) else x)
    cols = [[val(k[j]) for k in (TS_KINDS[i % len(TS_KINDS)] for i in range(r))]
            for j in range(3)]
    last, penult, maxts = (torch.tensor(c, dtype=torch.int32, device="cuda") for c in cols)
    cfg = (tb, model.special.no_timestamps, model.generation_config.max_initial_timestamp_index)
    return VF._ts_args(cfg, n_verif, last, penult, maxts, r, torch.device("cuda"))


def _ts_kw(ts):
    return dict(ts_cfg=ts["cfg"], n_verif=ts["n_verif"], last=ts["last"],
                penult=ts["penult"], maxts=ts["maxts"])


def _ts_clear(rows, embed, pos, masks, kw, ts, am, ram, gap):
    """(argmax equal on the clear rows, clear rows, forced rows): a row is
    clear where the top-2 gap of what it chooses from (the timestamp columns
    of a forced row, else every column) exceeds ``gap`` (a number, or one a
    row) and, for a verification row, the force rule's two sides differ by
    more than it."""
    from whisper_medusa_tpu_torch.ops import verify as VF

    x = VF.process_rows(VF.row_logits(rows, embed), pos, masks, ts=ts, **kw)
    tb, r = ts["cfg"][0], x.shape[0]
    verif = torch.arange(r, device=x.device) < ts["n_verif"]
    lse_ts, m_tx = torch.logsumexp(x[:, tb:], -1), x[:, :tb].amax(-1)
    forced = verif & (lse_ts > m_tx)
    text = torch.arange(x.shape[1], device=x.device)[None] < tb
    top2 = torch.where(forced[:, None] & text, float("-inf"), x).topk(2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > gap) & ~(verif & ((lse_ts - m_tx).abs() <= gap))
    return bool(torch.equal(am[clear], ram[clear])), int(clear.sum()), int(forced.sum())


def _scaled_ok(model, got, ref, norm):
    """(ok, worst err / limit, worst err): max / lse / gathered of each row
    within _stats_ok's limit times max(1, norm) of that row.  A row of
    elements of size s carries stage A's one bf16 rounding of each element
    into its logits s times as large as at the unit size check_verify holds
    to _stats_ok; int8 keeps its relative part as it is."""
    k = norm.clamp(min=1.0)
    worst, err = 0.0, 0.0
    for a, b in zip(got[1:], ref[1:]):
        d = (a.float() - b.float()).abs()
        lim = (1e-3 * k + 1e-3 * b.float().abs()) if _int8(model) else 1e-2 * k
        worst, err = max(worst, float((d / lim).max())), max(err, float(d.max()))
    return worst <= 1.0, worst, err


def check_verify_ts(g, model, identity0=False):
    """K4 in the timestamp mode at 11 heads x 11 nodes (R = 121, n_verif =
    11: the B=1 loop's), bf16, int8 and identity0 rows: the rules' masks on
    the 11 verification rows, the force rule where their timestamp mass
    beats their best text logit (hidden rows of norms spread 0.5-12 make
    both kinds).  Held three ways, each printed: (1) K4 against its plain
    version, verify_hidden_plain, on the same hid / src: argmax equal on the
    rows clear by that row's limit, max / lse / gathered within
    _scaled_ok's limit (the row's size times check_verify's); (2) stages B
    and C alone: the plain ts statistics over the rows the kernel's stage A
    built, within _stats_ok's unscaled limit; (3) K4's statistics bitwise
    K5's ts mode over head_rows' rows.  Stage A's rows against
    head_rows_plain at these sizes and the plain statistics over both sets
    of rows are printed, the reading behind the scaled limit.  Forced and
    unforced rows both required.  Device time beside the non-ts mode's on
    the same rows.  A kernels row (verify_hidden_ts, _int8) except for
    identity0."""
    from whisper_medusa_tpu_torch.ops import verify as VF

    q = _int8(model)
    hw, hb = _head_weights(model)
    n_nodes, kp1 = 11, hb.shape[0] + identity0
    r = kp1 * n_nodes
    embed, masks, _, gcol, kw = _verify_inputs(g, model, r)
    d = model.config.dims.d_model
    pos = (3 + torch.arange(n_nodes, device="cuda")[None, :]
           + torch.arange(kp1, device="cuda")[:, None]).reshape(-1).to(torch.int32)
    scale = torch.linspace(0.5, 12.0, n_nodes, device="cuda")
    hid = (torch.randn((1, n_nodes, d), generator=g, device="cuda")
           * scale[None, :, None]).to(torch.bfloat16)
    src = ((torch.randn((1, n_nodes, d), generator=g, device="cuda") * scale[None, :, None])
           .to(torch.bfloat16) if identity0 else hid)
    norm = scale.repeat(kp1)                      # row (k, n) is node n's size
    ts = _ts_operands(model, r, n_nodes)
    kw4 = dict(identity0=identity0, **kw)
    got = VF.verify_hidden_kernel(hid, src, hw, hb, embed, pos, gcol, masks, ts=ts, **kw4)
    ref = VF.verify_hidden_plain(hid, src, hw, hb, embed, pos, gcol, masks, ts=ts, **kw4)
    plain_rows = VF.build_rows(hid, src, hw, hb, identity0)
    # (1) against the plain version on the same inputs.
    lim = 1e-2 * norm.clamp(min=1.0)
    arg_ok, n_clear, n_forced = _ts_clear(plain_rows, embed, pos, masks, kw, ts, got[0],
                                          ref[0], lim)
    ok, ratio, err = _scaled_ok(model, got, ref, norm)
    # Stage A's rows at these sizes, kernel against plain.
    a16 = VF.head_rows_kernel(src.reshape(n_nodes, d), hw, hb)
    a_pl = VF.head_rows_plain(src.reshape(n_nodes, d), hw, hb)
    da = (a16.float() - a_pl.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(a_pl.float().abs().clamp(min=1e-30))) - 7)
    rows = a16.reshape(-1, d)
    if identity0:
        rows = torch.cat([hid.reshape(n_nodes, d), rows])
    # (2) stages B and C alone; the plain statistics over both sets of rows.
    ref_b = VF.verify_rows_plain(rows, embed, pos, gcol, masks, ts=ts, **kw)
    ok_b, err_b = _stats_ok(model, got, ref_b)
    arg_b, n_clear_b, _ = _ts_clear(rows, embed, pos, masks, kw, ts, got[0], ref_b[0], 1e-2)
    err_a = max(max_err(a, b) for a, b in zip(ref[1:], ref_b[1:]))
    # (3) bitwise K5's ts mode over head_rows' rows.
    k5 = VF.verify_rows_kernel(rows, embed, pos, gcol, masks, ts=ts, **kw)
    same = all(torch.equal(a, b) for a, b in zip(got, k5))
    name = "verify_hidden_ts" + ("_id0" if identity0 else "") + ("_int8" if q else "")
    log(f"K4 {name} R={r} n_verif={n_nodes}: {n_forced} forced rows of {n_nodes}; against "
        f"verify_hidden_plain: argmax equal on {n_clear} rows clear by their limit: "
        f"{arg_ok} ({int((got[0] == ref[0]).sum())}/{r} rows equal); max/lse/gathered "
        f"max_abs_err {err:.3e}, worst err/limit {ratio:.3f} (limit x max(1, row size "
        f"0.5-12))")
    log(f"K4 {name}: stage A rows head_rows_kernel vs head_rows_plain at row sizes "
        f"0.5-12: max_abs_err {float(da.max()):.3e}, at most {float((da / ulp).max()):.2f} "
        f"bf16 ulps, {int((da > 0).sum())} of {da.numel()} elements differ; the plain "
        f"statistics over the kernel's stage-A rows vs over the plain rows differ by "
        f"{err_a:.3e}")
    log(f"K4 {name}: stages B and C against the plain ts statistics over the kernel's "
        f"stage-A rows: argmax equal on {n_clear_b} clear rows: {arg_b}; max_abs_err "
        f"{err_b:.3e}; statistics bitwise K5's ts mode over head_rows' rows: {same}")
    require(arg_ok and ok and arg_b and ok_b and same and 0 < n_forced < n_nodes,
            f"K4 {name}: argmax {arg_ok}/{arg_b}, err {err} (err/limit {ratio}), stages "
            f"B+C err {err_b}, bitwise K5 {same}, forced {n_forced}")
    kern = lambda: VF.verify_hidden_kernel(hid, src, hw, hb, embed, pos, gcol, masks, ts=ts,
                                           **kw4)
    plain_kern = lambda: VF.verify_hidden_kernel(hid, src, hw, hb, embed, pos, gcol, masks,
                                                 **kw4)
    ms, dev, dev0 = cuda_ms(kern), device_ms(kern), device_ms(plain_kern)
    plain_ms = cuda_ms(lambda: VF.verify_hidden_plain(hid, src, hw, hb, embed, pos, gcol,
                                                      masks, ts=ts, **kw4))
    v, nh = model.config.dims.vocab_size, hb.shape[0]
    sources = (hid, src) if identity0 else (hid,)
    moved = (nbytes(*sources, *_tensors(hw), hb, *_tensors(embed), pos, gcol, masks,
                    ts["last"], ts["penult"], ts["maxts"]) + 4 * r * 4)
    b = bound(moved, 2 * r * v * d + 2 * nh * n_nodes * d * d)
    log(f"K4 {name} R={r}: kernel {ms:.4f} ms events, {dev:.4f} ms device (the non-ts "
        f"mode on the same rows {dev0:.4f} ms device); plain {plain_ms:.4f} ms; bound "
        f"{b[0]:.4f} ms ({b[1]}); {SMI}")
    return kernel_record(name, "whisper_medusa_tpu_torch/csrc/verify.cu",
                         "whisper_medusa_tpu/ops/verify.py:309",
                         (VF, "q_ts_launches" if q else "ts_launches"),
                         err, ms, plain_ms, b, None)


def check_verify_rows_ts(g, model, sizes=(8, 11, 88, 176, 1024)):
    """K5 in the timestamp mode at R = 11 (vanilla's rows at B=11), 88 and
    176 (pass A at B=8 and B=16, every row a verification row) and 1024
    (968 verification rows, the rest draft rows), bf16 and int8: held as
    check_verify_ts holds K4; the R=8 call's rows bitwise the first 8 of
    the R=88 call's; forced rows counted, both kinds required; device time
    beside the non-ts mode's on the same rows."""
    from whisper_medusa_tpu_torch.ops import verify as VF

    q = _int8(model)
    name = "verify_rows_ts_int8" if q else "verify_rows_ts"
    d = model.config.dims.d_model
    worst, timed, outs = 0.0, {}, {}
    for r in sizes:
        n_verif = 968 if r == 1024 else r
        embed, masks, pos, gcol, kw = _verify_inputs(g, model, r)
        scale = torch.linspace(0.5, 12.0, r, device="cuda")[:, None]
        hs = (torch.randn((r, d), generator=g, device="cuda") * scale).to(torch.bfloat16)
        if r == 88:
            hs[:8] = outs[8][0]
            pos, gcol = pos.clone(), gcol.clone()
            pos[:8], gcol[:8] = outs[8][1], outs[8][2]
        ts = _ts_operands(model, r, n_verif)
        got = VF.verify_rows_kernel(hs, embed, pos, gcol, masks, ts=ts, **kw)
        ref = VF.verify_rows_plain(hs, embed, pos, gcol, masks, ts=ts, **kw)
        arg_ok, n_clear, n_forced = _ts_clear(hs, embed, pos, masks, kw, ts, got[0], ref[0],
                                              1e-2)
        ok, err = _stats_ok(model, got, ref)
        log(f"K5 {name} R={r} n_verif={n_verif}: {n_forced} forced rows; argmax equal on "
            f"{n_clear} clear rows: {arg_ok} ({int((got[0] == ref[0]).sum())}/{r} rows "
            f"equal); max/lse/gathered max_abs_err {err:.3e}")
        require(arg_ok and ok and 0 < n_forced < n_verif,
                f"K5 {name} R={r}: argmax {arg_ok}, err {err}, forced {n_forced}")
        worst = max(worst, err)
        if r == 8:
            outs[8] = (hs, pos[:8], gcol[:8], got)
        if r == 88:
            same = all(torch.equal(a[:8], b) for a, b in zip(got, outs[8][3]))
            log(f"K5 {name}: the R=8 call's rows bitwise the first 8 of the R=88 call's: "
                f"{same}")
            require(same, f"K5 {name}: R=8 rows differ from the R=88 call's")
        if r in (11, 88, 176, 1024):
            args = (hs, embed, pos, gcol, masks)
            kern = lambda: VF.verify_rows_kernel(*args, ts=ts, **kw)
            ms, dev = cuda_ms(kern), device_ms(kern)
            dev0 = device_ms(lambda: VF.verify_rows_kernel(*args, **kw))
            plain_ms = cuda_ms(lambda: VF.verify_rows_plain(*args, ts=ts, **kw))
            v = model.config.dims.vocab_size
            b = bound(nbytes(hs, *_tensors(embed), pos, gcol, masks, ts["last"],
                             ts["penult"], ts["maxts"]) + 4 * r * 4, 2 * r * v * d)
            log(f"K5 {name} R={r}: kernel {ms:.4f} ms events, {dev:.4f} ms device (the "
                f"non-ts mode on the same rows {dev0:.4f} ms device); plain {plain_ms:.4f} "
                f"ms; bound {b[0]:.4f} ms ({b[1]}); no one PyTorch call computes it; {SMI}")
            timed[r] = (ms, plain_ms, b)
    ms, plain_ms, b = timed[88]       # pass A of the batched Medusa path
    return kernel_record(name, "whisper_medusa_tpu_torch/csrc/verify.cu",
                         "whisper_medusa_tpu/ops/verify.py:183",
                         (VF, "q_ts_rows_launches" if q else "ts_rows_launches"),
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


# K10's mask mode past 32 chunk columns: the ancestor masks of trees of TC
# nodes (W = ceil(TC / 32) words a row of chunk bits), the per-op step's
# self-attention for trees of more than 16 nodes: the 39-node
# (1,2,2,1,1,1,1,1,1,1,1), 71-node (1,2,2,2,1,1,1,1,1,1,1) and 130-node
# (1,3,3) + 13 x (1,) trees.
WIDE_TREES = ((1, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1), (1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1),
              (1, 3, 3) + (1,) * 13)
WIDE_BATCHES = (1, 8, 16)


def check_self_decode_wide(g):
    """K10's mask mode over chunks past 32 columns (WIDE_TREES, of 39, 71 and
    130 nodes: 2, 3 and 5 words a row of chunk bits, 3, 5 and 9 launches a call)
    against ``attention`` under ``make_step_mask`` on large-v2's self slabs
    (20 heads x SELF_MAX_LEN rows), bf16, at B = 1, 8 and 16: elementwise
    within 1e-2 + 1e-2 |x|, and every example of the B=8 and B=16 calls
    bitwise its B=1 call.  Timed at TC = 39, B = 16 (CUDA events and device
    time) beside the plain version, SDPA with the step's boolean mask and
    the byte bound (each example's visible keys, offset + TC, read once);
    B = 1's device time printed."""
    from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    h, s_len, worst, row = 20, SELF_MAX_LEN, 0.0, None
    for tree in WIDE_TREES:
        cm = torch.from_numpy(generate_medusa_buffers(tree).attn_mask).cuda()
        t = cm.shape[0]
        bmax = max(WIDE_BATCHES)
        rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=g, device="cuda")
                                         * scale).to(torch.bfloat16)
        q = rnd(bmax, t, h, 64, scale=0.125)
        k, v = rnd(bmax, s_len, h * 64), rnd(bmax, s_len, h * 64)
        off = torch.linspace(3, s_len - t, bmax, device="cuda").round().to(torch.int32)
        bits = DO.chunk_bits(cm, t, "cuda", s_len)
        one = lambda a, i: a[i:i + 1].contiguous()
        singles = [DO.self_attention_decode_kernel(one(q, i), one(k, i), one(v, i),
                                                   one(off, i), bits) for i in range(bmax)]
        for b in WIDE_BATCHES:
            sub = lambda a: a[:b].contiguous()
            before = DO.self_wide_launches
            got = DO.self_attention_decode_kernel(sub(q), sub(k), sub(v), sub(off), bits)
            launches = DO.self_wide_launches - before
            ref = DO.self_attention_decode_plain(sub(q), sub(k), sub(v), sub(off), cm)
            err = max_err(got, ref)
            what = (f"K10 mask mode, wide: tree of {t} nodes ({bits.shape[1]} words a row), "
                    f"B={b} x {s_len}")
            same = [torch.equal(got[i:i + 1], singles[i]) for i in range(b)]
            log(f"{what}: max_abs_err {err:.3e} ({launches} launches); each example bitwise "
                f"its B=1 output: {sum(same)}/{b}")
            require(got.shape == ref.shape and close(got, ref, 1e-2), f"{what}: err {err}")
            require(launches == len(DO.row_blocks(t)), f"{what}: {launches} launches")
            require(all(same), f"{what}: a B=1 call differs from its row of the B={b} call")
            worst = max(worst, err)
        if t != 39:
            continue
        kern = lambda: DO.self_attention_decode_kernel(q, k, v, off, bits)
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(lambda: DO.self_attention_decode_plain(q, k, v, off, cm))
        mask = whisper.make_step_mask(off, t, s_len, cm)
        qh = q.transpose(1, 2).contiguous()
        kh = k.reshape(bmax, -1, h, 64).transpose(1, 2).contiguous()
        vh = v.reshape(bmax, -1, h, 64).transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=1.0)
        lib_ms = cuda_ms(lib)
        keys = int((off.long() + t).sum())
        moved = nbytes(q) * 2 + 2 * keys * h * 64 * 2 + nbytes(off, bits)
        b_ms = bound(moved, 4 * h * t * keys * 64)
        dev_ms, dev_lib = device_ms(kern), device_ms(lib)
        q1, k1, v1, off1 = (one(a, 0) for a in (q, k, v, off))
        dev_1 = device_ms(lambda: DO.self_attention_decode_kernel(q1, k1, v1, off1, bits))
        log(f"K10 mask mode, wide, tree of 39 nodes, B={bmax}: device time {dev_ms:.4f} ms "
            f"(B=1: {dev_1:.4f} ms), bound {b_ms[0]:.4f} ms ({b_ms[1]}); SDPA with the "
            f"step's mask {lib_ms:.4f} ms, device {dev_lib:.4f} ms; plain {plain_ms:.4f} ms")
        row = (ms, plain_ms, b_ms, lib_ms)
    ms, plain_ms, b_ms, lib_ms = row
    return kernel_record("self_decode wide", DECODE_OPS_SOURCE,
                         "tools/decode_kernels_experiment.py:48",
                         (DO, "self_wide_launches"), worst, ms, plain_ms, b_ms, lib_ms)


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
    offs = torch.tensor([4, 2, 4, 3, 1, 4, 0, 2, 3, 1, 0, 4, 2, 4, 1, 3][:enc8.shape[0]],
                        dtype=torch.int32, device="cuda")

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
                    f"P3 {name}: example {i}'s self-attention in the batched step differs from "
                    f"the kernel on its inputs alone")
            if all(torch.equal(a, b) for a, b in zip(mine, args1)):
                same_in += 1
                require(torch.equal(out8[i:i + 1], out1),
                        f"P3 {name}: example {i}'s self-attention differs from its B=1 "
                        f"step's on the same inputs")
    n = len(rec8) * enc8.shape[0]
    log(f"P3 {name}, per-op step B={enc8.shape[0]} vs B=1 ({len(rec8)} layers): every "
        f"self-attention output bitwise the kernel's on its own inputs; {same_in}/{n} "
        f"(layer, example) pairs got bitwise the B=1 step's inputs and gave bitwise its "
        f"output; hidden "
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


def k2_attention_times(name, events, rows, cache, offsets, offs, t, quant):
    """K2's self- and cross-attention (the cluster body's K2 instantiations)
    in the profile ``rows`` (device_profile._fold_events) of the whole
    trace ``events`` of a step's runs (device_profile._device_runs):
    device ms a launch and launches a layer, beside the byte bound of one
    launch (the self-attention's history, fresh and committed rows; all
    cross K/V) and, on bf16 caches, SDPA's device time on the same work:
    slot 0's cross K/V re-laid head-major, and its self slab under the
    step's mask.  Also how early each starts under programmatic dependent
    launch (the kernel before it still running: its CTAs found room), from
    the trace, and how many of its clusters the card holds at once."""
    import ctypes

    from whisper_medusa_tpu_torch.device_profile import _short
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


def k2_launches(name, steps, slots, b, t):
    """K2's launches in each traced step (``steps``: device_profile.
    _device_runs' lists): 8 a layer over ``slots`` layers (the block's included) and exactly one
    ``ln_rows_kernel`` (ln_post); the layer norms run inside the q/k/v,
    cross-q and fc1 GEMMs (3 a layer).  Every step must count the same."""
    import collections

    from whisper_medusa_tpu_torch.device_profile import _short, is_ln_gemm

    counts = set()
    for events in steps:
        names = collections.Counter(_short(n) for n, _, _ in events)
        counts.add((sum(n for k, n in names.items() if k.startswith(K2_KERNELS)),
                    sum(n for k, n in names.items() if k.startswith("ln_rows_kernel")),
                    sum(n for k, n in names.items() if is_ln_gemm(k))))
    total, ln_rows, ln_gemms = max(counts)
    log(f"K2 {name} B={b} T={t}: {total} launches a step over {slots} layers "
        f"({(total - ln_rows) / slots:.2f} a layer), ln_rows_kernel {ln_rows} a step, "
        f"LN-mode GEMMs {ln_gemms} a step; the same in each of {len(steps)} traced steps: "
        f"{len(counts) == 1}")
    require(len(counts) == 1 and total == K2_PER_LAYER * slots + 1 and ln_rows == 1
            and ln_gemms == 3 * slots,
            f"K2 {name} B={b} T={t}: (launches, ln_rows, LN-mode GEMMs) a step "
            f"{sorted(counts)} over {slots} layers")


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


def check_megastep_full(model, enc1, enc8, block=None, suffix=""):
    """The full 32-layer step (and the block on slot 32, given ``block``)
    against the plain layer loop on copies of one cache: at B=1 prefill T=4
    then the T=11 chain, at B=8 prefill T=4, then T=11 and T=1 at
    per-example offsets that differ.  bf16: pre_norm (and block_hidden)
    cosine >= 0.999; int8 (a quantized model): >= 0.9998, its written rows
    dequantized.  With the block, block_hidden also lies at least 4x closer
    (in 1 - cosine) to the plain block_hidden than the plain hidden does, so
    a kernel that skipped the block cannot pass.  ``suffix`` ends the row's
    name (" d384": whisper tiny)."""
    from whisper_medusa_tpu_torch.device_profile import (_device_runs, _entry_host_ms,
                                                         _fold_events, _overlap_events)
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS

    q = _int8(model)
    name = ("megastep" + ("_block" if block is not None else "") + ("_int8" if q else "")
            + suffix)
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
                traced = _device_runs(run, 5)
                events = [e for step in traced for e in step]
                rows = _fold_events(events, len(traced))
                k2_launches(name, traced, nl, b, t)
                k2_attention_times(name, events, rows, cache, offsets, offs, t, q)
                gemm = sum(us for k, (us, _) in rows.items() if k.startswith("wgemm_kernel"))
                durations, busy = _overlap_events(events, len(traced))
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


def _others(kernels, allowed):
    """The rows that must not launch beside the rows named in ``allowed``:
    every row whose counter is not one of theirs (a row of another shape
    that shares an allowed row's counter, e.g. "verify_hidden f32 R144",
    counts the same launches)."""
    mine = {tuple(k["counter"]) for k in kernels if k["name"] in allowed}
    return tuple(k["name"] for k in kernels if tuple(k["counter"]) not in mine)


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
    of ``variants`` (whisper tiny too: K2 takes its steps at B <= 8, d_model
    384 being a multiple of 128)."""
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
    emb = model.params["whisper"]["decoder"]["embed_tokens"]
    mode = ("int8" if _int8(model) else "f32" if emb.dtype == torch.float32 else "bf16") + (
        f" d_model {cfg.dims.d_model}")
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


# P4: B=1 requests on long chains, past K2's chunk (T = 17) or K4's head
# stack (the JAX package's gate: R <= 1024 rows, heads * D^2 * 2 <= 40 MiB).
# (heads, kernels that must launch, kernels that must not.)  11 heads at
# large-v2: R = 144, a 39.3 MB stack, one K4 pass a step; 16 heads at
# large-v2: a 55.7 MB stack, two passes (head_rows + K5); 16 heads at whisper
# tiny: R = 289, 5.0 MB, one K4 pass.
P4_NEW_TOKENS = 24
P4_RUNS = ((11, ("attention", "megastep", "logits", "verify_hidden"), ("verify_rows",)),
           (16, ("attention", "megastep", "self_decode", "cross_decode", "ffn_decode",
                 "logits", "head_rows", "verify_rows"), ("verify_hidden",)))
P4_TINY_RUNS = ((16, ("attention", "megastep", "self_decode", "cross_decode", "ffn_decode",
                      "logits", "verify_hidden"), ("verify_rows",)),)


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


def phase_p4_requests(model, kernels, feat, runs=P4_RUNS):
    """P4 on the card, bf16, B=1, ``P4_NEW_TOKENS`` new tokens, the ``runs``
    of P4_RUNS (large-v2) or P4_TINY_RUNS (whisper tiny): an 11-head
    base_head model (12 x 12 = 144 verification rows: one K4 pass a step,
    K5 never launches) and 16-head chains (T = 17: the 4-token prefill runs
    on K2, every decode step on the per-op step, whose K10 calls take two
    16-row blocks a layer: K2 launches once and K10 2 x L times a step; at
    large-v2 two verification passes, head_rows + K5, at tiny one K4 pass
    of 289 rows).  Each is driven with the launch counters and its tokens
    held to those of its own run with every draft corrupted
    (``draft_corruption=1.0``)."""
    dims = model.config.dims
    vocab, nl = dims.vocab_size, dims.decoder_layers
    for heads, needs, absent in runs:
        m = wide_head_model(model, heads, SEED + 10 + heads)
        m.generate(feat, language="en", max_new_tokens=8)                 # warm-up
        seen = {}
        what = f"bf16 {heads}-head chain B=1 d_model {dims.d_model}"
        out, wall = drive(what, kernels,
                          lambda: m.generate(feat, language="en",
                                             max_new_tokens=P4_NEW_TOKENS),
                          needs, absent, seen)
        report(f"{what} request", out, wall, check_output(out, 1, vocab, P4_NEW_TOKENS))
        passes = "verify_hidden" if "verify_hidden" in needs else "verify_rows"
        require(seen[passes] == out.steps,
                f"{what}: {seen[passes]} {passes} launches in {out.steps} steps")
        if heads == 16:
            per_op = 2 * nl * out.steps
            log(f"  {what}: K2 {seen['megastep']} launch (the prefill), K10 "
                f"{seen['cross_decode']} and its mask mode {seen['self_decode']} launches in "
                f"{out.steps} steps of T = 17 ({per_op} expected each)")
            require(seen["megastep"] == 1 and seen["cross_decode"] == per_op
                    and seen["self_decode"] == per_op,
                    "16 heads: a T = 17 step did not take the per-op step's 16-row blocks")
        check_corruption(what, m, feat, out, P4_NEW_TOKENS)
        del m


# Whisper tiny (d_model 384): K2 takes its decode calls at B <= 8 (d_model
# % 128 == 0, ffn_dim % d_model == 0, the JAX gate), the per-op step the
# rest; K2's projections, K11, head_rows and K4's stage A run the weight-
# streaming GEMM in 64-wide K slices (6 of one chunk; fc2 8 of three).
# Timestamps and longform (phase 4): requests with return_timestamps=True,
# each driven as the other main paths, and the seek loop over 75 s.
TS_NEW_TOKENS = 48
NEEDS_TS = {
    "bf16 medusa B=1": ("megastep", "logits", "head_rows", "verify_hidden_ts"),
    f"bf16 medusa B={BATCH}": ("megastep", "logits", "head_rows", "verify_rows_ts"),
    "int8 medusa B=1": ("megastep_int8", "qmm_nt", "head_rows_int8", "verify_hidden_ts_int8"),
    f"int8 medusa B={BATCH}": ("megastep_int8", "qmm_nt", "head_rows_int8",
                               "verify_rows_ts_int8"),
    "bf16 medusa_block B=1": ("megastep_block", "logits", "verify_hidden_ts"),
    "bf16 vanilla B=1": ("megastep", "verify_rows_ts"),
}
# The non-ts modes of K4 / K5 launch on none of these paths.
ABSENT_TS = ("verify_hidden", "verify_rows", "verify_hidden_int8", "verify_rows_int8",
             "verify_hidden_id0", "verify_hidden_id0_int8")


def check_ts_output(model, out, prompt_len=3):
    """The timestamp grammar on every example: no <|notimestamps|>, a
    timestamp as the first generated token, non-decreasing timestamps,
    segments that _extract_segments reads from the tokens, and finite
    log-probs (a beam request's scores)."""
    from whisper_medusa_tpu_torch.models.api import _extract_segments

    st = model.special
    require(out.segments is not None and len(out.segments) == out.sequences.shape[0],
            "segments")
    for i in range(out.sequences.shape[0]):
        seq = out.sequences[i, prompt_len:out.lengths[i]].tolist()
        gen = [t for t in seq if t != st.eos]
        ts = [t for t in gen if t >= st.timestamp_begin]
        require(st.no_timestamps not in gen, f"example {i}: <|notimestamps|> generated")
        require(bool(gen) and gen[0] >= st.timestamp_begin,
                f"example {i}: first generated token {gen[:1]} is not a timestamp")
        require(ts == sorted(ts), f"example {i}: timestamps decrease")
        segs = _extract_segments(out.sequences[i], int(out.lengths[i]), prompt_len, 0.02, st)
        require(segs == out.segments[i], f"example {i}: segments")
    # Beams return their scores (avg_logprobs) and no per-token log-probs.
    lp = out.avg_logprobs if out.token_logprobs is None else out.token_logprobs
    require(np.isfinite(lp).all(), "finite log-probs")


def _ts_decode(model, enc):
    """speculative_generate with the timestamp rules from [sot, en,
    transcribe] on encoder rows ``enc``."""
    from whisper_medusa_tpu_torch.config import GenerationConfig
    from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
    from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig
    from whisper_medusa_tpu_torch.decoding.speculative import speculative_generate

    st, gd, cfg = model.special, model.generation_config, model.config
    b = enc.shape[0]
    prompt = torch.tensor([[st.sot, st.first_language, st.transcribe]] * b,
                          dtype=torch.int32, device="cuda")
    pcfg = ProcessorConfig(vocab_size=cfg.dims.vocab_size, suppress_tokens=gd.suppress_tokens,
                           begin_suppress_tokens=gd.begin_suppress_tokens, begin_index=3,
                           eos_token_id=st.eos, timestamp_rules=True,
                           timestamp_begin=st.timestamp_begin,
                           no_timestamps_id=st.no_timestamps,
                           max_initial_timestamp_index=gd.max_initial_timestamp_index)
    gen = GenerationConfig(max_length=3 + TS_NEW_TOKENS, eos_token_id=st.eos,
                           pad_token_id=gd.pad_token_id)
    return speculative_generate(model.params["whisper"], model.params["medusa"], cfg.dims,
                                generate_medusa_buffers(cfg.medusa.medusa_choices), pcfg,
                                gen, enc, prompt, variant=cfg.medusa.medusa_heads_type)


def phase_ts_requests(model, qmodel, bmodel, kernels, feat, feats8):
    """return_timestamps=True requests: B=1 and B=8 bf16 Medusa (K4 and
    pass A in the ts mode), int8 B=1 and B=8, Medusa-Block B=1, vanilla B=1; each
    output held to the grammar (check_ts_output), each B=8 example to its
    B=1 tokens, the B=1 Medusa and Medusa-Block tokens to their runs under
    draft_corruption=1.0."""
    kw = dict(language="en", max_new_tokens=TS_NEW_TOKENS, return_timestamps=True)
    runs = (("bf16 medusa B=1", model, feat, {}),
            (f"bf16 medusa B={BATCH}", model, feats8, {}),
            ("int8 medusa B=1", qmodel, feat, {}),
            (f"int8 medusa B={BATCH}", qmodel, feats8, {}),
            ("bf16 medusa_block B=1", bmodel, feat, {}),
            ("bf16 vanilla B=1", model, feat, dict(disable_medusa=True)))
    outs = {}
    for name, m, f, extra in runs:
        m.generate(f, **kw, **extra)              # warm-up
        out, wall = drive(f"timestamps {name}", kernels,
                          lambda: m.generate(f, **kw, **extra), NEEDS_TS[name], ABSENT_TS)
        check_ts_output(m, out)
        n_gen = int((out.lengths - 3).sum())
        report(f"timestamps {name}", out, wall, n_gen)
        log(f"  segments of example 0: {len(out.segments[0])}, first "
            f"{out.segments[0][:1]}")
        outs[name] = out
    # B=8 against B=1 on the same encoder rows (the encoder's GEMMs may
    # round another way at another batch size; report_generate_invariance).
    same = []
    enc8 = model.encode(feats8)
    batched = _ts_decode(model, enc8)
    for e in range(BATCH):
        alone = _ts_decode(model, enc8[e:e + 1])
        same.append(bool(torch.equal(alone.tokens[0], batched.tokens[e]))
                    and int(alone.lengths[0]) == int(batched.lengths[e]))
    log(f"timestamps decode B={BATCH} vs B=1 on the same encoder rows (bf16 medusa): "
        f"tokens equal for {sum(same)}/{BATCH}")
    require(all(same), f"timestamps: B={BATCH} tokens differ from B=1: {same}")
    for name, m in (("bf16 medusa B=1", model), ("bf16 medusa_block B=1", bmodel)):
        clean = outs[name]
        bad = m.generate(feat, draft_corruption=1.0, **kw)
        n = int(min(bad.lengths[0], clean.lengths[0]))
        ok = np.array_equal(bad.sequences[0, :n], clean.sequences[0, :n])
        log(f"timestamps {name} draft_corruption=1.0: common prefix of {n} tokens "
            f"identical {ok}, steps {bad.steps} (clean {clean.steps}), accepted "
            f"{int(bad.accepted.sum())} (clean {int(clean.accepted.sum())})")
        require(ok and bad.steps >= clean.steps,
                f"timestamps {name}: tokens changed under draft_corruption=1.0")
    return outs


def check_pieced_prefill(model, enc1, k2):
    """Prompts of 40 and 70 tokens prefilled in pieces of at most 16
    (decoding/speculative.py::prefill; each piece a K2 launch), against the
    one-pass plain prefill (megastep_plain over the whole prompt) on a
    copy of the cache: the last row's hidden and every written self-cache
    row, cosine >= 0.999 (K2's bar against its plain step in bf16)."""
    from whisper_medusa_tpu_torch.decoding import speculative as SP
    from whisper_medusa_tpu_torch.models import whisper as W
    from whisper_medusa_tpu_torch.ops import megastep as MS

    p, dims = model.params["whisper"], model.config.dims
    dec, nh = p["decoder"], dims.decoder_attention_heads
    for t0 in (40, 70):
        prompt = torch.arange(200, 200 + t0, dtype=torch.int32, device="cuda")[None]
        cache = W.init_cache(p, dims, enc1, dims.max_target_positions + 12)
        sk, sv = cache.self_k.clone(), cache.self_v.clone()
        before = _read_count(k2)
        out = SP.prefill(p, dims, prompt, cache)
        launches = _read_count(k2) - before
        offsets = torch.zeros((1,), dtype=torch.int32, device="cuda")
        _, rhid, _ = MS.megastep_plain(dec["layers"], dec["ln_post"],
                                       _embedded(dec, prompt, offsets), sk, sv, cache.cross_k,
                                       cache.cross_v, offsets, None, dims.max_source_positions,
                                       nh)
        cos_h = cosine(out.hidden[:, -1], rhid[:, -1])
        cos_k = min(cosine(cache.self_k[:, :, :t0], sk[:, :, :t0]),
                    cosine(cache.self_v[:, :, :t0], sv[:, :, :t0]))
        pieces = -(-t0 // SP.PREFILL_PIECE)
        log(f"pieced prefill T0={t0}: {pieces} pieces, K2 launches {launches}; last hidden "
            f"row cosine {cos_h:.6f}, written self-cache rows {cos_k:.6f} against the "
            f"one-pass plain prefill")
        require(launches == pieces and cos_h >= 0.999 and cos_k >= 0.999
                and bool(torch.isfinite(out.hidden).all()), f"pieced prefill T0={t0}")


LONG_SECS = (75.0, 50.0)
LONG_NEW_TOKENS = 64


def phase_longform(model, kernels, k2):
    """The seek loop on a 75 s synthetic waveform (log-mel from
    ops/mel.py, 7500 frames): B=1 sequential with condition_on_prev_tokens
    and a 40-token all-segments prompt (each window's prompt 43+ tokens:
    prefilled in pieces of 16, the third from offset 32; every piece must
    launch K2); then 75 s and 50 s at B=2 batched with an attention_mask.
    Windows, steps, wall and device time printed; outputs finite, in range,
    with segments whose times increase."""
    import whisper_medusa_tpu_torch.models.api as api_mod
    from whisper_medusa_tpu_torch.device_profile import _by_kernel
    from whisper_medusa_tpu_torch.models import whisper as W
    from whisper_medusa_tpu_torch.ops.mel import log_mel_spectrogram

    st = model.special
    waves = waveforms(LONG_SECS)
    n = int(LONG_SECS[0] * 16000)
    audio = torch.zeros((2, n), device="cuda")
    for i, w in enumerate(waves):
        audio[i, :w.shape[0]] = torch.from_numpy(w).cuda()
    feats = log_mel_spectrogram(audio)
    mask = np.zeros((2, feats.shape[-1]), np.int32)
    for i, secs in enumerate(LONG_SECS):
        mask[i, :int(secs * 100)] = 1
    require(feats.shape == (2, 80, 7500) and bool(torch.isfinite(feats).all()),
            "longform features")
    prompt = [st.start_of_prev] + list(range(1000, 1039))
    pieces, windows = [], [0]
    real_step, real_gen = W.decode_step, api_mod.speculative_generate

    def step_spy(params, dims, tokens, cache, offsets, rel_positions=None, **kw):
        before = _read_count(k2)
        out = real_step(params, dims, tokens, cache, offsets, rel_positions, **kw)
        if rel_positions is None:               # a prefill piece
            pieces.append((tokens.shape[1], int(offsets[0]), _read_count(k2) - before))
        return out

    def gen_spy(*a, **kw):
        windows[0] += 1
        return real_gen(*a, **kw)

    runs = (("B=1 sequential, condition_on_prev_tokens, all-segments prompt", feats[:1],
             dict(condition_on_prev_tokens=True, prompt_ids=prompt,
                  prompt_condition_type="all-segments", return_timestamps=True),
             NEEDS_TS["bf16 medusa B=1"]),
            ("B=2 batched, attention_mask", feats,
             dict(attention_mask=mask, return_timestamps=True),
             NEEDS_TS[f"bf16 medusa B={BATCH}"]))
    W.decode_step, api_mod.speculative_generate = step_spy, gen_spy
    try:
        for name, f, extra, needs in runs:
            run = lambda: model.generate(f, language="en", max_new_tokens=LONG_NEW_TOKENS,
                                         **extra)
            pieces.clear()
            windows[0] = 0
            out, wall = drive(f"longform {name}", kernels, run, needs, ABSENT_TS)
            n_windows = windows[0]
            dev = sum(us for us, _ in _by_kernel(run, 1).values()) / 1e3
            log(f"longform {name}: {n_windows} windows, {out.steps} steps, lengths "
                f"{out.lengths.tolist()}, wall {wall * 1e3:.1f} ms, device busy {dev:.1f} ms; "
                f"{SMI}")
            require(np.isfinite(out.token_logprobs).all()
                    and (out.sequences < model.config.dims.vocab_size).all(), name)
            for i, segs in enumerate(out.segments):
                starts = [sg["start"] for sg in segs]
                require(segs and starts == sorted(starts)
                        and starts[-1] < LONG_SECS[i] + 30.0, f"{name}: example {i} segments")
            if "sequential" in name:
                deep = [p for p in pieces if p[1] >= 32]
                log(f"longform {name}: prefill pieces (T, offset, K2 launches) {pieces[:6]}"
                    f"{' ...' if len(pieces) > 6 else ''}")
                require(deep and all(p[0] <= 16 and p[2] >= 1 for p in pieces),
                        f"{name}: prefill pieces {pieces}")
    finally:
        W.decode_step, api_mod.speculative_generate = real_step, real_gen


# The logits_processor hook (the unfused verification route) and beam search
# (phase 4): a force-token hook, an identity hook held to the fused route's
# tokens, beams held to the plain per-op step and to greedy decoding.
HOOK_TOKEN = 1234
BEAMS = 5
BEAM_TS_NEW_TOKENS = 48
# The clear-gap rule: two routes' tokens may differ only at an example's
# first differing position, and only where the reference's processed top-2
# logit gap there (recomputed by a teacher-forced prefill of its tokens) is
# under GAP_TOL, bf16 rounding of the two routes' logits.
GAP_TOL = 5e-2
BEAM_STEP_TOL = 1e-2      # folded vs repeated per-op step, elementwise (close)
NEEDS_HOOK = {"bf16": ("attention", "megastep", "head_rows", "logits"),
              "int8": ("attention", "megastep_int8", "head_rows_int8", "qmm_nt")}
NEEDS_BEAM = {"bf16": ("attention", "self_decode", "cross_decode", "ffn_decode", "logits"),
              "int8": ("attention", "self_decode", "cross_decode_int8", "qmm", "qmm_nt")}


class Hook:
    """A logits_processor that records its calls and the devices of what it
    was given: ``force`` keeps only HOOK_TOKEN, else the identity."""

    def __init__(self, force):
        self.force, self.calls, self.devices = force, 0, set()

    def __call__(self, logits, pred_pos):
        self.calls += 1
        self.devices |= {logits.device.type, pred_pos.device.type}
        require(logits.dtype == torch.float32 and pred_pos.dtype == torch.int32,
                f"hook operands {logits.dtype}, {pred_pos.dtype}")
        if not self.force:
            return logits
        keep = torch.arange(logits.shape[-1], device=logits.device) == HOOK_TOKEN
        return torch.where(keep, torch.zeros_like(logits), torch.full_like(logits, -1e9))


def device_split(run, top=6):
    """Device busy ms of one run of ``run`` under torch.profiler and its
    ``top`` kernels by device time, as text."""
    from whisper_medusa_tpu_torch.device_profile import _by_kernel

    by = _by_kernel(run, 1)
    tops = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
    return (sum(us for us, _ in by.values()) / 1e3,
            ", ".join(f"{k} {us / 1e3:.2f} ms x{n:.0f}" for k, (us, n) in tops))


def _verify_names(kernels):
    """K4 and K5 in every mode: the rows the unfused route never launches."""
    return tuple(k["name"] for k in kernels if k["name"].startswith("verify"))


def _request_pcfg(model):
    """The processors of a plain greedy request (the default suppress lists)."""
    from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig

    gd, st = model.generation_config, model.special
    return ProcessorConfig(vocab_size=model.config.dims.vocab_size,
                           suppress_tokens=gd.suppress_tokens,
                           begin_suppress_tokens=gd.begin_suppress_tokens,
                           begin_index=PROMPT_LEN, eos_token_id=st.eos)


def _top2_gap(model, enc, seq, pos, variant, with_top=False):
    """The processed top-2 logit gap at position ``pos`` of one example's
    tokens ``seq``: seq[:pos] prefilled (pieces of 16) on encoder row
    ``enc`` (on its device), the base logits of the last row (head 0 for
    base_head); with ``with_top``, (gap, the top logit)."""
    from whisper_medusa_tpu_torch.decoding import speculative as SP
    from whisper_medusa_tpu_torch.decoding.processors import apply_processors
    from whisper_medusa_tpu_torch.models import whisper as W

    p, dims, dev = model.params["whisper"], model.config.dims, enc.device
    cache = W.init_cache(p, dims, enc, pos + 1)
    out = SP.prefill(p, dims, torch.as_tensor(seq[None, :pos], dtype=torch.int32,
                                              device=dev), cache)
    mp = None if variant == "vanilla" else model.params["medusa"]
    base = SP._base_logits_fn(p, mp, variant)(out.hidden[:, -1])
    proc = apply_processors(base, torch.full((1,), pos, dtype=torch.int32, device=dev),
                            _request_pcfg(model))
    top2 = proc.topk(2, dim=-1).values[0]
    gap = float(top2[0] - top2[1])
    return (gap, float(top2[0])) if with_top else gap


def clear_gap_compare(name, model, enc, ref, got, variant, stop_at_eos=False):
    """Hold ``got``'s tokens to ``ref``'s under the clear-gap rule over each
    example's common length (with ``stop_at_eos``, ``got``'s tokens before
    its final EOS); returns the number of examples that differ."""
    diffs = []
    for e in range(ref.sequences.shape[0]):
        n = int(min(ref.lengths[e], got.lengths[e] - (1 if stop_at_eos else 0)))
        where = np.nonzero(ref.sequences[e, :n] != got.sequences[e, :n])[0]
        if where.size:
            pos = int(where[0])
            diffs.append((e, pos, _top2_gap(model, enc[e:e + 1], ref.sequences[e], pos,
                                            variant)))
    log(f"{name}: tokens equal for {ref.sequences.shape[0] - len(diffs)}/"
        f"{ref.sequences.shape[0]} examples; first differing (example, position, top-2 "
        f"gap): {diffs or 'none'} (allowed under a gap of {GAP_TOL})")
    require(all(gap < GAP_TOL for _, _, gap in diffs),
            f"{name}: tokens differ where the top-2 gap is clear: {diffs}")
    return len(diffs)


def phase_hook_requests(model, qmodel, kernels, feat, feats8, outs, qouts):
    """The logits_processor hook on the card.  (a) A force-token hook at
    B=1, bf16 Medusa: every generated token is HOOK_TOKEN; the unfused
    route (head_rows, K3) runs and K4 / K5 never launch; the hook saw CUDA
    tensors only; wall, steps, tokens and device time printed.  (b) An
    identity hook at B=1 and B=8, bf16 and int8, against the fused route's
    phase-4 outputs under the clear-gap rule (the differing examples
    counted and printed), and at bf16 each route's device time in turns
    (fused, unfused, unfused, fused)."""
    absent = _verify_names(kernels)
    kw = dict(language="en", max_new_tokens=MAX_NEW_TOKENS)
    hook = Hook(force=True)
    model.generate(feat, max_new_tokens=8, language="en", logits_processor=hook)  # warm-up
    run = lambda: model.generate(feat, logits_processor=hook, **kw)
    out, wall = drive("hook (force token) bf16 medusa B=1", kernels, run, NEEDS_HOOK["bf16"],
                      absent)
    n_gen = check_output(out, 1, model.config.dims.vocab_size)
    gen = out.sequences[0, PROMPT_LEN:out.lengths[0]]
    require(len(gen) > 0 and bool((gen == HOOK_TOKEN).all()),
            f"force-token hook: generated {gen[:8].tolist()}...")
    dev, tops = device_split(run)
    report("hook (force token) bf16 medusa B=1", out, wall, n_gen)
    log(f"  route: unfused (K4 and K5 at 0 launches); every one of {n_gen} generated tokens "
        f"is {HOOK_TOKEN}; the hook ran {hook.calls} times on {sorted(hook.devices)}; device "
        f"busy {dev:.1f} ms ({tops}); {SMI}")
    require(hook.devices == {"cuda"}, f"the hook saw {hook.devices}")
    enc8 = model.encode(feats8)
    differing = 0
    for mode, m, fused in (("bf16", model, outs), ("int8", qmodel, qouts)):
        for b, f, ref in ((1, feat, fused["medusa B=1"][0]),
                          (BATCH, feats8, fused[f"medusa B={BATCH}"])):
            ident = Hook(force=False)
            out, wall = drive(f"hook (identity) {mode} medusa B={b}", kernels,
                              lambda: m.generate(f, logits_processor=ident, **kw),
                              NEEDS_HOOK[mode], absent)
            report(f"hook (identity) {mode} medusa B={b}", out, wall,
                   check_output(out, b, m.config.dims.vocab_size))
            require(ident.devices == {"cuda"}, f"the hook saw {ident.devices}")
            enc = m.encode(f) if b == 1 else enc8
            differing += clear_gap_compare(f"identity hook vs fused route, {mode} B={b}", m,
                                           enc, ref, out, m.config.medusa.medusa_heads_type)
            if mode == "bf16":
                runs = {"fused": lambda: m.generate(f, **kw),
                        "unfused": lambda: m.generate(f, logits_processor=ident, **kw)}
                for route in ("fused", "unfused", "unfused", "fused"):
                    dev, tops = device_split(runs[route])
                    log(f"  device busy [{route} route, {mode} B={b}, {out.steps} steps]: "
                        f"{dev:.2f} ms ({tops}); {SMI}")
    log(f"identity hook against the fused route: {differing} examples differ in all "
        f"(each under the clear-gap rule)")


# The remaining decode modes (phase 4): branching trees, typical acceptance
# with sampling, and the temperature-fallback ladder, each on the unfused
# route (K3 / K7 rows, K4 and K5 at 0 launches).
TREE_NEW_TOKENS = 48
TREE_SMALL = (1, 2, 2, 1)                                 # 11 nodes: K2 with the mask
TREE_PER_OP = (1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1)           # 21 nodes: 2 K10 mask launches
TREE_WIDE = (1, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1)             # 39 nodes: 2 words a row
NEEDS_TREE = {"bf16": ("attention", "megastep", "head_rows", "logits"),
              "int8": ("attention", "megastep_int8", "head_rows_int8", "qmm_nt"),
              "block": ("attention", "megastep_block", "head_rows", "logits"),
              "per_op": ("attention", "megastep", "self_decode", "cross_decode",
                         "ffn_decode", "head_rows", "logits")}
SAMPLE_T = 0.7
LADDER = (0.0, 0.4, 0.8)


def _step_ms(run, steps):
    """Device busy ms of one run of ``run`` a decode step, and its top
    kernels."""
    dev, tops = device_split(run)
    return dev / max(steps, 1), tops


def check_tree_invariance(model, enc8, choices):
    """speculative_generate with a tree at B=8 on the batched encoder rows
    gives every example the tokens of a B=1 tree decode of its row."""
    from whisper_medusa_tpu_torch.config import GenerationConfig
    from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
    from whisper_medusa_tpu_torch.decoding.speculative import speculative_generate

    st, gd, cfg = model.special, model.generation_config, model.config
    b = enc8.shape[0]
    prompt = torch.tensor([[st.sot, st.first_language, st.transcribe,
                            st.no_timestamps]] * b, dtype=torch.int32, device="cuda")
    gen = GenerationConfig(max_length=PROMPT_LEN + TREE_NEW_TOKENS, eos_token_id=st.eos,
                           pad_token_id=gd.pad_token_id)
    buffers = generate_medusa_buffers(choices)
    run = lambda e, p: speculative_generate(
        model.params["whisper"], model.params["medusa"], cfg.dims, buffers,
        _request_pcfg(model), gen, e, p, variant=cfg.medusa.medusa_heads_type)
    batched = run(enc8, prompt)
    same = [bool(torch.equal(batched.tokens[e], run(enc8[e:e + 1], prompt[e:e + 1]).tokens[0]))
            for e in range(b)]
    mode = "int8" if _int8(model) else "bf16"
    log(f"{mode} tree {choices} batch invariance: B={b} tokens equal to the B=1 decode for "
        f"{sum(same)}/{b} examples; B={b} steps {batched.steps}, accepted "
        f"{batched.accepted.tolist()}")
    require(all(same), f"{mode} tree decode batch invariance: {same}")


def phase_tree_requests(model, qmodel, bmodel, kernels, feat, feats8):
    """Trees at full width, TREE_NEW_TOKENS new tokens, each driven with the
    launch counters (K4 and K5 at 0) and held to its own run under
    ``draft_corruption=1.0`` over their common length (under the clear-gap
    rule: see the comment below): TREE_SMALL (11 nodes, K2 with the ancestor
    mask) at B=1 and B=8, bf16 and int8, and Medusa-Block at B=1; TREE_PER_OP
    (21 nodes: the per-op step, two K10 mask-mode launches a layer) and
    TREE_WIDE (39 nodes: three launches a layer over two words a row) at
    B=1 bf16.  The B=8 TREE_SMALL decode (bf16, int8) gives each example its
    B=1 tree tokens.  Each B=1 bf16 tree's steps, accept length and device
    time a step are printed beside the chain's, and its agreement with the
    chain's tokens (printed, not held: the drafts differ, the verification
    is the same argmax up to the rounding of another route); "device time a
    step" is a request's device busy time (encoder and prefill included)
    over its steps."""
    absent = _verify_names(kernels)
    nl = model.config.dims.decoder_layers
    kw = dict(language="en", max_new_tokens=TREE_NEW_TOKENS)
    chain = model.generate(feat, **kw)
    chain_ms, chain_tops = _step_ms(lambda: model.generate(feat, **kw), chain.steps)
    log(f"chain (K4 route) bf16 B=1, {TREE_NEW_TOKENS} new tokens: {chain.steps} steps, "
        f"mean_accept_length {chain.mean_accept_length:.3f}, device {chain_ms:.3f} ms a step "
        f"({chain_tops}); {SMI}")
    runs = (("bf16", model, TREE_SMALL, 1, NEEDS_TREE["bf16"]),
            ("bf16", model, TREE_SMALL, BATCH, NEEDS_TREE["bf16"]),
            ("int8", qmodel, TREE_SMALL, 1, NEEDS_TREE["int8"]),
            ("int8", qmodel, TREE_SMALL, BATCH, NEEDS_TREE["int8"]),
            ("bf16 medusa_block", bmodel, TREE_SMALL, 1, NEEDS_TREE["block"]),
            ("bf16", model, TREE_PER_OP, 1, NEEDS_TREE["per_op"]),
            ("bf16", model, TREE_WIDE, 1, NEEDS_TREE["per_op"] + ("self_decode wide",)))
    for mode, m, choices, b, needs in runs:
        f = feat if b == 1 else feats8
        n_nodes = sum(int(np.prod(choices[:i + 1])) for i in range(len(choices)))
        name = f"tree {choices} ({n_nodes} nodes) {mode} B={b}"
        tkw = dict(kw, medusa_choices=choices)
        m.generate(f, language="en", max_new_tokens=4, medusa_choices=choices)   # warm-up
        seen = {}
        out, wall = drive(name, kernels, lambda: m.generate(f, **tkw), needs, absent, seen)
        report(name, out, wall, check_output(out, b, m.config.dims.vocab_size,
                                             TREE_NEW_TOKENS))
        if n_nodes > 16:
            blocks = -(-n_nodes // 16)
            log(f"  per-op step: K2 {seen['megastep']} launch (the prefill), K10 mask mode "
                f"{seen['self_decode']} launches ({seen['self_decode wide']} over two words) "
                f"in {out.steps} steps ({blocks * nl} a step expected)")
            require(seen["megastep"] == 1 and seen["self_decode"] == blocks * nl * out.steps,
                    f"{name}: the per-op step's 16-row blocks")
            require(seen["self_decode wide"] == (seen["self_decode"] if n_nodes > 32 else 0),
                    f"{name}: {seen['self_decode wide']} launches over two words")
        # A tree's accepted node computes its K/V in another cache slot than
        # the chain of one-token steps does, and K2 / K10 split the keys by
        # slot: the two runs may round apart, so a difference is allowed
        # only where the top-2 gap is under GAP_TOL (clear_gap_compare).
        bad = m.generate(f, draft_corruption=1.0, **tkw)
        log(f"  {name} under draft_corruption=1.0: steps {bad.steps} (clean {out.steps}), "
            f"accepted {int(bad.accepted.sum())}")
        require(bad.steps >= out.steps and int(bad.accepted.sum()) == 0,
                f"{name} under draft_corruption=1.0: steps {bad.steps}")
        clear_gap_compare(f"{name} vs its run under draft_corruption=1.0", m, m.encode(f),
                          out, bad, m.config.medusa.medusa_heads_type)
        if mode == "bf16" and b == 1:
            ms, tops = _step_ms(lambda: m.generate(f, **tkw), out.steps)
            log(f"  {name}: {out.steps} steps (chain {chain.steps}), mean_accept_length "
                f"{out.mean_accept_length:.3f} (chain {chain.mean_accept_length:.3f}), device "
                f"{ms:.3f} ms a step (chain {chain_ms:.3f}; {tops}); tokens equal to the "
                f"chain's at {token_share(out, chain):.3f} of the generated positions (printed, "
                f"not held); {SMI}")
    enc8 = model.encode(feats8)
    check_tree_invariance(model, enc8, TREE_SMALL)
    check_tree_invariance(qmodel, enc8, TREE_SMALL)


def phase_sampled_requests(model, qmodel, kernels, feat, feats8):
    """temperature=SAMPLE_T (typical acceptance, tokens drawn from
    softmax(logits / T) by a generator seeded from ``seed``), bf16 at B=1
    and B=8 and int8 at B=1, each driven with the launch counters (K4 and K5
    at 0): two runs at seed=0 give equal tokens (held), seed=1 other tokens
    (printed); the bf16 runs' steps and device time a step printed beside
    the greedy chain's (the fused route) on the same features."""
    absent = _verify_names(kernels)
    for mode, m, f, b in (("bf16", model, feat, 1), ("bf16", model, feats8, BATCH),
                          ("int8", qmodel, feat, 1)):
        kw = dict(language="en", max_new_tokens=TREE_NEW_TOKENS, temperature=SAMPLE_T)
        name = f"sampled T={SAMPLE_T} {mode} B={b}"
        out, wall = drive(name, kernels, lambda: m.generate(f, seed=0, **kw),
                          NEEDS_TREE[mode], absent)
        report(name, out, wall, check_output(out, b, m.config.dims.vocab_size,
                                             TREE_NEW_TOKENS))
        again = m.generate(f, seed=0, **kw)
        other = m.generate(f, seed=1, **kw)
        log(f"  {name}: seed 0 twice equal {np.array_equal(again.sequences, out.sequences)}; "
            f"seed 1 differs at {1 - token_share(other, out):.3f} of the generated positions "
            f"(printed)")
        require(np.array_equal(again.sequences, out.sequences)
                and np.array_equal(again.accepted, out.accepted),
                f"{name}: two runs at seed 0 differ")
        if mode == "bf16":
            ms, tops = _step_ms(lambda: m.generate(f, seed=0, **kw), out.steps)
            gkw = dict(kw, temperature=0.0)
            greedy = m.generate(f, **gkw)
            g_ms, _ = _step_ms(lambda: m.generate(f, **gkw), greedy.steps)
            log(f"  {name}: {out.steps} steps, mean_accept_length "
                f"{out.mean_accept_length:.3f}, device {ms:.3f} ms a step ({tops}); the "
                f"greedy chain (fused route) {greedy.steps} steps, {g_ms:.3f} ms a step; {SMI}")


def _ladder_split(model, greedy):
    """A compression_ratio_threshold (or, where the ratios do not split the
    batch, a logprob_threshold) between the greedy outputs' values nearest
    the batch's middle: ({option: value}, examples that retry at rung 1)."""
    from whisper_medusa_tpu_torch.models import api as A

    vocab = model.config.dims.vocab_size
    ratios = np.array([A._compression_ratio(greedy.sequences[e, PROMPT_LEN:greedy.lengths[e]],
                                            vocab) for e in range(BATCH)])
    for name, vals, above in (("compression_ratio_threshold", ratios, True),
                              ("logprob_threshold", greedy.avg_logprobs.astype(np.float64),
                               False)):
        order = np.sort(vals)
        cuts = [(abs(i - BATCH / 2), (order[i - 1] + order[i]) / 2)
                for i in range(1, BATCH) if order[i] > order[i - 1]]
        if cuts:
            thr = float(min(cuts)[1])
            return {name: thr}, int(((vals > thr) if above else (vals < thr)).sum())
    raise AssertionError("the greedy outputs do not split the batch")


def phase_ladder_requests(model, kernels, feats8, greedy):
    """The temperature ladder LADDER at B=8, bf16, MAX_NEW_TOKENS new tokens,
    with a threshold that splits the greedy request's batch (_ladder_split),
    driven with the launch counters (K4 and K5 at 0 on the sampled rungs'
    route; rung 0 is the greedy fused route, one K5 launch a step): the
    examples kept at rung 0
    equal ``greedy``'s tokens, and each retry rung decodes exactly the rows
    still failing (a spy on ``speculative_generate`` records each rung's
    batch and result); device time printed."""
    from whisper_medusa_tpu_torch.models import api as A

    opt, n_retry = _ladder_split(model, greedy)
    real, calls = A.speculative_generate, []

    def spy(*args, **kw):
        result = real(*args, **kw)
        calls.append((int(args[6].shape[0]), kw.get("rng") is not None, result))
        return result

    kw = dict(language="en", max_new_tokens=MAX_NEW_TOKENS, temperature=LADDER, seed=0, **opt)
    A.speculative_generate = spy
    seen = {}
    try:
        out, wall = drive(f"ladder {LADDER} bf16 B={BATCH}", kernels,
                          lambda: model.generate(feats8, **kw),
                          ("attention", "megastep", "head_rows", "logits", "verify_rows"),
                          seen=seen)
    finally:
        A.speculative_generate = real
    report(f"ladder {LADDER} bf16 B={BATCH}", out, wall,
           check_output(out, BATCH, model.config.dims.vocab_size))
    keep = np.zeros((BATCH,), bool)
    crt = opt.get("compression_ratio_threshold")
    lpt = opt.get("logprob_threshold")
    for rung, (b, sampled, result) in enumerate(calls):
        fail = np.arange(BATCH) if rung == 0 else np.where(~keep)[0]
        require(b == len(fail) and sampled == (LADDER[rung] > 0),
                f"ladder rung {rung}: a batch of {b} for {len(fail)} failing rows")
        toks, lens = result.tokens.cpu().numpy(), result.lengths.cpu().numpy()
        avg = A._avg_from_captured(result.logprobs.cpu().numpy(), lens, PROMPT_LEN)
        keep[fail] = ~A._needs_fallback(toks, lens, PROMPT_LEN, crt, avg, lpt,
                                        vocab_size=model.config.dims.vocab_size)
    kept0 = np.where(~A._needs_fallback(greedy.sequences, greedy.lengths, PROMPT_LEN, crt,
                                        greedy.avg_logprobs, lpt,
                                        vocab_size=model.config.dims.vocab_size))[0]
    log(f"  ladder {opt}: rung batches {[b for b, _, _ in calls]} ({n_retry} retried at rung "
        f"1), steps {out.steps} (per example {out.steps_per_example.tolist()}); kept at rung 0: "
        f"{kept0.tolist()}")
    require(calls[0][0] == BATCH and len(calls) >= 2 and calls[1][0] == n_retry,
            f"ladder: rung batches {[b for b, _, _ in calls]}, {n_retry} to retry")
    # Rung 0 is greedy (two-pass verification at B=8: one K5 launch a step);
    # the sampled rungs take the unfused route, K4 and K5 at 0.
    fused = sum(seen[n] for n in _verify_names(kernels))
    require(fused == calls[0][2].steps,
            f"ladder: {fused} K4 / K5 launches for rung 0's {calls[0][2].steps} steps")
    require(all(np.array_equal(out.sequences[e], greedy.sequences[e]) for e in kept0),
            "ladder: an example kept at rung 0 differs from the greedy request")
    dev, tops = device_split(lambda: model.generate(feats8, **kw))
    log(f"  ladder {LADDER} bf16 B={BATCH}: device busy {dev:.1f} ms ({tops}); {SMI}")


def check_beam_step(model, enc1, name):
    """The beam-folded per-op step (one example, BEAMS beam rows over one
    cross row: decoder_layers_ops with cross_beam) against the per-op step
    over the cross K/V repeated BEAMS times, on the same rows: a 4-token
    prefill (4 x 5 = 20 folded query rows, two K10 launches a layer) and
    one token.  hidden and the written self-cache rows elementwise within
    BEAM_STEP_TOL (close; int8 slab rows within one quantization step);
    bitwise equality printed."""
    from whisper_medusa_tpu_torch.models import whisper as W
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    p, dims = model.params["whisper"], model.config.dims
    dec, nh, k = p["decoder"], dims.decoder_attention_heads, BEAMS
    fold = W.init_cache(p, dims, enc1, 16, self_batch=k)
    rep = W.init_cache(p, dims, enc1.repeat_interleave(k, 0), 16)
    require(fold.cross_k.shape[1] == 1 and fold.self_k.shape[1] == k, "beam cache rows")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 30)
    worst, bitwise = 0.0, True
    for t, off in ((4, 0), (1, 4)):
        toks = torch.randint(300, 3000, (k, t), generator=g, device="cuda", dtype=torch.int32)
        offsets = torch.full((k,), off, dtype=torch.int32, device="cuda")
        x = _embedded(dec, toks, offsets)
        step = lambda c, beam: W.decoder_layers_ops(
            dec["layers"], dec["ln_post"], x, c.self_k, c.self_v, c.cross_k, c.cross_v,
            offsets, None, dims.max_source_positions, nh, cross_k_s=c.cross_k_s,
            cross_v_s=c.cross_v_s, self_s=c.self_s, cross_beam=beam)[1]
        before = DO.cross_launches + DO.q_cross_launches
        h_f = step(fold, k)
        k10 = DO.cross_launches + DO.q_cross_launches - before
        h_r = step(rep, 1)
        rows = (fold.self_k[:, :, :off + t], rep.self_k[:, :, :off + t])
        err, err_rows = max_err(h_f, h_r), max_err(*rows)
        same = bool(torch.equal(h_f, h_r)) and bool(torch.equal(*rows))
        log(f"beam-folded per-op step [{name}] T={t} at offset {off}: {k * t} folded query "
            f"rows, K10 launches {k10} ({dims.decoder_layers} layers); against the repeated "
            f"step: hidden max_abs_err {err:.3e}, self-cache rows {err_rows:.3e}; bitwise "
            f"{same}")
        # An int8 slab row may round one step the other way.
        rows_ok = (err_rows <= 1.0 if rows[0].dtype == torch.int8
                   else close(rows[0], rows[1], BEAM_STEP_TOL))
        require(close(h_f, h_r, BEAM_STEP_TOL) and rows_ok,
                f"beam-folded step [{name}] T={t}: {err}, {err_rows}")
        require(k10 == dims.decoder_layers * -(-(k * t) // DO.MAX_T),
                f"beam-folded step [{name}]: {k10} K10 launches")
        worst = max(worst, err)
        bitwise &= same
    return worst, bitwise


def beam_host_split(run):
    """Where a beam request's host time goes: the wall of one run of
    ``run`` (synchronized), the host time spent inside
    ``whisper.decode_step`` (the per-op step, its launches enqueued) and
    inside ``beam.top_k`` (the expansion's rankings), as text."""
    from whisper_medusa_tpu_torch.decoding import beam as BM
    from whisper_medusa_tpu_torch.models import whisper as W

    spent = {"decode_step": 0.0, "top_k": 0.0}

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    real_step, real_top = W.decode_step, BM.top_k
    W.decode_step, BM.top_k = timed("decode_step", real_step), timed("top_k", real_top)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        W.decode_step, BM.top_k = real_step, real_top
    rest = wall - sum(spent.values())
    return (f"wall {wall * 1e3:.1f} ms, in decode_step {spent['decode_step'] * 1e3:.1f} ms, "
            f"in top_k {spent['top_k'] * 1e3:.1f} ms, the rest {rest * 1e3:.1f} ms")


def phase_beam_requests(model, qmodel, kernels, feat, feats8):
    """Beam search on the card (num_beams=BEAMS, MAX_NEW_TOKENS new tokens):
    the folded step against the repeated one (bf16, int8); requests at B=1
    bf16 and int8 and B=2 bf16, each driven with the launch counters (the
    per-op step, K2 and K4 / K5 at 0), its wall, steps, tokens and peak
    memory (and its rise over what was resident) printed, the B=1 bf16
    one's device time and host split (beam_host_split); num_beams=1,
    length_penalty=0 against vanilla greedy under the clear-gap rule;
    beams with timestamps (B=1, the timestamp grammar) and a 75 s longform
    request with num_beams=2 at B=1."""
    from whisper_medusa_tpu_torch.ops.mel import log_mel_spectrogram

    absent = K2_ROWS + _verify_names(kernels)
    enc1 = model.encode(feat)
    for m, mode in ((model, "bf16"), (qmodel, "int8")):
        check_beam_step(m, enc1, mode)
    kw = dict(language="en", max_new_tokens=MAX_NEW_TOKENS, num_beams=BEAMS)
    for mode, m, f, b in (("bf16", model, feat, 1), ("int8", qmodel, feat, 1),
                          ("bf16", model, feats8[:2], 2)):
        m.generate(f, language="en", max_new_tokens=8, num_beams=BEAMS)       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30
        run = lambda: m.generate(f, **kw)
        out, wall = drive(f"beams K={BEAMS} {mode} B={b}", kernels, run, NEEDS_BEAM[mode],
                          absent)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_gen = int((out.lengths - PROMPT_LEN).sum())
        require(out.sequences.shape[0] == b and (out.lengths > PROMPT_LEN).all()
                and (out.sequences >= 0).all()
                and (out.sequences < m.config.dims.vocab_size).all()
                and np.isfinite(out.avg_logprobs).all() and out.steps > 0,
                f"beams {mode} B={b}: output")
        log(f"beams K={BEAMS} {mode} B={b}: {wall * 1e3:.1f} ms, {n_gen} generated tokens, "
            f"{out.steps} steps, scores {np.round(out.avg_logprobs, 4).tolist()}, lengths "
            f"{out.lengths.tolist()}, peak memory {peak:.2f} GiB ({peak - resident:.3f} over "
            f"the {resident:.2f} GiB resident before it); {SMI}")
        if mode == "bf16" and b == 1:
            dev, tops = device_split(run)
            log(f"  device busy {dev:.1f} ms of the request ({tops})")
            log(f"  host split: {beam_host_split(run)}")
    # num_beams=1, length_penalty=0 is greedy (JAX tests/test_beam.py).
    greedy = model.generate(feat, language="en", max_new_tokens=MAX_NEW_TOKENS,
                            disable_medusa=True)
    beam1 = model._generate_beam(feat, language="en", task="transcribe", max_length=None,
                                 max_new_tokens=MAX_NEW_TOKENS, num_beams=1,
                                 length_penalty=0.0)
    clear_gap_compare("num_beams=1, length_penalty=0 vs vanilla greedy (bf16 B=1)", model,
                      enc1, greedy, beam1, "vanilla", stop_at_eos=True)
    # Beams with timestamps, and the seek loop with beam-decoded windows.
    out, wall = drive(f"beams K={BEAMS} timestamps bf16 B=1", kernels,
                      lambda: model.generate(feat, language="en", num_beams=BEAMS,
                                             max_new_tokens=BEAM_TS_NEW_TOKENS,
                                             return_timestamps=True),
                      NEEDS_BEAM["bf16"], absent)
    check_ts_output(model, out)
    log(f"beams K={BEAMS} timestamps bf16 B=1: {wall * 1e3:.1f} ms, "
        f"{int(out.lengths[0]) - 3} generated tokens, {out.steps} steps, segments "
        f"{len(out.segments[0])}, first {out.segments[0][:1]}")
    wave = waveforms(LONG_SECS[:1])[0]
    feats = log_mel_spectrogram(torch.from_numpy(wave).cuda()[None])
    out, wall = drive("beams K=2 longform 75 s bf16 B=1", kernels,
                      lambda: model.generate(feats, language="en", num_beams=2,
                                             max_new_tokens=LONG_NEW_TOKENS,
                                             return_timestamps=True),
                      NEEDS_BEAM["bf16"], absent)
    starts = [sg["start"] for sg in out.segments[0]]
    log(f"beams K=2 longform 75 s bf16 B=1: {wall * 1e3:.1f} ms, {int(out.lengths[0])} kept "
        f"tokens, {out.steps} steps, {len(starts)} segments, last start "
        f"{starts[-1] if starts else None}")
    require(out.token_logprobs is None and starts and starts == sorted(starts)
            and starts[-1] < LONG_SECS[0] + 30.0
            and (out.sequences < model.config.dims.vocab_size).all(),
            "beams longform: segments")


# The capture surfaces (phase 4): the score stack, the attention maps, the
# hidden states, DTW word and token times and score_sequences, each served
# by one teacher-forced pass after the decode (models/api.py::_capture).
CAPTURE_HEADS = ((8, 3), (16, 11), (24, 5), (31, 19))     # return_cross_attentions
# The DTW's alignment heads: a checkpoint's generation config names a few
# (the default, every head of the upper half, is 320 at large-v2).
CAPTURE_ALIGN = ((18, 2), (20, 7), (22, 11), (24, 4), (26, 15), (28, 9), (30, 1), (31, 13))
CAPTURE_LONG_SECS = 75.0
# The score stack's rows (one teacher-forced pass: K1, cuBLAS, K3 / K7)
# gathered at the emitted tokens against the loop's token log-probs (K2,
# K4 / K5): at most 0.0381 over the B=1, B=8 and int8 requests on an H100
# 80GB HBM3 at 700 W (PERF.md, §5); held at 0.1.
SCORE_TOL = 0.1
# Kernels that must launch inside the capture (the teacher-forced pass and
# the score stack): K1 and K3 at bf16; the int8 pass's projections on K6
# and its vocab rows on K7.
CAPTURE_NEEDS = {"bf16": ("attention", "logits"), "int8": ("qmm", "qmm_nt")}


class _PseudoWords:
    """A tokenizer stand-in (the repository holds no BPE vocabulary): each
    id decodes to a space-separated pseudo-word, so each text token is one
    word."""

    def decode(self, ids, skip_special_tokens=True, **kw):
        return "".join(f" t{int(i)}" for i in ids)


def capture_model(model):
    """``model`` (base_head, its Whisper weights shared) with head 0 the
    identity (zero weights and bias): the loop then verifies from the
    backbone's hidden state itself, which is what the score stack, as the
    JAX package's, projects, so the stack's gathered rows can be held to
    the loop's token log-probs."""
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel

    heads = {k: v.clone() for k, v in model.params["medusa"]["heads"].items()}
    heads["w"][0].zero_()
    heads["b"][0].zero_()
    return WhisperMedusaModel(model.config, {"whisper": model.params["whisper"],
                                             "medusa": {"heads": heads}},
                              device=model.device, generation_config=model.generation_config,
                              special_tokens=model.special)


def _spy_capture(model, kernels, names):
    """Wrap ``model._capture``: each call's arguments, host seconds and the
    launches of the rows ``names`` inside it are appended to the list
    returned."""
    by_name = {k["name"]: k for k in kernels}
    real, calls = model._capture, []

    def spy(*args, **kw):
        before = {n: _read_count(by_name[n]) for n in names}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        calls.append(dict(args=args, kw=kw, secs=time.perf_counter() - t0,
                          launches={n: _read_count(by_name[n]) - before[n] for n in names}))
        return out

    model._capture = spy
    return calls


def check_score_stack(name, out, p_len=3):
    """Each live row of the score stack is a log-probability distribution
    (its log-sum-exp within 1e-3 of 0), rows past an example's length are 0,
    the rows gathered at the emitted tokens lie within SCORE_TOL of the
    loop's token log-probs, and every row whose top-2 gap exceeds
    2 x SCORE_TOL has the emitted token as its argmax.  Returns the largest
    gathered difference."""
    worst, clear, flips = 0.0, 0, []
    for i in range(out.sequences.shape[0]):
        n = int(out.lengths[i]) - p_len
        rows = out.scores[i, :n]
        toks = out.sequences[i, p_len:p_len + n]
        fin = np.where(np.isfinite(rows), rows, -np.inf)
        lse = np.log(np.exp(fin - fin.max(-1, keepdims=True)).sum(-1)) + fin.max(-1)
        require(np.abs(lse).max() < 1e-3, f"{name}: example {i}: rows are not log-probs")
        require(not out.scores[i, n:].any(), f"{name}: example {i}: rows past the length")
        got = rows[np.arange(n), toks]
        worst = max(worst, float(np.abs(got - out.token_logprobs[i, p_len:p_len + n]).max()))
        top2 = np.partition(fin, -2, axis=-1)[:, -2:]
        big = (top2[:, 1] - top2[:, 0]) > 2 * SCORE_TOL
        clear += int(big.sum())
        flips += [(i, int(j)) for j in np.nonzero(big & (fin.argmax(-1) != toks))[0]]
    log(f"  {name}: score stack {out.scores.shape}; gathered rows vs the loop's token "
        f"log-probs: max |diff| {worst:.4e} (held <= {SCORE_TOL}); {clear} rows with a top-2 "
        f"gap over {2 * SCORE_TOL}: argmax != the emitted token at {flips or 'none'}")
    require(worst <= SCORE_TOL and not flips, f"{name}: score stack against the loop")
    return worst


def check_times(name, model, out, live_s, p_len):
    """Word and token times are monotonic and lie within [0, live_s]; the
    token times' NaN rows are the non-text tokens (``p_len`` prompt tokens
    lead each sequence, none on longform output)."""
    for i in range(out.sequences.shape[0]):
        gen = out.sequences[i, p_len:out.lengths[i]]
        if out.token_timestamps is not None:
            tt = out.token_timestamps[i]
            text = gen < model.special.eos
            require(tt.shape == (len(gen), 2) and np.isnan(tt[~text]).all()
                    and np.isfinite(tt[text]).all(), f"{name}: example {i}: token times")
            st, en = tt[text, 0], tt[text, 1]
            require(bool((np.diff(st) >= -1e-9).all() and (en >= st - 1e-9).all()
                         and (st >= -1e-9).all() and (en <= live_s + 1e-6).all()),
                    f"{name}: example {i}: token times not monotonic in [0, {live_s}]")
        if out.words is not None:
            ws = out.words[i]
            starts = [w["start"] for w in ws]
            require(bool(ws) and starts == sorted(starts)
                    and all(0.0 <= w["start"] <= w["end"] <= live_s + 1e-6 for w in ws),
                    f"{name}: example {i}: word times not monotonic in [0, {live_s}]")


def check_capture_maps(name, model, out, call):
    """The maps against a direct ``decode_train_capture(cross="all",
    self_attn="all", collect_hidden=True)`` of each example (the API's
    capture pass runs one example at a time) on the request's final tokens
    and encoder rows: the selected cross maps, the self maps and the hidden
    stack bit for bit; every map row sums to 1 within 1e-3; the hidden
    stack's last row after ln_post is the pass's hidden, and that hidden is
    ``decode_train``'s, bit for bit."""
    from whisper_medusa_tpu_torch.models import whisper as W

    p, dims = model.params["whisper"], model.config.dims
    dec = p["decoder"]
    enc, tokens, _, _, _, max_length = call["args"][:6]
    dec_in = torch.as_tensor(tokens[:, :max_length], dtype=torch.int32, device="cuda")
    checks = dict.fromkeys(("selected cross maps", "self maps", "hidden stack",
                            "ln_post(last hidden row) == hidden",
                            "hidden == decode_train's"), True)
    for e in range(dec_in.shape[0]):
        with torch.no_grad():
            hid, cm, sm, hs = W.decode_train_capture(
                p, dims, dec_in[e:e + 1], enc[e:e + 1], cross="all", self_attn="all",
                collect_hidden=True)
            ref = W.decode_train(p, dims, dec_in[e:e + 1], enc[e:e + 1]).hidden
        for key, ok in (
                ("selected cross maps", all(np.array_equal(
                    out.cross_attentions[i][e], cm[l][0, h].cpu().numpy())
                    for i, (l, h) in enumerate(CAPTURE_HEADS))),
                ("self maps", np.array_equal(out.decoder_attentions[:, e],
                                             sm[:, 0].cpu().numpy())),
                ("hidden stack", np.array_equal(out.decoder_hidden_states[:, e],
                                                hs[:, 0].float().cpu().numpy())),
                ("ln_post(last hidden row) == hidden", torch.equal(W.layer_norm(
                    hs[-1], dec["ln_post"]["scale"], dec["ln_post"]["bias"]), hid)),
                ("hidden == decode_train's", torch.equal(hid, ref))):
            checks[key] &= bool(ok)
        del cm, sm, hs
    sums = [np.abs(out.cross_attentions.sum(-1) - 1).max(),
            np.abs(out.decoder_attentions.sum(-1) - 1).max()]
    log(f"  {name}: against a direct capture of every head: {checks}; map rows' sums "
        f"within {max(sums):.2e} of 1")
    require(all(checks.values()) and max(sums) <= 1e-3, f"{name}: maps {checks}, sums {sums}")


def _capture_times(name, model, plain, captured, call):
    """Device busy time of the decode (the request without captures), of the
    capture pass (decode_train_capture with the request's arguments) and of
    the score stack with its host copy (memcpy device time and host
    seconds), and each run's peak memory above what was allocated before."""
    from whisper_medusa_tpu_torch.decoding import scores as S
    from whisper_medusa_tpu_torch.device_profile import _by_kernel
    from whisper_medusa_tpu_torch.models import whisper as W

    p, dims = model.params["whisper"], model.config.dims
    enc, tokens, lengths, _, pcfg, max_length = call["args"][:6]
    dec_in = torch.as_tensor(tokens[:, :max_length], dtype=torch.int32, device="cuda")
    want = tuple(dict.fromkeys(CAPTURE_HEADS + CAPTURE_ALIGN))

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    def cap():
        with torch.no_grad():
            for e in range(dec_in.shape[0]):
                W.decode_train_capture(p, dims, dec_in[e:e + 1], enc[e:e + 1], cross=want,
                                       self_attn="all", collect_hidden=True, to_host=True)

    stack = lambda: S.full_scores(p, dims, tokens, lengths, enc, pcfg, max_length)
    dec_ms, dec_top = device_split(plain)
    cap_ms, cap_top = device_split(cap)
    by = _by_kernel(stack, 1)
    stack_ms = sum(us for us, _ in by.values()) / 1e3
    copy_ms = by.get("memcpy / memset", (0.0, 0))[0] / 1e3
    t0 = time.perf_counter()
    stack()
    stack_host = time.perf_counter() - t0
    mem = {"decode": peak(plain), "request with captures": peak(captured),
           "capture pass": peak(cap), "score stack": peak(stack)}
    log(f"  {name}: device busy ms: decode (the request without captures) {dec_ms:.2f} "
        f"({dec_top}); capture pass ({len(want)} cross maps, every self map, hidden states) "
        f"{cap_ms:.2f} ({cap_top}); score stack {stack_ms:.2f}, of it memcpy / memset "
        f"{copy_ms:.2f}, host {stack_host * 1e3:.1f} ms for {tokens.shape[0]} x "
        f"{max_length - pcfg.begin_index} x {dims.vocab_size} f32; the whole capture "
        f"(_capture) {call['secs'] * 1e3:.1f} ms of host time; peak GiB above the "
        f"baseline {', '.join(f'{k} {v:.3f}' for k, v in mem.items())}; {SMI}")


def phase_capture_requests(model, bmodel, kernels, feat, feats8):
    """The capture surfaces at full width, each request driven with the
    launch counters and held to the same request without captures (tokens
    equal): base_head at B=1 and B=8 (bf16) and B=1 (int8) with every
    surface (timestamps, the score stack, DTW word and token times with
    the pseudo-word tokenizer, four selected cross-attention heads, every
    self map, the hidden states); Medusa-Block B=1 with the score stack; a
    75 s longform B=1 with word times and the score stack; score_sequences
    on the B=8 output.  K1 and K3 (K6 and K7 at int8) must launch inside the
    capture.  Checks: check_capture_maps, check_score_stack, check_times,
    the B=8 word times within one encoder frame (0.02 s) of each example's
    B=1 capture on the same encoder row and tokens (the count of exactly
    equal words printed, not held), and score_sequences within SCORE_TOL of
    the loop's avg_logprobs.  The device times of the decode, the capture
    pass and the score stack, and peak memory, printed (_capture_times)."""
    from whisper_medusa_tpu_torch.ops.mel import log_mel_spectrogram

    cmodel = capture_model(model)
    cqmodel = cmodel.quantize()
    base = dict(language="en", max_new_tokens=CAPTURE_NEW_TOKENS, return_timestamps=True)
    every = dict(return_scores="full", return_token_timestamps=True, word_timestamps=True,
                 tokenizer=_PseudoWords(), alignment_heads=CAPTURE_ALIGN,
                 return_decoder_attentions=True, return_hidden_states=True,
                 return_cross_attentions=CAPTURE_HEADS)
    runs = (("bf16 base_head B=1", cmodel, feat, every, "bf16"),
            (f"bf16 base_head B={BATCH}", cmodel, feats8, every, "bf16"),
            ("int8 base_head B=1", cqmodel, feat, every, "int8"),
            ("bf16 medusa_block B=1", bmodel, feat, dict(return_scores="full"), "bf16"))
    outs = {}
    for name, m, f, caps, mode in runs:
        plain = lambda: m.generate(f, **base)
        ref = plain()
        calls = _spy_capture(m, kernels, CAPTURE_NEEDS[mode])
        try:
            out, wall = drive(f"capture {name}", kernels, lambda: m.generate(f, **base, **caps),
                              ("attention",) + CAPTURE_NEEDS[mode])
        finally:
            del m._capture
        call = calls[-1]
        log(f"capture {name}: {wall * 1e3:.1f} ms wall ({call['secs'] * 1e3:.1f} in "
            f"_capture), lengths {out.lengths.tolist()}; launches inside the capture "
            f"{call['launches']}")
        require(all(n > 0 for n in call["launches"].values()),
                f"capture {name}: a kernel did not launch inside the capture")
        require(np.array_equal(out.sequences, ref.sequences)
                and np.array_equal(out.lengths, ref.lengths),
                f"capture {name}: tokens differ from the request without captures")
        check_score_stack(f"capture {name}", out)
        if caps.get("word_timestamps"):
            check_capture_maps(f"capture {name}", m, out, call)
            check_times(f"capture {name}", m, out, 30.0, 3)
        if m is cmodel:
            _capture_times(f"capture {name}", m, plain, lambda: m.generate(f, **base, **caps),
                           call)
        outs[name] = (out, call)

    # B=8 word times against each example's B=1 capture on the same encoder
    # row and tokens.
    out8, call8 = outs[f"bf16 base_head B={BATCH}"]
    enc, tokens, lengths, p_len, pcfg, max_length, n_frames = call8["args"][:7]
    worst, equal, total = 0.0, 0, 0
    for e in range(BATCH):
        one = cmodel._capture(enc[e:e + 1], tokens[e:e + 1], lengths[e:e + 1], p_len, pcfg,
                              max_length, n_frames, None, None, **dict(
                                  call8["kw"], return_scores=False,
                                  return_decoder_attentions=False,
                                  return_hidden_states=False))
        wa, wb = out8.words[e], one["words"][0]
        require([w["word"] for w in wa] == [w["word"] for w in wb],
                f"capture B={BATCH}: example {e}: words differ from its B=1 capture")
        for x, y in zip(wa, wb):
            worst = max(worst, abs(x["start"] - y["start"]), abs(x["end"] - y["end"]))
            equal += int(x == y)
            total += 1
    log(f"capture B={BATCH} vs each example's B=1 capture: {equal}/{total} words with equal "
        f"times (printed); largest time difference {worst:.3f} s (held <= 0.02)")
    require(worst <= 0.02 + 1e-9, f"capture B={BATCH}: word times differ by {worst} s")

    # score_sequences on the B=8 output.
    seen = {}
    avg, _ = drive(f"score_sequences bf16 B={BATCH}", kernels,
                   lambda: cmodel.score_sequences(enc, out8.sequences, out8.lengths, 3),
                   ("attention", "logits"), seen=seen)
    # The plain version: the same pass's hidden state through an f32 product
    # with the embedding (no K3), log-softmax, gather and mean.
    from whisper_medusa_tpu_torch.models import whisper as W

    p = cmodel.params["whisper"]
    seq = torch.as_tensor(out8.sequences, dtype=torch.int64, device="cuda")
    with torch.no_grad():
        hid = W.decode_train(p, cmodel.config.dims, seq[:, :-1], enc).hidden
        lp = torch.log_softmax(W.project_logits_train(p, hid), dim=-1)
    tok = lp.gather(-1, seq[:, 1:, None])[..., 0].cpu().numpy()
    live = ((np.arange(tok.shape[1])[None] >= 2)
            & (np.arange(tok.shape[1])[None] < out8.lengths[:, None] - 1))
    plain = (tok * live).sum(-1) / live.sum(-1)
    diff = float(np.abs(avg - plain).max())
    log(f"  score_sequences B={BATCH}: {np.round(avg, 4).tolist()}; against the plain "
        f"projection max |diff| {diff:.3e} (held <= 1e-3); the loop's avg_logprobs (processed "
        f"log-probs, timestamp rules on) {np.round(out8.avg_logprobs, 4).tolist()} (printed)")
    require(avg.shape == (BATCH,) and np.isfinite(avg).all() and diff <= 1e-3,
            "score_sequences against its plain version")

    # 75 s longform, B=1.
    wave = waveforms((CAPTURE_LONG_SECS,))[0]
    feats = log_mel_spectrogram(torch.from_numpy(wave).cuda()[None])
    # The mask bounds each window's DTW to the audio (the last window is padded).
    kw = dict(language="en", max_new_tokens=CAPTURE_NEW_TOKENS, return_timestamps=True,
              attention_mask=np.ones((1, feats.shape[-1]), np.int32))
    ref = cmodel.generate(feats, **kw)
    out, wall = drive("capture longform 75 s B=1", kernels, lambda: cmodel.generate(
        feats, return_scores="full", word_timestamps=True, tokenizer=_PseudoWords(),
        alignment_heads=CAPTURE_ALIGN, return_token_timestamps=True, **kw),
        ("attention", "logits", "megastep"))
    n = int(out.lengths[0])
    log(f"capture longform 75 s B=1: {wall * 1e3:.1f} ms wall, {n} tokens, {len(out.words[0])} "
        f"words, last word {out.words[0][-1] if out.words[0] else None}")
    require(np.array_equal(out.sequences, ref.sequences),
            "capture longform: tokens differ from the request without captures")
    require(out.scores.shape == (1, out.sequences.shape[1], model.config.dims.vocab_size)
            and not out.scores[0, n:].any(), "capture longform: score rows")
    got = out.scores[0, np.arange(n), out.sequences[0, :n]]
    ldiff = float(np.abs(got - out.token_logprobs[0, :n]).max())
    log(f"  capture longform: gathered score rows vs token log-probs max |diff| {ldiff:.4e} "
        f"(held <= {SCORE_TOL})")
    require(ldiff <= SCORE_TOL, "capture longform: score rows against the loop")
    check_times("capture longform 75 s B=1", cmodel, out, CAPTURE_LONG_SECS, 0)
    require(any(sg.get("words") for sg in out.segments[0]), "capture longform: segment words")
    del cmodel, cqmodel


TINY_D = 384
TINY_ROWS = ("ffn_decode d384", "head_rows d384", "verify d384", "megastep d384",
             "megastep_int8 d384", "megastep_block d384")
NEEDS_TINY = {
    "bf16 medusa B=1": ("attention", "megastep d384", "logits", "head_rows d384",
                        "verify d384"),
    "bf16 vanilla B=1": ("attention", "megastep d384", "logits", "verify_rows"),
    f"bf16 medusa B={BATCH}": ("attention", "megastep d384", "logits", "head_rows d384",
                               "verify_rows"),
    "int8 medusa B=1": ("attention", "megastep_int8 d384", "qmm_nt", "head_rows_int8",
                        "verify_hidden_int8"),
    "bf16 medusa_block B=1": ("attention", "megastep_block d384", "logits",
                              "verify_hidden_id0"),
}
# The per-op step's kernels: none at B <= 8 on whisper tiny now that K2 takes it.
PER_OP_ROWS = ("self_decode", "cross_decode", "cross_decode_int8", "ffn_decode")


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
    phase 4 with K2 in the request's mode launching and the per-op step's
    kernels (K10, its mask mode, K11) at 0 (K2 serves d_model 384 at
    B <= 8); then speculative_generate at B=8 gives every example its B=1
    tokens."""
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
                          NEEDS_TINY[path], absent=PER_OP_ROWS)
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
# Phase 6b: f32 serving (the JAX package's default dtype)
# ---------------------------------------------------------------------------

# Every f32 mode is held to its plain version elementwise within
# F32_TOL + F32_TOL |x| (f32 sums in another order), and K4 / K5's argmax on
# the rows whose plain top-2 gap exceeds F32_TOL (_stats_ok's rule).
F32_TOL = 1e-4
F32_NEW_TOKENS = 48
F32_ROWS = ("attention f32", "logits f32", "verify_hidden f32", "head_rows f32",
            "verify_rows f32", "cross_decode f32", "self_decode f32", "ffn_decode f32",
            "gemm f32")
# K1's f32 mode at the paths' shapes: the encoder at B=1 and B=8, the
# capture pass's T = 67 causal and T x 1500, training's 224^2 causal, and off
# the paths a ragged kv_len.
K1_F32 = (((1, 20, 1500, 1500), 1500, False), ((8, 20, 1500, 1500), 1500, False),
          ((1, 20, CAPTURE_T, CAPTURE_T), CAPTURE_T, True),
          ((1, 20, CAPTURE_T, 1500), 1500, False), ((2, 20, 224, 224), 224, True),
          ((1, 4, 300, 300), 257, False))


def f32_model(preset="large-v2"):
    """An f32 model (param and compute dtype float32, as ModelConfig's
    defaults), random weights from SEED, 10 base_head heads with N(0, 0.02)
    weights from a generator of their own."""
    from whisper_medusa_tpu_torch.config import WHISPER_PRESETS, MedusaConfig, ModelConfig
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel

    dims = WHISPER_PRESETS[preset]
    cfg = ModelConfig(dims=dims, medusa=MedusaConfig(medusa_hidden_size=dims.d_model))
    require(cfg.param_dtype == cfg.compute_dtype == "float32", "ModelConfig's default dtype")
    model = WhisperMedusaModel.from_random(cfg, seed=SEED)
    hg = torch.Generator(device="cuda")
    hg.manual_seed(SEED + 1)
    model.params["medusa"]["heads"]["w"].normal_(0.0, 0.02, generator=hg)
    return model


def _f32(g, *shape, scale=1.0):
    return torch.randn(shape, generator=g, device="cuda") * scale


def _f32_ok(what, got, ref):
    err = max_err(got, ref)
    log(f"{what}: max_abs_err {err:.3e}")
    require(got.shape == ref.shape and close(got, ref, F32_TOL), f"{what}: err {err}")
    return err


def check_f32_attention(g):
    """K1's f32 mode against attention_plain and attention_lse_plain at
    K1_F32; every example of the B=8 call bitwise its B=1 call; timed at
    the B=1 encoder's shape beside the plain version and SDPA on the same
    f32 inputs."""
    from whisper_medusa_tpu_torch.ops import attention as A

    worst, timed = 0.0, None
    for (b, h, sq, skv), kv, causal in K1_F32:
        q, k, v = _f32(g, b, h, sq, 64, scale=0.125), _f32(g, b, h, skv, 64), _f32(g, b, h, skv, 64)
        out, lse = A.attention_kernel(q, k, v, kv, causal, return_lse=True)
        what = f"K1 f32 ({b},{h},{sq},{skv}) kv_len {kv} causal {causal}"
        worst = max(worst, _f32_ok(what, out, A.attention_plain(q, k, v, kv, causal)))
        _f32_ok(what + " log-sum-exp", lse, A.attention_lse_plain(q, k, kv, causal))
        if b == 8:
            same = [torch.equal(out[i:i + 1], A.attention_kernel(
                q[i:i + 1].contiguous(), k[i:i + 1].contiguous(), v[i:i + 1].contiguous(), kv,
                causal)) for i in range(b)]
            log(f"{what}: each example bitwise its B=1 output: {sum(same)}/{b}")
            require(all(same), f"{what}: a B=1 call differs from its row of the B=8 call")
        if timed is None:
            timed = (q, k, v, kv, causal)
    q, k, v, kv, causal = timed
    b, h, sq, _ = q.shape
    kern = lambda: A.attention_kernel(q, k, v, kv, causal)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0)
    ms, plain_ms, lib_ms = (cuda_ms(kern), cuda_ms(lambda: A.attention_plain(q, k, v, kv, causal)),
                            cuda_ms(sdpa))
    nb, ops = _attention_cost(b, h, sq, kv, causal)
    bd = bound(2 * nb, ops, F32_FLOPS)
    log(f"K1 f32 ({b},{h},{sq},{kv}): device {device_ms(kern):.4f} ms; SDPA f32 device "
        f"{device_ms(sdpa):.4f} ms; {SMI}")
    # The yardstick's backend, read from its kernels' names, and its error:
    # an f32 SDPA within F32_TOL of the plain version ran in f32, not TF32.
    names = sorted(_kernel_ms(sdpa, 1))
    backend = ("efficient attention (CUTLASS fmha)" if any("fmha" in n for n in names) else
               "flash attention" if any("flash" in n for n in names) else "math (aten ops)")
    sdpa_err = max_err(sdpa(), A.attention_plain(q, k, v, kv, causal))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    log(f"K1 f32 yardstick: SDPA f32 served by {backend} ({', '.join(names)}), max_abs_err "
        f"{sdpa_err:.3e} against attention_plain (TF32 matmul {tf32[0]}, cuDNN TF32 "
        f"{tf32[1]})")
    require(close(sdpa(), A.attention_plain(q, k, v, kv, causal), F32_TOL),
            f"K1 f32 yardstick: SDPA off the plain version by {sdpa_err}")
    return kernel_record("attention f32", K1_SOURCE, K1_REPLACES, (A, "f32_launches"), worst,
                         ms, plain_ms, bd, lib_ms)


def check_f32_logits(g, embed):
    """K3's f32 mode against project_plain at M = 1, 10, 80, 121, 300 (the
    stream's plan printed for each); the first 10 rows of the M=80 call
    bitwise an M=10 call; timed at M = 10 (the B=1 drafts) beside x @ E.T,
    M = 80 printed."""
    from whisper_medusa_tpu_torch.ops import logits as LG

    worst, xs = 0.0, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (1, 10, 80, 121, 300):
        plan = LG.f32_stream_plan(m, embed.shape[0], embed.shape[1], sms)
        log(f"K3 f32 M={m}: {plan['passes']} pass(es) of {plan['rows']} rows (TR "
            f"{plan['tr']}), {plan['items']} items over {plan['grid']} CTAs, "
            f"{plan['stages']} ring stages of {plan['stage']} bytes")
        x = _f32(g, m, embed.shape[1])
        worst = max(worst, _f32_ok(f"K3 f32 M={m}", LG.project_kernel(x, embed),
                                   LG.project_plain(x, embed)))
        xs[m] = x
    same = torch.equal(LG.project_kernel(xs[80][:10].contiguous(), embed),
                       LG.project_kernel(xs[80], embed)[:10])
    log(f"K3 f32: the first 10 rows of the M=80 call bitwise an M=10 call: {same}")
    require(same, "K3 f32: a row's bits depend on M")
    v, d = embed.shape
    for m in (10, 80):
        x = xs[m]
        kern = lambda: LG.project_kernel(x, embed)
        lib = lambda: x @ embed.T
        bd = bound(nbytes(x, embed) + m * v * 4, 2 * m * v * d, F32_FLOPS)
        log(f"K3 f32 M={m}: kernel {cuda_ms(kern):.4f} ms, device {device_ms(kern):.4f} ms; "
            f"x @ E.T {cuda_ms(lib):.4f} ms, device {device_ms(lib):.4f} ms; bound "
            f"{bd[0]:.4f} ms ({bd[1]}); {SMI}")
    x = xs[10]
    return kernel_record("logits f32", "whisper_medusa_tpu_torch/csrc/logits.cu",
                         "whisper_medusa_tpu/ops/logits.py:55", (LG, "f32_launches"), worst,
                         cuda_ms(lambda: LG.project_kernel(x, embed)),
                         cuda_ms(lambda: LG.project_plain(x, embed)),
                         bound(nbytes(x, embed) + 10 * v * 4, 2 * 10 * v * d, F32_FLOPS),
                         cuda_ms(lambda: x @ embed.T))


def _f32_stats_ok(what, rows, embed, pos, masks, kw, got, ref, ts=None):
    """K4 / K5 statistics: argmax equal on the rows whose plain top-2 gap
    exceeds F32_TOL, max / lse / gathered within F32_TOL + F32_TOL |x|."""
    if ts is None:
        arg_ok, n_clear = _clear_argmax(rows, embed, pos, masks, kw, got[0], ref[0], F32_TOL)
        forced = ""
    else:
        arg_ok, n_clear, n_forced = _ts_clear(rows, embed, pos, masks, kw, ts, got[0], ref[0],
                                              F32_TOL)
        forced = f", {n_forced} forced rows"
    err = max(max_err(a, b) for a, b in zip(got[1:], ref[1:]))
    ok = all(close(a, b, F32_TOL) for a, b in zip(got[1:], ref[1:]))
    log(f"{what}: argmax equal on {n_clear} clear rows: {arg_ok}{forced}; max/lse/gathered "
        f"max_abs_err {err:.3e}")
    require(arg_ok and ok, f"{what}: argmax {arg_ok}, err {err}")
    return err


def _f32_mode(model):
    """(row-name suffix, counter prefix) of the f32 checks: "f32" on f32
    weights, "w8a32" on the int8 copy of an f32 model."""
    return ("w8a32", "w8a32_") if _int8(model) else ("f32", "f32_")


def check_f32_verify(g, model):
    """K4's f32 mode (W8A32 on the int8 copy: int8 heads and embedding) at
    R = 121 (11 heads x 11 nodes; and identity0 rows, 10 heads + the hidden
    rows) against verify_hidden_plain, and in the timestamp mode (n_verif
    11); its statistics bitwise K5's over head_rows' rows (stage A is the
    same GEMM launch); timed beside the plain version."""
    from whisper_medusa_tpu_torch.ops import qmm as QM
    from whisper_medusa_tpu_torch.ops import verify as VF

    mode, prefix = _f32_mode(model)
    hw, hb = _head_weights(model)
    d, n_nodes = model.config.dims.d_model, 11
    worst, timed = 0.0, None
    for identity0 in (False, True):
        nh = hb.shape[0] - identity0
        w, b = QM.wmap(hw, lambda a: a[identity0:]), hb[identity0:]
        r = (nh + identity0) * n_nodes
        embed, masks, pos, gcol, kw = _verify_inputs(g, model, r)
        pos = (5 + torch.arange(n_nodes, device="cuda")[None, :]
               + torch.arange(nh + identity0, device="cuda")[:, None]).reshape(-1).to(torch.int32)
        hid = _f32(g, 1, n_nodes, d)
        src = _f32(g, 1, n_nodes, d) if identity0 else hid
        rows = VF.build_rows(hid, src, w, b, identity0)
        for ts in (None, _ts_operands(model, r, n_nodes)):
            kw4 = dict(identity0=identity0, **kw, **(_ts_kw(ts) if ts else {}))
            got = VF.verify_hidden(hid, src, w, b, embed, pos, gcol, masks, **kw4)
            ref = VF.verify_hidden_plain(hid, src, w, b, embed, pos, gcol, masks,
                                         identity0=identity0, ts=ts, **kw)
            what = (f"K4 {mode} R={r}" + (" identity0" if identity0 else "")
                    + (" timestamp mode" if ts else ""))
            worst = max(worst, _f32_stats_ok(what, rows, embed, pos, masks, kw, got, ref, ts))
            flat = VF.head_rows_kernel(src.reshape(n_nodes, d), w, b).reshape(-1, d)
            if identity0:
                flat = torch.cat([hid.reshape(n_nodes, d), flat])
            k5 = VF.verify_rows(flat, embed, pos, gcol, masks, **kw, **(_ts_kw(ts) if ts else {}))
            same = all(torch.equal(a, c) for a, c in zip(got, k5))
            log(f"{what}: statistics bitwise those of K5 over head_rows' rows: {same}")
            require(same, f"{what}: stage A's rows differ from head_rows'")
        if timed is None:
            timed = (hid, w, b, embed, pos, gcol, masks, kw, r, nh)
    hid, w, b, embed, pos, gcol, masks, kw, r, nh = timed
    kern = lambda: VF.verify_hidden_kernel(hid, hid, w, b, embed, pos, gcol, masks,
                                           identity0=False, **kw)
    plain = lambda: VF.verify_hidden_plain(hid, hid, w, b, embed, pos, gcol, masks,
                                           identity0=False, **kw)
    v = model.config.dims.vocab_size
    bd = bound(nbytes(hid, *_tensors(w), b, *_tensors(embed), pos, gcol, masks) + 4 * r * 4,
               2 * r * v * d + 2 * nh * n_nodes * d * d, F32_FLOPS)
    by_kernel = _kernel_ms(kern)
    log(f"K4 {mode} R={r}: device {sum(by_kernel.values()):.4f} ms by kernel "
        + ", ".join(f"{k} {t:.4f}" for k, t in by_kernel.items()) + f"; {SMI}")
    return kernel_record(f"verify_hidden {mode}", "whisper_medusa_tpu_torch/csrc/verify.cu",
                         "whisper_medusa_tpu/ops/verify.py:309", (VF, f"{prefix}launches"),
                         worst, cuda_ms(kern), cuda_ms(plain), bd, None)


def check_f32_head_rows(g, model):
    """wm_head_rows' f32 mode (the f32 GEMM over the heads) against
    head_rows_plain at the loop's shapes (head 0 x 88 and 176, the drafts x 8
    and 1, every head x 11, head 0 x 300); head 0 of a 1-head M=88 launch
    bitwise an 11-head M=11 launch's, M=88's first 8 rows bitwise M=8's;
    timed at head 0 x 88 (B=8's pass A) beside the baddbmm / silu / add
    yardstick (on the dequantized heads for int8 ones); the W8A32 mode on
    the int8 copy."""
    from whisper_medusa_tpu_torch.ops import qmm as QM
    from whisper_medusa_tpu_torch.ops import verify as VF

    mode, prefix = _f32_mode(model)
    w, b = _head_weights(model)
    sl = lambda lo, hi: QM.wmap(w, lambda a: a[lo:hi])
    d = model.config.dims.d_model
    worst, timed = 0.0, None
    for m, lo, hi in ((88, 0, 1), (8, 1, None), (1, 1, None), (176, 0, 1), (11, 0, None),
                      (300, 0, 1)):
        src = _f32(g, m, d)
        got = VF.head_rows_kernel(src, sl(lo, hi), b[lo:hi])
        worst = max(worst, _f32_ok(f"head_rows {mode} M={m} heads={b[lo:hi].shape[0]}", got,
                                   VF.head_rows_plain(src, sl(lo, hi), b[lo:hi])))
        if timed is None:
            timed = (src, got)
    src, got = timed
    one = VF.head_rows_kernel(src, sl(0, 1), b[:1])[0]
    checks = {"head 0, 1-head M=88 vs 11-head M=11":
              torch.equal(one[:11], VF.head_rows_kernel(src[:11].contiguous(), w, b)[0]),
              "every head, M=88's first 8 rows vs M=8":
              torch.equal(VF.head_rows_kernel(src, w, b)[:, :8],
                          VF.head_rows_kernel(src[:8].contiguous(), w, b))}
    for what, ok in checks.items():
        log(f"head_rows {mode} bitwise, {what}: {ok}")
        require(ok, f"head_rows {mode}: {what} differ")
    kern = lambda: VF.head_rows_kernel(src, sl(0, 1), b[:1])
    bd = bound(nbytes(src, *_tensors(sl(0, 1)), b[:1], got), 2 * 88 * d * d, F32_FLOPS)
    w0 = sl(0, 1)
    w0 = w0["q"].float() * w0["s"][:, None, :] if QM.is_quantized(w0) else w0
    log(f"head_rows {mode} head 0 x 88: device {_cold_ms(kern):.4f} ms, L2 flushed; baddbmm / "
        f"silu / add {_cold_ms(lambda: _head_yardstick(src, w0, b[:1])):.4f} ms; bound "
        f"{bd[0]:.4f} ms ({bd[1]}); {SMI}")
    return kernel_record(f"head_rows {mode}", "whisper_medusa_tpu_torch/csrc/verify.cu",
                         "whisper_medusa_tpu/ops/verify.py:309", (VF, f"{prefix}head_launches"),
                         worst, cuda_ms(kern),
                         cuda_ms(lambda: VF.head_rows_plain(src, sl(0, 1), b[:1])), bd, None)


def check_f32_verify_rows(g, model, sizes=(1, 8, 88, 176, 1024)):
    """K5's f32 mode (W8A32 on the int8 copy: an int8 embedding) at R in
    ``sizes`` against verify_rows_plain, and in the timestamp mode at R = 88
    (n_verif 88); a row's statistics independent of R (R = 88's first 8
    rows bitwise R = 8's, R = 1024's first 88 bitwise R = 88's); timed at
    R = 88 (B=8's pass A) beside the product's yardsticks on the same rows,
    K3 f32 and f32 x @ E.T (on the dequantized copy at W8A32)."""
    from whisper_medusa_tpu_torch.ops import logits as LG
    from whisper_medusa_tpu_torch.ops import verify as VF

    mode, prefix = _f32_mode(model)
    d, v = model.config.dims.d_model, model.config.dims.vocab_size
    worst, timed = 0.0, None
    for r in sizes:
        embed, masks, pos, gcol, kw = _verify_inputs(g, model, r)
        hs = _f32(g, r, d)
        for ts in (None, _ts_operands(model, r, r)) if r == 88 else (None,):
            extra = _ts_kw(ts) if ts else {}
            got = VF.verify_rows(hs, embed, pos, gcol, masks, **kw, **extra)
            ref = VF.verify_rows_plain(hs, embed, pos, gcol, masks, ts=ts, **kw)
            what = f"K5 {mode} R={r}" + (" timestamp mode" if ts else "")
            worst = max(worst, _f32_stats_ok(what, hs, embed, pos, masks, kw, got, ref, ts))
        if r == 88:
            timed = (hs, embed, pos, gcol, masks, kw)
    embed, masks, pos, gcol, kw = _verify_inputs(g, model, 1024)
    hs = _f32(g, 1024, d)
    stats = {n: VF.verify_rows(hs[:n], embed, pos[:n], gcol[:n], masks, **kw)
             for n in (1024, 88, 8)}
    for n, big in ((8, 88), (88, 1024)):
        same = all(torch.equal(a, b[:n]) for a, b in zip(stats[n], stats[big]))
        log(f"K5 {mode}: the first {n} rows of an R={big} call bitwise an R={n} call: {same}")
        require(same, f"K5 {mode}: a row's statistics depend on R ({n} of {big})")
    hs, embed, pos, gcol, masks, kw = timed
    kern = lambda: VF.verify_rows_kernel(hs, embed, pos, gcol, masks, **kw)
    r = hs.shape[0]
    bd = bound(nbytes(hs, *_tensors(embed), pos, gcol, masks) + 4 * r * 4, 2 * r * v * d,
               F32_FLOPS)
    e32 = embed["q"].float() * embed["s"][:, None] if isinstance(embed, dict) else embed
    log(f"K5 {mode} R={r}: device {device_ms(kern):.4f} ms; the product's yardsticks on "
        f"the same rows: K3 f32 {device_ms(lambda: LG.project_kernel(hs, e32)):.4f} ms, f32 "
        f"x @ E.T {device_ms(lambda: hs @ e32.T):.4f} ms (TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32}); bound {bd[0]:.4f} ms ({bd[1]}); {SMI}")
    del e32
    return kernel_record(f"verify_rows {mode}", "whisper_medusa_tpu_torch/csrc/verify.cu",
                         "whisper_medusa_tpu/ops/verify.py:183", (VF, f"{prefix}rows_launches"),
                         worst, cuda_ms(kern),
                         cuda_ms(lambda: VF.verify_rows_plain(hs, embed, pos, gcol, masks, **kw)),
                         bd, None)


def check_f32_cross_decode(g, int8=False):
    """K10's f32 mode (``int8``: its W8A32 mode, f32 queries on int8 K/V
    with f32 (B, H, S) scales) against its plain version at CROSS_OFF +
    CROSS_PATH; every example of the (16, 20, 11, 64) call bitwise its B=1
    call; timed there beside f32 SDPA on K and V (dequantized) re-laid
    head-major."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    mode = "w8a32" if int8 else "f32"
    worst, timed = 0.0, None
    for b, t, s, kv in CROSS_OFF + CROSS_PATH:
        q = _f32(g, b, 20, t, 64, scale=0.125)
        if int8:
            i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device="cuda",
                                              dtype=torch.int8)
            scl = lambda: 0.004 + 0.012 * torch.rand((b, 20, s), generator=g, device="cuda")
            k, v, sc = i8(b, 20, 64, s), i8(b, s, 1280), (scl(), scl())
        else:
            k, v, sc = _f32(g, b, 20, 64, s), _f32(g, b, s, 1280), ()
        got = DO.cross_attention_decode_kernel(q, k, v, kv, *sc)
        what = f"K10 {mode} ({b},20,{t},64) x {s} kv_len {kv}"
        worst = max(worst, _f32_ok(what, got, DO.cross_attention_decode_plain(q, k, v, kv, *sc)))
        if b == 16:
            one = lambda a, i: a[i:i + 1].contiguous()
            same = [torch.equal(got[i:i + 1], DO.cross_attention_decode_kernel(
                one(q, i), one(k, i), one(v, i), kv, *(one(a, i) for a in sc)))
                for i in range(b)]
            log(f"{what}: each example bitwise its B=1 output: {sum(same)}/{b}")
            require(all(same), f"{what}: a B=1 call differs from its row of the B={b} call")
            if t == 11:
                timed = (q, k, v, sc)
            else:
                one_row = lambda: DO.cross_attention_decode_kernel(q, k, v, kv, *sc)
                log(f"K10 {mode} (16,20,1,64) x 1500 (T = 1: one query row computed): device "
                    f"{device_ms(one_row):.4f} ms; {SMI}")
    q, k, v, sc = timed
    b, h, t, _ = q.shape
    kern = lambda: DO.cross_attention_decode_kernel(q, k, v, 1500, *sc)
    kd = k.float() * sc[0][:, :, None, :] if int8 else k
    vd = v.float().reshape(b, -1, h, 64).transpose(1, 2)
    vd = vd * sc[1][..., None] if int8 else vd
    kh, vh = kd.transpose(2, 3).contiguous(), vd.contiguous()
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, kh, vh, scale=1.0)
    log(f"K10 {mode} (16,20,11,64) x 1500: device {device_ms(kern):.4f} ms; SDPA f32"
        + (" on the dequantized K/V" if int8 else "") + f" device {device_ms(sdpa):.4f} ms; "
        f"{SMI}")
    return kernel_record(f"cross_decode {mode}", DECODE_OPS_SOURCE,
                         "tools/decode_kernels_experiment.py:48",
                         (DO, "w8a32_cross_launches" if int8 else "f32_cross_launches"),
                         worst, cuda_ms(kern),
                         cuda_ms(lambda: DO.cross_attention_decode_plain(q, k, v, 1500, *sc)),
                         bound(nbytes(q, k, v, *sc, q), 4 * b * h * t * 1500 * 64, F32_FLOPS),
                         cuda_ms(sdpa))


def check_f32_self_decode(g):
    """K10's f32 mask mode against self_attention_decode_plain at
    SELF_SHAPES (max_len 460); every example of each call, and of a B=8
    call, bitwise its B=1 call; timed at large-v2's (16, 11) beside SDPA
    with the step's mask."""
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    worst, row = 0.0, None
    for name, b, t, h, chunk in SELF_SHAPES:
        q = _f32(g, b, t, h, 64, scale=0.125)
        k, v = _f32(g, b, SELF_MAX_LEN, h * 64), _f32(g, b, SELF_MAX_LEN, h * 64)
        off = torch.linspace(3, 400, b, device="cuda").round().to(torch.int32)
        cm = tree_mask(t) if chunk == "tree" else None
        bits = DO.chunk_bits(cm, t, "cuda")
        got = DO.self_attention_decode_kernel(q, k, v, off, bits)
        what = f"K10 f32 mask mode {name} (B={b}, T={t}, H={h}) x {SELF_MAX_LEN}, {chunk}"
        worst = max(worst, _f32_ok(what, got, DO.self_attention_decode_plain(q, k, v, off, cm)))
        one = lambda a, i: a[i:i + 1].contiguous()
        same = [torch.equal(got[i:i + 1], DO.self_attention_decode_kernel(
            one(q, i), one(k, i), one(v, i), one(off, i), bits)) for i in range(b)]
        log(f"{what}: each example bitwise its B=1 output: {sum(same)}/{b}")
        require(all(same), f"{what}: a B=1 call differs from its row of the B={b} call")
        if name == "large-v2 vanilla":
            one_row = lambda: DO.self_attention_decode_kernel(q, k, v, off, bits)
            log(f"{what} (T = 1: one query row computed): device {device_ms(one_row):.4f} ms; "
                f"{SMI}")
        if name != "large-v2":
            continue
        kern = lambda: DO.self_attention_decode_kernel(q, k, v, off, bits)
        mask = whisper.make_step_mask(off, t, SELF_MAX_LEN, cm)
        qh = q.transpose(1, 2).contiguous()
        kh = k.reshape(b, -1, h, 64).transpose(1, 2).contiguous()
        vh = v.reshape(b, -1, h, 64).transpose(1, 2).contiguous()
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=1.0)
        keys = int((off.long() + t).sum())
        log(f"{what}: device {device_ms(kern):.4f} ms; SDPA f32 with the mask device "
            f"{device_ms(lib):.4f} ms; {SMI}")
        row = (cuda_ms(kern), cuda_ms(lambda: DO.self_attention_decode_plain(q, k, v, off, cm)),
               bound(nbytes(q) * 2 + 2 * keys * h * 64 * 4 + nbytes(off, bits),
                     4 * h * t * keys * 64, F32_FLOPS), cuda_ms(lib))
    return kernel_record("self_decode f32", DECODE_OPS_SOURCE,
                         "tools/decode_kernels_experiment.py:48", (DO, "f32_self_launches"),
                         worst, *row)


def check_f32_ffn_decode(g, d=1280, f=5120):
    """K11's f32 mode against ffn_decode_plain at M = 176, 16, 11, 1 and
    300; the first 11 rows of the M=176 call bitwise an M=11 call; timed at
    M = 11 (the B=1 chain) and 176 beside addmm / gelu / addmm."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    w1, b1, w2, b2 = (_f32(g, d, f, scale=0.02), _f32(g, f, scale=0.02),
                      _f32(g, f, d, scale=0.02), _f32(g, d, scale=0.02))
    worst, xs = 0.0, {}
    for m in (176, 16, 11, 1, 300):
        x = _f32(g, m, d)
        y = DO.ffn_decode_kernel(x, w1, b1, w2, b2)
        worst = max(worst, _f32_ok(f"K11 f32 M={m} D={d} F={f}", y,
                                   DO.ffn_decode_plain(x, w1, b1, w2, b2)))
        xs[m] = (x, y)
    same = torch.equal(xs[176][1][:11],
                       DO.ffn_decode_kernel(xs[176][0][:11].contiguous(), w1, b1, w2, b2))
    log(f"K11 f32: the first 11 rows of the M=176 call bitwise an M=11 call: {same}")
    require(same, "K11 f32: M=176 rows differ from an M=11 call")
    gelu = torch.nn.functional.gelu
    for m in (11, 176):
        xm = xs[m][0]
        kern = lambda: DO.ffn_decode_kernel(xm, w1, b1, w2, b2)
        three = lambda: torch.addmm(b2, gelu(torch.addmm(b1, xm, w1)), w2)
        bd = bound(nbytes(xm, w1, b1, w2, b2) + m * d * 4, 4 * m * d * f, F32_FLOPS)
        log(f"K11 f32 M={m}: kernel {cuda_ms(kern):.4f} ms, device {device_ms(kern):.4f} ms; "
            f"addmm / gelu / addmm {cuda_ms(three):.4f} ms, device {device_ms(three):.4f} ms; "
            f"bound {bd[0]:.4f} ms ({bd[1]}); {SMI}")
    x = xs[11][0]
    return kernel_record("ffn_decode f32", DECODE_OPS_SOURCE,
                         "tools/decode_kernels_experiment.py:110", (DO, "f32_ffn_launches"),
                         worst, cuda_ms(lambda: DO.ffn_decode_kernel(x, w1, b1, w2, b2)),
                         cuda_ms(lambda: DO.ffn_decode_plain(x, w1, b1, w2, b2)),
                         bound(nbytes(x, w1, b1, w2, b2) + 11 * d * 4, 4 * 11 * d * f,
                               F32_FLOPS), None)


# The f32 GEMM alone at the per-op step's shapes: (M, K, N), M the step's
# rows at B = 1 vanilla and Medusa, B = 8 and B = 16, the bias on.
GEMM_F32_ROWS = (1, 11, 88, 176)
GEMM_F32_SHAPES = ((1280, 1280), (1280, 5120), (5120, 1280))
GEMM_F32_SOURCE = "whisper_medusa_tpu_torch/csrc/ffma_gemm.cuh"


def check_f32_gemm(g):
    """The f32 GEMM alone (``decode_ops.gemm_f32``, the per-op step's f32
    projections; also K11's and the head rows' f32 products) against
    ``whisper.dense``'s plain f32 product (cuBLAS f32, TF32 off) within
    F32_TOL + F32_TOL |x| at GEMM_F32_ROWS x GEMM_F32_SHAPES; the first 11
    rows of each M=176 call bitwise an M=11 call; each shape's device time
    beside ``torch.addmm`` in f32.  Its kernels row is timed at M = 11
    through 1280 x 1280 (a decode step's projection at B = 1)."""
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    require(not torch.backends.cuda.matmul.allow_tf32, "the f32 GEMM's yardstick in f32")
    worst, timed = 0.0, None
    for k, n in GEMM_F32_SHAPES:
        w, b = _f32(g, k, n, scale=0.02), _f32(g, n, scale=0.02)
        xs = {}
        for m in GEMM_F32_ROWS:
            x = _f32(g, m, k)
            y = DO.gemm_f32(x, w, b)
            worst = max(worst, _f32_ok(f"gemm f32 M={m} {k}x{n}", y, whisper.dense(x, w, b)))
            xs[m] = (x, y)
            kern = lambda: DO.gemm_f32(x, w, b)
            lib = lambda: torch.addmm(b, x, w)
            bd = bound(nbytes(x, w, b, y), 2 * m * k * n, F32_FLOPS)
            log(f"gemm f32 M={m} {k}x{n}: device {device_ms(kern):.4f} ms, addmm f32 device "
                f"{device_ms(lib):.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}); {SMI}")
            if (m, k, n) == (11, 1280, 1280):
                timed = (x, w, b, y)
        same = torch.equal(xs[176][1][:11], DO.gemm_f32(xs[176][0][:11].contiguous(), w, b))
        log(f"gemm f32 {k}x{n}: the first 11 rows of the M=176 call bitwise an M=11 call: "
            f"{same}")
        require(same, f"gemm f32 {k}x{n}: M=176 rows differ from an M=11 call")
    x, w, b, y = timed
    return kernel_record("gemm f32", GEMM_F32_SOURCE, "tools/decode_kernels_experiment.py:110",
                         (DO, "f32_gemm_launches"), worst, cuda_ms(lambda: DO.gemm_f32(x, w, b)),
                         cuda_ms(lambda: whisper.dense(x, w, b)),
                         bound(nbytes(x, w, b, y), 2 * 11 * 1280 * 1280, F32_FLOPS),
                         cuda_ms(lambda: torch.addmm(b, x, w)))


STEP_F32 = ("self_decode f32", "cross_decode f32", "ffn_decode f32", "gemm f32")
NEEDS_F32 = {
    "medusa B=1": ("attention f32", "logits f32", "head_rows f32", "verify_hidden f32")
    + STEP_F32,
    "vanilla B=1": ("attention f32", "verify_rows f32") + STEP_F32,
    f"medusa B={BATCH}": ("attention f32", "logits f32", "head_rows f32", "verify_rows f32")
    + STEP_F32,
    "medusa_block B=1": ("attention f32", "logits f32", "verify_hidden f32") + STEP_F32,
}


def _cpu_copy(tree):
    return {k: (_cpu_copy(v) if isinstance(v, dict) else v.to("cpu")) for k, v in tree.items()}


def phase_f32_requests(model, kernels, feat, feats8):
    """f32 large-v2 requests on the card through the entry points: Medusa
    B=1 (K4), vanilla B=1, Medusa B=8 (two-pass verification, K5),
    Medusa-Block B=1 and return_timestamps B=1 (K4's timestamp mode), each
    driven with every counter set to 0: the f32 rows of its path must
    launch, and no other row (K2, the bf16 and int8 modes) may; each run
    again under the profiler for its device busy time and idle share; then the
    B=1 Medusa request under draft_corruption=1.0; an identity hook (the
    unfused route), num_beams=2 and return_scores="full" requests at B=1,
    each with only f32 rows launching."""
    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.ops import verify as VF

    bmodel = bridge.random_block_model(model, seed=SEED + 2)
    others = _others(kernels, F32_ROWS)
    vocab = model.config.dims.vocab_size
    kw = dict(language="en", max_new_tokens=F32_NEW_TOKENS)
    runs = {"medusa B=1": (model, feat, {}),
            "vanilla B=1": (model, feat, dict(disable_medusa=True)),
            f"medusa B={BATCH}": (model, feats8, {}),
            "medusa_block B=1": (bmodel, feat, {})}
    outs = {}
    for path, (m, f, extra) in runs.items():
        m.generate(f, language="en", max_new_tokens=8, **extra)       # warm-up
        out, wall = drive(f"f32 {path}", kernels, lambda: m.generate(f, **kw, **extra),
                          NEEDS_F32[path], absent=others)
        report(f"f32 {path} request", out, wall,
               check_output(out, f.shape[0], vocab, F32_NEW_TOKENS))
        dev, tops = device_split(lambda: m.generate(f, **kw, **extra))
        log(f"f32 {path}: device busy {dev:.2f} ms of {wall * 1e3:.1f} ms wall, idle share "
            f"{1 - dev / (wall * 1e3):.3f}, {out.steps} steps; {tops}; {SMI}")
        outs[path] = out
    ts0 = VF.f32_ts_launches
    out, wall = drive("f32 timestamps medusa B=1", kernels,
                      lambda: model.generate(feat, return_timestamps=True, **kw),
                      ("attention f32", "logits f32") + STEP_F32,
                      absent=others + ("verify_hidden f32",))
    require(VF.f32_ts_launches > ts0, "f32 timestamps: K4's f32 timestamp mode never launched")
    check_ts_output(model, out)
    report("f32 timestamps medusa B=1", out, wall, int((out.lengths - 3).sum()))
    check_corruption("f32", model, feat, outs["medusa B=1"], new_tokens=F32_NEW_TOKENS)
    # The other routes generate takes, at B=1: an identity hook (the unfused
    # route: K4 and K5 at 0), beams (K3 on the beams' rows) and the score
    # stack of a vanilla request (the capture pass: K1 causal and T x 1500,
    # K3 on 64-position chunks; vanilla, so that the stack is the loop's
    # distribution).
    verify_rows = ("verify_hidden f32", "verify_rows f32")
    hook = Hook(force=False)
    for name, extra, needs, absent, ref in (
            ("identity hook", dict(logits_processor=hook), ("logits f32", "head_rows f32"),
             verify_rows, "medusa B=1"),
            ("beams K=2", dict(num_beams=2), ("logits f32",), verify_rows, "medusa B=1"),
            ("vanilla score stack", dict(return_scores="full", disable_medusa=True),
             ("logits f32", "verify_rows f32"), (), "vanilla B=1")):
        out, wall = drive(f"f32 {name} B=1", kernels, lambda: model.generate(feat, **kw, **extra),
                          ("attention f32",) + STEP_F32 + needs, absent=others + absent)
        require(out.sequences.shape[0] == 1 and (out.sequences >= 0).all()
                and (out.sequences < vocab).all() and out.steps > 0, f"f32 {name}: output")
        same = np.array_equal(out.sequences, outs[ref].sequences)
        log(f"f32 {name} B=1: {wall * 1e3:.1f} ms, {out.steps} steps, tokens equal to the "
            f"{ref} request's: {same} (printed, not held)")
    require(hook.calls > 0 and hook.devices == {"cuda"},
            f"f32 hook: {hook.calls} calls on {hook.devices}")
    check_score_stack("f32 vanilla B=1", out, PROMPT_LEN)
    del bmodel
    return outs


def check_f32_tiny_against_cpu(feat):
    """An f32 whisper tiny request on the card against the CPU port on the
    same weights and features: tokens equal, or where an example's first
    differing position has a processed top-2 logit gap under F32_TOL of
    the top logit on the CPU (a tie the two devices' sums may break either
    way)."""
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel

    cuda_model = f32_model("tiny")
    cpu_model = WhisperMedusaModel(cuda_model.config, _cpu_copy(cuda_model.params), device="cpu")
    kw = dict(language="en", max_new_tokens=F32_NEW_TOKENS)
    got = cuda_model.generate(feat, **kw)
    ref = cpu_model.generate(feat.cpu(), **kw)
    diffs = []
    for e in range(ref.sequences.shape[0]):
        n = int(min(ref.lengths[e], got.lengths[e]))
        where = np.nonzero(ref.sequences[e, :n] != got.sequences[e, :n])[0]
        if where.size:
            pos = int(where[0])
            enc = cpu_model.encode(feat[e:e + 1].cpu())
            gap, top = _top2_gap(cpu_model, enc, ref.sequences[e], pos, "base_head",
                                 with_top=True)
            diffs.append((e, pos, gap, gap / max(abs(top), 1e-30)))
    log(f"f32 whisper tiny, card vs CPU port: {ref.sequences.shape[0] - len(diffs)}/"
        f"{ref.sequences.shape[0]} examples' tokens equal over {int(ref.lengths.sum())} "
        f"positions; first differing (example, position, CPU top-2 gap, relative): "
        f"{diffs or 'none'}")
    require(all(rel < F32_TOL for *_, rel in diffs),
            f"f32 tiny: tokens differ from the CPU port where the top-2 gap is clear: {diffs}")


# ---------------------------------------------------------------------------
# Phase 6c: the int8 copy of the f32 model (W8A32), on phase 6b's model
# ---------------------------------------------------------------------------

# Every W8A32 mode is held to its plain version elementwise within F32_TOL +
# F32_TOL |x| (f32 sums in another order; each int8 value converted exactly),
# K4 / K5's argmax on the rows whose plain top-2 gap exceeds F32_TOL; the
# self rows K2 commits within one int8 step of the plain version's and
# their bf16 scales within one bf16 ulp (2**-7 relative: a value on a
# rounding boundary may round to the neighbouring step).
W8A32_ROWS = ("megastep w8a32", "megastep_block w8a32", "verify_hidden w8a32",
              "head_rows w8a32", "verify_rows w8a32", "cross_decode w8a32", "gemm w8a32")
# K2 W8A32's launches a layer: three ln_rows_f32_kernel, six GEMMs
# (ffma_gemm_kernel's int8-weight mode, one launch each) and two attentions
# (decode_attn_f32_kernel, one cluster launch each); then ln_post.
W8A32_PER_LAYER = {"ln_rows_f32_kernel": 3, "ffma_gemm_kernel": 6, "decode_attn_f32_kernel": 2}
W8A32_STEPS = ((11, [7]), (11, [7, 0, 120, 33, 448, 5, 260, 90]),
               (1, [0, 17, 100, 5, 300, 440, 2, 63]))
# K2 W8A32's 32-layer cosine against its plain step (pre_norm, hidden and
# block_hidden), every step of check_w8a32_megastep_full.
W8A32_COS_FLOOR = 0.999999


def _w8a32_tree(tree):
    """A random bf16 layer tree (_random_layers) as an f32 tree, its
    streamed weights quantized: the int8 copy of an f32 model's layers."""
    from whisper_medusa_tpu_torch.ops import qmm as QM

    f32 = lambda t: {k: f32(v) if isinstance(v, dict) else v.float() for k, v in t.items()}
    return QM.quantize_layers(f32(tree))


def _w8a32_caches(g, n, b, s_len, d, h, s_enc):
    """Random int8 self slabs with bf16 scales and int8 cross K/V with f32
    scales, n slots."""
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device="cuda",
                                      dtype=torch.int8)
    scl = lambda *shape: 0.004 + 0.012 * torch.rand(shape, generator=g, device="cuda")
    return dict(self_k=i8(n, b, s_len, d), self_v=i8(n, b, s_len, d),
                self_s=scl(n, b, s_len, 2 * h).to(torch.bfloat16),
                cross_k=i8(n, b, h, 64, s_enc), cross_v=i8(n, b, s_enc, d),
                cross_k_s=scl(n, b, h, s_enc), cross_v_s=scl(n, b, h, s_enc))


def _w8a32_rows_ok(what, c, ref, written, h):
    """The self rows a K2 W8A32 call wrote against the plain version's:
    int8 values within one step, bf16 scales within one ulp; every other
    row and scale untouched.  Returns (ok, the largest int8 difference)."""
    steps = max(int((c[k][:, written].int() - ref[k][:, written].int()).abs().max())
                for k in ("self_k", "self_v"))
    s_a, s_b = c["self_s"][:, written].float(), ref["self_s"][:, written].float()
    scales_ok = bool(((s_a - s_b).abs() <= 2.0 ** -7 * s_b.abs()).all())
    untouched = all(torch.equal(c[k][:, ~written], ref[k][:, ~written])
                    for k in ("self_k", "self_v", "self_s"))
    log(f"{what}: written rows within {steps} int8 step(s) of the plain version's, "
        f"scales within a bf16 ulp {scales_ok}, other rows equal {untouched}")
    return steps <= 1 and scales_ok and untouched, steps


def check_w8a32_megastep_2layer(g, t, offs, block=False, dims=None):
    """K2's W8A32 mode, two layers (and the block on slot 2 when
    ``block``), at per-example offsets ``offs``, against the plain version
    (megastep_plain's W8A32 branch; the plain block layer on the kernel's
    own hidden): pre_norm, hidden and block_hidden within F32_TOL +
    F32_TOL |x|, the written rows as _w8a32_rows_ok holds them; at B > 1
    every example bitwise a B=1 call on its own cache rows."""
    from whisper_medusa_tpu_torch.config import WhisperDims
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS

    dims = WhisperDims(decoder_layers=2) if dims is None else dims
    b, d, h, s_enc, s_len = len(offs), dims.d_model, dims.decoder_attention_heads, 1500, 460
    tree, ln_post, _ = _random_layers(g, dims, 2)
    layers, ln_post = _w8a32_tree(tree), {k: v.float() for k, v in ln_post.items()}
    blk = (_w8a32_tree(whisper.layer_params(_random_layers(g, dims, 1)[0], 0))
           if block else None)
    n = 2 + block
    c = _w8a32_caches(g, n, b, s_len, d, h, s_enc)
    x = torch.randn((b, t, d), generator=g, device="cuda")
    offsets = torch.tensor(offs, dtype=torch.int32, device="cuda")
    before = {k: c[k].clone() for k in ("self_k", "self_v", "self_s")}
    ref = {k: v.clone() for k, v in before.items()}
    kw = lambda cc, sl: dict(cross_k_s=c["cross_k_s"][sl], cross_v_s=c["cross_v_s"][sl],
                             self_s=cc["self_s"][sl])
    allsl = slice(None)
    got = MS.megastep_kernel(layers, ln_post, x, c["self_k"], c["self_v"], c["cross_k"],
                             c["cross_v"], offsets, None, s_enc, h, block=blk, **kw(c, allsl))
    two = slice(0, 2)
    pre, hid, _ = MS.megastep_plain(layers, ln_post, x, ref["self_k"][two], ref["self_v"][two],
                                    c["cross_k"][two], c["cross_v"][two], offsets, None, s_enc,
                                    h, **kw(ref, two))
    refs = [pre, hid]
    if block:
        refs.append(MS.w8a32_layer_step(
            blk, got[1], ref["self_k"][2], ref["self_v"][2], c["cross_k"][2], c["cross_v"][2],
            offsets, torch.tril(torch.ones((t, t), dtype=torch.bool, device="cuda")), h,
            s_enc, cross_k_s=c["cross_k_s"][2], cross_v_s=c["cross_v_s"][2],
            self_s=ref["self_s"][2]))
    require(all(a is not None and a.dtype == torch.float32 for a in got[:2])
            and (got[2] is None) != block, "K2 W8A32 outputs")
    err = max(max_err(a, r) for a, r in zip(got, refs))
    ok = all(close(a, r, F32_TOL) for a, r in zip(got, refs))
    written = torch.zeros((b, s_len), dtype=torch.bool, device="cuda")
    for e, off in enumerate(offs):
        written[e, off:off + t] = True
    what = (f"K2 W8A32 {'block mode, 2 layers + block' if block else '2-layer'} D={d} "
            f"B={b} T={t}")
    rows_ok, _ = _w8a32_rows_ok(what, c, ref, written, h)
    same = []
    if b > 1:
        one = lambda a, e: a[:, e:e + 1].contiguous()
        for e in range(b):
            alone = MS.megastep_kernel(
                layers, ln_post, x[e:e + 1], one(before["self_k"], e), one(before["self_v"], e),
                one(c["cross_k"], e), one(c["cross_v"], e), offsets[e:e + 1], None, s_enc, h,
                cross_k_s=one(c["cross_k_s"], e), cross_v_s=one(c["cross_v_s"], e),
                self_s=one(before["self_s"], e), block=blk)
            same.append(all(torch.equal(a[e:e + 1], a1) for a, a1 in zip(got, alone)
                            if a is not None))
    log(f"{what} offsets {offs}: pre_norm/hidden{'/block_hidden' if block else ''} err "
        f"{err:.3e}" + (f"; each example bitwise its B=1 call: {sum(same)}/{b}" if same else ""))
    require(ok and rows_ok and all(same), f"{what}: err {err}, rows {rows_ok}, B=1 {same}")
    return err


def check_w8a32_megastep_full(model, enc1, enc8, block=None, suffix=""):
    """K2's W8A32 mode over the int8 copy's 32 layers (and the block on slot
    32, given ``block``) against its plain step on copies of one cache: at
    B=1 prefill T=4 then the T=11 chain, at B=8 prefill T=4, then T=11 and
    T=1 at per-example offsets; pre_norm, hidden (and block_hidden) cosine
    >= W8A32_COS_FLOOR, the written rows as _w8a32_rows_ok holds them, every
    example of a B=8 call bitwise its B=1 call.  Timed at (1, 11) beside the
    plain step and its bound; returns (kernels row, worst cosine)."""
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS

    name = "megastep" + ("_block" if block is not None else "") + " w8a32" + suffix
    p, dims = model.params["whisper"], model.config.dims
    dec, nh, st = p["decoder"], dims.decoder_attention_heads, model.special
    worst, timed = 1.0, None
    for enc, steps in ((enc1, ((4, [0]), (11, [4]))),
                       (enc8, ((4, [0] * 8), (11, [4, 2, 4, 3, 1, 4, 0, 2]),
                               (1, [15, 9, 13, 14, 5, 11, 2, 7])))):
        b = enc.shape[0]
        cache = whisper.init_cache(p, dims, enc, dims.max_target_positions + 12,
                                   extra_layers=int(block is not None))
        if block is not None:
            whisper.set_block_cross_kv(cache, block, enc, nh)
        for t, offs in steps:
            toks = (torch.tensor([[st.sot, st.first_language, st.transcribe,
                                   st.no_timestamps]] * b) if t == 4 else
                    torch.arange(100, 100 + b * t).reshape(b, t)).to("cuda", torch.int32)
            offsets = torch.tensor(offs, dtype=torch.int32, device="cuda")
            x = _embedded(dec, toks, offsets)
            ref = {"self_k": cache.self_k.clone(), "self_v": cache.self_v.clone(),
                   "self_s": cache.self_s.clone()}
            args = (x, cache.self_k, cache.self_v, cache.cross_k, cache.cross_v, offsets,
                    None, dims.max_source_positions, nh)
            sc = dict(cross_k_s=cache.cross_k_s, cross_v_s=cache.cross_v_s, block=block)
            alone = k2_alone(dec, cache, x, offsets, dims, nh, block) if b > 1 else None
            got = MS.megastep_kernel(dec["layers"], dec["ln_post"], *args, self_s=cache.self_s,
                                     **sc)
            if alone is not None:
                same = [all(torch.equal(a[0], bat[e]) for a, bat in zip(alone[e], got)
                            if bat is not None) for e in range(b)]
                log(f"K2 {name} B={b} T={t}: each example bitwise its B=1 call: "
                    f"{sum(same)}/{b}")
                require(all(same), f"K2 {name} B={b} T={t}: an example's bits depend on B")
            plain = MS.megastep_plain(dec["layers"], dec["ln_post"], x, ref["self_k"],
                                      ref["self_v"], *args[3:], self_s=ref["self_s"], **sc)
            cos = [cosine(a, r) for a, r in zip(got, plain) if r is not None]
            written = torch.zeros(cache.self_k.shape[1:3], dtype=torch.bool, device="cuda")
            for e, off in enumerate(offs):
                written[e, off:off + t] = True
            what = f"K2 {name} {cache.self_k.shape[0]}-slot B={b} T={t} offsets {offs}"
            c = {"self_k": cache.self_k, "self_v": cache.self_v, "self_s": cache.self_s}
            rows_ok, _ = _w8a32_rows_ok(what, c, ref, written, nh)
            log(f"{what}: cosine against the plain step (pre_norm, hidden"
                + (", block_hidden" if block is not None else "") + "): "
                + ", ".join(f"{x:.9f}" for x in cos))
            require(min(cos) >= W8A32_COS_FLOOR and rows_ok,
                    f"{what}: cosine {cos}, rows {rows_ok}")
            worst = min(worst, *cos)
            if (b, t) == (1, 11):
                run = lambda: MS.megastep_kernel(dec["layers"], dec["ln_post"], *args,
                                                 self_s=cache.self_s, **sc)
                cost = _megastep_cost(dec["layers"], dec["ln_post"], cache, offs, t,
                                      dims.max_source_positions, block)
                bd = bound(*cost, F32_FLOPS)
                timed = (cuda_ms(run), cuda_ms(lambda: MS.megastep_plain(
                    dec["layers"], dec["ln_post"], *args, self_s=cache.self_s, **sc)), bd)
                by_kernel = _kernel_ms(run)
                log(f"K2 {name} B=1 T=11: kernel {timed[0]:.4f} ms, device "
                    f"{sum(by_kernel.values()):.4f} ms ("
                    + ", ".join(f"{k} {ms:.4f}" for k, ms in by_kernel.items())
                    + f"), plain {timed[1]:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}; "
                    f"{cost[0] / 1e9:.3f} GB, {cost[1] / 1e9:.1f} GFLOP); {SMI}")
                w8a32_launches_per_layer(name, run, cache.self_k.shape[0])
            for k in ("self_k", "self_v", "self_s"):      # continue from the plain cache
                getattr(cache, k).copy_(ref[k])
        del cache
    counter = "w8a32_block_launches" if block is not None else "w8a32_launches"
    return kernel_record(name, "whisper_medusa_tpu_torch/csrc/megastep.cu",
                         "whisper_medusa_tpu/ops/megastep.py:342", (MS, counter), None,
                         *timed, None), worst


def w8a32_launches_per_layer(name, run, layers):
    """K2 W8A32's launches in one call of ``run`` over ``layers`` layers:
    W8A32_PER_LAYER a layer and one more ln_rows_f32_kernel (ln_post), no
    other kernel of the port (no combine kernel; the wrapper's row buffers
    are PyTorch's)."""
    from whisper_medusa_tpu_torch.device_profile import _by_kernel

    count = collections.Counter()
    for k, (_, n) in _by_kernel(run, 2).items():
        if k.startswith(("ffma_", "decode_", "ln_rows")):
            count[re.split(r"<", k)[0]] += n
    want = {k: n * layers + (k == "ln_rows_f32_kernel") for k, n in W8A32_PER_LAYER.items()}
    per_layer = (sum(count.values()) - 1) / layers
    log(f"K2 {name}: {dict(count)} launches a call over {layers} layers: {per_layer:g} a layer "
        f"(held at {sum(W8A32_PER_LAYER.values())}, every GEMM and attention under "
        f"programmatic dependent launch)")
    require(dict(count) == want, f"K2 {name}: launches {dict(count)}, want {want}")


# The W8A32 GEMM alone at K2 W8A32's projection shapes: M = B T at (1, 1),
# (1, 11) and (8, 11), through 1280 x 1280, 1280 x 5120 and 5120 x 1280.
GEMM_W8_ROWS = (1, 11, 88)


def check_w8a32_gemm(g):
    """The W8A32 GEMM alone (``decode_ops.gemm_w8a32_launch``: the int8 head
    rows' GEMM, K2 W8A32's projections and K4 W8A32's stage A) against
    ``megastep.mm_w8`` (the column's scale on the sum, then the bias) within
    F32_TOL + F32_TOL |x| at GEMM_W8_ROWS x GEMM_F32_SHAPES (seeded N(0,
    0.02) weights quantized as ``qmm.quantize_array`` does); the first 1
    and 11 rows of each M=88 call bitwise M=1 and M=11 calls; each shape's
    device time beside ``torch.addmm`` in f32 on the dequantized copy (TF32
    off) and the f32 GEMM on it.  Its kernels row is timed at M = 11
    through 1280 x 1280 (a decode step's projection at B = 1)."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO
    from whisper_medusa_tpu_torch.ops import megastep as MS
    from whisper_medusa_tpu_torch.ops import qmm as QM

    require(not torch.backends.cuda.matmul.allow_tf32, "the W8A32 GEMM's yardstick in f32")
    worst, timed = 0.0, None
    for k, n in GEMM_F32_SHAPES:
        wq, ws = QM.quantize_array(_f32(g, k, n, scale=0.02))
        wd = wq.float() * ws
        b = _f32(g, n, scale=0.02)
        w = {"q": wq, "s": ws}
        gemm = lambda x: DO.gemm_w8a32_launch(x, wq[None], ws[None], b[None], DO.EPI_BIAS)[0]
        ys = {}
        for m in GEMM_W8_ROWS:
            x = _f32(g, m, k)
            y = gemm(x)
            worst = max(worst, _f32_ok(f"gemm w8a32 M={m} {k}x{n}", y, MS.mm_w8(x, w, b)))
            ys[m] = (x, y)
            kern, lib = lambda: gemm(x), lambda: torch.addmm(b, x, wd)
            bd = bound(nbytes(x, wq, ws, b, y), 2 * m * k * n, F32_FLOPS)
            log(f"gemm w8a32 M={m} {k}x{n}: device {device_ms(kern):.4f} ms, addmm f32 on the "
                f"dequantized copy device {device_ms(lib):.4f} ms, the f32 GEMM on it "
                f"{device_ms(lambda: DO.gemm_f32(x, wd, b)):.4f} ms, bound {bd[0]:.4f} ms "
                f"({bd[1]}); {SMI}")
            if (m, k, n) == (11, 1280, 1280):
                timed = (x, w, b, y, wd)
        for m in GEMM_W8_ROWS[:-1]:
            same = torch.equal(ys[88][1][:m], gemm(ys[88][0][:m].contiguous()))
            log(f"gemm w8a32 {k}x{n}: the first {m} rows of the M=88 call bitwise an M={m} "
                f"call: {same}")
            require(same, f"gemm w8a32 {k}x{n}: M=88 rows differ from an M={m} call")
    x, w, b, y, wd = timed
    return kernel_record("gemm w8a32", GEMM_F32_SOURCE, "whisper_medusa_tpu/ops/megastep.py:342",
                         (DO, "w8a32_gemm_launches"), worst,
                         cuda_ms(lambda: DO.gemm_w8a32_launch(x, w["q"][None], w["s"][None],
                                                              b[None], DO.EPI_BIAS)),
                         cuda_ms(lambda: MS.mm_w8(x, w, b)),
                         bound(nbytes(x, w["q"], w["s"], b, y), 2 * 11 * 1280 * 1280, F32_FLOPS),
                         cuda_ms(lambda: torch.addmm(b, x, wd)))


W8A32_NEW_TOKENS = 48
# The rows each W8A32 request must launch: K1's f32 mode for the f32 encoder,
# K2's W8A32 mode where K2 takes the step (B <= 8), else the per-op step
# (K6 projections and FFN as JAX's qmm, K10's f32 mask mode on the bf16
# slab, K10's W8A32 mode), and the W8A32 vocab side.
NEEDS_W8A32 = {
    "medusa B=1": ("attention f32", "megastep w8a32", "verify_hidden w8a32"),
    "vanilla B=1": ("attention f32", "megastep w8a32", "verify_rows w8a32"),
    f"medusa B={BATCH}": ("attention f32", "megastep w8a32", "head_rows w8a32",
                          "verify_rows w8a32", "gemm w8a32"),
    f"medusa B={BATCH16}": ("attention f32", "self_decode f32", "cross_decode w8a32",
                            "head_rows w8a32", "verify_rows w8a32", "gemm w8a32"),
    "medusa_block B=1": ("attention f32", "megastep_block w8a32", "verify_hidden w8a32"),
}


def phase_w8a32_requests(model, bmodel, kernels, feat, feats8, feats16):
    """W8A32 large-v2 requests through generate, each driven with every
    counter set to 0: Medusa and vanilla at B=1, Medusa at B=8 and B=16 (the
    per-op step), Medusa-Block at B=1 and a return_timestamps request (K4's
    W8A32 timestamp mode); the rows of NEEDS_W8A32 must launch, and none but
    those, K6 / K7 (the int8 projections JAX's qmm and qmm_nt round to bf16)
    and the f32 mask mode of K10; each request's device busy time and idle
    share under the profiler."""
    from whisper_medusa_tpu_torch.ops import qmm as QM
    from whisper_medusa_tpu_torch.ops import verify as VF

    allowed = set(W8A32_ROWS) | {"attention f32", "self_decode f32"} | {
        k["name"] for k in kernels if k["counter"][0] is QM}
    others = _others(kernels, allowed)
    vocab = model.config.dims.vocab_size
    kw = dict(language="en", max_new_tokens=W8A32_NEW_TOKENS)
    runs = {"medusa B=1": (model, feat, {}),
            "vanilla B=1": (model, feat, dict(disable_medusa=True)),
            f"medusa B={BATCH}": (model, feats8, {}),
            f"medusa B={BATCH16}": (model, feats16, {}),
            "medusa_block B=1": (bmodel, feat, {})}
    outs = {}
    for path, (m, f, extra) in runs.items():
        m.generate(f, language="en", max_new_tokens=8, **extra)       # warm-up
        out, wall = drive(f"w8a32 {path}", kernels, lambda: m.generate(f, **kw, **extra),
                          NEEDS_W8A32[path], absent=others)
        report(f"w8a32 {path} request", out, wall,
               check_output(out, f.shape[0], vocab, W8A32_NEW_TOKENS))
        dev, tops = device_split(lambda: m.generate(f, **kw, **extra))
        log(f"w8a32 {path}: device busy {dev:.2f} ms of {wall * 1e3:.1f} ms wall, idle share "
            f"{1 - dev / (wall * 1e3):.3f}, {out.steps} steps; {tops}; {SMI}")
        outs[path] = out
    ts0 = VF.w8a32_ts_launches
    out, wall = drive("w8a32 timestamps medusa B=1", kernels,
                      lambda: model.generate(feat, return_timestamps=True, **kw),
                      ("attention f32", "megastep w8a32", "verify_hidden w8a32"),
                      absent=others)
    require(VF.w8a32_ts_launches > ts0,
            "w8a32 timestamps: K4's W8A32 timestamp mode never launched")
    check_ts_output(model, out)
    report("w8a32 timestamps medusa B=1", out, wall, int((out.lengths - 3).sum()))
    alone = model.generate(feats8[:1], **kw)
    same = np.array_equal(alone.sequences[0], outs[f"medusa B={BATCH}"].sequences[0])
    log(f"w8a32 medusa: example 0 of the B={BATCH} request equals its B=1 request: {same} "
        f"(check_batch_invariance holds every example's decode)")
    return outs


def phase_w8a32(g, kernels, model, feats, feats8):
    """Phase 6c: the int8 copy of phase 6b's f32 model (``model.quantize()``,
    int8 decoder weights, embedding and heads beside f32 norms, biases,
    encoder and positions): each W8A32 mode against its plain version (K2
    2-layer at (1, 11), (8, 11), (8, 1) with offsets, its block mode, 32
    layers with the worst cosine; K4 / K5 / head_rows at the f32 checks'
    sizes; K10 at (16, 20, 11, 64) x 1500), P3 on the per-op step at B=8
    and B=16, the requests, and the B=8 decode held to B=1.  Returns the
    W8A32 kernel rows (added to ``kernels`` before the requests run)."""
    from whisper_medusa_tpu_torch.models import bridge

    t0 = time.perf_counter()
    qmodel = model.quantize()
    bq = bridge.random_block_model(model, seed=SEED + 2).quantize()
    torch.cuda.synchronize()
    log(f"W8A32 models (model.quantize() of the f32 large-v2 and of its Medusa-Block "
        f"variant): {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    err2 = max(check_w8a32_megastep_2layer(g, t, offs) for t, offs in W8A32_STEPS)
    err2b = max(check_w8a32_megastep_2layer(g, t, offs, block=True) for t, offs in W8A32_STEPS)
    enc1, enc8 = qmodel.encode(feats[0]), qmodel.encode(feats8)
    k2, cos = check_w8a32_megastep_full(qmodel, enc1, enc8)
    k2b, cos_b = check_w8a32_megastep_full(bq, enc1, enc8, bq.params["medusa"]["block"])
    k2["max_abs_err"], k2b["max_abs_err"] = err2, err2b
    log(f"K2 W8A32 32-layer worst cosine against its plain step: {cos:.9f}, block mode "
        f"{cos_b:.9f} (held >= {W8A32_COS_FLOOR})")
    rows = [k2, k2b, check_f32_verify(g, qmodel), check_f32_head_rows(g, qmodel),
            check_f32_verify_rows(g, qmodel), check_f32_cross_decode(g, int8=True),
            check_w8a32_gemm(g)]
    require(tuple(k["name"] for k in rows) == W8A32_ROWS, "W8A32 rows")
    kernels += rows + [check_verify_wide(g, qmodel, "w8a32")]
    enc16 = torch.cat([enc8, enc8.flip(0)])
    check_step_invariance(qmodel, enc8, "large-v2 W8A32")
    check_step_invariance(qmodel, enc16, "large-v2 W8A32")
    t1 = time.perf_counter()
    feats16 = torch.cat([feats8, feats8.flip(0)])
    phase_w8a32_requests(qmodel, bq, kernels, feats[0], feats8, feats16)
    check_batch_invariance(qmodel, enc8, ("base_head",))
    log(f"w8a32 requests and B=8 decode invariance: {time.perf_counter() - t1:.1f} s")
    del bq, enc1, enc8, enc16
    torch.cuda.empty_cache()
    rows.append(phase_tiny_w8a32(g, kernels, feats[0], feats8))
    for k in rows:
        log(f"launches {k['name']} (W8A32 paths): {k['launches']}")
    del qmodel
    torch.cuda.empty_cache()
    log(f"W8A32 phase: {time.perf_counter() - t0:.1f} s")
    return rows


def phase_f32(g, kernels, feats, feats8):
    """Phase 6b: the f32 modes against their plain versions, P3 (the per-op
    step at B=8 bitwise its B=1 steps, every layer) on the f32 model, the
    f32 requests, the B=8 decode held to B=1, and whisper tiny in f32
    against the CPU port.  Returns the f32 kernel rows (added to
    ``kernels`` before the requests run)."""
    t0 = time.perf_counter()
    model = f32_model()
    torch.cuda.synchronize()
    log(f"model: whisper-large-v2 + 10 base_head heads, f32 (ModelConfig's default), random "
        f"(seed {SEED}), {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    embed = model.params["whisper"]["decoder"]["embed_tokens"]
    rows = [check_f32_attention(g), check_f32_logits(g, embed), check_f32_verify(g, model),
            check_f32_head_rows(g, model), check_f32_verify_rows(g, model),
            check_f32_cross_decode(g), check_f32_self_decode(g), check_f32_ffn_decode(g),
            check_f32_gemm(g)]
    kernels += rows + [check_verify_wide(g, model, "f32")]
    enc8 = model.encode(feats8)
    check_step_invariance(model, enc8, "large-v2 f32")
    t1 = time.perf_counter()
    phase_f32_requests(model, kernels, feats[0], feats8)
    check_batch_invariance(model, enc8, ("base_head",))
    log(f"f32 requests and B=8 decode invariance: {time.perf_counter() - t1:.1f} s")
    del embed, enc8
    phase_w8a32(g, kernels, model, feats, feats8)
    del model
    torch.cuda.empty_cache()
    check_f32_tiny_against_cpu(feats[0])
    for k in rows:
        log(f"launches {k['name']} (f32 paths): {k['launches']}")
    log(f"f32 phase: {time.perf_counter() - t0:.1f} s")
    return rows


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


def _attn_bwd_cost(b, h, sq, skv, kv_len, causal, dh=64, elem=2):
    """(bytes, operations) of one attention backward from the forward's
    statistics: q, k, v, dO and O read once (``elem`` bytes an element: bf16,
    or 4 for the f32 mode) with the f32 log-sum-exp, dq, dk and dv written
    once; five products of 2 Dh operations over the (query, key) pairs this
    call's masks leave visible."""
    pairs = sum(min(kv_len, i + 1) for i in range(sq)) if causal else sq * kv_len
    return (elem * dh * b * h * (4 * sq + 4 * skv) + 4 * b * h * sq,
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


# K9's f32 mode against both plain versions: relative (Frobenius) error of
# dQ, dK and dV (f32 sums in another order; the bf16 mode takes 1e-2).
K9_F32_TOL = 1e-5
K9_F32_NAMES = {key: name.replace("attention_bwd", "attention_bwd f32")
                for key, name in K9_SHAPES.items()}


def check_attention_bwd_f32(g):
    """K9's f32 mode from K1 f32's output and log-sum-exp: off the path
    (ragged Sq, kv_len < Skv, causal and not), then at the training paths'
    three shapes, f32 throughout.  dQ, dK and dV each within K9_F32_TOL
    relative (Frobenius) of attention_bwd_plain and attention_bwd_lse_plain
    on the same f32 inputs, the dK / dV rows of keys past kv_len exactly 0;
    each main-path shape twice on the same inputs, bitwise equal, and
    example 0 of its B=2 call bitwise a B=1 call (the dQ partials' scratch
    printed).  Timed
    against the plain version and PyTorch's f32 SDPA backward (the
    efficient-attention backend: flash takes no f32), the one backward call
    through autograd on a graph kept from one forward, held to the plain
    version too; device times under the profiler; one kernels row a
    shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from whisper_medusa_tpu_torch.device_profile import _by_kernel
    from whisper_medusa_tpu_torch.ops import attention as A
    from whisper_medusa_tpu_torch.ops import cuda_lib

    cases = [((1, 4, 300, 300), 257, True), ((1, 3, 77, 300), 299, False),
             ((1, 2, 130, 64), 64, True)]
    cases += [((TRAIN_B, 20, sq, skv), skv, causal) for sq, skv, causal in K9_SHAPES]
    rows = []
    for (b, h, sq, skv), kv_len, causal in cases:
        q, k, v, do = (_f32(g, b, h, sq, 64, scale=0.25), _f32(g, b, h, skv, 64),
                       _f32(g, b, h, skv, 64), _f32(g, b, h, sq, 64))
        o, lse = A.attention_kernel(q, k, v, kv_len, causal, return_lse=True)
        got = A.attention_bwd_kernel(q, k, v, do, kv_len, causal, o=o, lse=lse)
        ref = A.attention_bwd_plain(q, k, v, do, kv_len, causal)
        ref2 = A.attention_bwd_lse_plain(q, k, v, o, lse, do, kv_len, causal)
        rels = [rel_err(a, c) for a, c in zip(got, ref)]
        rels2 = [rel_err(a, c) for a, c in zip(got, ref2)]
        err = max(max_err(a, c) for a, c in zip(got, ref2))
        zero = not (got[1][:, :, kv_len:].any() or got[2][:, :, kv_len:].any())
        dtypes = all(t.dtype == torch.float32 for t in got)
        what = f"K9 f32 attention_bwd ({b},{h},{sq}x{skv},64) kv_len {kv_len} causal {causal}"
        log(f"{what}: relative error to attention_bwd_plain dq {rels[0]:.2e} dk "
            f"{rels[1]:.2e} dv {rels[2]:.2e}, to attention_bwd_lse_plain dq {rels2[0]:.2e} "
            f"dk {rels2[1]:.2e} dv {rels2[2]:.2e}, max_abs_err {err:.3e}, dK/dV past "
            f"kv_len zero {zero}")
        require(max(rels + rels2) <= K9_F32_TOL and zero and dtypes,
                f"{what}: {rels}, {rels2}, zero {zero}, f32 {dtypes}")
        key = (sq, skv, causal)
        if b != TRAIN_B or key not in K9_SHAPES:
            continue
        again = A.attention_bwd_kernel(q, k, v, do, kv_len, causal, o=o, lse=lse)
        same = all(torch.equal(a, c) for a, c in zip(again, got))
        log(f"{what}: a second run on the same inputs: dQ, dK and dV bitwise equal {same}")
        require(same, f"{what}: dQ / dK / dV changed between two runs")
        one = A.attention_bwd_kernel(*(t[:1].contiguous() for t in (q, k, v, do)), kv_len,
                                     causal, o=o[:1].contiguous(), lse=lse[:1].contiguous())
        b_inv = all(torch.equal(a[:1], c) for a, c in zip(got, one))
        scratch = math.prod(A.bwd_scratch_shape(b, h, sq, skv)) * 4
        log(f"{what}: example 0 of the B={b} call bitwise a B=1 call (dQ, dK, dV): {b_inv}; "
            f"dQ partials scratch {scratch / 1e6:.1f} MB ({scratch} bytes)")
        require(b_inv, f"{what}: example 0's dQ / dK / dV depend on B")
        kern = lambda: A.attention_bwd_kernel(q, k, v, do, kv_len, causal, o=o, lse=lse)
        ms = cuda_ms(kern)
        dsum = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
        bufs = [torch.empty_like(t) for t in (q, k, v)] + [dsum] + [
            torch.empty(A.bwd_scratch_shape(b, h, sq, skv), dtype=torch.float32, device="cuda")]
        entry_ms = cuda_ms(lambda: cuda_lib.launch(
            "wm_attention_bwd_f32", q.device, *(t.data_ptr() for t in (q, k, v, o, lse, do)),
            *(t.data_ptr() for t in bufs), b, h, sq, skv, 64, kv_len, int(causal)))
        plain_ms = cuda_ms(lambda: A.attention_bwd_lse_plain(q, k, v, o, lse, do, kv_len,
                                                             causal))
        tpu_plain_ms = cuda_ms(lambda: A.attention_bwd_plain(q, k, v, do, kv_len, causal))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=1.0,
                                                                   is_causal=causal)
        lib = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
        lib_rel = max(rel_err(a, c) for a, c in zip(lib(), ref))
        require(lib_rel <= 1e-3, f"{what}: the SDPA f32 backward is {lib_rel} from the plain")
        lib_ms = cuda_ms(lib)
        split = _by_kernel(kern, 20)
        dev_ms, lib_dev_ms = sum(us for us, _ in split.values()) / 1e3, device_ms(lib)
        cost = _attn_bwd_cost(b, h, sq, skv, kv_len, causal, elem=4)
        log(f"{what}: {cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.2f} GFLOP; device time K9 f32 "
            f"{dev_ms:.4f} ms ("
            + ", ".join(f"{n} {us / 1e3:.4f}" for n, (us, _) in split.items())
            + f"), SDPA f32 backward {lib_dev_ms:.4f} ms (relative error "
            f"{lib_rel:.2e}); attention_bwd_plain {tpu_plain_ms:.4f} ms; K9 f32's C entry "
            f"alone {entry_ms:.4f} ms; {SMI}")
        rows.append(kernel_record(K9_F32_NAMES[key], K9_SOURCE, K9_REPLACES,
                                  (A, "f32_launches_bwd", key), err, ms, plain_ms,
                                  bound(*cost, F32_FLOPS), lib_ms))
        del out, leaves
    return rows


def _train_config(variant, dtype="bfloat16", **dims_kw):
    from whisper_medusa_tpu_torch.config import WhisperDims, MedusaConfig, ModelConfig

    return ModelConfig(dims=WhisperDims(**dims_kw),
                       medusa=MedusaConfig(medusa_heads_type=variant),
                       param_dtype=dtype, compute_dtype=dtype)


def _train_batch(feats_b, seed):
    """Seeded labels (B, 224) of text-token ids, the second row's last 24
    positions padded with -100."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 50257, size=(feats_b.shape[0], TRAIN_T))
    labels[1:, -24:] = -100
    return feats_b, labels


def _grads(params, cfg, feats, labels, policy, remat=False):
    """(loss, {trainable leaf: masked gradient}) of one train forward."""
    from whisper_medusa_tpu_torch.training import train as TT

    out, grads = TT.masked_grads(params, cfg, feats, labels, policy, remat=remat)
    return float(out.loss.detach()), grads


# The card's train step against its f32 CPU copy: (loss relative error,
# worst gradient cosine) a dtype may take.  bf16 weights (rounded P, dS and
# activations on the card) 1e-2 and 0.999; f32 (f32 sums in another order)
# 1e-5 and 0.99999.
TRAIN_2LAYER_TOL = {"bfloat16": (1e-2, 0.999), "float32": (1e-5, 0.99999)}


def _k9_count(dtype):
    """K9's launches so far on the training shapes, in ``dtype``'s mode."""
    from whisper_medusa_tpu_torch.ops import attention as A

    counter = A.f32_launches_bwd if dtype == "float32" else A.launches_bwd
    return sum(counter.values())


def check_train_2layer(variant, policy, feats1, dtype="bfloat16"):
    """One train forward and backward at full width, 2 encoder and 2 decoder
    layers, B=1, T=224, on the card (K1, K9; their f32 modes for f32
    weights) and on a float32 CPU copy of the same weights and batch (the
    plain versions): loss and the worst trainable leaf's gradient cosine
    within ``TRAIN_2LAYER_TOL[dtype]``; K9 launched twice, in dtype's mode."""
    from whisper_medusa_tpu_torch.models import bridge

    cfg = _train_config(variant, dtype, encoder_layers=2, decoder_layers=2)
    params = bridge.from_random(cfg, seed=SEED, device="cuda")
    hg = torch.Generator(device="cuda")
    hg.manual_seed(SEED + 5)
    params["medusa"]["heads"]["w"].normal_(0.0, 0.02, generator=hg)   # off identity
    f32 = lambda tree: {k: f32(v) if isinstance(v, dict) else v.float().cpu()
                        for k, v in tree.items()}
    cpu = f32(params)
    feats, labels = _train_batch(feats1.float().cpu().numpy(), SEED + 6)
    n9 = _k9_count(dtype)
    loss, grads = _grads(params, cfg, feats, labels, policy)
    torch.cuda.synchronize()
    n9 = _k9_count(dtype) - n9
    loss_c, grads_c = _grads(cpu, cfg.replace(param_dtype="float32"), feats, labels, policy)
    cos = {k: cosine(grads[k].cpu(), grads_c[k]) for k in grads}
    rels = {k: rel_err(grads[k].cpu(), grads_c[k]) for k in grads}
    worst = min(cos, key=cos.get)
    rel = abs(loss - loss_c) / abs(loss_c)
    loss_tol, cos_tol = TRAIN_2LAYER_TOL[dtype]
    log(f"train 2-layer {variant} / {policy} {dtype} B=1 T={TRAIN_T}: loss card {loss:.6f}, "
        f"CPU f32 {loss_c:.6f} (relative {rel:.2e}); K9 ({dtype}) launches {n9}; gradient "
        f"cosine over {len(cos)} trainable leaves: worst {cos[worst]:.8f} ({worst}), median "
        f"{statistics.median(cos.values()):.8f}; worst relative error "
        f"{max(rels.values()):.2e} ({max(rels, key=rels.get)})")
    require(rel <= loss_tol and cos[worst] >= cos_tol and n9 == 2,
            f"train 2-layer {variant} / {policy} {dtype}: loss {rel}, cosine {cos[worst]} at "
            f"{worst}, K9 launches {n9}")


# Training paths: (name, variant, policy, steps, K9 launches per step).
TRAIN_RUNS = (("Medusa-Block recipe", "medusa_block", "whisper", 3, 2),
              ("Medusa-Linear recipe", "base_head", "all_but_last", 3, 2),
              ("full fine-tune", "base_head", None, 1, 96))
# The kernels rows each dtype's training must launch, and those it must not.
TRAIN_ROWS = {"bfloat16": ("attention", *K9_SHAPES.values()),
              "float32": ("attention f32", *K9_F32_NAMES.values())}


def train_run(kernels, name, variant, policy, steps, k9_per_step, feats2, dtype="bfloat16"):
    """Train steps at full large-v2 width, ``dtype`` weights, B=2, T=224,
    random weights from SEED, one repeated batch, Adafactor at lr 1e-3 (no
    warmup, constant schedule), remat off.  Finite losses; for a recipe the
    third loss below the first; frozen leaves and frozen slices
    bit-identical; every trained leaf changed but those still at 1.0 (a
    layer-norm scale of 1.0 does not move in bf16 at this lr: half a bf16
    ulp of 1.0 is 3.9e-3, the step 1e-3); K9 launched ``k9_per_step`` times
    per step, in dtype's mode, and neither K1 nor K9 in the other mode.  The
    weights' copy for that comparison lives on the host, so the peak memory
    printed is the training's own."""
    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.ops import attention as A
    from whisper_medusa_tpu_torch.training import train as TT

    cfg = _train_config(variant, dtype)
    params = bridge.from_random(cfg, seed=SEED, device="cuda")
    before = {k: v.to("cpu", copy=True) for k, v in bridge.flatten(params).items()}
    opt = TT.make_optimizer("adafactor", lr=1e-3, warmup_steps=0, schedule="constant")
    state = TT.init_train_state(params, opt)
    step = TT.make_train_step(cfg, opt, policy, remat=False)
    feats, labels = _train_batch(feats2, SEED + 7)
    rows = TRAIN_ROWS[dtype]
    needs = list(rows[:3]) + ([rows[3]] if policy is None else [])
    absent = [n for d, other in TRAIN_ROWS.items() if d != dtype for n in other]

    def run():
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            _, metrics = step(state, feats, labels)
            losses.append(float(metrics["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, times

    torch.cuda.reset_peak_memory_stats()
    seen = {}
    (losses, times), _ = drive(f"train {name} {dtype}", kernels, run, needs, absent, seen)
    peak = torch.cuda.max_memory_allocated() / 2**30
    k1 = seen[rows[0]] / steps
    k9 = sum(seen[n] for n in rows[1:]) / steps
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
    log(f"train {name} ({variant}, parts_to_freeze={policy}) {dtype} B={TRAIN_B} T={TRAIN_T}: "
        f"losses {', '.join(f'{x:.6f}' for x in losses)}; ms per step "
        f"{', '.join(f'{t:.1f}' for t in times)}; peak memory {peak:.2f} GiB; per step "
        f"K1 {k1:g}, K9 {k9:g}; trained leaves changed {moved}, unchanged at 1.0 "
        f"{len(ones)}, otherwise unchanged {still or 'none'}; frozen leaves and slices "
        f"identical {frozen_ok}; {SMI}")
    require(all(np.isfinite(losses)) and (steps < 3 or losses[2] < losses[0])
            and frozen_ok and not still and moved > 0 and k9 == k9_per_step,
            f"train {name} {dtype}: losses {losses}, frozen {frozen_ok}, unchanged {still}, "
            f"K9 per step {k9}")
    del state, params, before
    return losses


def check_remat_dots(kernels, feats2):
    """One f32 full fine-tune forward and backward at full large-v2 width,
    B=2, T=224, under remat False, "attn" and "dots" on the same weights and
    batch: the loss and every gradient under "attn" and "dots" bitwise
    False's (every kernel of the step is deterministic, and a recompute runs
    the same operations on the same inputs); K9 f32 96 launches a pass; each
    pass's peak memory above what was allocated before it, "dots" below
    False's."""
    from whisper_medusa_tpu_torch.models import bridge

    cfg = _train_config("base_head", "float32")
    params = bridge.from_random(cfg, seed=SEED + 8, device="cuda")
    feats, labels = _train_batch(feats2, SEED + 9)
    rows = TRAIN_ROWS["float32"]
    ref, peaks = None, {}
    for remat in (False, "attn", "dots"):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        seen = {}
        (loss, grads), wall = drive(f"remat {remat!r} f32 full fine-tune", kernels,
                                    lambda: _grads(params, cfg, feats, labels, None, remat),
                                    rows, seen=seen)
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**30
        k9 = sum(seen[n] for n in rows[1:])
        log(f"remat {remat!r}: loss {loss:.8f}, {wall * 1e3:.1f} ms, peak memory "
            f"{peaks[remat]:.2f} GiB above the weights, K1 f32 {seen[rows[0]]}, K9 f32 {k9}")
        require(k9 == 96, f"remat {remat!r}: K9 f32 launches {k9}")
        if ref is None:
            ref = (loss, grads)
            continue
        same = [k for k in grads if torch.equal(grads[k], ref[1][k])]
        worst = max(rel_err(grads[k], ref[1][k]) for k in grads)
        log(f"remat {remat!r} vs False: loss bitwise {loss == ref[0]}, {len(same)}/{len(grads)} "
            f"gradients bitwise, worst relative error {worst:.2e}")
        require(loss == ref[0] and len(same) == len(grads),
                f"remat {remat!r}: loss {loss} vs {ref[0]}, gradient error {worst}")
        del grads
    from whisper_medusa_tpu_torch.ops import attention as A

    scratch = max(math.prod(A.bwd_scratch_shape(TRAIN_B, 20, sq, skv)) * 4
                  for sq, skv, _ in K9_SHAPES)
    log(f"peak memory of one f32 full fine-tune pass above the weights (GiB): "
        + ", ".join(f"remat {r!r} {p:.2f}" for r, p in peaks.items())
        + f"; K9 f32's largest dQ partials scratch {scratch / 2**30:.3f} GiB; {SMI}")
    require(peaks["dots"] < peaks[False], "remat 'dots' did not lower the peak memory")
    del params, ref


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
    """The training CLI in-process at its defaults (--param-dtype float32,
    --device cuda, --parts-to-freeze whisper: K1's f32 mode in the frozen
    forward), on a temporary CSV of generated WAV files, at --whisper-size
    tiny (d_model 384), 2 steps, a checkpoint every step; its
    model_components/ loads through from_pretrained as an f32 model and
    answers a generate (f32 serving: the per-op step's f32 modes, K4 f32)."""
    import tempfile
    import wave

    from whisper_medusa_tpu_torch.cli import train as cli
    from whisper_medusa_tpu_torch.data.tokenizer import CharTokenizer
    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel
    from whisper_medusa_tpu_torch.ops import attention as A
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
        k1_train = A.f32_launches
        summary = cli.main(["--train-data-path", data, "--validation-data-path", data,
                            "--output-path", out, "--whisper-size", "tiny", "--max-steps", "2",
                            "--save-steps", "1", "--eval-steps", "2", "--warmup-steps", "0",
                            "--batch-size", "2"])
        cli_s = time.perf_counter() - t0
        k1_train = A.f32_launches - k1_train
        saved = sorted(os.listdir(os.path.join(out, "checkpoints")))
        model = WhisperMedusaModel.from_pretrained(os.path.join(out, "model_components"))
        dtypes = {t.dtype for t in bridge.flatten(model.params).values()
                  if t.is_floating_point()}
        proc = WhisperMedusaProcessor(tokenizer=CharTokenizer())
        k1 = A.f32_launches
        res = model.generate(proc(waves[0]), language="en", max_new_tokens=16)
        k1 = A.f32_launches - k1
    n_gen = int(res.lengths[0]) - PROMPT_LEN
    log(f"cli.train.main (tiny, its default f32, 2 steps): {cli_s:.1f} s, {summary}; K1 f32 "
        f"launches {k1_train}; checkpoints {saved}; model_components loaded ({dtypes}) and "
        f"generated {n_gen} tokens {res.sequences[0, :PROMPT_LEN + n_gen].tolist()} (K1 f32 "
        f"launches {k1})")
    require(summary["final_step"] == 2 and "trainer_state.json" in saved and n_gen >= 1
            and np.isfinite(res.token_logprobs).all() and dtypes == {torch.float32}
            and k1_train > 0 and k1 > 0, "cli train / load / generate")


# ---------------------------------------------------------------------------
# K2 at d_model 384, K4 past 128 rows, reference checkpoints and the
# evaluation CLI
# ---------------------------------------------------------------------------

# K2's 2-layer checks at whisper tiny's widths: (1, 11), (8, 11), (8, 1).
D384_STEPS = ((11, [7]), (11, [7, 0, 120, 33, 448, 5, 260, 90]),
              (1, [0, 17, 100, 5, 300, 440, 2, 63]))


def tiny_dims2():
    """Whisper tiny's widths (d_model 384, 6 heads, ffn 1536), 2 decoder layers."""
    import dataclasses

    from whisper_medusa_tpu_torch.config import WHISPER_PRESETS

    return dataclasses.replace(WHISPER_PRESETS["tiny"], decoder_layers=2)


def check_megastep_d384(g, tiny, enc1, enc8):
    """K2 at D = 384 (whisper tiny), in bf16, int8, block and int8 block
    mode: two layers at D384_STEPS against the plain layer loop within 3e-2
    + 3e-2 |x| (the large-v2 checks' bound, PERF rows 2 / 2q / 2b), then the
    4-layer step of tiny's models (bf16, int8 and the Medusa-Block model)
    against its plain step at (1, 11), (8, 11) and (8, 1), every example of
    a B=8 call bitwise its B=1 call, timed beside the plain step and its
    bound.  Returns the rows megastep d384, megastep_int8 d384 and
    megastep_block d384."""
    model, qmodel, bmodel = tiny
    dims = tiny_dims2()
    errs = {"bf16": max(check_megastep_2layer(g, t, o, dims=dims) for t, o in D384_STEPS),
            "int8": max(check_megastep_2layer_int8(g, t, o, dims=dims) for t, o in D384_STEPS),
            "block": max(check_megastep_2layer(g, t, o, block=True, dims=dims)
                         for t, o in D384_STEPS),
            "block int8": max(check_megastep_2layer_int8(g, t, o, block=True, dims=dims)
                              for t, o in D384_STEPS)}
    rows, worst = [], 1.0
    for m, key, blk in ((model, "bf16", None), (qmodel, "int8", None),
                        (bmodel, "block", bmodel.params["medusa"]["block"])):
        row, cos = check_megastep_full(m, enc1, enc8, blk, suffix=" d384")
        row["max_abs_err"] = errs[key]
        rows.append(row)
        worst = min(worst, cos)
    log(f"K2 at D=384: 2-layer max_abs_err {errs}; 4-layer worst cosine against the plain "
        f"step {worst:.6f}; {SMI}")
    from whisper_medusa_tpu_torch.utils.profiling import megastep_chain_ms

    for b, t in ((1, 11), (8, 11), (8, 1)):
        ms = megastep_chain_ms(model.params["whisper"], model.config.dims, enc8[:b], t, steps=50)
        log(f"utils.profiling.megastep_chain_ms, whisper tiny bf16 ({b}, {t}): {ms:.4f} ms a "
            f"step over a chain of 50 K2 steps (CUDA events); {SMI}")
    return rows


# K4 past the old 128 rows: (stacked heads, source rows B * N at B = 1,
# identity0) giving R = 144 (the 11-head chain), 289 (16 heads + the
# identity rows, whisper tiny's 16-head chain) and 1024 (one head over 1024
# rows: stage A in six blocks).  Where 16 heads are over the 40 MiB stack
# (large-v2: 52.4 MB), R = 289 is one head over 289 source rows (two
# stage-A blocks) and identity0 runs 12 heads + the identity rows over 21
# (R = 273).
WIDE_K4 = ((12, 12, False), (16, 17, True), (1, 1024, False))
WIDE_K4_LARGE = ((12, 12, False), (1, 289, False), (12, 21, True), (1, 1024, False))


def _wide_heads(g, model, nh):
    """``nh`` random single-layer heads in the model's mode: N(0, 0.02)
    (nh, D, D) weights and N(0, 0.1) (nh, D) biases in its row dtype (bf16,
    or f32), the weights quantized as quantize() does on an int8 model."""
    from whisper_medusa_tpu_torch.ops import qmm as QM

    d = model.config.dims.d_model
    dt = model.params["whisper"]["decoder"]["ln_post"]["scale"].dtype
    w = (torch.randn((nh, d, d), generator=g, device="cuda") * 0.02).to(dt)
    b = (torch.randn((nh, d), generator=g, device="cuda") * 0.1).to(dt)
    if _int8(model):
        q, sc = QM.quantize_array(w)
        w = {"q": q, "s": sc}
    return w, b, dt


def check_verify_wide(g, model, label):
    """K4 at R = 144, 289 and 1024 (WIDE_K4, or WIDE_K4_LARGE past a 16-head
    stack of 40 MiB) in the model's mode (bf16; int8 heads and embedding;
    f32; W8A32) against verify_hidden_plain, the
    R = 144 call also in the timestamp mode: bf16 and int8 held as
    check_verify holds them (argmax on rows whose plain top-2 gap exceeds
    1e-2, max / lse / gathered by _stats_ok), f32 and W8A32 as
    check_f32_verify (_f32_stats_ok); each call's statistics bitwise K5's
    over head_rows' rows (stage A's blocks of 192 source rows give a row
    the bits of any other launch).  Timed at each R; returns the R = 144
    row (``label`` names the mode)."""
    from whisper_medusa_tpu_torch.ops import verify as VF

    d, v = model.config.dims.d_model, model.config.dims.vocab_size
    q = _int8(model)
    worst, timed = 0.0, {}
    for nh, n, id0 in WIDE_K4 if 16 * d * d * 2 <= VF.MAX_HEAD_BYTES else WIDE_K4_LARGE:
        w, b, dt = _wide_heads(g, model, nh)
        r = (nh + id0) * n
        require(VF.hidden_available(1, n, nh, id0, v, d), f"K4 takes R = {r}")
        embed, masks, _, gcol, kw = _verify_inputs(g, model, r)
        # Row (k, n) predicts position 5 + n % 12 + k: within a decode's
        # positions (past ~480 the EOS decay's factor overflows f32).
        pos = (5 + torch.arange(n, device="cuda")[None, :] % 12
               + torch.arange(nh + id0, device="cuda")[:, None]).reshape(-1).to(torch.int32)
        hid = torch.randn((1, n, d), generator=g, device="cuda").to(dt)
        src = torch.randn((1, n, d), generator=g, device="cuda").to(dt) if id0 else hid
        rows = VF.build_rows(hid, src, w, b, id0)
        for ts in ((None, _ts_operands(model, r, n)) if r == 144 else (None,)):
            tkw = _ts_kw(ts) if ts else {}
            got = VF.verify_hidden(hid, src, w, b, embed, pos, gcol, masks, identity0=id0,
                                   **kw, **tkw)
            ref = VF.verify_hidden_plain(hid, src, w, b, embed, pos, gcol, masks,
                                         identity0=id0, ts=ts, **kw)
            what = (f"K4 {label} R={r} ({nh} heads{' + identity0' if id0 else ''} x {n} "
                    f"rows){' timestamp mode' if ts else ''}")
            if dt == torch.float32:
                err = _f32_stats_ok(what, rows, embed, pos, masks, kw, got, ref, ts)
            else:
                if ts is None:
                    arg_ok, n_clear = _clear_argmax(rows, embed, pos, masks, kw, got[0],
                                                    ref[0], 1e-2)
                else:
                    arg_ok, n_clear, _ = _ts_clear(rows, embed, pos, masks, kw, ts, got[0],
                                                   ref[0], 1e-2)
                ok, err = _stats_ok(model, got, ref)
                log(f"{what}: argmax equal on {n_clear} clear rows: {arg_ok}; "
                    f"max/lse/gathered max_abs_err {err:.3e}")
                require(arg_ok and ok and got[0].shape == (r,), f"{what}: argmax {arg_ok}, "
                        f"err {err}")
            flat = VF.head_rows(src.reshape(n, d), w, b).reshape(-1, d)
            if id0:
                flat = torch.cat([hid.reshape(n, d), flat])
            k5 = VF.verify_rows(flat, embed, pos, gcol, masks, **kw, **tkw)
            same = all(torch.equal(a, c) for a, c in zip(got, k5))
            log(f"{what}: statistics bitwise those of K5 over head_rows' rows: {same}")
            require(same, f"{what}: stage A's rows differ from head_rows'")
            worst = max(worst, err)
        kern = lambda: VF.verify_hidden(hid, src, w, b, embed, pos, gcol, masks,
                                        identity0=id0, **kw)
        plain = lambda: VF.verify_hidden_plain(hid, src, w, b, embed, pos, gcol, masks,
                                               identity0=id0, **kw)
        sources = (hid, src) if id0 else (hid,)
        bd = bound(nbytes(*sources, *_tensors(w), b, *_tensors(embed), pos, gcol, masks)
                   + 4 * r * 4, 2 * r * v * d + 2 * nh * n * d * d,
                   F32_FLOPS if dt == torch.float32 else BF16_FLOPS)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        by_kernel = _kernel_ms(kern)
        log(f"K4 {label} R={r}: kernel {ms:.4f} ms events, device "
            f"{sum(by_kernel.values()):.4f} ms (" + ", ".join(
                f"{k} {t:.4f}" for k, t in by_kernel.items())
            + f"); plain {plain_ms:.4f} ms; bound {bd[0]:.4f} ms ({bd[1]}); {SMI}")
        timed[r] = (ms, plain_ms, bd)
    if dt == torch.float32:
        counter = "w8a32_launches" if q else "f32_launches"
    else:
        counter = "q_launches" if q else "launches"
    name = "verify_hidden" + ("_int8" if q and dt != torch.float32 else "") + (
        f" {label}" if dt == torch.float32 else "") + " R144"
    return kernel_record(name, "whisper_medusa_tpu_torch/csrc/verify.cu",
                         "whisper_medusa_tpu/ops/verify.py:309", (VF, counter), worst,
                         *timed[144], None)


EVAL_SECS = (3.0, 7.5, 12.0, 21.0)       # the evaluation CLI's synthetic utterances
EVAL_NEEDS = {1: ("attention", "megastep", "logits", "verify_hidden"),
              4: ("attention", "megastep", "logits", "head_rows", "verify_rows")}


def phase_eval_cli(model, kernels):
    """Reference checkpoints and the evaluation CLI at large-v2 width: the
    bf16 model's weights (seed 0, its 10 random heads) written in the
    reference's key layout (``convert.save_reference_checkpoint``) to a
    temporary directory; ``from_pretrained`` on it holds every tensor
    bitwise to the source; then ``cli.evaluate.evaluate_model`` over four
    synthetic WAVs (EVAL_SECS) and a CSV at --batch-size 1 and 4, each driven
    with the launch counters (K1, K2, K3 and K4 at B=1; K5 at B=4), its
    summary printed, its CSV's rows read back.  The directory is removed."""
    import argparse
    import csv
    import shutil
    import tempfile
    import wave

    from whisper_medusa_tpu_torch.cli import args as cli_args
    from whisper_medusa_tpu_torch.cli import evaluate as cli_eval
    from whisper_medusa_tpu_torch.models import bridge, convert
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="wm_eval_")
    try:
        ckpt = os.path.join(tmp, "ckpt")
        convert.save_reference_checkpoint(ckpt, model.params, model.config)
        t1 = time.perf_counter()
        loaded = WhisperMedusaModel.from_pretrained(ckpt, device="cuda", dtype="bfloat16")
        src, got = bridge.flatten(model.params), bridge.flatten(loaded.params)
        same = src.keys() == got.keys() and all(
            got[k].dtype == src[k].dtype and torch.equal(got[k], src[k]) for k in src)
        size = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        log(f"reference checkpoint of the bf16 model (d_model {model.config.dims.d_model}, "
            f"{model.config.medusa.medusa_num_heads} heads): written in {t1 - t0:.1f} s, "
            f"{size / 1e9:.2f} GB; from_pretrained {time.perf_counter() - t1:.1f} s; "
            f"{len(got)} tensors bitwise the source's: {same}")
        require(same, "from_pretrained of the reference checkpoint differs from the source")
        del loaded, got
        torch.cuda.empty_cache()
        rows = []
        for i, w in enumerate(waveforms(EVAL_SECS)):
            path = os.path.join(tmp, f"utt{i}.wav")
            with wave.open(path, "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(16000)
                f.writeframes((np.clip(w, -1, 1) * 32767).astype(np.int16).tobytes())
            rows.append({"audio": path, "sentence": f"utterance number {i}", "language": "en"})
        data = os.path.join(tmp, "data.csv")
        with open(data, "w", newline="") as f:
            wr = csv.DictWriter(f, fieldnames=["audio", "sentence", "language"])
            wr.writeheader()
            wr.writerows(rows)
        for batch, needs in EVAL_NEEDS.items():
            parser = argparse.ArgumentParser()
            cli_args.add_eval_args(parser)
            out_csv = os.path.join(tmp, f"preds{batch}.csv")
            args = parser.parse_args(["--model-name", ckpt, "--data-path", data,
                                      "--out-file-path", out_csv, "--batch-size", str(batch),
                                      "--max-length", str(PROMPT_LEN + MAX_NEW_TOKENS)])
            summary, wall = drive(f"evaluate CLI --batch-size {batch}", kernels,
                                  lambda: cli_eval.evaluate_model(args), needs)
            with open(out_csv) as f:
                preds = list(csv.DictReader(f))
            log(f"evaluate CLI --batch-size {batch} (reference checkpoint, bf16, cuda): "
                f"{wall:.1f} s with the load; summary {summary}; {len(preds)} rows, columns "
                f"{list(preds[0])}; {SMI}")
            require(len(preds) == len(EVAL_SECS) and summary["utterances"] == len(EVAL_SECS)
                    and np.isfinite(summary["wer"]) and np.isfinite(summary["cer"])
                    and summary["tokens_per_second"] > 0
                    and list(preds[0]) == list(cli_eval.OUT_FIELDS),
                    f"evaluate CLI --batch-size {batch}: {summary}")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"reference checkpoint and evaluation CLI phase: {time.perf_counter() - t0:.1f} s")


# The scopes K2 and K4 had before they took the JAX gates', for a same-call
# comparison of the routes they chose.
def _parent_fits(fits):
    """``megastep.fits`` with its former width rule: d_model and ffn_dim
    multiples of 256 besides the current conditions."""
    def gate(dec_layers, x, self_k, cross_k, num_heads, cross_beam=1):
        return (x.shape[-1] % 256 == 0 and dec_layers["fc1_b"].shape[-1] % 256 == 0
                and fits(dec_layers, x, self_k, cross_k, num_heads, cross_beam))
    return gate


def _parent_hidden_available(b, n, n_heads, identity0, v, d):
    """``verify.hidden_available`` with its former row rule: R <= 128 and
    B * N <= 16 source rows."""
    return (n_heads >= 1 and b * n <= 16 and (n_heads + int(identity0)) * b * n <= 128
            and d % 64 == 0)


def report_scope_ab(model, tiny, feat, feats8):
    """Printed, not held: the requests whose route the wider scopes change,
    each under the former gates (``_parent_fits``,
    ``_parent_hidden_available``) and the current ones, in turns (former,
    current, current, former; printed as parent and this), in one call: whisper tiny Medusa B=1 and B=8 (the per-op step against K2) and
    the 11-head large-v2 chain at B=1 (two passes against one K4 pass); wall
    ms of each run (128 new tokens; the 11-head chain P4_NEW_TOKENS), then
    each route's device busy ms and idle share under the profiler."""
    from whisper_medusa_tpu_torch.ops import megastep as MS
    from whisper_medusa_tpu_torch.ops import verify as VF

    fits, avail = MS.fits, VF.hidden_available
    wide = wide_head_model(model, 11, SEED + 21)
    runs = {"tiny medusa B=1": (tiny, feat, MAX_NEW_TOKENS),
            f"tiny medusa B={BATCH}": (tiny, feats8, MAX_NEW_TOKENS),
            "large-v2 11-head chain B=1": (wide, feat, P4_NEW_TOKENS)}
    try:
        for name, (m, f, new) in runs.items():
            gen = lambda: m.generate(f, language="en", max_new_tokens=new)
            walls, outs, dev = {}, {}, {}
            for side in ("parent", "this", "this", "parent"):
                MS.fits, VF.hidden_available = ((_parent_fits(fits), _parent_hidden_available)
                                                if side == "parent" else (fits, avail))
                gen()                                               # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[side] = gen()
                torch.cuda.synchronize()
                walls.setdefault(side, []).append((time.perf_counter() - t0) * 1e3)
                if len(walls[side]) == 1:
                    dev[side] = device_split(gen)[0]
            same = np.array_equal(outs["parent"].sequences, outs["this"].sequences)
            log(f"scope A/B [{name}]: wall ms parent {walls['parent'][0]:.1f}, this "
                + ", ".join(f"{w:.1f}" for w in walls["this"]) + f", parent "
                f"{walls['parent'][1]:.1f}; device busy parent {dev['parent']:.2f} ms (idle "
                f"{1 - dev['parent'] / min(walls['parent']):.3f}), this {dev['this']:.2f} ms "
                f"(idle {1 - dev['this'] / min(walls['this']):.3f}); {outs['this'].steps} "
                f"steps; tokens equal across the routes: {same}; {SMI}")
    finally:
        MS.fits, VF.hidden_available = fits, avail
    del wide


def phase_tiny_w8a32(g, kernels, feat, feats8):
    """K2's W8A32 mode at D = 384: two layers at D384_STEPS (and the block)
    within F32_TOL + F32_TOL |x| of the plain version, B=8 bitwise B=1; the
    4-layer step of the int8 copy of an f32 whisper tiny against its plain
    step (W8A32_COS_FLOOR); one Medusa B=1 request on it driven with
    K2's W8A32 mode required.  Returns the row megastep w8a32 d384 (added to
    ``kernels`` before the request runs)."""
    dims = tiny_dims2()
    err = max(max(check_w8a32_megastep_2layer(g, t, o, dims=dims) for t, o in D384_STEPS),
              max(check_w8a32_megastep_2layer(g, t, o, block=True, dims=dims)
                  for t, o in D384_STEPS))
    qmodel = f32_model("tiny").quantize()
    enc1, enc8 = qmodel.encode(feat), qmodel.encode(feats8)
    row, cos = check_w8a32_megastep_full(qmodel, enc1, enc8, suffix=" d384")
    row["max_abs_err"] = err
    log(f"K2 W8A32 at D=384: 2-layer max_abs_err {err:.3e}, 4-layer worst cosine {cos:.9f} "
        f"(held >= {W8A32_COS_FLOOR})")
    kernels.append(row)
    qmodel.generate(feat, language="en", max_new_tokens=8)           # warm-up
    out, wall = drive("w8a32 tiny medusa B=1", kernels,
                      lambda: qmodel.generate(feat, language="en",
                                              max_new_tokens=W8A32_NEW_TOKENS),
                      ("attention f32", "megastep w8a32 d384", "verify_hidden w8a32"),
                      absent=PER_OP_ROWS + ("self_decode f32", "cross_decode w8a32"))
    report("w8a32 tiny medusa B=1 request", out, wall,
           check_output(out, 1, qmodel.config.dims.vocab_size, W8A32_NEW_TOKENS))
    del qmodel, enc1, enc8
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phase 8: data- and tensor-parallel serving and training on two ranks
# ---------------------------------------------------------------------------

PAR_RANKS = 2
PAR_TP_NEW_TOKENS = 32
PAR_TIMEOUT_S = 600
PAR_TRAIN_LOSS_RTOL = 1e-3       # the DDP step's loss against the single-process step's
# The DDP step's gradient of each head leaf against the single-process
# step's, ||g_ddp - g_one|| / ||g_one||: one bf16 ulp, relative.  A bf16
# leaf's gradient is one rounding of an f32 sum in one process and the f32
# sum of the ranks' two rounded halves under DDP.  The updated weights are
# printed, not held: an element near zero, summed from nearly cancelling
# halves, moves by many of its own ulps, and most bias updates are below
# half a bf16 ulp of the bias, so which of them round up is not stable
# under a change of that size.
PAR_GRAD_RTOL = 2.0 ** -7
# The DDP step's update of each head leaf (new - old) against the
# single-process step's, ||u_ddp - u_one|| / ||u_one||, held below this.
# Sound readings and the reading of a fault (the update of rank 0's row
# alone, what a step that never reduced its gradients would apply) are in
# PERF.md; the limit lies between them.
PAR_UPDATE_RTOL = 0.05
# One TP=2 per-op step's hidden rows (the kernels on this rank's shards)
# against the same step on the same shards with every kernel's plain
# version in its place: cosine at least this (readings in PERF.md).
PAR_TP_PLAIN_COS = 0.9998
# Launch counters a rank reads around each of its runs (module, attribute).
PAR_COUNTERS = {"attention": ("attention", "launches"), "megastep": ("megastep", "launches"),
                "logits": ("logits", "launches"), "head_rows": ("verify", "head_launches"),
                "verify_hidden": ("verify", "launches"),
                "verify_rows": ("verify", "rows_launches"),
                "self_decode": ("decode_ops", "self_launches"),
                "cross_decode": ("decode_ops", "cross_launches"),
                "ffn_decode": ("decode_ops", "ffn_launches")}


def _par_counts(reset=False):
    import importlib

    out = {}
    for name, (mod, attr) in PAR_COUNTERS.items():
        m = importlib.import_module(f"whisper_medusa_tpu_torch.ops.{mod}")
        out[name] = getattr(m, attr)
        if reset:
            setattr(m, attr, 0)
    return out


def _par_model():
    """main()'s large-v2 bf16 model: the Whisper weights from SEED, the
    heads drawn from a generator of their own (SEED + 1)."""
    from whisper_medusa_tpu_torch.config import WHISPER_PRESETS, MedusaConfig, ModelConfig
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel

    cfg = ModelConfig(dims=WHISPER_PRESETS["large-v2"], medusa=MedusaConfig(),
                      param_dtype="bfloat16", compute_dtype="bfloat16")
    model = WhisperMedusaModel.from_random(cfg, seed=SEED)
    hg = torch.Generator(device="cuda")
    hg.manual_seed(SEED + 1)
    model.params["medusa"]["heads"]["w"].normal_(0.0, 0.02, generator=hg)
    return model


def _par_checksum(model):
    p = model.params
    return [float(t.double().sum()) for t in (
        p["whisper"]["decoder"]["embed_tokens"], p["whisper"]["decoder"]["layers"]["fc1_w"],
        p["whisper"]["encoder"]["layers"]["self"]["q_w"], p["medusa"]["heads"]["w"])]


def _per_op_hidden(params, dims, tokens, enc):
    """One per-op decoder step (``decoder_layers_ops``) over ``tokens`` at
    offset 0 on a fresh cache of ``enc``: the hidden rows."""
    from whisper_medusa_tpu_torch.models import whisper as W

    dec = params["whisper"]["decoder"]
    cache = W.init_cache(params["whisper"], dims, enc, 64)
    t = tokens.shape[1]
    x = W.embed_lookup(dec["embed_tokens"], tokens) + dec["pos_embed"][None, :t]
    offsets = torch.zeros((tokens.shape[0],), dtype=torch.int32, device=tokens.device)
    _, hidden, _ = W.decoder_layers_ops(
        dec["layers"], dec["ln_post"], x, cache.self_k, cache.self_v, cache.cross_k,
        cache.cross_v, offsets, None, cross_len=enc.shape[1],
        num_heads=dims.decoder_attention_heads)
    return hidden


def _bf16_ulps(a, b):
    """|a - b| in bf16 ulps of the larger magnitude (elementwise, float)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7),
                      torch.full_like(mag, 2.0 ** -133))
    return (a - b).abs() / ulp


def _leaf_ulps(a, b):
    """max |a - b| in bf16 ulps of the leaf ``b``'s largest magnitude (an
    element near zero, summed from nearly cancelling partial gradients, may
    change sign when the sum runs in another order: no elementwise ulp
    bound holds there)."""
    top = float(b.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 2.0 ** -133
    return float((a.float() - b.float()).abs().max()) / ulp


def _bits_mask(bits, t):
    """The (T, T) chunk mask that :func:`decode_ops.chunk_bits` packed."""
    j = torch.arange(t, device=bits.device)
    return ((bits[:, j // 32] >> (j % 32)) & 1).bool()


@contextlib.contextmanager
def _plain_per_op():
    """The per-op step with K10 (both modes) and K11 replaced by their plain
    versions on the same CUDA tensors (the projections are cuBLAS in both)."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    saved = (DO.cross_attention_decode, DO.self_attention_decode_kernel, DO.ffn_decode)
    DO.cross_attention_decode = DO.cross_attention_decode_plain
    DO.self_attention_decode_kernel = lambda q, k, v, off, bits: (
        DO.self_attention_decode_plain(q, k, v, off, _bits_mask(bits, q.shape[1])))
    DO.ffn_decode = DO.ffn_decode_plain
    try:
        yield
    finally:
        DO.cross_attention_decode, DO.self_attention_decode_kernel, DO.ffn_decode = saved


def _digests(tree):
    """sha256 of each leaf's bytes, by its flat name."""
    import hashlib

    from whisper_medusa_tpu_torch.models import bridge

    return {k: hashlib.sha256(v.detach().cpu().contiguous().view(torch.uint8).numpy()
                              .tobytes()).hexdigest()
            for k, v in bridge.flatten(tree).items()}


def parallel_rank_main():
    """One rank of phase 8 (``chip_smoke.py --parallel-rank``, launched by
    :func:`phase_parallel` with torchrun's variables): (a) DP=2 serving,
    (b) TP=2 serving, (c) a DDP=2 training step, each against the
    single-process call on the same card; results to WM_PAR_DIR/rank<r>.json."""
    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.models import whisper as W
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel
    from whisper_medusa_tpu_torch.parallel import distributed
    from whisper_medusa_tpu_torch.parallel import mesh as mesh_mod
    from whisper_medusa_tpu_torch.training import train as TT

    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(backend="gloo", timeout_s=PAR_TIMEOUT_S)
    rank = distributed.process_index()
    d = os.environ["WM_PAR_DIR"]
    pay = torch.load(os.path.join(d, "payload.pt"), weights_only=False)
    res = {"rank": rank}
    t0 = time.perf_counter()
    model = _par_model()
    dims = model.config.dims
    require(_par_checksum(model) == pay["checksum"], "the rank's weights are main()'s")
    res["model_s"] = time.perf_counter() - t0
    feats8, enc8, feat1 = (pay[k].cuda() for k in ("feats8", "enc8", "feat1"))
    kw = dict(language="en", max_new_tokens=MAX_NEW_TOKENS)

    # (a) DP=2: the single-process B=8 call (rank 0, for its wall), then the
    # sharded call end to end, then the sharded decode on the
    # single-process encoder rows, held to the single-process B=8 decode.
    if rank == 0:
        model.generate(feats8, language="en", max_new_tokens=8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single8 = model.generate(feats8, **kw)
        torch.cuda.synchronize()
        res["single_b8_wall_s"] = time.perf_counter() - t0
        res["single_b8_equals_parent"] = bool(np.array_equal(single8.sequences, pay["seq8"]))
    distributed.sync()
    model.shard(dp=PAR_RANKS, tp=1)
    model.generate(feats8, language="en", max_new_tokens=8)
    _par_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp_out = model.generate(feats8, **kw)
    torch.cuda.synchronize()
    res["dp_b8_wall_s"] = time.perf_counter() - t0
    res["dp_counts"] = _par_counts()
    res["dp_e2e_tokens_equal"] = bool(np.array_equal(dp_out.sequences, pay["seq8"]))
    enc_dp = model.encode(feats8)
    per = enc8.shape[0] // PAR_RANKS
    res["dp_encoder_rows_bitwise"] = [bool(torch.equal(enc_dp[r * per:(r + 1) * per],
                                                       enc8[r * per:(r + 1) * per]))
                                      for r in range(PAR_RANKS)]
    mine = enc8[rank * per:(rank + 1) * per].contiguous()
    real_encode = W.encode
    W.encode = lambda params, dims_, mel, remat=False: mine
    try:
        _par_counts(reset=True)
        held = model.generate(feats8, **kw)
        res["held_counts"] = _par_counts()
    finally:
        W.encode = real_encode
    res["held_tokens_equal"] = bool(np.array_equal(held.sequences, pay["seq8"])
                                    and np.array_equal(held.lengths, pay["len8"]))
    log(f"rank {rank} (a): {res}")
    require(res["held_tokens_equal"], f"rank {rank}: the DP=2 decode on the single-process "
            "encoder rows differs from the single-process B=8 decode")
    require(res["dp_counts"]["attention"] > 0, f"rank {rank}: K1 never launched under DP=2")
    for k in ("megastep", "head_rows", "verify_rows", "logits"):
        require(res["held_counts"][k] > 0, f"rank {rank}: {k} never launched under DP=2")

    # (b) TP=2: a B=1 request on each rank's heads and FFN columns (the
    # per-op step, K2 never), beside the single-process request, and one
    # per-op step's hidden rows beside the single-process per-op step's.
    one = WhisperMedusaModel(model.config, model.params)
    for r in range(PAR_RANKS):
        if r == rank:
            one.generate(feat1, language="en", max_new_tokens=4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single1 = one.generate(feat1, language="en", max_new_tokens=PAR_TP_NEW_TOKENS)
            torch.cuda.synchronize()
            res["single_b1_wall_s"] = time.perf_counter() - t0
        distributed.sync()
    tpm = WhisperMedusaModel(model.config, model.params).shard(dp=1, tp=PAR_RANKS)
    tpm.generate(feat1, language="en", max_new_tokens=4)
    _par_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tp_out = tpm.generate(feat1, language="en", max_new_tokens=PAR_TP_NEW_TOKENS)
    torch.cuda.synchronize()
    res["tp_b1_wall_s"] = time.perf_counter() - t0
    res["tp_counts"] = _par_counts()
    for k in ("attention", "self_decode", "cross_decode", "ffn_decode", "logits"):
        require(res["tp_counts"][k] > 0, f"rank {rank}: {k} never launched under TP=2")
    require(res["tp_counts"]["megastep"] == 0, f"rank {rank}: K2 launched under TP=2")
    n = min(int(tp_out.lengths[0]), int(single1.lengths[0]))
    res["tp_token_share"] = float((tp_out.sequences[0, PROMPT_LEN:n]
                                   == single1.sequences[0, PROMPT_LEN:n]).mean())
    res["tp_new_tokens"] = int(tp_out.lengths[0]) - PROMPT_LEN
    toks = torch.as_tensor(single1.sequences[:, :PROMPT_LEN + 11], device="cuda")
    enc1 = enc8[:1].contiguous()
    with torch.no_grad():
        h_one = _per_op_hidden(model.params, dims, toks, enc1)
        with mesh_mod.use_mesh(tpm.mesh):
            h_tp = _per_op_hidden(tpm.params, dims, toks, enc1)
        with _plain_per_op():
            h_one_plain = _per_op_hidden(model.params, dims, toks, enc1)
            with mesh_mod.use_mesh(tpm.mesh):
                h_tp_plain = _per_op_hidden(tpm.params, dims, toks, enc1)
    res["tp_hidden_cosine"] = cosine(h_tp, h_one)
    res["tp_plain_cosine"] = cosine(h_tp, h_tp_plain)
    res["tp_plain_rel_err"] = rel_err(h_tp, h_tp_plain)
    res["one_plain_cosine"] = cosine(h_one, h_one_plain)
    res["one_plain_rel_err"] = rel_err(h_one, h_one_plain)
    log(f"rank {rank} (b): {res}")
    require(res["tp_plain_cosine"] >= PAR_TP_PLAIN_COS,
            f"rank {rank}: the TP=2 per-op step's hidden rows vs the plain versions on the "
            f"same shards: cosine {res['tp_plain_cosine']}")
    del tpm, model, one, enc_dp
    torch.cuda.empty_cache()

    # (c) DDP=2: one Medusa-Linear recipe step (base_head + all_but_last,
    # Adafactor at lr 1e-3) at the global batch of TRAIN_B, each rank on
    # its row, against the single-process step on both rows.
    cfg_t = _train_config("base_head", "bfloat16")
    feats2, labels = _train_batch(pay["feats8"][:TRAIN_B].cuda(), SEED + 7)
    params = bridge.from_random(cfg_t, seed=SEED, device="cuda")
    opt = TT.make_optimizer("adafactor", lr=1e-3, warmup_steps=0, schedule="constant")
    heads0 = {k: v.clone() for k, v in bridge.flatten(params["medusa"]).items()}
    labels_t = torch.as_tensor(labels)
    heads_of = lambda grads: {k[len("medusa/"):]: v for k, v in grads.items()
                              if k.startswith("medusa/")}
    if rank == 0:
        p1 = bridge._unflatten({k: v.clone() for k, v in bridge.flatten(params).items()})
        g1 = heads_of(TT.masked_grads(p1, cfg_t, feats2, labels_t, "all_but_last",
                                      remat=False)[1])
        state1 = TT.init_train_state(p1, opt)
        step1 = TT.make_train_step(cfg_t, opt, "all_but_last", remat=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m1 = step1(state1, feats2, labels)
        torch.cuda.synchronize()
        res["single_step_s"] = time.perf_counter() - t0
        single_loss = float(m1["loss"])
        heads1 = {k: v.clone() for k, v in bridge.flatten(p1["medusa"]).items()}
        del state1, p1
        # A fault's reading: the update from rank 0's row alone.
        p0 = bridge._unflatten({k: v.clone() for k, v in bridge.flatten(params).items()})
        _, m0 = step1(TT.init_train_state(p0, opt), feats2[:1], labels[:1])
        heads_row0 = {k: v.clone() for k, v in bridge.flatten(p0["medusa"]).items()}
        del p0
    distributed.sync()
    mesh = mesh_mod.make_mesh(PAR_RANKS, dp=PAR_RANKS, tp=1)
    state = TT.init_train_state(params, opt)
    step = TT.make_train_step(cfg_t, opt, "all_but_last", remat=False, mesh=mesh)
    rows = lambda x: distributed.local_rows(x, mesh.data_index, mesh.dp)
    gd = heads_of(TT.masked_grads(params, cfg_t, rows(feats2), rows(labels_t), "all_but_last",
                                  remat=False, mesh=mesh)[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = step(state, rows(feats2), rows(labels_t))
    torch.cuda.synchronize()
    res["ddp_step_s"] = time.perf_counter() - t0
    res["ddp_loss"] = float(m["loss"])
    digests = distributed.all_gather_objects(_digests(params["medusa"]), mesh.data_group)
    res["heads_equal_across_ranks"] = all(x == digests[0] for x in digests)
    require(res["heads_equal_across_ranks"], f"rank {rank}: the updated heads differ "
            "between the ranks")
    if rank == 0:
        res["single_loss"] = single_loss
        res["loss_rel_err"] = abs(res["ddp_loss"] - single_loss) / abs(single_loss)
        heads = bridge.flatten(params["medusa"])
        res["head_grad_rel_err"] = {k: rel_err(gd[k], g1[k]) for k in g1}
        res["head_elem_ulps"] = {k: float(_bf16_ulps(v, heads1[k]).max())
                                 for k, v in heads.items()}
        res["head_elem_over_1ulp"] = {k: int((_bf16_ulps(v, heads1[k]) > 1).sum())
                                      for k, v in heads.items()}
        res["head_leaf_ulps"] = {k: float(_leaf_ulps(v, heads1[k])) for k, v in heads.items()}
        res["head_update_rel_err"] = {k: rel_err(v.float() - heads0[k].float(),
                                                 heads1[k].float() - heads0[k].float())
                                      for k, v in heads.items()}
        res["head_update_rel_err_fault"] = {
            k: rel_err(heads_row0[k].float() - heads0[k].float(),
                       heads1[k].float() - heads0[k].float()) for k in heads}
        res["heads_moved"] = {k: int((v != heads0[k]).sum()) for k, v in heads.items()}
        log(f"rank 0 (c): loss {res['ddp_loss']} vs {single_loss}; {res}")
        require(res["loss_rel_err"] <= PAR_TRAIN_LOSS_RTOL,
                f"DDP loss {res['ddp_loss']} vs single {single_loss}")
        require(max(res["head_grad_rel_err"].values()) <= PAR_GRAD_RTOL,
                f"DDP head gradients vs single step: {res['head_grad_rel_err']}")
        require(max(res["head_update_rel_err"].values()) <= PAR_UPDATE_RTOL,
                f"DDP heads' update vs single step: {res['head_update_rel_err']}")
    distributed.sync()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.shutdown()


def check_native_audio():
    """(d) The native reader (``data/native.py``, g++ onto native/audio_io.cpp)
    against the plain readers on a WAV and a FLAC written here."""
    import tempfile
    import wave

    from tests.flac_encoder import encode_flac
    from whisper_medusa_tpu_torch.data import audio, native

    x = np.clip(np.cumsum(np.random.default_rng(SEED).integers(-300, 301, 48000)),
                -30000, 30000).astype(np.int64)
    with tempfile.TemporaryDirectory() as d:
        wav, flac = os.path.join(d, "a.wav"), os.path.join(d, "a.flac")
        with wave.open(wav, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(x.astype(np.int16).tobytes())
        with open(flac, "wb") as f:
            f.write(encode_flac(x, 16000, block_size=4096, mode="lpc"))
        t0 = time.perf_counter()
        got = [native.load_audio(p) for p in (wav, flac)]
        native_s = time.perf_counter() - t0
        plain = [audio.load_audio_plain(p) for p in (wav, flac)]
    errs = [float(np.abs(a - b).max()) for (a, _), (b, _) in zip(got, plain)]
    log(f"(d) native reader: WAV and FLAC ({len(x)} samples) max |native - plain| "
        f"{errs[0]:.3e}, {errs[1]:.3e}; {native_s * 1e3:.1f} ms for both (and the library's "
        "build where no earlier phase read audio)")
    require(all(len(a) == len(b) == len(x) and sa == sb == 16000 and e <= 1e-7
                for (a, sa), (b, sb), e in zip(got, plain, errs)), "native reader")


# The chunks the TP=2 request of phase 8 (b) gives K10 and K11 at B=1: the
# prompt at offset 0, the Medusa chain (11 rows) and one row, later on.
TP_SHARD_STEPS = ((PROMPT_LEN, 0), (11, 40), (1, 52))


def check_tp_shard_kernels():
    """K10 (cross and mask modes) and K11 against their plain versions at
    the shapes of one TP=2 rank of large-v2: 10 of the 20 heads (cross K/V
    of 1500 keys, self slabs of SELF_MAX_LEN rows), fc1 / fc2 over 2560 of
    the 5120 FFN columns with a zero fc2 bias (the bias is added once,
    after the all-reduce), at TP_SHARD_STEPS; elementwise within the
    tolerances of check_cross_decode / check_self_decode (1e-2 + 1e-2 |x|)
    and check_ffn_decode (2e-2 + 2e-2 |x|)."""
    from whisper_medusa_tpu_torch.ops import decode_ops as DO

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 11)
    h, d, f = 20 // PAR_RANKS, 1280, 5120 // PAR_RANKS
    rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=g, device="cuda")
                                     * scale).to(torch.bfloat16)
    w1, b1, w2 = rnd(d, f, scale=0.02), rnd(f, scale=0.02), rnd(f, d, scale=0.02)
    b2 = torch.zeros((d,), dtype=torch.bfloat16, device="cuda")
    errs = []
    for t, off in TP_SHARD_STEPS:
        q, k, v, _, _ = _cross_inputs(g, 1, t, 1500, False, h=h)
        got = DO.cross_attention_decode_kernel(q, k, v, 1500)
        ref = DO.cross_attention_decode_plain(q, k, v, 1500)
        require(got.shape == ref.shape and close(got, ref, 1e-2),
                f"K10 cross (1,{h},{t},64) x 1500: err {max_err(got, ref)}")
        errs.append(("cross", t, max_err(got, ref)))
        q = rnd(1, t, h, 64, scale=0.125)
        k, v = rnd(1, SELF_MAX_LEN, h * 64), rnd(1, SELF_MAX_LEN, h * 64)
        offs = torch.tensor([off], dtype=torch.int32, device="cuda")
        got = DO.self_attention_decode_kernel(q, k, v, offs, DO.chunk_bits(None, t, "cuda"))
        ref = DO.self_attention_decode_plain(q, k, v, offs)
        require(got.shape == ref.shape and close(got, ref, 1e-2),
                f"K10 mask mode (1,{t},{h},64) offset {off}: err {max_err(got, ref)}")
        errs.append(("mask", t, max_err(got, ref)))
        x = rnd(t, d)
        got = DO.ffn_decode_kernel(x, w1, b1, w2, b2)
        ref = DO.ffn_decode_plain(x, w1, b1, w2, b2)
        require(got.shape == ref.shape and close(got, ref, 2e-2),
                f"K11 M={t} D={d} F={f}, zero fc2 bias: err {max_err(got, ref)}")
        errs.append(("ffn", t, max_err(got, ref)))
    log(f"(8) the TP=2 shard shapes (H={h}, F={f}, zero fc2 bias), max_abs_err against the "
        f"plain versions: " + ", ".join(f"{n} T={t} {e:.3e}" for n, t, e in errs))


def phase_parallel(ref):
    """Phase 8: two ranks on the one card under gloo (NCCL refuses two ranks
    on a device), each a fresh process running :func:`parallel_rank_main`;
    then (d) the native reader here.  First, here, K10 and K11 at the shapes
    of a TP=2 rank (:func:`check_tp_shard_kernels`).  ``ref``: main()'s B=8
    features, its encoder rows, its B=8 decode and a checksum of its
    weights."""
    import shutil
    import socket
    import tempfile

    check_tp_shard_kernels()
    d = tempfile.mkdtemp(prefix="wm_par_")
    torch.save(ref, os.path.join(d, "payload.pt"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = []
    for r in range(PAR_RANKS):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(PAR_RANKS), RANK=str(r), LOCAL_RANK="0", WM_PAR_DIR=d)
        with open(os.path.join(d, f"log{r}.txt"), "w") as logf:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                           "--parallel-rank"], env=env, stdout=logf,
                                          stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(PAR_TIMEOUT_S - (time.perf_counter() - t0), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(d, f"log{r}.txt")) as f:
                log(f"--- rank {r} (exit {p.returncode}) ---\n{f.read()[-6000:]}")
    require(all(p.returncode == 0 for p in procs), "a phase-8 rank failed")
    res = []
    for r in range(PAR_RANKS):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            res.append(json.load(f))
    shutil.rmtree(d)
    r0 = res[0]
    log(f"(8) two ranks on one card, gloo: {wall:.1f} s of phase wall, model build "
        f"{r0['model_s']:.1f} s a rank; {SMI}")
    log(f"(a) DP=2 B={BATCH} (4 + 4 examples): wall per rank "
        f"{[round(x['dp_b8_wall_s'] * 1e3, 1) for x in res]} ms against "
        f"the single-process B={BATCH} call's {r0['single_b8_wall_s'] * 1e3:.1f} ms on rank 0 "
        f"(single-process tokens equal main()'s: {r0['single_b8_equals_parent']}); end-to-end "
        f"tokens equal the single-process decode: {r0['dp_e2e_tokens_equal']} (printed: each "
        f"rank's encoder rows bitwise the single-process rows: "
        f"{r0['dp_encoder_rows_bitwise']}); decode on the single-process encoder rows equal "
        f"to the single-process B={BATCH} decode on every rank: "
        f"{[x['held_tokens_equal'] for x in res]} (held); launches per rank "
        f"{[x['held_counts'] for x in res]}; {SMI}")
    log(f"(b) TP=2 B=1 request, {r0['tp_new_tokens']} new tokens: wall per rank "
        f"{[round(x['tp_b1_wall_s'] * 1e3, 1) for x in res]} ms against the single-process "
        f"B=1 request's {[round(x['single_b1_wall_s'] * 1e3, 1) for x in res]} ms (each rank "
        f"alone on the card); token share against the single-process request "
        f"{r0['tp_token_share']:.3f}, one per-op step's hidden cosine against the "
        f"single-process per-op step {r0['tp_hidden_cosine']:.6f} (printed, not held); the "
        f"same step against the plain versions on the same shards: cosine per rank "
        f"{[x['tp_plain_cosine'] for x in res]} (held >= {PAR_TP_PLAIN_COS}), rel err "
        f"{[x['tp_plain_rel_err'] for x in res]}; single-process kernels against plain "
        f"cosine {r0['one_plain_cosine']}, rel err {r0['one_plain_rel_err']}; "
        f"launches per rank {[x['tp_counts'] for x in res]}; {SMI}")
    log(f"(c) DDP=2 Medusa-Linear recipe step (base_head + all_but_last, B={TRAIN_B}, "
        f"T={TRAIN_T}, Adafactor): loss {r0['ddp_loss']:.6f} against the single-process "
        f"{r0['single_loss']:.6f} (rel err {r0['loss_rel_err']:.2e}, held <= "
        f"{PAR_TRAIN_LOSS_RTOL}); heads' gradient rel err {r0['head_grad_rel_err']} (held <= "
        f"{PAR_GRAD_RTOL}); the heads' update rel err {r0['head_update_rel_err']} (held <= "
        f"{PAR_UPDATE_RTOL}; rank 0's row alone, a step that never reduced its gradients: "
        f"{r0['head_update_rel_err_fault']}); updated heads bitwise equal across the ranks: "
        f"{[x['heads_equal_across_ranks'] for x in res]} (held); printed: "
        f"largest weight distance {r0['head_leaf_ulps']} bf16 ulps of the leaf's "
        f"largest magnitude, elementwise {r0['head_elem_ulps']} ulps "
        f"({r0['head_elem_over_1ulp']} elements past one); moved: {r0['heads_moved']}; "
        f"step per rank {[round(x['ddp_step_s'] * 1e3, 1) for x in res]} ms against the "
        f"single-process "
        f"{r0['single_step_s'] * 1e3:.1f} ms; {SMI}")
    check_native_audio()


def main_parallel_only():
    """``chip_smoke.py --parallel-only``: phase 8 alone, on main()'s model,
    features and B=8 decode rebuilt here (about two minutes)."""
    phase_env()
    phase_build()
    from whisper_medusa_tpu_torch.data.tokenizer import CharTokenizer
    from whisper_medusa_tpu_torch.processor import WhisperMedusaProcessor

    model = _par_model()
    proc = WhisperMedusaProcessor(tokenizer=CharTokenizer())
    feat1 = proc(waveforms((8.0,))[0])
    feats8 = proc(waveforms(tuple(float(s) for s in np.linspace(4.0, 30.0, BATCH))))
    enc8 = model.encode(feats8)
    out8 = model.generate(feats8, language="en", max_new_tokens=MAX_NEW_TOKENS)
    ref = {"feats8": feats8.cpu(), "feat1": feat1.cpu(), "enc8": enc8.cpu(),
           "seq8": out8.sequences, "len8": out8.lengths, "checksum": _par_checksum(model)}
    del model, enc8
    torch.cuda.empty_cache()
    phase_parallel(ref)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


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
    # Trees of at most 16 nodes decode through K2 with their ancestor mask.
    trees = k2_tree_masks()
    err2 = max(err2, *(check_megastep_2layer(g, t, offs, chunk_mask=trees[t])
                       for t, offs in K2_TREE_STEPS))
    err2q = max(err2q, *(check_megastep_2layer_int8(g, t, offs, chunk_mask=trees[t])
                         for t, offs in K2_TREE_STEPS))
    err2b = max(err2b, *(check_megastep_2layer(g, t, offs, block=True, chunk_mask=trees[t])
                         for t, offs in K2_TREE_STEPS))
    err2bq = max(err2bq, *(check_megastep_2layer_int8(g, t, offs, block=True,
                                                      chunk_mask=trees[t])
                           for t, offs in K2_TREE_STEPS))
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
    k4ts = check_verify_ts(g, model)
    k4tsq = check_verify_ts(g, qmodel)
    check_verify_ts(g, bmodel, identity0=True)
    check_verify_ts(g, bqmodel, identity0=True)
    k5ts = check_verify_rows_ts(g, model)
    k5tsq = check_verify_rows_ts(g, qmodel)
    k4w, k4wq = check_verify_wide(g, model, "bf16"), check_verify_wide(g, qmodel, "int8")

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
    k10w = check_self_decode_wide(g)
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
               k8, k2b, k2bq, k4b, k4bq, k10, k10q, k10m, k10w, k11, k4ts, k4tsq, k5ts, k5tsq,
               k4w, k4wq]

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
    t0 = time.perf_counter()
    phase_ts_requests(model, qmodel, bmodel, kernels, feats[0], feats8)
    phase_longform(model, kernels, k2)
    check_pieced_prefill(model, enc1, k2)
    log(f"timestamps and longform phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_hook_requests(model, qmodel, kernels, feats[0], feats8, outs, qouts)
    phase_beam_requests(model, qmodel, kernels, feats[0], feats8)
    log(f"hook and beam phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_tree_requests(model, qmodel, bmodel, kernels, feats[0], feats8)
    phase_sampled_requests(model, qmodel, kernels, feats[0], feats8)
    phase_ladder_requests(model, kernels, feats8, outs[f"medusa B={BATCH}"])
    log(f"tree, sampling and ladder phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_capture_requests(model, bmodel, kernels, feats[0], feats8)
    log(f"capture phase: {time.perf_counter() - t0:.1f} s")
    phase_eval_cli(model, kernels)
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

    # ---- phase 4 at whisper tiny (d_model 384): K2 at B <= 8, the per-op step past it
    tiny = tiny_models()
    kernels += [check_ffn_decode(g, d=TINY_D, f=4 * TINY_D, timed_m=16,
                                 name="ffn_decode d384"),
                check_head_rows(g, tiny[0], name="head_rows d384"),
                check_verify(g, tiny[0], name="verify d384")]
    check_head_invariance(g, tiny[1], "head_rows_int8 d384")
    check_verify_wide(g, tiny[0], "bf16 d384")
    tenc8 = tiny[0].encode(feats8)
    kernels += check_megastep_d384(g, tiny, tiny[0].encode(feats[0]), tenc8)
    check_step_invariance(tiny[0], tenc8, "tiny bf16")
    phase_tiny_requests(tiny, kernels, feats, feats8)
    phase_p4_requests(tiny[0], kernels, feats[0], P4_TINY_RUNS)
    report_scope_ab(model, tiny[0], feats[0], feats8)
    for k in kernels:
        if k["name"] in TINY_ROWS:
            log(f"launches {k['name']} (whisper tiny paths): {k['launches']}")
    del tiny

    # ---- phase 6b: f32 serving, its model alone on the card
    check_grad_guard(model.params)
    par_ref = {"feats8": feats8.cpu(), "feat1": feats[0].cpu(), "enc8": enc8.cpu(),
               "seq8": outs[f"medusa B={BATCH}"].sequences,
               "len8": outs[f"medusa B={BATCH}"].lengths, "checksum": _par_checksum(model)}
    del model, qmodel, bmodel, bqmodel, outs, qouts, bouts, bqouts, outs16, enc1, enc8, enc16
    torch.cuda.empty_cache()
    phase_f32(g, kernels, feats, feats8)

    # ---- phase 7: training (K9), on fresh models after the serving ones go
    kernels += check_attention_bwd(g)
    kernels += check_attention_bwd_f32(g)
    for dtype in ("bfloat16", "float32"):
        for variant, policy in (("medusa_block", "whisper"), ("base_head", "all_but_last")):
            check_train_2layer(variant, policy, feats[0], dtype)
    for dtype in ("float32", "bfloat16"):
        for run in TRAIN_RUNS:
            train_run(kernels, *run, feats8[:TRAIN_B], dtype)
            torch.cuda.empty_cache()
    check_remat_dots(kernels, feats8[:TRAIN_B])
    torch.cuda.empty_cache()
    check_cli()
    t0 = time.perf_counter()
    phase_parallel(par_ref)
    log(f"parallel phase: {time.perf_counter() - t0:.1f} s")
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
    if sys.argv[1:] == ["--parallel-rank"]:
        parallel_rank_main()
    elif sys.argv[1:] == ["--parallel-only"]:
        main_parallel_only()
    else:
        main()
