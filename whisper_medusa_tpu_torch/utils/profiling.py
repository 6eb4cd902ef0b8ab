"""Profiling and timing helpers — the port's counterpart of
whisper_medusa_tpu/utils/profiling.py: a ``torch.profiler`` trace, the
decode-throughput report, and the device time of a chain of K2 decode
steps.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed work (the host, and the card when there is one)
    and write a Chrome / Perfetto trace to ``log_dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def decode_report(new_tokens: int, steps: int, accepted: int,
                  wall_s: float) -> Dict[str, float]:
    """Throughput and acceptance: tokens per second and per step, mean accept
    length (accepted drafts per step), decoder steps, wall-clock seconds."""
    return {
        "tokens_per_second": new_tokens / max(wall_s, 1e-9),
        "tokens_per_step": new_tokens / max(steps, 1),
        "mean_accept_length": accepted / max(steps, 1),
        "decoder_steps": steps,
        "wall_clock_s": wall_s,
    }


def megastep_chain_ms(weights, dims, enc: torch.Tensor, t: int, steps: int = 100,
                      max_len: int = 260) -> float:
    """Device ms a step of ``steps`` back-to-back K2 decode steps
    (``ops/megastep.py::fused_decoder_layers``) of T = ``t`` tokens over a
    fresh cache of ``enc`` (B, S, D) on the card, each step's pre_norm the
    next one's input, offsets 64 + (step % 8); timed with CUDA events after
    one warm-up chain.  ``weights`` is the Whisper tree (bf16, or int8 from
    ``quantize()``); B <= 8, T <= 16 (K2's scope)."""
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep

    if not enc.is_cuda:
        raise ValueError("megastep_chain_ms times K2 on the card: enc must be a CUDA tensor")
    b = enc.shape[0]
    dec = weights["decoder"]
    cache = whisper.init_cache(weights, dims, enc, max_len)
    nh = dims.decoder_attention_heads
    g = torch.Generator(device=enc.device)
    g.manual_seed(0)
    x0 = (0.1 * torch.randn((b, t, dims.d_model), generator=g, device=enc.device)).to(
        enc.dtype)
    mask = torch.ones((t, t), dtype=torch.bool, device=enc.device)
    offs = [torch.full((b,), 64 + i, dtype=torch.int32, device=enc.device) for i in range(8)]

    def chain():
        x = x0
        for i in range(steps):
            x, _, _ = megastep.fused_decoder_layers(
                dec["layers"], dec["ln_post"], x, cache.self_k, cache.self_v, cache.cross_k,
                cache.cross_v, offs[i % 8], mask, min(dims.max_source_positions,
                                                     cache.cross_k.shape[4]), nh,
                cross_k_s=cache.cross_k_s, cross_v_s=cache.cross_v_s, self_s=cache.self_s)

    chain()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    chain()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps
