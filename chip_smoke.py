#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU (needs torch with CUDA and nvcc).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  1. versions, and the card's name and power limit from nvidia-smi;
  2. build the four Hopper kernels from whisper_medusa_tpu_torch/csrc;
  3. hold each kernel against its plain PyTorch version at the shapes the
     greedy base_head decode path gives it (bf16), and time both with CUDA
     events (3 warm-ups, median of 20);
  4. the main path at full whisper-large-v2 width with random bf16 weights:
     WhisperMedusaProcessor on three seeded synthetic waveforms, then
     ``generate(features, language="en", max_new_tokens=128)`` for each, with
     every kernel's launch counter read around the three requests; a full
     32-layer decode step is also checked against the plain layer loop;
  5. the output is unchanged when every draft is corrupted.

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


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def cosine(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.float().reshape(1, -1), b.float().reshape(1, -1)))


def rel_err(a, b):
    """||a - b|| / ||b|| (Frobenius)."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def close(a, b, tol):
    """Elementwise |a - b| <= tol + tol * |b| (numpy's allclose at rtol = atol)."""
    return bool(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol))


def require(cond, what):
    if not cond:
        raise AssertionError(what)


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from whisper_medusa_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.lib()
    log(f"build + load: {time.perf_counter() - t0:.1f} s -> {cuda_lib.BUILD_DIR}")


def check_attention(g):
    from whisper_medusa_tpu_torch.ops import attention as A

    dev = "cuda"
    # Off-path coverage first: causal, ragged kv_len, rectangular tail.
    q, k, v = (torch.randn((1, 4, 300, 64), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    q = (q.float() * 0.25).to(torch.bfloat16)
    for causal, kv_len in ((True, 300), (False, 257)):
        err = max_err(A.attention_kernel(q, k, v, kv_len, causal),
                      A.attention_plain(q, k, v, kv_len, causal))
        require(err <= 2e-2, f"K1 causal={causal} kv_len={kv_len}: err {err}")
    # Main-path shape: encoder self-attention, (1, 20, 1500, 64), unpadded.
    q, k, v = (torch.randn((1, 20, 1500, 64), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    q = (q.float() * 0.25).to(torch.bfloat16)
    got = A.attention_kernel(q, k, v, 1500, False)
    ref = A.attention_plain(q, k, v, 1500, False)
    err = max_err(got, ref)
    log(f"K1 attention (1,20,1500,64): max_abs_err {err:.3e}")
    require(err <= 2e-2, f"K1 err {err} > 2e-2")
    ms = cuda_ms(lambda: A.attention_kernel(q, k, v, 1500, False))
    plain_ms = cuda_ms(lambda: A.attention_plain(q, k, v, 1500, False))
    return dict(name="attention", source="whisper_medusa_tpu_torch/csrc/attention.cu",
                replaces="whisper_medusa_tpu/ops/attention.py:71",
                module=A, max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_megastep_2layer(g, t, off):
    from whisper_medusa_tpu.config import WhisperDims
    from whisper_medusa_tpu_torch.ops import megastep as MS

    dev = "cuda"
    dims = WhisperDims(decoder_layers=2)
    d, f, h, s_enc = dims.d_model, dims.decoder_ffn_dim, 20, 1500

    def rnd(*shape, scale=0.02):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    def attn():
        return {"q_w": rnd(2, d, d), "q_b": rnd(2, d), "k_w": rnd(2, d, d),
                "v_w": rnd(2, d, d), "v_b": rnd(2, d), "o_w": rnd(2, d, d),
                "o_b": rnd(2, d)}

    def ln():
        return {"scale": (1 + rnd(2, d, scale=0.1).float()).to(torch.bfloat16),
                "bias": rnd(2, d, scale=0.1)}

    layers = {"self_ln": ln(), "self": attn(), "cross_ln": ln(), "cross": attn(),
              "ffn_ln": ln(), "fc1_w": rnd(2, d, f), "fc1_b": rnd(2, f),
              "fc2_w": rnd(2, f, d), "fc2_b": rnd(2, d)}
    s_len = 460
    self_k = rnd(2, 1, s_len, d, scale=1.0)
    self_v = rnd(2, 1, s_len, d, scale=1.0)
    cross_k = rnd(2, 1, h, 64, s_enc, scale=1.0)
    cross_v = rnd(2, 1, s_enc, d, scale=1.0)
    x = rnd(1, t, d, scale=1.0)
    offsets = torch.full((1,), off, dtype=torch.int32, device=dev)
    sk2, sv2 = self_k.clone(), self_v.clone()
    got = MS.megastep_kernel(layers, x, self_k, self_v, cross_k, cross_v, offsets,
                             None, s_enc, h)
    ref = MS.megastep_plain(layers, x, sk2, sv2, cross_k, cross_v, offsets, None,
                            s_enc, h)
    err = max_err(got, ref)
    rows = slice(off, off + t)
    cerr = max(max_err(self_k[:, :, rows], sk2[:, :, rows]),
               max_err(self_v[:, :, rows], sv2[:, :, rows]))
    untouched = (torch.equal(self_k[:, :, :off], sk2[:, :, :off])
                 and torch.equal(self_k[:, :, off + t:], sk2[:, :, off + t:]))
    log(f"K2 megastep 2-layer T={t} off={off}: pre_norm err {err:.3e}, "
        f"written rows err {cerr:.3e}, other rows equal {untouched}")
    ok = (close(got, ref, 3e-2) and close(self_k[:, :, rows], sk2[:, :, rows], 3e-2)
          and close(self_v[:, :, rows], sv2[:, :, rows], 3e-2))
    require(ok and untouched,
            f"K2 2-layer T={t}: err {err}, rows {cerr}, untouched {untouched}")
    return err


def check_logits(g, embed):
    from whisper_medusa_tpu_torch.ops import logits as LG

    out = {}
    for m in (1, 10):
        x = torch.randn((m, embed.shape[1]), generator=g, device="cuda").to(torch.bfloat16)
        got = LG.project_kernel(x, embed)
        ref = LG.project_plain(x, embed)
        err = max_err(got, ref)
        bound = 1e-3 * float(ref.abs().max())
        log(f"K3 logits M={m}: max_abs_err {err:.3e} (bound {bound:.3e})")
        require(err <= bound, f"K3 M={m}: err {err} > {bound}")
        out[m] = (x, err)
    x10, err10 = out[10]
    ms = cuda_ms(lambda: LG.project_kernel(x10, embed))
    plain_ms = cuda_ms(lambda: LG.project_plain(x10, embed))
    return dict(name="logits", source="whisper_medusa_tpu_torch/csrc/logits.cu",
                replaces="whisper_medusa_tpu/ops/logits.py:55", module=LG,
                max_abs_err=max(out[1][1], err10), ms=ms, plain_ms=plain_ms)


def check_verify(g, model):
    from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig
    from whisper_medusa_tpu_torch.ops import verify as VF

    dev = "cuda"
    embed = model.params["whisper"]["decoder"]["embed_tokens"]
    heads = model.params["medusa"]["heads"]
    hw, hb = heads["w"][:, 0], heads["b"][:, 0]
    n_nodes, kp1, d = 11, 11, embed.shape[1]
    hid = torch.randn((1, n_nodes, d), generator=g, device=dev).to(torch.bfloat16)
    st = model.special
    pcfg = ProcessorConfig(vocab_size=embed.shape[0],
                           suppress_tokens=model.generation_config.suppress_tokens,
                           begin_suppress_tokens=model.generation_config.begin_suppress_tokens,
                           begin_index=4, exponential_decay_length_penalty=(9, 1.2),
                           eos_token_id=st.eos)
    masks = VF.masks_for(pcfg, dev)
    cur_len = 5
    pos = (cur_len + torch.arange(n_nodes, device=dev)[None, :]
           + torch.arange(kp1, device=dev)[:, None]).reshape(-1).to(torch.int32)
    gcol = torch.randint(0, embed.shape[0], (kp1 * n_nodes,), generator=g,
                         device=dev).to(torch.int32)
    gcol[:n_nodes] = st.eos
    kw = dict(identity0=False, begin_index=4, eos_id=st.eos, decay=(9, 1.2))
    am, mx, lse, gth = VF.verify_hidden_kernel(hid, hid, hw, hb, embed, pos, gcol,
                                               masks, **kw)
    ram, rmx, rlse, rgth = VF.verify_hidden_plain(hid, hid, hw, hb, embed, pos, gcol,
                                                  masks, **kw)
    rows = VF.build_rows(hid, hid, hw, hb, False)
    proc = VF.process_rows(rows.float() @ embed.float().T, pos, masks,
                           begin_index=4, eos_id=st.eos, decay=(9, 1.2))
    top2 = proc.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-2
    arg_ok = bool(torch.equal(am[clear], ram[clear]))
    err = max(max_err(mx, rmx), max_err(lse, rlse), max_err(gth, rgth))
    log(f"K4 verify_hidden R={kp1 * n_nodes}: argmax equal on {int(clear.sum())} "
        f"clear rows: {arg_ok}; max/lse/gathered max_abs_err {err:.3e}")
    require(arg_ok and err <= 1e-2, f"K4: argmax {arg_ok}, err {err}")
    ms = cuda_ms(lambda: VF.verify_hidden_kernel(hid, hid, hw, hb, embed, pos, gcol,
                                                 masks, **kw))
    plain_ms = cuda_ms(lambda: VF.verify_hidden_plain(hid, hid, hw, hb, embed, pos,
                                                      gcol, masks, **kw))
    return dict(name="verify_hidden", source="whisper_medusa_tpu_torch/csrc/verify.cu",
                replaces="whisper_medusa_tpu/ops/verify.py:309", module=VF,
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_megastep_full(model, feats, err2):
    """The full 32-layer step (prefill T=4, then the T=11 chain) against the
    plain layer loop on copies of one cache."""
    from whisper_medusa_tpu_torch.models import whisper
    from whisper_medusa_tpu_torch.ops import megastep as MS

    p = model.params["whisper"]
    dims = model.config.dims
    dec = p["decoder"]
    enc = model.encode(feats)
    # The longest cache generate() builds (max_length 448 + 12 rows): its
    # self-attention scores and V rows need more than 48 KB of shared memory.
    cache = whisper.init_cache(p, dims, enc, dims.max_target_positions + 12)
    nh = dims.decoder_attention_heads
    st = model.special
    worst_cos, worst_rows = 1.0, 0.0
    for t, off in ((4, 0), (11, 4)):
        toks = (torch.tensor([[st.sot, st.first_language, st.transcribe, st.no_timestamps]])
                if t == 4 else torch.arange(100, 100 + t)[None]).to("cuda", torch.int32)
        offsets = torch.full((1,), off, dtype=torch.int32, device="cuda")
        pos = (offsets[:, None] + torch.arange(t, device="cuda")[None]).long()
        x = dec["embed_tokens"][toks.long()] + dec["pos_embed"][pos]
        sk, sv = cache.self_k.clone(), cache.self_v.clone()
        got = MS.megastep_kernel(dec["layers"], x, cache.self_k, cache.self_v,
                                 cache.cross_k, cache.cross_v, offsets, None,
                                 dims.max_source_positions, nh)
        ref = MS.megastep_plain(dec["layers"], x, sk, sv, cache.cross_k,
                                cache.cross_v, offsets, None,
                                dims.max_source_positions, nh)
        # An f32 run of the same step (weights, cache and input upcast): how far
        # each bf16 path lies from it.
        f32 = lambda tree: {k: f32(v) if isinstance(v, dict) else v.float()
                            for k, v in tree.items()}
        ref32 = MS.megastep_plain(f32(dec["layers"]), x.float(), sk.float(),
                                  sv.float(), cache.cross_k.float(),
                                  cache.cross_v.float(), offsets, None,
                                  dims.max_source_positions, nh)
        cos = cosine(got, ref)
        ln = lambda h: whisper.layer_norm(h, dec["ln_post"]["scale"], dec["ln_post"]["bias"])
        lg_k = whisper.project_logits(p, ln(got))
        lg_p = whisper.project_logits(p, ln(ref))
        top2 = lg_p.float().topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 5e-2
        arg_ok = bool(torch.equal(lg_k.argmax(-1)[clear], lg_p.argmax(-1)[clear]))
        rows = slice(off, off + t)
        # Written rows per layer, as a relative Frobenius error: over 32
        # layers bf16 rounding differences compound (the 2-layer check above
        # holds the elementwise bound), so the deep stack is held to a norm.
        per_layer = [max(rel_err(cache.self_k[i, :, rows], sk[i, :, rows]),
                         rel_err(cache.self_v[i, :, rows], sv[i, :, rows]))
                     for i in range(dims.decoder_layers)]
        rerr = max(per_layer)
        aerr = max(max_err(cache.self_k[:, :, rows], sk[:, :, rows]),
                   max_err(cache.self_v[:, :, rows], sv[:, :, rows]))
        log(f"K2 megastep 32-layer T={t} off={off}: pre_norm cosine {cos:.6f} "
            f"(kernel vs f32 {cosine(got, ref32):.6f}, plain bf16 vs f32 "
            f"{cosine(ref, ref32):.6f}); argmax equal on {int(clear.sum())}/{t} rows "
            f"with top-2 gap > 5e-2: {arg_ok}; written rows relative error by "
            f"layer 0/1/4/16/31: " + " ".join(f"{per_layer[i]:.2e}" for i in
                                              (0, 1, 4, 16, 31))
            + f", max_abs_err {aerr:.3e}")
        require(cos >= 0.999 and arg_ok and rerr <= 3e-2,
                f"K2 32-layer T={t}: cos {cos}, argmax {arg_ok}, rows {rerr}")
        worst_cos, worst_rows = min(worst_cos, cos), max(worst_rows, rerr)
        cache.self_k.copy_(sk)      # continue from the plain path's cache
        cache.self_v.copy_(sv)
    t, off = 11, 4
    toks = torch.arange(100, 111, device="cuda", dtype=torch.int32)[None]
    offsets = torch.full((1,), off, dtype=torch.int32, device="cuda")
    x = dec["embed_tokens"][toks.long()] + dec["pos_embed"][
        (off + torch.arange(t, device="cuda"))[None]]
    args = (dec["layers"], x, cache.self_k, cache.self_v, cache.cross_k, cache.cross_v,
            offsets, None, dims.max_source_positions, nh)
    ms = cuda_ms(lambda: MS.megastep_kernel(*args))
    plain_ms = cuda_ms(lambda: MS.megastep_plain(*args))
    return dict(name="megastep", source="whisper_medusa_tpu_torch/csrc/megastep.cu",
                replaces="whisper_medusa_tpu/ops/megastep.py:342", module=MS,
                max_abs_err=err2, ms=ms, plain_ms=plain_ms,
                cosine_32_layers=worst_cos, cache_rows_err_32_layers=worst_rows)


def waveforms(n=3):
    rng = np.random.default_rng(SEED)
    out = []
    for i, secs in enumerate((8.0, 17.5, 29.0)[:n]):
        t = np.arange(int(secs * 16000)) / 16000.0
        f0 = 110.0 * (i + 1) * (1 + 0.1 * np.sin(2 * np.pi * 0.5 * t))
        wave = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 16000.0)
        wave += 0.05 * rng.standard_normal(t.shape)
        out.append(wave.astype(np.float32))
    return out


def main():
    smi = phase_env()
    phase_build()
    from whisper_medusa_tpu.config import MedusaConfig, ModelConfig, WHISPER_PRESETS
    from whisper_medusa_tpu.data.tokenizer import CharTokenizer
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel
    from whisper_medusa_tpu_torch.processor import WhisperMedusaProcessor

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)

    # ---- phase 3: kernels vs plain versions
    k1 = check_attention(g)
    err2 = max(check_megastep_2layer(g, t, off) for t, off in ((4, 0), (11, 7)))
    cfg = ModelConfig(dims=WHISPER_PRESETS["large-v2"], medusa=MedusaConfig(),
                      param_dtype="bfloat16", compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = WhisperMedusaModel.from_random(cfg, seed=SEED, device="cuda")
    model.params["medusa"]["heads"]["w"].normal_(0.0, 0.02, generator=g)
    torch.cuda.synchronize()
    log(f"model: whisper-large-v2 + 10 base_head heads, bf16, random (seed {SEED}), "
        f"{time.perf_counter() - t0:.1f} s")
    k3 = check_logits(g, model.params["whisper"]["decoder"]["embed_tokens"])
    k4 = check_verify(g, model)

    proc = WhisperMedusaProcessor(tokenizer=CharTokenizer(), device="cuda")
    waves = waveforms()
    feats = [proc(w) for w in waves]
    for f in feats:
        require(f.shape == (1, 80, 3000) and bool(torch.isfinite(f).all()),
                "processor output")
    k2 = check_megastep_full(model, feats[0], err2)
    kernels = [k1, k2, k3, k4]

    # ---- phase 4: the main path, three requests
    model.generate(feats[0], language="en", max_new_tokens=8)      # warm-up
    for k in kernels:
        k["module"].launches = 0
    outs = []
    for i, f in enumerate(feats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(f, language="en", max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_gen = int(out.lengths[0]) - 4
        require(out.sequences.shape == (1, 4 + MAX_NEW_TOKENS), "sequence shape")
        require(n_gen >= 1 and (out.sequences >= 0).all()
                and (out.sequences < cfg.dims.vocab_size).all(), "token range")
        require(np.isfinite(out.token_logprobs).all()
                and np.isfinite(out.no_speech_probs).all(), "finite outputs")
        log(f"request {i}: {waves[i].shape[0] / 16000:.1f} s audio, {n_gen} tokens, "
            f"{out.steps} steps, mean_accept_length {out.mean_accept_length:.3f}, "
            f"{wall * 1e3:.1f} ms, {n_gen / wall:.1f} tok/s")
        outs.append(out)
    for k in kernels:
        log(f"{k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms")
        k["launches"] = k["module"].launches
        log(f"launches {k['name']}: {k['launches']}")
        require(k["launches"] > 0, f"{k['name']} never launched on the main path")

    # ---- phase 5: invariance under corrupted drafts.  Every draft is wrong, so
    # the loop commits one token per step (vanilla decoding); the finish rule
    # may stop it a few tokens apart, so the common prefix is compared.
    bad = model.generate(feats[0], language="en", max_new_tokens=MAX_NEW_TOKENS,
                         draft_corruption=1.0)
    n = int(min(bad.lengths[0], outs[0].lengths[0]))
    same = np.array_equal(bad.sequences[0, :n], outs[0].sequences[0, :n])
    log(f"draft_corruption=1.0: first {n} tokens identical {same}, steps {bad.steps} "
        f"(clean {outs[0].steps}), accepted {int(bad.accepted.sum())}")
    require(same and bad.steps >= outs[0].steps,
            "tokens changed under draft_corruption=1.0")

    rows = [{"name": k["name"], "route": "cuda", "source": k["source"],
             "replaces": k["replaces"], "launches": k["launches"],
             "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"]}
            for k in kernels]
    log(f"gpu: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
