#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels to account.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; imports nothing of JAX. Phases, any failure exits
non-zero:
  1. build the three CUDA kernels from ``neural_compressor_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version at the llama2-7b shapes
     of the main path, with its time, the plain version's time, one
     PyTorch yardstick call (``library_ms``, never used by the port) and the
     least time the card could take (``bound_ms``);
  3. the kernels at shapes llama2-7b does not give them (GQA, other head
     widths, ragged M and N, group 32, a bias) against their plain
     versions, and a small GQA model's greedy tokens on the card against
     the CPU; then a full-width 2-layer model on the card (kernels)
     against the same weights on the CPU (plain versions): 32-token
     prefill, 8 greedy steps;
  4. llama2-7b at full width and depth, RTN int4 g128 W4A8, answering
     three greedy requests (prompts of 16, 100 and 371 tokens, 48 new
     tokens each, max_len 1024), with exact kernel launch counts;
  5. where the time goes: one prefill and 8 decode steps under
     torch.profiler (wall time, device busy time, top kernels).
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on the main path and its times.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

G = 128
# llama2-7b projections: name -> (K, N); gate_up and qkv are fused
SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096), "gate_up": (4096, 22016),
          "down": (11008, 4096), "lm_head": (4096, 32000)}
LAYERS, HEADS, HEAD_DIM, MAX_LEN = 32, 32, 128, 1024
PROMPTS, NEW_TOKENS = (16, 100, 371), 48
GEMM_MS = (17, 128, 512)
UNIT_M = 128                  # the GEMM row of the kernels line: a 128-token prefill
ATTN_POS = (0, 517, 1023)
UNIT_POS = 517                # the attention row: one decode step at pos 517
TOL = {"gemm": 1e-5, "gemv": 1e-2, "attn": 1e-2}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_peaks(name: str) -> dict:
    """Published dense peaks (NVIDIA data sheets) of the card's variant."""
    if "PCIe" in name:
        return {"bytes_s": 2.0e12, "int8_s": 1513e12, "bf16_s": 756e12,
                "source": "H100 PCIe data sheet"}
    return {"bytes_s": 3.35e12, "int8_s": 1979e12, "bf16_s": 989e12,
            "source": "H100 SXM data sheet"}


def bound(nbytes: float, ops: float, peak_ops: float, peaks: dict):
    t_bytes = nbytes / peaks["bytes_s"] * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_ms(torch, fns, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, cycling through ``fns`` (one
    closure per copy of the operands, so the weights come from device
    memory and not from a warm L2, as in the decode loop)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def n_copies(nbytes: int) -> int:
    return max(2, math.ceil(200e6 / max(nbytes, 1)))


def phase_kernels(torch, nct, peaks: dict) -> dict:
    from neural_compressor_tpu_torch.kernels import (decode_attn,
                                                     decode_attn_plain,
                                                     fused_gemv,
                                                     fused_gemv_plain,
                                                     w4a8_gemm,
                                                     w4a8_gemm_plain)
    from neural_compressor_tpu_torch.ops import (dequantize_packed,
                                                 pack_qtensor,
                                                 quantize_act_per_token,
                                                 quantize_tensor, to_hopper)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {"gemm": [], "gemv": [], "attn": []}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    weights = {}
    for name, (K, N) in SHAPES.items():
        w = randn(K, N, dtype=torch.float32) * K ** -0.5
        pw = to_hopper(pack_qtensor(quantize_tensor(w, bits=4, group_size=G)))
        weights[name] = (pw, dequantize_packed(pw, torch.bfloat16))
        del w

    def wcopies(pw):
        n = n_copies(pw.packed.numel() + pw.scales.numel() * 4)
        return [(pw.packed.clone(), pw.scales.clone()) for _ in range(n)]

    # GEMM: every projection at three prompt lengths
    for name, (K, N) in SHAPES.items():
        pw, wbf = weights[name]
        cps = wcopies(pw)
        for M in GEMM_MS:
            x = randn(M, K)
            xq, xs = quantize_act_per_token(x)
            xs = xs.reshape(-1).contiguous()
            yk = w4a8_gemm(xq, pw.packed, pw.scales, xs)
            yp = w4a8_gemm_plain(xq, pw.packed, pw.scales, xs)
            torch.cuda.synchronize()
            err = float((yk - yp).abs().max())
            ref = float(yp.abs().max())
            ok = math.isfinite(err) and err <= TOL["gemm"] * ref
            ms = timed_ms(torch, [lambda p=p, s=s: w4a8_gemm(xq, p, s, xs)
                                  for p, s in cps], 50)
            pms = timed_ms(torch, [lambda: w4a8_gemm_plain(
                xq, pw.packed, pw.scales, xs)], 5)
            lms = timed_ms(torch, [lambda: torch.matmul(x, wbf)], 50)
            nbytes = M * K + K * N // 2 + (K // G) * N * 4 + M * 4 + M * N * 4
            bms, by = bound(nbytes, 2 * M * N * K, peaks["int8_s"], peaks)
            rows["gemm"].append(dict(shape=name, M=M, K=K, N=N, err=err,
                                     tol=TOL["gemm"] * ref, ok=ok, ms=ms,
                                     plain_ms=pms, library_ms=lms,
                                     bound_ms=bms, bound_by=by))
            print(f"gemm {name:8s} M={M:4d} K={K:5d} N={N:5d} "
                  f"max_abs_err={err:.3e} tol={TOL['gemm'] * ref:.3e} "
                  f"ok={ok} ms={ms:.4f} plain_ms={pms:.4f} "
                  f"library_ms={lms:.4f} bound_ms={bms:.4f} ({by})",
                  flush=True)
        del cps

    # GEMV: the five epilogue forms of the decode step
    forms = {"qkv": dict(rms=True), "o": dict(res=True),
             "gate_up": dict(rms=True, silu=True), "down": dict(res=True),
             "lm_head": dict(rms=True)}
    for name, form in forms.items():
        pw, wbf = weights[name]
        K, N = pw.orig_shape
        silu = form.get("silu", False)
        n_out = N // 2 if silu else N
        x = randn(K)
        rms_w = (1.0 + 0.1 * randn(K, dtype=torch.float32)
                 if form.get("rms") else None)
        res = randn(n_out) if form.get("res") else None
        args = dict(eps=1e-5, silu=silu, out_dtype=torch.bfloat16)
        yk = fused_gemv(x, rms_w, pw.packed, pw.scales, None, res, **args)
        yp = fused_gemv_plain(x, rms_w, pw.packed, pw.scales, None, res, **args)
        torch.cuda.synchronize()
        err = float((yk.float() - yp.float()).abs().max())
        ref = float(yp.float().abs().max())
        ok = math.isfinite(err) and err <= TOL["gemv"] * ref
        cps = wcopies(pw)
        ms = timed_ms(torch, [lambda p=p, s=s: fused_gemv(
            x, rms_w, p, s, None, res, **args) for p, s in cps], 200)
        pms = timed_ms(torch, [lambda: fused_gemv_plain(
            x, rms_w, pw.packed, pw.scales, None, res, **args)], 5)
        x2 = x.reshape(1, K)
        lms = timed_ms(torch, [lambda: torch.matmul(x2, wbf)], 200)
        nbytes = (K * 2 + (K * 4 if rms_w is not None else 0) + K * N // 2
                  + (K // G) * N * 4 + (n_out * 2 if res is not None else 0)
                  + n_out * 2)
        bms, by = bound(nbytes, 2 * K * N, peaks["int8_s"], peaks)
        rows["gemv"].append(dict(shape=name, K=K, N=N, err=err,
                                 tol=TOL["gemv"] * ref, ok=ok, ms=ms,
                                 plain_ms=pms, library_ms=lms, bound_ms=bms,
                                 bound_by=by))
        print(f"gemv {name:8s} {'+'.join(form):9s} K={K:5d} N={N:5d} "
              f"max_abs_err={err:.3e} tol={TOL['gemv'] * ref:.3e} ok={ok} "
              f"ms={ms:.4f} plain_ms={pms:.4f} library_ms={lms:.4f} "
              f"bound_ms={bms:.4f} ({by})", flush=True)
        del cps

    # decode attention: llama2-7b heads over a 1024-row cache
    H = Hkv = HEADS
    D, T = HEAD_DIM, MAX_LEN
    q = randn(1, H, D)
    kv = [(randn(1, Hkv, T, D), randn(1, Hkv, T, D))
          for _ in range(n_copies(2 * Hkv * T * D * 2))]
    k, v = kv[0]
    for pos in ATTN_POS:
        ok_ = decode_attn(q, k, v, pos)
        op = decode_attn_plain(q, k, v, pos)
        torch.cuda.synchronize()
        err = float((ok_.float() - op.float()).abs().max())
        ok = math.isfinite(err) and err <= TOL["attn"]
        L = pos + 1
        ms = timed_ms(torch, [lambda a=a, b=b: decode_attn(q, a, b, pos)
                              for a, b in kv], 200)
        pms = timed_ms(torch, [lambda: decode_attn_plain(q, k, v, pos)], 20)
        q4 = q[:, :, None]
        lms = timed_ms(torch, [
            lambda a=a, b=b: torch.nn.functional.scaled_dot_product_attention(
                q4, a[:, :, :L], b[:, :, :L]) for a, b in kv], 200)
        nbytes = H * D * 2 * 2 + 2 * Hkv * L * D * 2
        bms, by = bound(nbytes, 4 * H * L * D, peaks["bf16_s"], peaks)
        rows["attn"].append(dict(pos=pos, err=err, tol=TOL["attn"], ok=ok,
                                 ms=ms, plain_ms=pms, library_ms=lms,
                                 bound_ms=bms, bound_by=by))
        print(f"attn pos={pos:4d} T={T} H={H} Hkv={Hkv} D={D} "
              f"max_abs_err={err:.3e} tol={TOL['attn']:.1e} ok={ok} "
              f"ms={ms:.4f} plain_ms={pms:.4f} library_ms={lms:.4f} "
              f"bound_ms={bms:.4f} ({by})", flush=True)
    del kv
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    return rows


def phase_envelope(torch, nct) -> None:
    """The kernels at shapes llama2-7b does not give them (ragged M and N,
    group 32, a bias, grouped-query attention, head widths 32/64/256),
    each equal to its plain version bit for bit, and a small GQA model
    served on the card with the same greedy tokens as on the CPU."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.models.llama import LlamaConfig
    from neural_compressor_tpu_torch.ops import (pack_qtensor,
                                                 quantize_act_per_token,
                                                 quantize_tensor, to_hopper)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bad = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def weight(K, N, G):
        w = randn(K, N) * K ** -0.5
        return to_hopper(pack_qtensor(quantize_tensor(w, bits=4,
                                                      group_size=G)))

    def check(label, a, b):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            bad.append(label)

    n = 0
    for M, K, N, G in ((1, 256, 256, 128), (5, 512, 768, 32),
                       (65, 384, 320, 128), (130, 256, 64, 256)):
        pw = weight(K, N, G)
        xq, xs = quantize_act_per_token(randn(M, K))
        xs = xs.reshape(-1).contiguous()
        check(f"gemm M={M} K={K} N={N} G={G}",
              kernels.w4a8_gemm(xq, pw.packed, pw.scales, xs),
              kernels.w4a8_gemm_plain(xq, pw.packed, pw.scales, xs))
        n += 1
    for K, N in ((384, 640), (256, 136)):
        pw = weight(K, N, 128)
        x = randn(K, dtype=torch.bfloat16)
        for form in ("plain", "rms", "rms+silu", "bias+res", "rms+res"):
            silu = "silu" in form
            n_out = N // 2 if silu else N
            rms_w = 1 + 0.1 * randn(K) if "rms" in form else None
            bias = 0.1 * randn(n_out) if "bias" in form else None
            res = randn(n_out, dtype=torch.bfloat16) if "res" in form else None
            args = dict(eps=1e-5, silu=silu, out_dtype=torch.bfloat16)
            check(f"gemv K={K} N={N} {form}",
                  kernels.fused_gemv(x, rms_w, pw.packed, pw.scales, bias,
                                     res, **args),
                  kernels.fused_gemv_plain(x, rms_w, pw.packed, pw.scales,
                                           bias, res, **args))
            n += 1
    T = 64
    for H, Hkv, D in ((8, 2, 64), (8, 1, 32), (4, 4, 256), (32, 8, 128)):
        for pos in (0, 31, 63):
            q = randn(1, H, 1, D, dtype=torch.bfloat16)
            kn, vn = (randn(1, Hkv, 1, D, dtype=torch.bfloat16)
                      for _ in range(2))
            kc, vc = (randn(1, Hkv, T, D, dtype=torch.bfloat16)
                      for _ in range(2))
            k_ref, v_ref = kc.clone(), vc.clone()
            k_ref[:, :, pos], v_ref[:, :, pos] = kn[:, :, 0], vn[:, :, 0]
            out, k2, v2 = kernels.decode_attention(q, kn, vn, kc, vc, pos)
            label = f"attn H={H} Hkv={Hkv} D={D} pos={pos}"
            if k2 is not kc or v2 is not vc:
                bad.append(label + " (cache not updated in place)")
            check(label + " cache", kc, k_ref)
            check(label, out[:, :, 0], kernels.decode_attn_plain(
                q[:, :, 0].contiguous(), k_ref, v_ref, pos))
            n += 1

    # 16 heads on 4 KV heads of 32; every projection inside the envelope
    cfg = LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=16,
                      num_key_value_heads=4)
    m_cpu = nct.build_quantized(cfg, nct.RTNConfig(
        dtype="int4", group_size=G, quant_lm_head=True), seed=3,
        device="cpu")
    nct.fuse_for_serving(m_cpu)
    nct.to_w4a8_serving(m_cpu)
    nct.enable_fused_decode(m_cpu)
    m_gpu = copy.deepcopy(m_cpu).to(dev)
    ids = torch.randint(0, 512, (1, 12),
                        generator=torch.Generator().manual_seed(4))
    want = nct.greedy_search(m_cpu, ids, max_new_tokens=16, max_len=64)
    before = [fn.launches for fn in kernels.KERNEL_WRAPPERS]
    got = nct.greedy_search(m_gpu, ids, max_new_tokens=16, max_len=64)
    grew = [fn.launches - b for fn, b in zip(kernels.KERNEL_WRAPPERS, before)]
    L = cfg.num_hidden_layers
    if not torch.equal(got.cpu(), want):
        bad.append(f"GQA model tokens {got.tolist()} vs {want.tolist()}")
    if grew != [4 * L + 1, 15 * (4 * L + 1), 15 * L]:
        bad.append(f"GQA model launches {grew}")
    print(f"envelope: {n} kernel shapes and a 2-layer GQA model "
          f"(16 greedy tokens), card vs plain: "
          f"{'all equal' if not bad else bad}", flush=True)
    if bad:
        fail(f"outside the llama2-7b shapes: {bad}")


def unit(rows, pick, bound_by) -> dict:
    """Sum the per-launch numbers over one main-path unit of work:
    32 layers' projections plus the lm_head, or 32 layers' attention."""
    out = {}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        out[key] = sum(w * r[key] for r, w in pick(rows))
    out["bound_by"] = bound_by(rows)
    out["max_abs_err"] = max(r["err"] for r in rows)
    return out


def phase_model_check(torch, nct) -> None:
    from neural_compressor_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                          LlamaConfig,
                                                          init_kv_cache)

    torch.set_num_threads(8)
    params = dict(LLAMA_PRESETS["llama2-7b"], num_hidden_layers=2)
    cfg = LlamaConfig(**params)
    t0 = time.perf_counter()
    m_cpu = nct.build_quantized(
        cfg, nct.RTNConfig(dtype="int4", group_size=G, quant_lm_head=True),
        seed=1, device="cpu")
    nct.fuse_for_serving(m_cpu)
    nct.to_w4a8_serving(m_cpu)
    nct.enable_fused_decode(m_cpu)
    m_gpu = copy.deepcopy(m_cpu).to("cuda")
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen)

    @torch.no_grad()
    def run(model):
        dev = model.device
        caches = init_kv_cache(cfg, 1, 64, device=dev)
        x = ids.to(dev)
        logits, caches = model(x, torch.arange(32, device=dev)[None], caches,
                               0)
        out_logits, toks = [logits[:, -1].float().cpu()], []
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        for i in range(8):
            toks.append(int(tok))
            pos = 32 + i
            logits, caches = model(tok, torch.full((1, 1), pos, device=dev),
                                   caches, pos)
            out_logits.append(logits[:, -1].float().cpu())
            tok = torch.argmax(logits[:, -1], -1)[:, None]
        toks.append(int(tok))
        return torch.cat(out_logits), toks

    lg_gpu, tok_gpu = run(m_gpu)
    lg_cpu, tok_cpu = run(m_cpu)
    err = float((lg_gpu - lg_cpu).abs().max())
    ref = float(lg_cpu.abs().max())
    ok = (tok_gpu == tok_cpu and math.isfinite(err) and err <= 5e-2 * ref)
    print(f"model check (2 layers, full width): tokens equal="
          f"{tok_gpu == tok_cpu} max|logit diff|={err:.4e} "
          f"tol={5e-2 * ref:.4e} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if not ok:
        fail(f"card vs CPU: tokens {tok_gpu} vs {tok_cpu}, err {err}")
    del m_cpu, m_gpu


def phase_serve(torch, nct) -> dict:
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.layers.woq_linear import _dequant_dot
    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    t0 = time.perf_counter()
    model = nct.build_quantized(
        "llama2-7b", nct.RTNConfig(dtype="int4", group_size=G,
                                   quant_lm_head=True), seed=0)
    nct.fuse_for_serving(model)
    nct.to_w4a8_serving(model)
    n_fused = nct.enable_fused_decode(model)
    torch.cuda.synchronize()
    print(f"llama2-7b built and converted in {time.perf_counter() - t0:.1f} s "
          f"({n_fused} fused-decode layers, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card)",
          flush=True)
    if n_fused != LAYERS:
        fail(f"fused decode on {n_fused} of {LAYERS} layers")
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, model.cfg.vocab_size, (1, P), generator=gen)
               for P in PROMPTS]
    # warm-up, then prefill times (outside the counted run)
    nct.greedy_search(model, prompts[0], max_new_tokens=4, max_len=MAX_LEN)
    prefill_ms = []
    with torch.no_grad():
        for ids in prompts:
            ids = ids.cuda()
            caches = init_kv_cache(model.cfg, 1, MAX_LEN)
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = model(ids, None, caches, 0)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t) * 1e3)
            if not bool(torch.isfinite(logits).all()):
                fail("non-finite prefill logits")
            del caches, logits
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    _dequant_dot.calls = 0
    req_s, outs = [], []
    for ids in prompts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(nct.greedy_search(model, ids, max_new_tokens=NEW_TOKENS,
                                      max_len=MAX_LEN))
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t)
    launches = {fn.__name__: fn.launches for fn in kernels.KERNEL_WRAPPERS}
    fallbacks = _dequant_dot.calls
    steps = NEW_TOKENS - 1
    want = {"w4a8_gemm": len(PROMPTS) * (4 * LAYERS + 1),
            "fused_gemv": len(PROMPTS) * steps * (4 * LAYERS + 1),
            "decode_attn": len(PROMPTS) * steps * LAYERS}
    print(f"kernels {json.dumps(launches)} expected {json.dumps(want)} "
          f"dequant-and-dot fallbacks {fallbacks}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for ids, out, s, pms in zip(prompts, outs, req_s, prefill_ms):
        P = ids.shape[1]
        if (tuple(out.shape) != (1, P + NEW_TOKENS)
                or not torch.equal(out[:, :P].cpu(), ids.to(torch.int32))
                or int(out.min()) < 0 or int(out.max()) >= model.cfg.vocab_size):
            fail(f"bad greedy output for prompt {P}: {out}")
        tok_s = steps / (s - pms / 1e3)
        print(f"request prompt={P} new={NEW_TOKENS}: {s * 1e3:.1f} ms, "
              f"prefill {pms:.2f} ms, decode {tok_s:.2f} tok/s "
              f"(first new tokens {out[0, P:P + 8].tolist()})", flush=True)
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    if fallbacks:
        fail(f"{fallbacks} projections took the bf16 dequant-and-dot")
    return launches, model, prompts


def phase_profile(torch, model, ids) -> None:
    """Where the time goes (after the counted run): one prefill, then 8
    decode steps, each under torch.profiler; device busy time is the sum
    of the kernels' self device time."""
    from torch.profiler import ProfilerActivity, profile

    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    ids = ids.cuda()
    P = ids.shape[1]

    def window(label, fn):
        fn()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        # kernels only: a CPU op's entry repeats the device time of the
        # kernels it launched
        ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        launched = sum(e.count for e in ev)
        print(f"profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
              f"device idle {100 * (1 - busy / wall):.1f}%, "
              f"{launched} device kernels", flush=True)
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:70]}", flush=True)

    with torch.no_grad():
        caches = init_kv_cache(model.cfg, 1, MAX_LEN)
        window(f"prefill P={P}", lambda: model(ids, None, caches, 0))
        tok = ids[:, -1:]

        def steps():
            for i in range(8):
                model(tok, torch.full((1, 1), P + i, device="cuda"), caches,
                      P + i)

        window("decode x8", steps)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(2)
    try:
        import neural_compressor_tpu_torch as nct
        from neural_compressor_tpu_torch.kernels import _build
    except ImportError as e:
        fail(f"the port is not importable here: {e}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"bounds from the {peaks['source']}: "
          f"{peaks['bytes_s'] / 1e12} TB/s, int8 {peaks['int8_s'] / 1e12} "
          f"TOP/s, bf16 {peaks['bf16_s'] / 1e12} TFLOP/s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s) -> {lib_path.name}", flush=True)
    for line in (lib_path.parent / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    rows = phase_kernels(torch, nct, peaks)
    phase_envelope(torch, nct)
    phase_model_check(torch, nct)
    launches, model, prompts = phase_serve(torch, nct)
    phase_profile(torch, model, prompts[1])
    del model

    proj = ("qkv", "o", "gate_up", "down")

    def per_layer(rs):
        return [(r, LAYERS if r["shape"] in proj else 1) for r in rs]

    gemm_u = unit([r for r in rows["gemm"] if r["M"] == UNIT_M], per_layer,
                  lambda rs: "operations" if all(
                      r["bound_by"] == "operations" for r in rs) else "bytes")
    gemm_u["max_abs_err"] = max(r["err"] for r in rows["gemm"])
    gemv_u = unit(rows["gemv"], per_layer, lambda rs: "bytes")
    attn_u = unit([r for r in rows["attn"] if r["pos"] == UNIT_POS],
                  lambda rs: [(r, LAYERS) for r in rs], lambda rs: "bytes")
    attn_u["max_abs_err"] = max(r["err"] for r in rows["attn"])
    entries = [
        ("w4a8_gemm", "neural_compressor_tpu_torch/csrc/w4a8_gemm.cu",
         "neural_compressor_tpu/kernels/w4a8_matmul.py:88 (_w4a8_impl, K1); "
         "neural_compressor_tpu/kernels/fused_matvec.py:324 (_u4k_impl, K3)",
         gemm_u),
        ("fused_gemv", "neural_compressor_tpu_torch/csrc/fused_gemv.cu",
         "neural_compressor_tpu/kernels/fused_matvec.py:195 (_fused_impl, K4)",
         gemv_u),
        ("decode_attn", "neural_compressor_tpu_torch/csrc/decode_attention.cu",
         "neural_compressor_tpu/kernels/decode_attention.py:282 "
         "(_decode_attn_ro_impl, K5)", attn_u),
    ]
    print("unit of the kernels line: w4a8_gemm = one 128-token prefill "
          "(32 layers x 4 projections + lm_head); fused_gemv = one decode "
          "step (32 x 4 + lm_head); decode_attn = one decode step at "
          "pos 517 (32 layers)", flush=True)
    kernels_line = {"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[n], "max_abs_err": u["max_abs_err"],
         "ms": u["ms"], "plain_ms": u["plain_ms"], "bound_ms": u["bound_ms"],
         "bound_by": u["bound_by"], "library_ms": u["library_ms"]}
        for n, src, rep, u in entries]}
    print(smi, flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
