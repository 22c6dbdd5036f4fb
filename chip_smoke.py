#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels to account.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; imports nothing of JAX. Phases, any failure exits
non-zero:
  1. build the CUDA kernels from ``neural_compressor_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version at the llama2-7b shapes
     of the main path (B=1 decode and prefill; the 8-slot engine's decode
     over a 1024-row cache and over pools of 128-row pages), with its time,
     the plain version's time, one PyTorch yardstick call (``library_ms``,
     never used by the port) and the least time the card could take
     (``bound_ms``);
  3. the kernels at shapes llama2-7b does not give them (GQA, other head
     widths, ragged M, N and T, group 32, a bias, positions at 0, at page
     boundaries and past the end, zero-length and idle slots, a shared
     trash page) against their plain versions, and a small GQA model's
     greedy tokens on the card against the CPU; then a full-width 2-layer
     model on the card (kernels) against the same weights on the CPU
     (plain versions): 32-token prefill, 8 greedy steps; and the same
     2-layer model served by the engine on the card and on the CPU in
     each pool mode (contiguous bf16, paged bf16, paged int8);
  4. llama2-7b at full width and depth, RTN int4 g128 W4A8, answering
     three greedy requests at B=1 (prompts of 16, 100 and 371 tokens, 48
     new tokens each, max_len 1024), with exact kernel launch counts;
  5. where the time goes at B=1: one prefill and 8 decode steps under
     torch.profiler (wall time, device busy time, top kernels);
  6. the same llama2-7b behind ``ContinuousBatchingEngine(n_slots=8,
     max_len=1024)``: 16 greedy requests (prompts of 16, 100 and 371
     tokens, 48-64 new tokens) over contiguous bf16 caches, then over a
     paged int8 pool, ``run(chunk=8)``, with exact launch counts derived
     from the engine's counters, and one B=8 decode dispatch profiled;
  7. weight-only (W4A16) serving: K8 and K9 against their plain versions
     at the llama2-7b asym-int4 g128 shapes (timed as in 2) and over the
     formats, groups and shapes the path does not give them (int2, nf4,
     fp4, int8 codes, per-channel, double quant, perm, bias, pre_scale,
     ragged M and N, f32 x); a full-width 2-layer W4A16 model on the card
     against the CPU with the plain K8/K9 forced;
  8. after the W4A8 model is freed, llama2-7b asym-int4 g128 W4A16 at full
     width and depth: three greedy requests at B=1 and 16 through the
     8-slot engine (contiguous bf16), exact launch counts of K8, K9, K5
     and K7 and the dequantize-then-matmul calls (M > 256 only),
     profiled as in 5.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on the main path and its times.
"""

from __future__ import annotations

import copy
import gc
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
TOL = {"gemm": 1e-5, "gemv": 1e-2, "attn": 1e-2, "batched": 1e-2,
       "paged_attn": 1e-2, "paged_write": 0.0}
# the engine: 8 slots; its decode positions spread over the 1024-row cache
SLOTS, PAGE, CHUNK = 8, 128, 8
SLOT_POS = (0, 127, 128, 300, 517, 640, 901, 1023)
ENGINE_REQUESTS = 16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_peaks(name: str) -> dict:
    """Published dense peaks (NVIDIA data sheets) of the card's variant."""
    if "PCIe" in name:
        return {"bytes_s": 2.0e12, "int8_s": 1513e12, "bf16_s": 756e12,
                "f32_s": 51e12, "source": "H100 PCIe data sheet"}
    return {"bytes_s": 3.35e12, "int8_s": 1979e12, "bf16_s": 989e12,
            "f32_s": 67e12, "source": "H100 SXM data sheet"}


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


def _pool(torch, randn, gen, n_pages, Hkv, page, D, quant):
    """A random paged pool: bf16 rows, or int8 codes with scales."""
    shape = (n_pages, Hkv, page, D)
    if not quant:
        return randn(*shape), None, randn(*shape), None
    dev = torch.device("cuda")

    def codes():
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales():
        return 0.005 + 0.015 * torch.rand(shape[:-1], generator=gen,
                                          device=dev)

    return codes(), scales(), codes(), scales()


def phase_engine_kernels(torch, nct, peaks: dict) -> dict:
    """The engine's decode kernels at llama2-7b shapes, 8 slots: K7 over
    the contiguous [8, 32, 1024, 128] bf16 cache with per-slot positions
    spread over it; K11 and K12 over pools of 128-row pages (bf16 and int8)
    holding the same positions. Each against its plain version, timed
    with L2 cold (operands rotated through >200 MB of copies)."""
    from neural_compressor_tpu_torch.kernels import (
        batched_decode_attn, batched_decode_attn_plain, paged_attn,
        paged_attn_plain, paged_write, paged_write_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {"batched": [], "paged_attn": [], "paged_write": []}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, H, Hkv, D, T = SLOTS, HEADS, HEADS, HEAD_DIM, MAX_LEN
    pos = torch.tensor(SLOT_POS, dtype=torch.int32, device=dev)
    L = pos.to(torch.int64) + 1
    n_vis = int(L.sum())
    Lmax = int(L.max())
    mask = (torch.arange(Lmax, device=dev)[None, :] < L[:, None])[:, None,
                                                                 None]
    q = randn(B, H, D)
    q4 = q[:, :, None]

    def record(kind, label, err, tol, ms, pms, lms, nbytes, ops, **extra):
        ok = math.isfinite(err) and err <= tol
        bms, by = bound(nbytes, ops, peaks["bf16_s"], peaks)
        rows[kind].append(dict(label=label, err=err, tol=tol, ok=ok, ms=ms,
                               plain_ms=pms, library_ms=lms, bound_ms=bms,
                               bound_by=by, **extra))
        lib = "null" if lms is None else f"{lms:.4f}"
        print(f"{kind} {label} max_abs_err={err:.3e} tol={tol:.1e} ok={ok} "
              f"ms={ms:.4f} plain_ms={pms:.4f} library_ms={lib} "
              f"bound_ms={bms:.4f} ({by})", flush=True)

    # K7: one layer's decode step of the contiguous engine
    kv = [(randn(B, Hkv, T, D), randn(B, Hkv, T, D))
          for _ in range(n_copies(2 * B * Hkv * T * D * 2))]
    k, v = kv[0]
    out = batched_decode_attn(q, k, v, pos)
    ref = batched_decode_attn_plain(q, k, v, pos)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    ms = timed_ms(torch, [lambda a=a, b=b: batched_decode_attn(q, a, b, pos)
                          for a, b in kv], 200)
    pms = timed_ms(torch, [lambda: batched_decode_attn_plain(q, k, v, pos)], 5)
    lms = timed_ms(torch, [lambda a=a, b=b: sdpa(q4, a[:, :, :Lmax],
                                                  b[:, :, :Lmax],
                                                  attn_mask=mask)
                           for a, b in kv], 200)
    record("batched", f"B={B} H={H} Hkv={Hkv} D={D} T={T} pos={SLOT_POS}",
           err, TOL["batched"], ms, pms, lms,
           2 * Hkv * n_vis * D * 2 + 2 * B * H * D * 2 + B * 4,
           4 * H * n_vis * D)
    del kv, k, v

    # K11 and K12 over pools of 128-row pages holding the same slots
    pmax = T // PAGE
    n_pages = B * pmax + 1                      # page 0 is the trash page
    bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                         .manual_seed(12)) + 1).reshape(B, pmax)
    bt = bt.to(torch.int32).to(dev)
    lengths = (pos + 1).contiguous()
    kn, vn = randn(B, Hkv, D), randn(B, Hkv, D)
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        esize = 1 if quant else 2
        pool_bytes = 2 * n_pages * Hkv * PAGE * D * esize
        pools = [_pool(torch, randn, gen, n_pages, Hkv, PAGE, D, quant)
                 for _ in range(n_copies(pool_bytes))]
        kp, ks, vp, vs = pools[0]
        out = paged_attn(q, kp, ks, vp, vs, bt, lengths)
        ref = paged_attn_plain(q, kp, ks, vp, vs, bt, lengths)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        ms = timed_ms(torch, [lambda p=p: paged_attn(q, *p, bt, lengths)
                              for p in pools], 200)
        pms = timed_ms(torch, [lambda: paged_attn_plain(
            q, kp, ks, vp, vs, bt, lengths)], 5)

        # the library's yardstick: SDPA over the slots' rows gathered out
        # of the pages (dequantized for int8) into padded [B, Hkv, L, D]
        def gathered(pages, scales):
            g = pages[bt.long()].transpose(1, 2).reshape(B, Hkv, T, D)
            if scales is not None:
                s_ = scales[bt.long()].transpose(1, 2).reshape(B, Hkv, T)
                g = g.float() * s_[..., None]
            return g[:, :, :Lmax].to(torch.bfloat16).contiguous()

        gk = [(gathered(p[0], p[1]), gathered(p[2], p[3])) for p in pools]
        lms = timed_ms(torch, [lambda a=a, b=b: sdpa(q4, a, b,
                                                      attn_mask=mask)
                               for a, b in gk], 200)
        del gk
        record("paged_attn", f"{tag} B={B} H={H} D={D} page={PAGE} "
               f"pmax={pmax} lengths={tuple(lengths.tolist())}", err,
               TOL["paged_attn"], ms, pms, lms,
               2 * Hkv * n_vis * (D * esize + (4 if quant else 0))
               + 2 * B * H * D * 2 + B * pmax * 4 + B * 4,
               4 * H * n_vis * D, pool=tag)
        del pools

        # K12: the 8 slots' new rows at their positions
        kp, ks, vp, vs = _pool(torch, randn, gen, n_pages, Hkv, PAGE, D,
                               quant)
        pool_p = [t.clone() if t is not None else None
                  for t in (kp, ks, vp, vs)]
        paged_write(kn, vn, kp, ks, vp, vs, bt, pos)
        paged_write_plain(kn, vn, *pool_p, bt, pos)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip((kp, ks, vp, vs), pool_p)
                  if a is not None)
        ms = timed_ms(torch, [lambda: paged_write(kn, vn, kp, ks, vp, vs,
                                                  bt, pos)], 500)
        pms = timed_ms(torch, [lambda: paged_write_plain(kn, vn, *pool_p, bt,
                                                         pos)], 20)
        # the yardstick for bf16 is index assignment of the K and V rows;
        # no single PyTorch call quantizes and scatters an int8 row
        lms = None
        if not quant:
            pid = bt.long()[torch.arange(B, device=dev),
                            pos.long() // PAGE]
            off = pos.long() % PAGE

            def index_assign():
                kp[pid, :, off] = kn
                vp[pid, :, off] = vn

            lms = timed_ms(torch, [index_assign], 500)
        record("paged_write", f"{tag} B={B} Hkv={Hkv} D={D} page={PAGE} "
               f"pos={SLOT_POS}", err, TOL["paged_write"], ms, pms, lms,
               2 * B * Hkv * D * 2 + 2 * B * Hkv * D * esize
               + (2 * B * Hkv * 4 if quant else 0) + B * 8, 0, pool=tag)
        del kp, ks, vp, vs, pool_p
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"engine kernel disagrees with its plain version: {bad}")
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
    if grew != [4 * L + 1, 15 * (4 * L + 1), 15 * L, 0, 0, 0, 0, 0]:
        bad.append(f"GQA model launches {grew}")
    print(f"envelope: {n} kernel shapes and a 2-layer GQA model "
          f"(16 greedy tokens), card vs plain: "
          f"{'all equal' if not bad else bad}", flush=True)
    if bad:
        fail(f"outside the llama2-7b shapes: {bad}")


def phase_engine_envelope(torch) -> None:
    """The engine's kernels where llama2-7b does not take them, each equal
    to its plain version bit for bit: GQA with 2, 4 and 8 query heads a KV
    head, head widths 32, 64 and 256, T not a multiple of 128, positions
    at 0, T - 1 and past the end, page boundaries (rows 0 and 127 of a
    page), a zero-length slot, an idle slot whose block table is all trash
    page, rows past the block table, and two slots writing one trash-page
    row (that row excepted: the race leaves it unspecified)."""
    from neural_compressor_tpu_torch import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    bad, n = [], 0

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(label, a, b):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            bad.append(label)

    for H, Hkv, D in ((16, 8, 128), (16, 4, 64), (16, 2, 256), (8, 1, 32)):
        T = 200
        pos = torch.tensor([0, 127, T - 1, T + 3], dtype=torch.int32,
                           device=dev)
        q = randn(4, H, D)
        k, v = randn(4, Hkv, T, D), randn(4, Hkv, T, D)
        check(f"batched H={H} Hkv={Hkv} D={D} T={T}",
              kernels.batched_decode_attn(q, k, v, pos),
              kernels.batched_decode_attn_plain(q, k, v, pos))
        n += 1
    for (H, Hkv, D, page), quant in zip(
            ((16, 8, 128, 128), (16, 4, 64, 16), (16, 2, 256, 128),
             (8, 1, 32, 16), (32, 32, 128, 128), (8, 2, 64, 128)),
            (False, True, True, False, True, False)):
        pmax, B = 3, 5
        n_pages = (B - 1) * pmax + 1
        kp, ks, vp, vs = _pool(torch, randn, gen, n_pages, Hkv, page, D,
                               quant)
        bt = torch.arange(1, n_pages, dtype=torch.int32,
                          device=dev).reshape(B - 1, pmax)
        bt = torch.cat([bt, torch.zeros((1, pmax), dtype=torch.int32,
                                        device=dev)])       # slot 4 idle
        # row 0 of page 0, row page-1 (a full page), row 0 of page 2, a
        # zero-length slot, and the idle slot past the end of its table
        lengths = torch.tensor([1, page, 2 * page + 1, 0, pmax * page + 5],
                               dtype=torch.int32, device=dev)
        q = randn(B, H, D)
        tag = f"H={H} Hkv={Hkv} D={D} page={page} {'int8' if quant else 'bf16'}"
        check(f"paged_attn {tag}",
              kernels.paged_attn(q, kp, ks, vp, vs, bt, lengths),
              kernels.paged_attn_plain(q, kp, ks, vp, vs, bt, lengths))
        # writes: page-boundary rows, the trash-page row of two idle slots
        # (slots 3 and 4 both park at the last row of their table), and
        # a row past the table, dropped
        bt_w = bt.clone()
        bt_w[3] = 0
        wpos = torch.tensor([0, page - 1, 2 * page, pmax * page - 1,
                             pmax * page - 1], dtype=torch.int32, device=dev)
        wpos2 = wpos.clone()
        wpos2[4] = pmax * page + 2
        for p_ in (wpos, wpos2):
            kn, vn = randn(B, Hkv, D), randn(B, Hkv, D)
            pool_k = [t.clone() if t is not None else None
                      for t in (kp, ks, vp, vs)]
            pool_p = [t.clone() if t is not None else None
                      for t in (kp, ks, vp, vs)]
            kernels.paged_write(kn, vn, *pool_k, bt_w, p_)
            kernels.paged_write_plain(kn, vn, *pool_p, bt_w, p_)
            torch.cuda.synchronize()
            for a, b in zip(pool_k, pool_p):
                if a is None:
                    continue
                a, b = a.clone(), b.clone()
                a[0, :, page - 1] = 0          # the contended trash row
                b[0, :, page - 1] = 0
                check(f"paged_write {tag} pos={p_.tolist()}", a, b)
        n += 3
    print(f"engine envelope: {n} kernel shapes, card vs plain: "
          f"{'all equal' if not bad else bad}", flush=True)
    if bad:
        fail(f"engine kernels outside the llama2-7b shapes: {bad}")


ENGINE_MODES = {"contiguous": {}, "paged_bf16": dict(paged=True),
                "paged_int8": dict(paged=True)}


def serve_engine(torch, nct, model, mode, prompts, new_tokens,
                 chunk=CHUNK, **kw):
    """A fresh engine in ``mode`` on ``model``'s device, the prompts
    submitted, run dry; returns (engine, requests, seconds)."""
    on_card = model.device.type == "cuda"
    model.kv_cache_quantized = mode == "paged_int8"
    model.kv_cache_format = "int8"
    eng = nct.ContinuousBatchingEngine(model, **{**kw, **ENGINE_MODES[mode]})
    reqs = [eng.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, new_tokens)]
    if on_card:
        torch.cuda.synchronize()
    t = time.perf_counter()
    done = eng.run(chunk=chunk)
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    model.kv_cache_quantized = False
    if sorted(r.uid for r in done) != sorted(r.uid for r in reqs):
        fail(f"engine ({mode}) finished {len(done)} of {len(reqs)} requests")
    return eng, reqs, seconds


def phase_engine_check(torch, nct) -> None:
    """A full-width 2-layer llama2-7b served by the engine on the card
    (kernels) and on the CPU (plain versions), the same weights and
    requests, in each pool mode: the tokens must be equal."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                          LlamaConfig)

    torch.set_num_threads(8)
    t0 = time.perf_counter()
    cfg = LlamaConfig(**dict(LLAMA_PRESETS["llama2-7b"], num_hidden_layers=2))
    m_cpu = nct.build_quantized(
        cfg, nct.RTNConfig(dtype="int4", group_size=G, quant_lm_head=True),
        seed=4, device="cpu")
    nct.fuse_for_serving(m_cpu)
    nct.to_w4a8_serving(m_cpu)
    nct.enable_fused_decode(m_cpu)
    m_gpu = copy.deepcopy(m_cpu).to("cuda")
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (P,), generator=gen).numpy()
               for P in (12, 20, 5)]
    new = (5, 4, 5)
    kw = dict(n_slots=4, max_len=128, prefill_chunk=16, page_size=32)
    path = {"contiguous": ("batched_decode_attn",),
            "paged_bf16": ("paged_attn", "paged_write"),
            "paged_int8": ("paged_attn", "paged_write")}
    for mode in ENGINE_MODES:
        kernels.reset_launch_counts()
        _e, got, _s = serve_engine(torch, nct, m_gpu, mode, prompts, new,
                                   chunk=2, **kw)
        launched = {fn.__name__: fn.launches for fn in kernels.KERNEL_WRAPPERS}
        _e, want, _s = serve_engine(torch, nct, m_cpu, mode, prompts, new,
                                    chunk=2, **kw)
        toks = [r.generated for r in got]
        ok = (toks == [r.generated for r in want]
              and all(launched[k] > 0 for k in path[mode]))
        print(f"engine check {mode} (2 layers, full width): card tokens "
              f"{toks} cpu tokens {[r.generated for r in want]} "
              f"launches {launched}", flush=True)
        if not ok:
            fail(f"engine {mode}: card and CPU differ or the path's kernels "
                 "did not run")
    print(f"engine check done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del m_cpu, m_gpu


def unit(rows, pick, bound_by) -> dict:
    """Sum the per-launch numbers over one main-path unit of work:
    32 layers' projections plus the lm_head, or 32 layers' attention.
    A number that is None in any row (no library call) stays None."""
    out = {}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        picked = [(r[key], w) for r, w in pick(rows)]
        out[key] = (None if any(x is None for x, _w in picked)
                    else sum(w * x for x, w in picked))
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
    from neural_compressor_tpu_torch.kernels import dequant_dot
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
    dequant_dot.calls = 0
    req_s, outs = [], []
    for ids in prompts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(nct.greedy_search(model, ids, max_new_tokens=NEW_TOKENS,
                                      max_len=MAX_LEN))
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t)
    launches = {fn.__name__: fn.launches for fn in kernels.KERNEL_WRAPPERS}
    fallbacks = dequant_dot.calls
    steps = NEW_TOKENS - 1
    want = {"w4a8_gemm": len(PROMPTS) * (4 * LAYERS + 1),
            "fused_gemv": len(PROMPTS) * steps * (4 * LAYERS + 1),
            "decode_attn": len(PROMPTS) * steps * LAYERS,
            "batched_decode_attn": 0, "paged_attn": 0, "paged_write": 0,
            "dequant_gemm": 0, "vpu_gemv": 0}
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
    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    ids = ids.cuda()
    P = ids.shape[1]

    def window(label, fn):
        fn()  # warm
        profile_window(torch, label, fn)

    with torch.no_grad():
        caches = init_kv_cache(model.cfg, 1, MAX_LEN)
        window(f"prefill P={P}", lambda: model(ids, None, caches, 0))
        tok = ids[:, -1:]

        def steps():
            for i in range(8):
                model(tok, torch.full((1, 1), P + i, device="cuda"), caches,
                      P + i)

        window("decode x8", steps)


def profile_window(torch, label, fn) -> None:
    """``fn`` once under torch.profiler: wall time, device busy time (the
    kernels' self device time), idle share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # kernels only: a CPU op's entry repeats the device time of the kernels
    # it launched
    ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    launched = sum(e.count for e in ev)
    print(f"profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"device idle {100 * (1 - busy / wall):.1f}%, "
          f"{launched} device kernels", flush=True)
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:70]}", flush=True)


def phase_engine_serve(torch, nct, model) -> dict:
    """llama2-7b W4A8 behind the 8-slot engine, contiguous bf16 caches and
    then a paged int8 pool: 16 greedy requests each, exact launch counts
    from the engine's counters, then one B=8 decode dispatch profiled.
    Returns {mode: launches}."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_dot

    V = model.cfg.vocab_size
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, V, (PROMPTS[i % len(PROMPTS)],),
                             generator=gen).numpy()
               for i in range(ENGINE_REQUESTS)]
    new = [48 + (7 * i) % 17 for i in range(ENGINE_REQUESTS)]   # 48-64
    out = {}
    for mode in ("contiguous", "paged_int8"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        dequant_dot.calls = 0
        eng, reqs, seconds = serve_engine(torch, nct, model, mode, prompts,
                                          new, n_slots=SLOTS,
                                          max_len=MAX_LEN, page_size=PAGE)
        launches = {fn.__name__: fn.launches for fn in kernels.KERNEL_WRAPPERS}
        fallbacks = dequant_dot.calls
        m = eng.metrics()
        steps = CHUNK * m["decode_dispatches"]
        chunks = m["prefill_chunk_dispatches"]
        paged = mode != "contiguous"
        want = {"w4a8_gemm": (4 * LAYERS + 1) * (steps + chunks),
                "fused_gemv": 0, "decode_attn": 0,
                "batched_decode_attn": 0 if paged else LAYERS * steps,
                "paged_attn": LAYERS * steps if paged else 0,
                "paged_write": LAYERS * steps if paged else 0,
                "dequant_gemm": 0, "vpu_gemv": 0}
        counters = {k: m[k] for k in (
            "requests", "prompt_tokens", "generated_tokens",
            "prefill_chunk_dispatches", "decode_dispatches",
            "combined_dispatches", "preemptions")}
        kv = (f"{eng.n_pages} pages of {PAGE} rows, int8" if paged else
              f"{SLOTS} x {MAX_LEN} rows, bf16")
        print(f"engine {mode} ({kv}): {len(reqs)} requests in "
              f"{seconds:.3f} s, generated {m['generated_tok_s']:.2f} tok/s "
              f"(metrics wall {m['wall_s']:.3f} s), {json.dumps(counters)}, "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        print(f"engine {mode} kernels {json.dumps(launches)} expected "
              f"{json.dumps(want)} dequant-and-dot fallbacks {fallbacks}",
              flush=True)
        for r, p, n in zip(reqs, prompts, new):
            if (len(r.generated) != n or min(r.generated) < 0
                    or max(r.generated) >= V
                    or not all(math.isfinite(x) for x in r.logprobs)):
                fail(f"engine {mode}: bad output for a {len(p)}-token "
                     f"prompt: {r.generated}")
        print(f"engine {mode} first new tokens "
              f"{[r.generated[:4] for r in reqs[:3]]}", flush=True)
        if launches != want:
            fail(f"engine {mode}: launch counts {launches} != {want}")
        if fallbacks:
            fail(f"engine {mode}: {fallbacks} projections took the bf16 "
                 "dequant-and-dot")
        out[mode] = launches

        # where the time goes: one B=8 decode dispatch with every slot live
        model.kv_cache_quantized = paged
        eng = nct.ContinuousBatchingEngine(
            model, n_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
            **ENGINE_MODES[mode])
        for p in prompts[:SLOTS]:
            eng.submit(p, max_new_tokens=64)
        while eng.queue or "prefill" in eng.slot_state:
            eng.run(max_steps=1, chunk=1)
        profile_window(torch, f"engine {mode} decode dispatch, 8 slots x "
                       f"{CHUNK} steps", lambda: eng.step_many(CHUNK))
        eng.run()
        model.kv_cache_quantized = False
        del eng
    return out


# ------------------------------------------------------------------ W4A16
WOQ_MS = (8, 100, 256)          # K8 rows timed at the llama2-7b shapes
WOQ_UNIT_M = 8                  # K8's row of the kernels line: one 8-slot step


def woq_tol(torch, x, pw, y_ref, k9: bool, extra=None):
    """Elementwise tolerance of a W4A16 kernel against its plain version,
    each sum bounded over the terms it adds, plus a bf16 rounding of the
    output (2^-7 |y| when y is bf16; ``extra`` adds the magnitude of a
    second rounding, e.g. a bias add).
      * K9 (and its plain version) adds G terms a group and K/G groups,
        factored as s (sum u x - (2^(b-1) + z) sum x): each side is within
        (G + K/G + 4) 2^-24 (|x| @ A), A = s (u + |2^(b-1) + z|), the
        terms the factored sums add before they cancel.
      * K8's weights equal its plain version's bit for bit (the same f32
        dequantization rounded to bf16) and the bf16 products are exact,
        so only the order of the K-term f32 sum differs: the tensor cores'
        chain of m16n8k16 steps on the card, a blocked matmul in the plain
        version. Each side is taken within 8 sqrt(K) 2^-24 (|x| @ |W|),
        the probabilistic bound of a K-term sum at lambda = 8."""
    from neural_compressor_tpu_torch.ops import (dequantize_packed,
                                                 resolve_double_quant,
                                                 unpack_codes)

    pw = resolve_double_quant(pw)
    K, N = pw.orig_shape
    xa = x.reshape(-1, K).float().abs()
    if k9:
        G = pw.group_size if pw.group_size > 0 else K
        if pw.perm is not None:
            xa = xa[:, pw.perm.long()]
        u = unpack_codes(pw.packed, pw.bits, G, K, signed=False).float()
        off = torch.full_like(pw.scales, float(1 << (pw.bits - 1)))
        if pw.zeros is not None:
            off = off + pw.zeros
        A = ((u.reshape(-1, G, N) + off.abs()[:, None, :])
             * pw.scales[:, None, :]).reshape(K, N)
        per_side = (G + K // G + 4) * 2.0 ** -24
    else:
        A = dequantize_packed(pw, torch.float32).abs()
        per_side = 8 * K ** 0.5 * 2.0 ** -24
    tol = (2 * per_side) * (xa @ A)
    tol = tol.reshape(y_ref.shape)
    if y_ref.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * y_ref.float().abs()
    if extra is not None:
        tol = tol + 2.0 ** -7 * extra.float().abs()
    del A
    return tol


def woq_weight(torch, gen, K, N, G=128, scheme="asym", dtype="int", bits=4,
               **pack_kw):
    from neural_compressor_tpu_torch.ops import pack_qtensor, quantize_tensor

    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    return pack_qtensor(quantize_tensor(w, bits=bits, group_size=G,
                                        scheme=scheme, dtype=dtype),
                        **pack_kw)


def woq_operands(pw):
    """The kernel operands of a weight: packed words, f32 scales, f32 zero
    points or None."""
    return (pw.packed, pw.scales, pw.zeros)


def woq_faults(s, z):
    """Faults planted in a kernel's scales and zero points, each of which
    ``woq_tol`` must catch: (name, scales, zeros)."""
    g7 = s.clone()
    g7[7] *= 1.25
    return (("zeros dropped", s, None),
            ("scales one group late", s.roll(1, dims=0), z),
            ("group 7 scale x1.25", g7, z))


def phase_woq_kernels(torch, nct, peaks: dict) -> dict:
    """K8 and K9 at the llama2-7b asym-int4 g128 shapes of the W4A16 path:
    K9 at M = 1, K8 at M = 8, 100 and 256, each against its plain version,
    with its time (weights rotated through >200 MB of copies, so L2 is
    cold), the plain version's, the yardstick ``torch.matmul`` of the
    bf16-dequantized weight (dequantization not timed; never called by the
    port) and the bound. At M = 1 and 8 the kernel also runs on faulty
    scales or zero points (``woq_faults``), and the tolerance must flag
    each fault."""
    from neural_compressor_tpu_torch.kernels import dequant_matmul as dm
    from neural_compressor_tpu_torch.ops import dequantize_packed

    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    rows = {"k8": [], "k9": []}
    missed = []
    for name, (K, N) in SHAPES.items():
        pw = woq_weight(torch, gen, K, N)
        wbf = dequantize_packed(pw, torch.bfloat16)
        wbytes = K * N // 2 + 2 * (K // G) * N * 4
        cps = [tuple(t.clone() for t in woq_operands(pw))
               for _ in range(n_copies(wbytes))]
        lcps = [wbf] + [wbf.clone() for _ in range(
            n_copies(K * N * 2) - 1)]
        for M in (1,) + WOQ_MS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            if M == 1:
                kw = dict(bits=4, group_size=G, out_dtype=torch.bfloat16)
                yk = dm.vpu_gemv(x, *woq_operands(pw), **kw)
                yp = dm.vpu_gemv_plain(x, *woq_operands(pw), **kw)
                run = [lambda c=c: dm.vpu_gemv(x, *c, **kw) for c in cps]
                plain = [lambda: dm.vpu_gemv_plain(x, *woq_operands(pw),
                                                   **kw)]
                ops, peak = 2 * K * N, peaks["f32_s"]
            else:
                kw = dict(bits=4, group_size=G, layout="tpu_strided",
                          out_dtype=torch.bfloat16)
                yk = dm.dequant_gemm(x, *woq_operands(pw), None, **kw)
                yp = dm.dequant_gemm_plain(x, *woq_operands(pw), None, **kw)
                run = [lambda c=c: dm.dequant_gemm(x, *c, None, **kw)
                       for c in cps]
                plain = [lambda: dm.dequant_gemm_plain(
                    x, *woq_operands(pw), None, **kw)]
                ops, peak = 2 * M * N * K, peaks["bf16_s"]
            torch.cuda.synchronize()
            tol = woq_tol(torch, x, pw, yp, k9=M == 1)
            d = (yk.float() - yp.float()).abs()
            err, ratio = float(d.max()), float((d / tol).max())
            ok = bool(torch.isfinite(yk).all()) and bool((d <= tol).all())
            if M in (1, WOQ_UNIT_M):
                for fault, fs, fz in woq_faults(pw.scales, pw.zeros):
                    yf = (dm.vpu_gemv(x, pw.packed, fs, fz, **kw) if M == 1
                          else dm.dequant_gemm(x, pw.packed, fs, fz, None,
                                               **kw))
                    df = (yf.float() - yp.float()).abs()
                    caught = int((df > tol).sum())
                    print(f"{'k9' if M == 1 else 'k8'} {name} M={M} planted "
                          f"fault '{fault}': {caught}/{M * N} outputs "
                          f"outside the tolerance, max d/tol="
                          f"{float((df / tol).max()):.3g}", flush=True)
                    if not caught:
                        missed.append(f"{name} M={M} {fault}")
                    del yf, df
            ms = timed_ms(torch, run, 100 if M == 1 else 30)
            pms = timed_ms(torch, plain, 3)
            lms = timed_ms(torch, [lambda b=b: torch.matmul(x, b)
                                   for b in lcps], 30)
            nbytes = M * K * 2 + wbytes + M * N * 2
            bms, by = bound(nbytes, ops, peak, peaks)
            kind = "k9" if M == 1 else "k8"
            rows[kind].append(dict(shape=name, M=M, K=K, N=N, err=err,
                                   tol_ratio=ratio, ok=ok, ms=ms, plain_ms=pms,
                                   library_ms=lms, bound_ms=bms,
                                   bound_by=by))
            print(f"{kind} {name:8s} M={M:4d} K={K:5d} N={N:5d} asym int4 "
                  f"g{G} max_abs_err={err:.3e} "
                  f"max_tol={float(tol.max()):.3e} max d/tol={ratio:.3g} "
                  f"ok={ok} ms={ms:.4f} "
                  f"plain_ms={pms:.4f} library_ms={lms:.4f} "
                  f"bound_ms={bms:.4f} ({by})", flush=True)
        del cps, lcps, wbf
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"K8/K9 disagree with their plain versions: {bad}")
    if missed:
        fail(f"the K8/K9 tolerance missed planted faults: {missed}")
    return rows


def phase_woq_envelope(torch, nct) -> None:
    """K8 and K9 over the weight formats, groups and shapes the llama2-7b
    path does not give them, each against its plain version within
    ``woq_tol``; then ``WOQLinear`` on the card against its copy on the
    CPU (the plain K9 at M == 1, the plain K8 above) with double quant, a
    row permutation, a bias and a pre-scale; f32 activations."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_matmul as dm
    from neural_compressor_tpu_torch.layers import WOQLinear
    from neural_compressor_tpu_torch.ops import apply_double_quant

    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    bad, n = [], 0
    worst = [0.0]   # the largest d / tol of a case

    def x_of(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def cpu(pw):
        return pw._replace(**{f: (None if getattr(pw, f) is None
                                  else getattr(pw, f).cpu())
                              for f in ("packed", "scales", "zeros", "perm",
                                        "sq_scales", "sq_zeros")})

    def check(label, x, pw, k9, out_dtype=torch.bfloat16):
        nonlocal n
        fn = dm.vpu_matvec if k9 else dm.dequant_matmul
        before = (kernels.vpu_gemv.launches if k9
                  else kernels.dequant_gemm.launches)
        yk = fn(x, pw, out_dtype=out_dtype)
        after = (kernels.vpu_gemv.launches if k9
                 else kernels.dequant_gemm.launches)
        yp = fn(x.cpu(), cpu(pw), out_dtype=out_dtype).to("cuda")
        torch.cuda.synchronize()
        d = (yk.float() - yp.float()).abs()
        tol = woq_tol(torch, x, pw, yp, k9)
        worst[0] = max(worst[0], float((d / tol).max()))
        if not (after == before + 1 and bool(torch.isfinite(yk).all())
                and bool((d <= tol).all())):
            bad.append(f"{label} err={float(d.max()):.3e}")
        n += 1

    # formats x groups (K8 at M = 17, K9 at M = 1 where it applies)
    formats = [("sym", "int", 4), ("asym", "int", 4), ("sym", "int", 2),
               ("asym", "int", 2), ("sym", "nf4", 4), ("sym", "fp4", 4),
               ("sym", "int", 8), ("asym", "int", 8)]
    for scheme, dtype, bits in formats:
        for Gs in (32, 64, 128, -1):
            pw = woq_weight(torch, gen, 512, 384, G=Gs, scheme=scheme,
                            dtype=dtype, bits=bits)
            tag = f"{scheme} {dtype} b{bits} G={Gs} ({pw.layout})"
            check(f"k8 M=17 {tag}", x_of(17, 512), pw, k9=False)
            if pw.layout == "tpu_strided" and dtype == "int":
                check(f"k9 {tag}", x_of(1, 512), pw, k9=True)
    # "int8"-layout codes of 4-bit weights, M and N edges, 3-D x
    pw = woq_weight(torch, gen, 256, 256, G=32, force_int8=True)
    check("k8 force_int8 asym4 M=5", x_of(5, 256), pw, k9=False)
    pw = woq_weight(torch, gen, 1024, 128 * 7, G=64)
    for M in (1, 2, 17, 255, 256):
        check(f"k8 M={M} N=896", x_of(M, 1024), pw, k9=False)
    check("k9 N=896", x_of(1, 1024), pw, k9=True)
    check("k8 3-D x (2, 3)", x_of(2, 3, 1024), pw, k9=False)
    check("k9 3-D x (1, 1)", x_of(1, 1, 1024), pw, k9=True)
    pw = woq_weight(torch, gen, 4096, 32000, G=128)
    check("k8 M=2 N=32000", x_of(2, 4096), pw, k9=False)
    check("k8 M=255 N=32000", x_of(255, 4096), pw, k9=False)
    # f32 activations: K9 computes in f32; K8's tensor cores take bf16
    pw = woq_weight(torch, gen, 512, 384, G=64)
    check("k9 f32 x, f32 out", x_of(1, 512, dtype=torch.float32), pw,
          k9=True, out_dtype=torch.float32)
    try:
        dm.dequant_matmul(x_of(8, 512, dtype=torch.float32), pw)
        bad.append("k8 took f32 activations on the card")
    except ValueError:
        n += 1
    del pw

    # WOQLinear: card (auto: K9 at M == 1, K8 above) vs the CPU forced on
    # the plain versions, with the module's own glue
    cases = [("dq", dict(dq=True)), ("perm", dict(perm=True)),
             ("bias", dict(bias=True)), ("pre_scale", dict(pre=True)),
             ("all", dict(dq=True, perm=True, bias=True, pre=True))]
    K, N = 1024, 384
    for label, c in cases:
        perm = (torch.randperm(K, generator=torch.Generator().manual_seed(7))
                .to(torch.int32).cuda() if c.get("perm") else None)
        pw = woq_weight(torch, gen, K, N, G=64, perm=perm)
        if c.get("dq"):
            pw = apply_double_quant(pw, bits=8, group_size=4)
        bias = (0.1 * x_of(N) if c.get("bias") else None)
        pre = (1.0 + 0.5 * torch.rand((K,), generator=gen, device="cuda")
               if c.get("pre") else None)
        mod = WOQLinear(pw, bias=bias, pre_scale=pre)
        ref = copy.deepcopy(mod).to("cpu")
        for M in (1, 9):
            x = x_of(M, K)
            yk = mod(x)
            ref.impl = "vpu" if M == 1 else "pallas"
            yp = ref(x.cpu()).to("cuda")
            torch.cuda.synchronize()
            xs = x if pre is None else (x / pre.to(x.dtype))
            nob = yp if bias is None else (yp - bias.to(yp.dtype))
            tol = woq_tol(torch, xs, pw, yp, k9=M == 1,
                          extra=nob if bias is not None else None)
            d = (yk.float() - yp.float()).abs()
            worst[0] = max(worst[0], float((d / tol).max()))
            if not (bool(torch.isfinite(yk).all()) and bool((d <= tol).all())):
                bad.append(f"WOQLinear {label} M={M} err={float(d.max()):.3e}")
            n += 1
    print(f"woq envelope: {n} cases (formats, groups, M, N, 3-D x, f32 x, "
          f"double quant, perm, bias, pre_scale), card vs plain: "
          f"{'all within tolerance' if not bad else bad}, largest d/tol="
          f"{worst[0]:.3g}", flush=True)
    if bad:
        fail(f"K8/K9 outside the llama2-7b shapes: {bad}")


def set_woq_impl(model, impl: str) -> None:
    """Set every WOQLinear's ``woq_matmul`` impl (the CPU reference takes
    the plain K8 for prefill, the plain K9 for decode)."""
    from neural_compressor_tpu_torch.layers import WOQLinear

    for m in model.modules():
        if type(m) is WOQLinear:
            m.impl = impl


def woq_model(nct, cfg_or_preset, seed, device=None):
    """llama2-7b (or a cut of it) quantized weight-only, asym int4 g128
    with the lm_head, q/k/v and gate/up fused: the W4A16 path."""
    model = nct.build_quantized(cfg_or_preset, nct.RTNConfig(
        dtype="int4", group_size=G, use_sym=False, quant_lm_head=True),
        seed=seed, device=device)
    nct.fuse_for_serving(model)
    return model


def phase_woq_model_check(torch, nct) -> None:
    """A full-width 2-layer llama2-7b asym-int4 W4A16 model on the card
    (K8 prefill, K9 decode) against the same weights on the CPU with the
    plain K8 and K9 forced: a 32-token prefill, then 8 greedy steps; tokens
    equal, logits within 5e-2 of max|logit|."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                          LlamaConfig,
                                                          init_kv_cache)

    torch.set_num_threads(8)
    t0 = time.perf_counter()
    cfg = LlamaConfig(**dict(LLAMA_PRESETS["llama2-7b"], num_hidden_layers=2))
    m_gpu = woq_model(nct, cfg, seed=7, device="cuda")
    m_cpu = copy.deepcopy(m_gpu).to("cpu")
    ids = torch.randint(0, cfg.vocab_size, (1, 32),
                        generator=torch.Generator().manual_seed(8))

    @torch.no_grad()
    def run(model, on_cpu):
        dev = model.device
        caches = init_kv_cache(cfg, 1, 64, device=dev)
        if on_cpu:
            set_woq_impl(model, "pallas")
        logits, caches = model(ids.to(dev), torch.arange(32, device=dev)[None],
                               caches, 0)
        if on_cpu:
            set_woq_impl(model, "vpu")
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

    kernels.reset_launch_counts()
    lg_gpu, tok_gpu = run(m_gpu, False)
    grew = {"dequant_gemm": kernels.dequant_gemm.launches,
            "vpu_gemv": kernels.vpu_gemv.launches}
    lg_cpu, tok_cpu = run(m_cpu, True)
    err = float((lg_gpu - lg_cpu).abs().max())
    ref = float(lg_cpu.abs().max())
    n_proj = 4 * cfg.num_hidden_layers + 1
    ok = (tok_gpu == tok_cpu and math.isfinite(err) and err <= 5e-2 * ref
          and grew == {"dequant_gemm": n_proj, "vpu_gemv": 8 * n_proj})
    print(f"woq model check (2 layers, full width, asym int4 g{G}): tokens "
          f"equal={tok_gpu == tok_cpu} max|logit diff|={err:.4e} "
          f"tol={5e-2 * ref:.4e} card launches {grew} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not ok:
        fail(f"W4A16 card vs CPU: tokens {tok_gpu} vs {tok_cpu}, err {err}, "
             f"launches {grew}")
    del m_cpu, m_gpu


def phase_woq_serve(torch, nct):
    """The slice's path: llama2-7b asym-int4 g128 W4A16 at full width and
    depth, three greedy requests at B=1 (prompts of 16, 100 and 371
    tokens, 48 new each, max_len 1024): K8 prefills the two short prompts,
    the 371-token one takes dequantize-then-matmul (M > 256), K9 and K5
    decode. Exact launch counts; then one prefill and 8 decode steps
    profiled. Returns (launches, model)."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_dot
    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    t0 = time.perf_counter()
    model = woq_model(nct, "llama2-7b", seed=0)
    torch.cuda.synchronize()
    print(f"llama2-7b W4A16 (asym int4 g{G}) built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, model.cfg.vocab_size, (1, P), generator=gen)
               for P in PROMPTS]
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
                fail("non-finite W4A16 prefill logits")
            del caches, logits
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    dequant_dot.calls = 0
    req_s, outs = [], []
    for ids in prompts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(nct.greedy_search(model, ids, max_new_tokens=NEW_TOKENS,
                                      max_len=MAX_LEN))
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t)
    launches = {fn.__name__: fn.launches for fn in kernels.KERNEL_WRAPPERS}
    dots = dequant_dot.calls
    steps = NEW_TOKENS - 1
    n_proj = 4 * LAYERS + 1
    short = sum(P <= 256 for P in PROMPTS)
    want = {"w4a8_gemm": 0, "fused_gemv": 0,
            "decode_attn": len(PROMPTS) * steps * LAYERS,
            "batched_decode_attn": 0, "paged_attn": 0, "paged_write": 0,
            "dequant_gemm": short * n_proj,
            "vpu_gemv": len(PROMPTS) * steps * n_proj}
    want_dots = (len(PROMPTS) - short) * n_proj
    print(f"woq kernels {json.dumps(launches)} expected {json.dumps(want)}; "
          f"dequantize-then-matmul calls {dots} (expected {want_dots}, "
          f"M > 256 only); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for ids, out, s_, pms in zip(prompts, outs, req_s, prefill_ms):
        P = ids.shape[1]
        if (tuple(out.shape) != (1, P + NEW_TOKENS)
                or not torch.equal(out[:, :P].cpu(), ids.to(torch.int32))
                or int(out.min()) < 0
                or int(out.max()) >= model.cfg.vocab_size):
            fail(f"bad W4A16 greedy output for prompt {P}: {out}")
        print(f"woq request prompt={P} new={NEW_TOKENS}: {s_ * 1e3:.1f} ms, "
              f"prefill {pms:.2f} ms, decode "
              f"{steps / (s_ - pms / 1e3):.2f} tok/s (first new tokens "
              f"{out[0, P:P + 8].tolist()})", flush=True)
    if launches != want or dots != want_dots:
        fail(f"W4A16 launch counts {launches} != {want} or dequantize-"
             f"then-matmul calls {dots} != {want_dots}")
    phase_profile(torch, model, prompts[1])
    return launches, model


def phase_woq_engine(torch, nct, model) -> dict:
    """The W4A16 llama2-7b behind ``ContinuousBatchingEngine(n_slots=8,
    max_len=1024)``: 16 greedy requests over contiguous bf16 caches. Each
    decode step runs K8 at M = 8 and K7; a prefill chunk of one row
    (M = 256) runs K8, a chunk of 2+ rows (M >= 512) dequantize-then-
    matmul. The chunks' row counts are observed, the counts derived from
    them and the engine's counters; one B=8 decode dispatch profiled."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_dot

    V = model.cfg.vocab_size
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, V, (PROMPTS[i % len(PROMPTS)],),
                             generator=gen).numpy()
               for i in range(ENGINE_REQUESTS)]
    new = [48 + (7 * i) % 17 for i in range(ENGINE_REQUESTS)]   # 48-64
    eng = nct.ContinuousBatchingEngine(model, n_slots=SLOTS, max_len=MAX_LEN)
    chunk_rows = []
    prefill_forward = eng._prefill_forward

    def observed(target, ids, *args):
        chunk_rows.append(int(ids.shape[0]))
        return prefill_forward(target, ids, *args)

    eng._prefill_forward = observed
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, new)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    dequant_dot.calls = 0
    t = time.perf_counter()
    done = eng.run(chunk=CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in kernels.KERNEL_WRAPPERS}
    dots = dequant_dot.calls
    if sorted(r.uid for r in done) != sorted(r.uid for r in reqs):
        fail(f"W4A16 engine finished {len(done)} of {len(reqs)} requests")
    m = eng.metrics()
    steps = CHUNK * m["decode_dispatches"]
    n_proj = 4 * LAYERS + 1
    C = eng.prefill_chunk
    k8_chunks = sum(r * C <= 256 for r in chunk_rows)
    if len(chunk_rows) != m["prefill_chunk_dispatches"]:
        fail(f"{len(chunk_rows)} prefill chunks seen, the engine counted "
             f"{m['prefill_chunk_dispatches']}")
    want = {"w4a8_gemm": 0, "fused_gemv": 0, "decode_attn": 0,
            "batched_decode_attn": LAYERS * steps, "paged_attn": 0,
            "paged_write": 0, "dequant_gemm": n_proj * (steps + k8_chunks),
            "vpu_gemv": 0}
    want_dots = n_proj * (len(chunk_rows) - k8_chunks)
    counters = {k: m[k] for k in (
        "requests", "prompt_tokens", "generated_tokens",
        "prefill_chunk_dispatches", "decode_dispatches",
        "combined_dispatches", "preemptions")}
    print(f"woq engine contiguous ({SLOTS} x {MAX_LEN} rows, bf16): "
          f"{len(reqs)} requests in {seconds:.3f} s, generated "
          f"{m['generated_tok_s']:.2f} tok/s (metrics wall "
          f"{m['wall_s']:.3f} s), {json.dumps(counters)}, prefill chunk "
          f"rows {chunk_rows} (chunk {C}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"woq engine kernels {json.dumps(launches)} expected "
          f"{json.dumps(want)}; dequantize-then-matmul calls {dots} "
          f"(expected {want_dots}, M > 256 only)", flush=True)
    for r, p, n_ in zip(reqs, prompts, new):
        if (len(r.generated) != n_ or min(r.generated) < 0
                or max(r.generated) >= V
                or not all(math.isfinite(x) for x in r.logprobs)):
            fail(f"W4A16 engine: bad output for a {len(p)}-token prompt: "
                 f"{r.generated}")
    print(f"woq engine first new tokens {[r.generated[:4] for r in reqs[:3]]}",
          flush=True)
    if launches != want or dots != want_dots:
        fail(f"W4A16 engine: launch counts {launches} != {want} or "
             f"dequantize-then-matmul calls {dots} != {want_dots}")
    eng = nct.ContinuousBatchingEngine(model, n_slots=SLOTS, max_len=MAX_LEN)
    for p in prompts[:SLOTS]:
        eng.submit(p, max_new_tokens=64)
    while eng.queue or "prefill" in eng.slot_state:
        eng.run(max_steps=1, chunk=1)
    profile_window(torch, f"woq engine decode dispatch, 8 slots x {CHUNK} "
                   "steps", lambda: eng.step_many(CHUNK))
    eng.run()
    del eng
    return launches



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
    erows = phase_engine_kernels(torch, nct, peaks)
    wrows = phase_woq_kernels(torch, nct, peaks)
    phase_envelope(torch, nct)
    phase_engine_envelope(torch)
    phase_woq_envelope(torch, nct)
    phase_model_check(torch, nct)
    phase_engine_check(torch, nct)
    phase_woq_model_check(torch, nct)
    launches, model, prompts = phase_serve(torch, nct)
    phase_profile(torch, model, prompts[1])
    by_path = {"greedy_b1": launches}
    for mode, counts in phase_engine_serve(torch, nct, model).items():
        by_path[f"engine_{mode}"] = counts
    del model
    gc.collect()
    torch.cuda.empty_cache()
    by_path["woq_greedy_b1"], model = phase_woq_serve(torch, nct)
    by_path["woq_engine_contiguous"] = phase_woq_engine(torch, nct, model)
    del model
    print(f"launches by main path: {json.dumps(by_path)}", flush=True)

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
    layers = lambda rs: [(r, LAYERS) for r in rs]  # noqa: E731
    bytes_ = lambda rs: "bytes"  # noqa: E731
    batched_u = unit(erows["batched"], layers, bytes_)
    pattn_u = unit([r for r in erows["paged_attn"] if r["pool"] == "int8"],
                   layers, bytes_)
    pattn_u["max_abs_err"] = max(r["err"] for r in erows["paged_attn"])
    pwrite_u = unit([r for r in erows["paged_write"] if r["pool"] == "int8"],
                    layers, bytes_)
    pwrite_u["max_abs_err"] = max(r["err"] for r in erows["paged_write"])
    mixed = lambda rs: ("operations" if all(  # noqa: E731
        r["bound_by"] == "operations" for r in rs) else "bytes")
    k8_u = unit([r for r in wrows["k8"] if r["M"] == WOQ_UNIT_M], per_layer,
                mixed)
    k8_u["max_abs_err"] = max(r["err"] for r in wrows["k8"])
    k9_u = unit(wrows["k9"], per_layer, mixed)
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
        ("batched_decode_attn",
         "neural_compressor_tpu_torch/csrc/batched_decode_attention.cu",
         "neural_compressor_tpu/kernels/decode_attention.py:666 "
         "(_batched_attn_impl, K7)", batched_u),
        ("paged_attn", "neural_compressor_tpu_torch/csrc/paged_attention.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:489 "
         "(_paged_attn_impl_v2, K11)", pattn_u),
        ("paged_write", "neural_compressor_tpu_torch/csrc/paged_write.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:641, :661 "
         "(_paged_write_impl, K12)", pwrite_u),
        ("dequant_gemm", "neural_compressor_tpu_torch/csrc/dequant_matmul.cu",
         "neural_compressor_tpu/kernels/dequant_matmul.py:397 "
         "(_dequant_matmul_impl, K8)", k8_u),
        ("vpu_gemv", "neural_compressor_tpu_torch/csrc/dequant_matmul.cu",
         "neural_compressor_tpu/kernels/dequant_matmul.py:286 "
         "(_vpu_matvec_impl, K9)", k9_u),
    ]
    print(smi, flush=True)
    print("unit of the kernels line: w4a8_gemm = one 128-token prefill "
          "(32 layers x 4 projections + lm_head); fused_gemv = one decode "
          "step (32 x 4 + lm_head); decode_attn = one decode step at "
          "pos 517 (32 layers); batched_decode_attn = one 8-slot decode "
          f"step at positions {SLOT_POS} (32 layers); paged_attn and "
          "paged_write = the same step over the int8 pool of 128-row pages "
          "(32 layers; paged_write has no single library call for int8); "
          "dequant_gemm = one 8-slot W4A16 decode step (32 x 4 + lm_head "
          "at M = 8); vpu_gemv = one B=1 W4A16 decode step (32 x 4 + "
          "lm_head). launches: the sum over the main paths (W4A8: B=1 "
          "greedy, the engine contiguous, the engine paged int8; W4A16: "
          "B=1 greedy, the engine contiguous), each counted from 0",
          flush=True)
    kernels_line = {"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[n] for c in by_path.values()),
         "max_abs_err": u["max_abs_err"],
         "ms": u["ms"], "plain_ms": u["plain_ms"], "bound_ms": u["bound_ms"],
         "bound_by": u["bound_by"], "library_ms": u["library_ms"]}
        for n, src, rep, u in entries]}
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
