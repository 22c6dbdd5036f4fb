#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels to account.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; imports nothing of JAX. Phases, any failure exits
non-zero:
  1. build the CUDA kernels from ``neural_compressor_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version at the llama2-7b shapes
     of the main path (B=1 decode and prefill, K1 at the 8-slot engine's
     M = 8 and prompts of 17-512 tokens, bit for bit, with planted faults:
     a flipped nibble, a wrong scale and the group fold in reverse order;
     the 8-slot engine's decode
     over a 1024-row cache and over pools of 128-row pages; W4A16's K8 and
     K9; the quantized caches' K6 (int8, fp8), K7's quantized branch and
     K11/K12 over fp8 and int4 pools), with its time, the plain version's
     time, one PyTorch yardstick call (``library_ms``, never used by the
     port) and the least time the card could take (``bound_ms``); K8/K9
     and the quantized-cache kernels also on planted faults (zeros
     dropped, scales a group or a token late, a K6 that attends the
     quantized new row, a K11 without int4 offsets, a K12 that writes the
     wrong nibble; K9 with a group lost or counted twice at a block
     boundary and a split's partial dropped), each of which the tolerance
     must flag;
  3. the kernels at shapes llama2-7b does not give them (GQA, other head
     widths, ragged M, N and T, group 32, a bias, every W4A16 format,
     positions at 0, at page boundaries and past the end, all-zero K/V
     rows, int4 writes to both nibbles of a byte row, zero-length and idle
     slots, a shared trash page; K5's and K7's splits at the parts'
     boundaries, with a lost part-boundary row planted in each) against
     their plain versions, and a small
     GQA model's greedy tokens on the card against the CPU; the repaired
     envelope (phase 12's ``deepseek_envelope``): any head width in the
     attention kernels (D 16, 80, 96, K7's 384), K1 at group sizes 8, 16
     and 24, K4 at K 262,144, a D-80 llama's greedy against the CPU;
  4. full-width 2-layer models built with ``RTNConfig +
     KVCacheQuantConfig`` on the card (kernels) against the same weights
     on the CPU (plain versions), W4A8 with fused B=1 decode and W4A16, in
     each KV format (bf16, int8, fp8, int4): a 32-token prefill and 8
     greedy steps, tokens equal (over int4 caches, but at near-ties of the
     CPU's top-2 logits; one W4A16 model that parts at one is run too);
     and the W4A8 model served by the engine on the card and on the CPU
     in each pool mode (contiguous bf16/int8/fp8/int4, paged
     bf16/int8/fp8/int4);
  5. llama2-7b at full width, cut to ``W4A8_LAYERS`` = 4 of its 32
     layers for the run's time limit, RTN int4 g128 W4A8, answering
     three greedy requests at B=1 (prompts of 16, 100 and 371 tokens, 48
     new tokens each, max_len 1024), with exact kernel launch counts;
  6. where the time goes at B=1: one prefill and 8 decode steps under
     torch.profiler (wall time, device busy time, top kernels);
  7. the same llama2-7b behind ``ContinuousBatchingEngine(n_slots=8,
     max_len=1024)``: 16 greedy requests (prompts of 16, 100 and 371
     tokens, 48-64 new tokens) over contiguous bf16 caches, then over a
     paged int8 pool, ``run(chunk=8)``, with exact launch counts derived
     from the engine's counters, and one B=8 decode dispatch profiled;
  8. after the W4A8 model is freed, llama2-7b asym-int4 g128 W4A16 at full
     width, cut to ``WOQ_LAYERS`` = 4 of its 32 layers for the run's time
     limit (built with ``RTNConfig + KVCacheQuantConfig``):
     three greedy requests at B=1 and 16 through the 8-slot engine over
     bf16 caches, exact launch counts of K8, K9, K5 and K7 and the
     dequantize-then-matmul calls (M > 256 only), profiled as in 6;
  9. the same model with quantized KV caches: the three B=1 requests over
     int8 and over fp8 caches (K6, K12 writing the row), and the 16 engine
     requests over contiguous int8/fp8 (K7 quant, K12) and int4 caches and
     paged fp8/int4 pools (K11, K12), with tok/s, cache bytes, peak memory, exact launch
     counts and one decode window profiled per format;
 10. greedy speculation: K13 (the verify window's write) and K11's W-query
     window against their plain versions at the 8-slot engine's shapes in
     every pool format, with planted faults, two of them in K11's split of
     the keys (a fold that drops each slot's last part; p rounded against
     its part's own maximum), planted in a float64 emulation of the split
     that without a fault equals the kernel bit for bit (phase 2's
     ``spec_kernels``); K11 at lengths on a part's boundaries with a band
     starting inside a part (phase 3's ``spec_envelope``);
     K5, K6, K7 and K11 over contexts of 16,384-65,536 rows, which their
     score rows in device memory allow (phase 3's ``spec_envelope``);
     prompt lookup, draft-verify and the speculative engine in every pool
     mode on full-width 2-layer models, card against CPU (phase 4's
     ``spec_model_check``); and on the W4A8 model of phase 5,
     ``bench.py``'s B=1 prompt-lookup path and the 8-slot speculative
     engine over contiguous bf16 caches and the paged int8 pool, against
     greedy and the plain engine, exact launch counts, one spec dispatch
     profiled;
 11. Gemma: K11's sliding-band and softcap branches against their plain
     version at gemma2-9b's shapes (8 slots over 8192-row contexts, Hkv 8,
     rep 2, D 256) in every pool format, with planted faults (phase 2's
     ``gemma_kernels``); the device time of K11's two launches at the
     main paths' shapes (``k11_profile``; ``k11_part_sweep`` in a
     development run: the same at parts of 256, 512 and 1024 keys); the
     repaired envelope, K5/K6/K7 at rep 16, K8
     with float32 activations, K4 at K 65,536, and the plain paths where
     JAX declines its kernel, their calls counted (phase 3's
     ``gemma_envelope``); full-width 2-layer gemma2-9b and gemma3-4b-text
     W4A16 (window cut to 64), card against CPU, greedy in every KV format
     and the engine in every pool mode (phase 4's ``gemma_model_check``);
     and gemma2-9b W4A16 at full width, ``GEMMA_LAYERS`` = 6 of its 42
     layers: three B=1 requests
     (prompts of 16, 371 and 4,500 tokens) and the 8-slot engine over
     8192-row paged bf16 and int8 pools (8 requests, 2 past the window),
     its tokens against greedy's, exact launch counts, one decode
     dispatch profiled.
 12. DeepSeek: K14's write and attention against their plain versions at
     deepseek-v3's shapes (8 slots at lengths 1-4096 over a 4096-row
     table of 128-row pages, H 128, C 576, r 512), with planted faults
     (phase 2's ``deepseek_kernels``); K14 at ragged H, small pages, a
     PMAX not a multiple of 4, idle and zero-length slots and 16k-32k
     rows, and the repaired envelope of phase 3 (any head width in K5,
     K6, K7, K11 and K13: D 16, 80, 96 and K7's 384; K1 at group sizes
     8, 16 and 24; K4 at K 262,144, its codes in global memory; a D-80
     llama's greedy on the card against the CPU) (``deepseek_envelope``);
     deepseek-v3's widths cut to 2 layers and 32 routed experts, W4A16,
     card against CPU, greedy over the expanded and every latent cache
     and the engine contiguous and paged (phase 4's
     ``deepseek_model_check``); and deepseek-v3 W4A16 at 2 of its 61
     layers (one dense layer and one MoE layer of 257 experts): three
     B=1 greedy requests over the contiguous latent cache and the 8-slot
     engine over the paged latent pool (K14 each decode step of each
     layer), its tokens against greedy's, exact launch counts, the pool's
     bytes against expanded K/V, one decode dispatch profiled
     (``deepseek_serve``).
 13. The flag-selected decode variants, each set through the port's own
     switch: K15 (v1 paged attention, ``set_paged_v2(False)``), K16 (the
     in-kernel cache write, ``set_cache_write_mode("kernel")``, bf16 and
     int8; the bulk-copied caches, ``set_ro_cache_space("hbm")``), K17
     (o + MLP in one cooperative launch, ``set_omlp_fused(True)``) and K18
     (attention inside the o-projection, ``ATTN_O_FUSED``): each against
     its plain version at llama2-7b's shapes with planted faults (K15's
     split: the running maximum restarted at each part, a lost
     part-boundary row) (``variant_kernels``); at rep 1/4/8, D 64/80, K17's tiles of h,
     K17's and K18's declines counted, and the repaired K5's per-slot
     positions (``variant_envelope``); a full-width 2-layer llama2-7b
     under each switch, card against CPU, and the v1 engine over paged
     bf16, int8 and fp8 pools (``variant_model_check``); and phase 5's
     model at B=1 under each switch (prompts 16 and 371, 48 new; K16's
     int8 write over an int8 cache) and the 8-slot v1 engine over paged
     bf16 and int8 pools (16 requests), each against the default path in
     the same run, exact launch counts (``variant_serve``).
 14. Hybrid GPTQ (W4A8) and the last two TPU kernels: K2 (``s4_gemm``, on
     "s4_rowpack" words) at M 1, 8 and 128, K1 on "tpu_strided" words
     (``w4a8_gemm_strided``, the repair) at M 4, 8 and 128, and K10
     (``vpu_int8act``, the all-integer M = 1 matvec) at the B=1 step's
     shapes in sym and asym int4, int2 and with a row permutation, bit for
     bit against their plain versions (K10's device ms beside its event
     ms, every K10 launch repeated bit for bit), with planted faults
     (``hybrid_kernels``; K10's include its block boundaries and tiles
     folded out of order); their envelope and its declines
     (``hybrid_envelope``); and llama2-7b at full width, ``HYB_LAYERS`` = 2
     of its 32 layers, calibrated on the card by ``quantize(...,
     HybridGPTQConfig(...), run_fn=calibration_forward)`` over 8 random
     sequences of 512 tokens (GPTQ's objective under RTN's for every
     matrix, one matrix's codes against the CPU's), then served three
     ways, each against the same weights' plain path: "s4_rowpack" (B=1
     greedy and the 8-slot engine: K2 at every M), "tpu_strided" under
     ``M_INT8_THRESHOLD = 2`` (B=1 greedy: K1's strided loader and K10) and
     "hopper_nk" with fused decode (``hybrid_serve``).
Development runs name checks of phases 2-4, 13 and 14, ``k11_part_sweep``,
``w4a8_core`` (K1 and K2 on the shared core's plans at llama2-7b's five
projections, M 1-512, device times; other tiles:
``tools/w4a8_core_sweep.py``), ``k8_core`` (K8 on its plans at
llama2-7b's five projections and DeepSeek-V3's expert shapes, M 1-32, 100,
128, 256, device times; other plans: ``tools/k8_sweep.py``), or
``deepseek_serve``, ``variant_serve`` or
``hybrid_serve``, as arguments (``python3 chip_smoke.py variant_kernels
variant_envelope``): the build, those checks, no result line.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on the main path and its times.
"""

from __future__ import annotations

import contextlib
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
W4A8_LAYERS = 4               # depth of the served W4A8 model (5-7, 10, 13)
PROMPTS, NEW_TOKENS = (16, 100, 371), 48
GEMM_MS = (8, 17, 128, 512)
UNIT_M = 128                  # the GEMM row of the kernels line: a 128-token prefill
STEP_M = 8                    # K1's second unit: one step of the 8-slot engine
ATTN_POS = (0, 517, 1023)
UNIT_POS = 517                # the attention row: one decode step at pos 517
TOL = {"gemm": 1e-5, "gemv": 1e-2, "attn": 1e-2, "batched": 1e-2,
       "paged_write": 0.0}
# the engine: 8 slots; its decode positions spread over the 1024-row cache
SLOTS, PAGE, CHUNK = 8, 128, 8
SLOT_POS = (0, 127, 128, 300, 517, 640, 901, 1023)
ENGINE_REQUESTS = 16
KV_FORMATS = ("int8", "fp8_e4m3", "int4")
POOL_FORMATS = ("bf16",) + KV_FORMATS


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


# K5's, K6's and K7's kernels (csrc/decode_split.cuh), as torch.profiler
# names them
SPLIT_KERNELS = ("nctt_dsplit::",)
# K15's two kernels (K11's scores launch in its v1 form, csrc/
# paged_attention_v1.cu's PV and fold)
V1_KERNELS = ("nctt_k11::scores_kernel", "nctt_v1::pv_fold_kernel")


def split_positions(torch, fmt, dev):
    """A cache length of three of K6's and K7's key parts and a tail
    (``decode_plan``), and slot positions on the split's boundaries: key 0,
    a part's last key, its first, the key after, a later part's first, the
    last row and past the end -> (T, part keys, int32 [7] positions)."""
    from neural_compressor_tpu_torch.kernels.decode_attention import \
        decode_plan

    pk = decode_plan(1, 1, 1, 1, 128, fmt).part_keys
    T = 3 * pk + 40
    pos = torch.tensor([0, pk - 1, pk, pk + 1, 2 * pk, T - 1, T + 3],
                       dtype=torch.int32, device=dev)
    return T, pk, pos


T_START = time.perf_counter()


def timed_phase(name: str, fn):
    """Run one phase; print its wall time and the time since the start."""
    t = time.perf_counter()
    out = fn()
    print(f"phase {name}: {time.perf_counter() - t:.1f} s (at "
          f"{time.perf_counter() - T_START:.1f} s)", flush=True)
    return out


# the kernels-line entries of the wrappers that count their launches per
# cache format: wrapper -> {entry: formats}
FORMAT_ENTRIES = {
    "batched_decode_attn": {"batched_decode_attn": ("bf16",),
                            "batched_decode_attn_quant": ("int8",
                                                          "fp8_e4m3")},
    "paged_attn": {"paged_attn": ("bf16", "int8"),
                   "paged_attn_fp8": ("fp8_e4m3",),
                   "paged_attn_int4": ("int4",)},
    "paged_write": {"paged_write": ("bf16", "int8"),
                    "paged_write_fp8": ("fp8_e4m3",),
                    "paged_write_int4": ("int4",)},
    # the speculative verify window's kernels, every pool format in one
    # entry (the full-depth main path runs the int8 pool; the 2-layer check
    # runs each format)
    "paged_write_window_kernel": {"paged_write_window": POOL_FORMATS},
    "paged_window_attn": {"paged_window_attn": POOL_FORMATS},
    # K11's gemma branches, every pool format: the band (sliding layers,
    # with or without the softcap) and the softcap alone (gemma-2's global
    # layers); one kernels-line entry, paged_attn_gemma (LINE_SUMS)
    "paged_attn_gemma": {
        "paged_attn_gemma_band": tuple(f"band_{f}" for f in POOL_FORMATS),
        "paged_attn_gemma_softcap": tuple(f"softcap_{f}"
                                          for f in POOL_FORMATS)},
    # K15 (v1 paged attention) over every pool format it takes, one entry
    "paged_attn_v1": {"paged_attn_v1": ("bf16", "int8", "fp8_e4m3")},
    # K16's in-kernel write: bf16 and int8 caches apart
    "decode_attn_write": {"decode_attn_write": ("bf16",),
                          "decode_attn_write_int8": ("int8",)}}
# kernels-line entries that sum several launch_counts() entries
LINE_SUMS = {"paged_attn_gemma": ("paged_attn_gemma_band",
                                  "paged_attn_gemma_softcap")}


def launch_counts() -> dict:
    """Every kernel's launches since the last reset, by kernels-line entry
    (``FORMAT_ENTRIES`` splits a wrapper's per-format counts)."""
    from neural_compressor_tpu_torch import kernels

    out = {}
    for fn in kernels.KERNEL_WRAPPERS:
        if isinstance(fn.launches, dict):
            for entry, fmts in FORMAT_ENTRIES[fn.__name__].items():
                out[entry] = sum(fn.launches[f] for f in fmts)
        else:
            out[fn.__name__] = fn.launches
    return out


def expect(**nonzero) -> dict:
    """Expected launch counts: the named kernels at their counts, every
    other kernel wrapper at 0."""
    want = {name: 0 for name in launch_counts()}
    unknown = set(nonzero) - set(want)
    if unknown:
        fail(f"no kernel wrappers named {sorted(unknown)}")
    want.update(nonzero)
    return want


def flip_nibbles(torch, w):
    """A copy of packed words with one 32-bit word's eight nibbles flipped
    (bit 3 of each, in the middle of the tensor)."""
    w = w.clone()
    flat = w.view(-1).view(torch.int32)
    flat[flat.numel() // 2 + 3] ^= -0x77777778   # 0x88888888
    return w


def bad_scale(s, by=None):
    """One group scale 1.5 times too large (or, ``by`` given, one zero
    point ``by`` off)."""
    s = s.clone()
    i, j = s.shape[0] // 2, s.shape[1] // 3
    if by is None:
        s[i, j] *= 1.5
    else:
        s[i, j] += by
    return s


def grouped_products(torch, xq, codes, scales):
    """The core's per-group products on the card: each group's exact
    integer sum (float64 matmul; |sum| < 2^53) times its scale in float32,
    [K/G, M, N]."""
    M, K = xq.shape
    ng, N = scales.shape
    Gs = K // ng
    part = torch.bmm(xq.double().reshape(M, ng, Gs).transpose(0, 1),
                     codes.double().reshape(ng, Gs, N))
    return part.float() * scales[:, None, :]


def fold_products(torch, prods, x_scale, order):
    """The group fold over ``order`` (group indices) from 0, float32 adds,
    times x_scale: the core's arithmetic, or a planted fault in it."""
    acc = torch.zeros(prods.shape[1:], dtype=torch.float32,
                      device=prods.device)
    for g in order:
        acc = acc + prods[g]
    return acc * x_scale[:, None]


def gemm_faults(torch, xq, pw, xs, yk, yp):
    """K1 ("hopper_nk") on planted faults, each of which the bit comparison
    must flag: a flipped nibble, a wrong scale, and the group fold in
    reverse order, planted in an emulation of the core's arithmetic on the
    card that without the fault equals the kernel bit for bit (else the
    phase fails). Returns [(label, flagged)]."""
    from neural_compressor_tpu_torch.kernels import w4a8_gemm
    from neural_compressor_tpu_torch.ops.packing import unpack_codes_hopper

    out = [("k1 flipped nibble",
            not torch.equal(w4a8_gemm(xq, flip_nibbles(torch, pw.packed),
                                      pw.scales, xs), yp)),
           ("k1 wrong scale",
            not torch.equal(w4a8_gemm(xq, pw.packed, bad_scale(pw.scales),
                                      xs), yp))]
    prods = grouped_products(torch, xq, unpack_codes_hopper(pw.packed),
                             pw.scales)
    ng = prods.shape[0]
    if not torch.equal(fold_products(torch, prods, xs, range(ng)), yk):
        fail("the emulated group fold differs from K1")
    out.append(("k1 fold in reverse group order",
                not torch.equal(fold_products(torch, prods, xs,
                                              range(ng - 1, -1, -1)), yk)))
    return out


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

    # GEMM: every projection at the 8-slot engine's step and three prompt
    # lengths, bit for bit against the plain version (each path of the
    # core keeps its order of float operations)
    faults = []
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
            ok = bool(torch.equal(yk, yp))
            ms = timed_ms(torch, [lambda p=p, s=s: w4a8_gemm(xq, p, s, xs)
                                  for p, s in cps], 50)
            pms = timed_ms(torch, [lambda: w4a8_gemm_plain(
                xq, pw.packed, pw.scales, xs)], 5)
            lms = timed_ms(torch, [lambda: torch.matmul(x, wbf)], 50)
            nbytes = M * K + K * N // 2 + (K // G) * N * 4 + M * 4 + M * N * 4
            bms, by = bound(nbytes, 2 * M * N * K, peaks["int8_s"], peaks)
            rows["gemm"].append(dict(shape=name, M=M, K=K, N=N, err=err,
                                     ok=ok, ms=ms, plain_ms=pms,
                                     library_ms=lms, bound_ms=bms,
                                     bound_by=by))
            print(f"gemm {name:8s} M={M:4d} K={K:5d} N={N:5d} "
                  f"bit-equal={ok} max_abs_err={err:.3e} ms={ms:.4f} "
                  f"plain_ms={pms:.4f} library_ms={lms:.4f} "
                  f"bound_ms={bms:.4f} ({by})", flush=True)
            if name == "o" and M == STEP_M:
                faults += gemm_faults(torch, xq, pw, xs, yk, yp)
        del cps
    missed = [label for label, flagged in faults if not flagged]
    for label, flagged in faults:
        print(f"planted fault {label}: flagged={flagged}", flush=True)
    if missed:
        fail(f"planted faults not flagged: {missed}")

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
        # K5 reads the position on the device, as an int32 [B] tensor; its
        # split keeps every bit of the plain version (max_abs_err 0)
        posd = torch.tensor([pos], dtype=torch.int32, device=dev)
        ok_ = decode_attn(q, k, v, posd)
        op = decode_attn_plain(q, k, v, posd)
        torch.cuda.synchronize()
        err = float((ok_.float() - op.float()).abs().max())
        ok = math.isfinite(err) and err <= TOL["attn"] and err == 0
        L = pos + 1
        fns = [lambda a=a, b=b: decode_attn(q, a, b, posd) for a, b in kv]
        ms = timed_ms(torch, fns, 200)
        dms = sum(profiled(torch, fns, names=SPLIT_KERNELS).values())
        pms = timed_ms(torch, [lambda: decode_attn_plain(q, k, v, posd)],
                       20)
        q4 = q[:, :, None]
        lms = timed_ms(torch, [
            lambda a=a, b=b: torch.nn.functional.scaled_dot_product_attention(
                q4, a[:, :, :L], b[:, :, :L]) for a, b in kv], 200)
        nbytes = H * D * 2 * 2 + 2 * Hkv * L * D * 2
        bms, by = bound(nbytes, 4 * H * L * D, peaks["bf16_s"], peaks)
        rows["attn"].append(dict(pos=pos, err=err, tol=TOL["attn"], ok=ok,
                                 ms=ms, device_ms=dms, plain_ms=pms,
                                 library_ms=lms, bound_ms=bms, bound_by=by))
        print(f"attn pos={pos:4d} T={T} H={H} Hkv={Hkv} D={D} "
              f"max_abs_err={err:.3e} tol={TOL['attn']:.1e} ok={ok} "
              f"ms={ms:.4f} device_ms={dms:.4f} plain_ms={pms:.4f} "
              f"library_ms={lms:.4f} bound_ms={bms:.4f} ({by})", flush=True)
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

    def record(kind, label, err, tol, ms, pms, lms, nbytes, ops, ok=None,
               **extra):
        """``tol`` an absolute tolerance, or a label where ``ok`` says
        whether the outputs held an elementwise one (K11: ``kv_tol``)."""
        if ok is None:
            ok = math.isfinite(err) and err <= tol
        bms, by = bound(nbytes, ops, peaks["bf16_s"], peaks)
        rows[kind].append(dict(label=label, err=err, tol=tol, ok=ok, ms=ms,
                               plain_ms=pms, library_ms=lms, bound_ms=bms,
                               bound_by=by, **extra))
        lib = "null" if lms is None else f"{lms:.4f}"
        tol_s = tol if isinstance(tol, str) else f"{tol:.1e}"
        dev_s = (f" device_ms={extra['device_ms']:.4f}"
                 if "device_ms" in extra else "")
        print(f"{kind} {label} max_abs_err={err:.3e} tol={tol_s} ok={ok} "
              f"ms={ms:.4f}{dev_s} plain_ms={pms:.4f} library_ms={lib} "
              f"bound_ms={bms:.4f} ({by})", flush=True)

    # K7: one layer's decode step of the contiguous engine
    kv = [(randn(B, Hkv, T, D), randn(B, Hkv, T, D))
          for _ in range(n_copies(2 * B * Hkv * T * D * 2))]
    k, v = kv[0]
    out = batched_decode_attn(q, k, v, pos)
    ref = batched_decode_attn_plain(q, k, v, pos)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    fns = [lambda a=a, b=b: batched_decode_attn(q, a, b, pos) for a, b in kv]
    ms = timed_ms(torch, fns, 200)
    dms = sum(profiled(torch, fns, names=SPLIT_KERNELS).values())
    pms = timed_ms(torch, [lambda: batched_decode_attn_plain(q, k, v, pos)], 5)
    lms = timed_ms(torch, [lambda a=a, b=b: sdpa(q4, a[:, :, :Lmax],
                                                  b[:, :, :Lmax],
                                                  attn_mask=mask)
                           for a, b in kv], 200)
    record("batched", f"B={B} H={H} Hkv={Hkv} D={D} T={T} pos={SLOT_POS}",
           err, TOL["batched"], ms, pms, lms,
           2 * Hkv * n_vis * D * 2 + 2 * B * H * D * 2 + B * 4,
           4 * H * n_vis * D, device_ms=dms)
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
        d = (out.float() - ref.float()).abs()
        err = float(d.max())
        # held at kv_tol, as K11's other phases hold it
        ok = (bool(torch.isfinite(out.float()).all())
              and bool((d <= kv_tol(ref)).all()))
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
               "kv_tol", ms, pms, lms,
               2 * Hkv * n_vis * (D * esize + (4 if quant else 0))
               + 2 * B * H * D * 2 + B * pmax * 4 + B * 4,
               4 * H * n_vis * D, ok=ok, pool=tag)
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


def boundary_fault(torch, label, got, want) -> str | None:
    """A planted fault of the split (the kernel at position p - 1, p a
    part's first key, against the plain version at p: the boundary key
    lost): None when the outputs part outside ``kv_tol``, else a failure."""
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    caught = int((d > kv_tol(want)).sum())
    print(f"planted fault '{label}: a part's boundary key lost': "
          f"{caught}/{d.numel()} outputs outside kv_tol", flush=True)
    return None if caught else f"fault not flagged: {label}"


def row_at(x, p):
    """Row p[b] of each slot of x [B, Hkv, T, ...] -> [B, Hkv, ...]."""
    return x[range(x.shape[0]), :, p.long()]


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
    kernels.reset_launch_counts()
    got = nct.greedy_search(m_gpu, ids, max_new_tokens=16, max_len=64)
    grew = launch_counts()
    L = cfg.num_hidden_layers
    if not torch.equal(got.cpu(), want):
        bad.append(f"GQA model tokens {got.tolist()} vs {want.tolist()}")
    if grew != expect(w4a8_gemm=4 * L + 1, fused_gemv=15 * (4 * L + 1),
                      decode_attn=15 * L):
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
    row (that row excepted: the race leaves it unspecified). K7's and K5's
    splits of the keys at positions on the parts' boundaries, each with a
    planted fault: a lost part-boundary key."""
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
    # K7's split of the keys: a cache of three parts and a tail, slots on
    # the parts' boundaries, GQA and head widths to 512
    T, pk, spos = split_positions(torch, "bf16", dev)
    for H, Hkv, D in ((32, 32, 128), (16, 4, 64), (32, 2, 128), (8, 2, 256),
                      (8, 2, 384), (12, 2, 512), (6, 2, 80)):
        q = (randn(7, H, D).float() * 4).to(torch.bfloat16)
        k, v = randn(7, Hkv, T, D), randn(7, Hkv, T, D)
        check(f"batched split H={H} Hkv={Hkv} D={D} T={T} "
              f"pos={spos.tolist()}", kernels.batched_decode_attn(q, k, v,
                                                                  spos),
              kernels.batched_decode_attn_plain(q, k, v, spos))
        n += 1
    # the planted fault: each slot's query is 8x its key at p, a part's
    # first key, so that key carries the softmax
    p = torch.tensor([pk, 2 * pk], dtype=torch.int32, device=dev)
    k, v = randn(2, 4, T, 128), randn(2, 4, T, 128)
    q = (row_at(k, p) * 8).repeat_interleave(4, dim=1)
    miss = boundary_fault(torch, "k7 bf16",
                          kernels.batched_decode_attn(q, k, v, p - 1),
                          kernels.batched_decode_attn_plain(q, k, v, p))
    if miss:
        bad.append(miss)
    # K5 on K6's split over bf16 rows: the same boundaries, its plan's
    # (decode_plan with k6), GQA and head widths to 256, then its own
    # planted fault (a lost part-boundary row)
    T, pk, spos = split_positions(torch, "bf16", dev)
    for H, Hkv, D in ((32, 32, 128), (16, 4, 64), (32, 2, 128), (8, 2, 256),
                      (6, 2, 80), (16, 1, 96)):
        q = (randn(7, H, D).float() * 4).to(torch.bfloat16)
        k, v = randn(7, Hkv, T, D), randn(7, Hkv, T, D)
        check(f"k5 split H={H} Hkv={Hkv} D={D} T={T} pos={spos.tolist()}",
              kernels.decode_attn(q, k, v, spos),
              kernels.decode_attn_plain(q, k, v, spos))
        n += 1
    k, v = randn(2, 4, T, 128), randn(2, 4, T, 128)
    q = (row_at(k, p) * 8).repeat_interleave(4, dim=1)
    miss = boundary_fault(torch, "k5 bf16",
                          kernels.decode_attn(q, k, v, p - 1),
                          kernels.decode_attn_plain(q, k, v, p))
    if miss:
        bad.append(miss)
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


# engine mode -> (engine arguments, KV-cache format or None for bf16)
ENGINE_MODES = {"contiguous": ({}, None),
                "paged_bf16": (dict(paged=True), None),
                "paged_int8": (dict(paged=True), "int8"),
                "contiguous_int8": ({}, "int8"),
                "contiguous_fp8": ({}, "fp8_e4m3"),
                "contiguous_int4": ({}, "int4"),
                "paged_fp8": (dict(paged=True), "fp8_e4m3"),
                "paged_int4": (dict(paged=True), "int4")}
# the modes this slice adds (quantized KV caches)
KV_MODES = ("contiguous_int8", "contiguous_fp8", "contiguous_int4",
            "paged_fp8", "paged_int4")


@contextlib.contextmanager
def unpack_once(held=None):
    """Within the block each packed weight is unpacked once: the plain
    kernel versions unpack their weight on every call, which sets the pace
    of a full-width reference model on the CPU. The codes (int8, as the
    unpackers return them, and the W4A8 codes as float32), the plain K8's
    float32 weights, the plain K9's float32 fields and the weights of the
    dequantize-then-matmul path are held until the block ends, or in
    ``held`` (a dict the caller clears) across the blocks that pass it, so
    a phase's modes unpack each weight once; callers only read them."""
    import torch

    from neural_compressor_tpu_torch.kernels import dequant_matmul
    from neural_compressor_tpu_torch.ops import packing

    s4m, w4m = port_module("s4_matmul"), port_module("w4a8_matmul")
    own = held is None
    held = {} if own else held

    def once(fn):
        def unpack(packed, *args, **kw):
            key = (id(packed), fn.__name__, args, tuple(sorted(kw.items())))
            hit = held.get(key)
            if hit is None or hit[0] is not packed:
                hit = held[key] = (packed, fn(packed, *args, **kw))
            return hit[1]
        return unpack

    def once_pw(fn):
        """``fn(pw, cdt)``, held by the identity of the weight's tensors
        (each call passes a new PackedWeight of the same tensors)."""
        def weight(pw, cdt):
            key = (tuple(id(f) if isinstance(f, torch.Tensor) else f
                         for f in pw), cdt)
            hit = held.get(key)
            if hit is None or any(a is not b for a, b in zip(hit[0], pw)
                                  if isinstance(a, torch.Tensor)):
                hit = held[key] = (pw, fn(pw, cdt))
            return hit[1]
        return weight

    saved = [(packing, "unpack_codes_hopper"), (packing, "unpack_codes"),
             (packing, "unpack_codes_hopper_f32"),
             (dequant_matmul, "unpack_codes"),
             (dequant_matmul, "plain_weight_f32"),
             (dequant_matmul, "codes_f32"),
             (s4m, "unpack_codes_s4"), (w4m, "unpack_codes")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    saved.append((dequant_matmul, "dot_weight_f32",
                  dequant_matmul.dot_weight_f32))
    for mod, name, fn in saved:
        setattr(mod, name, once_pw(fn) if name == "dot_weight_f32"
                else once(fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        if own:
            held.clear()


@contextlib.contextmanager
def quantized_on_card():
    """Within the block, the quantize pass of ``build_quantized`` runs on
    the card: each layer's float weights still come from the CPU's
    generator, RTN's codes, scales and packed words are the same bits there
    (exact elementwise IEEE operations and integer packing) in a fraction
    of the CPU's time, and each layer comes back to the CPU."""
    import importlib

    qmod = importlib.import_module(
        "neural_compressor_tpu_torch.quantization.quantize")
    cpu_quantize = qmod.quantize

    def quantize(model, quant_config, *args, **kw):
        out = cpu_quantize(model.to("cuda"), quant_config, *args, **kw)
        model.to("cpu")
        return out

    qmod.quantize = quantize
    try:
        yield
    finally:
        qmod.quantize = cpu_quantize


def w4a8_pair(nct, cfg, quant_config, seed: int):
    """A llama from ``seed`` (weights from the CPU's generator), RTN on the
    card (``quantized_on_card``), fused for serving on "hopper_nk" with
    fused B=1 decode on the card -> (CPU copy, card model), the same bits
    as building, fusing and converting it on the CPU."""
    with quantized_on_card():
        model = nct.build_quantized(cfg, quant_config, seed=seed,
                                    device="cpu")
    model = model.to("cuda")
    nct.fuse_for_serving(model)
    nct.to_w4a8_serving(model)
    nct.enable_fused_decode(model)
    return copy.deepcopy(model).to("cpu"), model


def set_kv_format(model, fmt) -> None:
    """Flag ``model``'s KV-cache format as ``KVCacheQuantConfig`` does;
    None for bf16 caches."""
    model.kv_cache_quantized = fmt is not None
    model.kv_cache_format = fmt or "int8"


def engine_for(nct, model, mode, **kw):
    """A ``ContinuousBatchingEngine`` in ``mode`` on ``model``; the model's
    KV format is set for the engine's allocation and cleared after."""
    mode_kw, fmt = ENGINE_MODES[mode]
    set_kv_format(model, fmt)
    try:
        return nct.ContinuousBatchingEngine(model, **{**kw, **mode_kw})
    finally:
        set_kv_format(model, None)


def serve_engine(torch, nct, model, mode, prompts, new_tokens,
                 chunk=CHUNK, **kw):
    """A fresh engine in ``mode`` on ``model``'s device, the prompts
    submitted, run dry; returns (engine, requests, seconds)."""
    on_card = model.device.type == "cuda"
    eng = engine_for(nct, model, mode, **kw)
    reqs = [eng.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, new_tokens)]
    if on_card:
        torch.cuda.synchronize()
    t = time.perf_counter()
    done = eng.run(chunk=chunk)
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    if sorted(r.uid for r in done) != sorted(r.uid for r in reqs):
        fail(f"engine ({mode}) finished {len(done)} of {len(reqs)} requests")
    return eng, reqs, seconds


def phase_engine_check(torch, nct) -> None:
    """A full-width 2-layer llama2-7b served by the engine on the card
    (kernels) and on the CPU (plain versions), the same weights and
    requests, in each pool mode (``ENGINE_MODES``: bf16, and the int8,
    fp8 and int4 caches and pools): the tokens must be equal and the
    mode's kernels must have run."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                          LlamaConfig)

    torch.set_num_threads(8)
    t0 = time.perf_counter()
    cfg = LlamaConfig(**dict(LLAMA_PRESETS["llama2-7b"], num_hidden_layers=2))
    m_cpu, m_gpu = w4a8_pair(nct, cfg, nct.RTNConfig(
        dtype="int4", group_size=G, quant_lm_head=True), seed=4)
    gen = torch.Generator().manual_seed(5)
    lens = (12, 20, 5, 33)
    prompts = [torch.randint(0, cfg.vocab_size, (P,), generator=gen).numpy()
               for P in lens]
    new = (5, 4, 5, 3)
    # the quantized caches' modes: fewer new tokens (the CPU side of a
    # decode step at full width sets this phase's time)
    new_kv = (3, 2, 3, 2)
    kw = dict(n_slots=4, max_len=128, prefill_chunk=16, page_size=32)
    path = {"contiguous": ("batched_decode_attn",),
            "paged_bf16": ("paged_attn", "paged_write"),
            "paged_int8": ("paged_attn", "paged_write"),
            "contiguous_int8": ("batched_decode_attn_quant", "paged_write"),
            "contiguous_fp8": ("batched_decode_attn_quant",
                               "paged_write_fp8"),
            # int4 contiguous caches attend in plain PyTorch, as in JAX
            "contiguous_int4": ("w4a8_gemm",),
            "paged_fp8": ("paged_attn_fp8", "paged_write_fp8"),
            "paged_int4": ("paged_attn_int4", "paged_write_int4")}
    held = {}  # the CPU's unpacked weights, shared by the modes
    for mode in ENGINE_MODES:
        # the earlier modes: 3 requests on 4 slots; the quantized caches:
        # 4 requests on the engine's 8 slots
        n = 4 if mode in KV_MODES else 3
        mkw = dict(kw, n_slots=8) if mode in KV_MODES else kw
        t1 = time.perf_counter()
        kernels.reset_launch_counts()
        mnew = (new_kv if mode in KV_MODES else new)[:n]
        _e, got, _s = serve_engine(torch, nct, m_gpu, mode, prompts[:n],
                                   mnew, chunk=2, **mkw)
        launched = launch_counts()
        with unpack_once(held):
            _e, want, _s = serve_engine(torch, nct, m_cpu, mode, prompts[:n],
                                        mnew, chunk=2, **mkw)
        toks = [r.generated for r in got]
        ok = (toks == [r.generated for r in want]
              and all(launched[k] > 0 for k in path[mode]))
        print(f"engine check {mode} (2 layers, full width): card tokens "
              f"{toks} cpu tokens {[r.generated for r in want]} launches "
              f"{ {k: v for k, v in launched.items() if v} } "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
        if not ok:
            fail(f"engine {mode}: card and CPU differ or the path's kernels "
                 "did not run")
    print(f"engine check done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    held.clear()
    del m_cpu, m_gpu


def unit(rows, pick, bound_by) -> dict:
    """Sum the per-launch numbers over one main-path unit of work:
    32 layers' projections plus the lm_head, or 32 layers' attention.
    A number that is None in any row (no library call) stays None."""
    out = {}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms"):
        picked = [(r.get(key), w) for r, w in pick(rows)]
        out[key] = (None if any(x is None for x, _w in picked)
                    else sum(w * x for x, w in picked))
    out["bound_by"] = bound_by(rows)
    out["max_abs_err"] = max(r["err"] for r in rows)
    return out


def two_layer_check(torch, label, m_cpu, m_gpu, ids, woq: bool,
                    formats=(None,) + KV_FORMATS, max_len: int = 64,
                    tie_any: bool = False, want_fn=None, held=None) -> None:
    """A full-width 2-layer model on the card (kernels) against the same
    weights on the CPU (plain versions; W4A16 forced onto the plain K8 for
    the prefill and the plain K9 for decode), in each KV format of
    ``formats`` (None for bf16): a 32-token prefill, then 8 greedy steps.
    The card decodes freely; the CPU is fed the card's tokens, so each step
    compares the two on the same inputs: logits within 5e-2 of
    max|logit|, and the greedy tokens equal at every step. int4 caches
    alone may part at a near-tie: a step where the CPU's top-2 gap is at
    most the logit difference measured there (W4A16's K8/K9 round apart
    from their plain versions by float32 ulps, which move int4 codes by a
    whole step; printed with the gap and the difference); ``tie_any``
    allows that in every format (a gemma's final softcap squeezes its
    logits, ``card_cpu_tie``). Exact launch counts of the card's run
    (``want_fn(fmt)``, else a Llama's). ``max_len`` rows of cache. The
    CPU's unpacked weights are shared by the formats, and with the caller
    where it passes ``held`` (``unpack_once``)."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    cfg = m_cpu.cfg
    L, P = cfg.num_hidden_layers, ids.shape[1]
    n_proj = 4 * L + 1

    @torch.no_grad()
    def run(model, fmt, forced=None):
        dev = model.device
        caches = init_kv_cache(cfg, 1, max_len, quantized=fmt or False,
                               device=dev)
        cpu = woq and dev.type == "cpu"
        if cpu:
            set_woq_impl(model, "pallas")
        logits, caches = model(ids.to(dev), torch.arange(P, device=dev)[None],
                               caches, 0)
        if cpu:
            set_woq_impl(model, "vpu")
        rows, toks = [logits[0, -1].float().cpu()], []
        for i in range(8):
            tok = int(torch.argmax(rows[-1])) if forced is None else forced[i]
            toks.append(tok)
            pos = P + i
            logits, caches = model(torch.tensor([[tok]], device=dev),
                                   torch.full((1, 1), pos, device=dev),
                                   caches, pos)
            rows.append(logits[0, -1].float().cpu())
        return torch.stack(rows), toks

    own = held is None
    held = {} if own else held
    for fmt in formats:
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        lg_gpu, tok_gpu = run(m_gpu, fmt)
        launched = launch_counts()
        with unpack_once(held):
            lg_cpu, _ = run(m_cpu, fmt, forced=tok_gpu)
        diff = (lg_gpu - lg_cpu).abs().amax(dim=1)          # per step
        err, ref = float(diff.max()), float(lg_cpu.abs().max())
        cpu_tok = lg_cpu.argmax(dim=1).tolist()
        card_tok = tok_gpu + [int(lg_gpu[-1].argmax())]
        ties, parted = [], []
        for i, (a, b) in enumerate(zip(card_tok, cpu_tok)):
            if a != b:
                gap = float(lg_cpu[i, b] - lg_cpu[i, a])
                tie = (fmt == "int4" or tie_any) and gap <= float(diff[i])
                (ties if tie else parted).append(
                    dict(step=i, card=a, cpu=b, gap=gap,
                         diff=float(diff[i])))
        # B=1 decode: K5 (bf16) or K6 attends; K12 writes int8/fp8 rows
        attn = {None: {"decode_attn": 8 * L}, "int4": {},
                "int8": {"decode_attn_quant": 8 * L, "paged_write": 8 * L},
                "fp8_e4m3": {"decode_attn_quant": 8 * L,
                             "paged_write_fp8": 8 * L}}[fmt]
        want = want_fn(fmt) if want_fn else expect(
            **({"w4a8_gemm": n_proj, "fused_gemv": 8 * n_proj} if not woq
               else {"dequant_gemm": n_proj, "vpu_gemv": 8 * n_proj}),
            **attn)
        ok = (not parted and math.isfinite(err) and err <= 5e-2 * ref
              and launched == want)
        print(f"{label} {fmt or 'bf16'} (2 layers, full width): tokens "
              f"equal={not ties and not parted} near-ties {ties} "
              f"max|logit diff|={err:.4e} tol={5e-2 * ref:.4e} card "
              f"launches { {k: v for k, v in launched.items() if v} } "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if not ok:
            fail(f"{label} {fmt}: card tokens {card_tok} vs CPU {cpu_tok} "
                 f"(parted {parted}), err {err}, launches {launched} != "
                 f"{want}")
    if own:
        held.clear()


def phase_model_check(torch, nct) -> None:
    """``two_layer_check`` for W4A8 with fused B=1 decode (K1, K4, and K5
    or, over int8/fp8 caches, K6 through ``_fused_call``), the model built
    with ``RTNConfig + KVCacheQuantConfig`` (the flag checked)."""
    from neural_compressor_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                          LlamaConfig)

    torch.set_num_threads(8)
    params = dict(LLAMA_PRESETS["llama2-7b"], num_hidden_layers=2)
    cfg = LlamaConfig(**params)
    qc = (nct.RTNConfig(dtype="int4", group_size=G, quant_lm_head=True)
          + nct.KVCacheQuantConfig(dtype="fp8"))
    with quantized_on_card():
        m_cpu = nct.build_quantized(cfg, qc, seed=1, device="cpu")
    if not (m_cpu.kv_cache_quantized and m_cpu.kv_cache_format == "fp8_e4m3"
            and type(m_cpu.lm_head).__name__ == "WOQLinear"):
        fail("RTNConfig + KVCacheQuantConfig did not quantize the lm_head "
             "and flag the fp8 cache")
    m_gpu = m_cpu.to("cuda")
    nct.fuse_for_serving(m_gpu)
    nct.to_w4a8_serving(m_gpu)
    nct.enable_fused_decode(m_gpu)
    m_cpu = copy.deepcopy(m_gpu).to("cpu")
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen)
    two_layer_check(torch, "model check W4A8", m_cpu, m_gpu, ids, woq=False)
    del m_cpu, m_gpu


def w4a8_model(torch, nct):
    """Phase 5's model: llama2-7b at full width cut to ``W4A8_LAYERS``
    layers, RTN int4 g128 W4A8 with fused B=1 decode, on the card."""
    from neural_compressor_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                          LlamaConfig)

    t0 = time.perf_counter()
    # cut to W4A8_LAYERS of llama2-7b's 32 layers, full width: the chip
    # check's time limit (PERF.md §4)
    cfg = LlamaConfig(**dict(LLAMA_PRESETS["llama2-7b"],
                             num_hidden_layers=W4A8_LAYERS))
    model = nct.build_quantized(
        cfg, nct.RTNConfig(dtype="int4", group_size=G, quant_lm_head=True),
        seed=0)
    nct.fuse_for_serving(model)
    nct.to_w4a8_serving(model)
    n_fused = nct.enable_fused_decode(model)
    nl = model.cfg.num_hidden_layers
    torch.cuda.synchronize()
    print(f"llama2-7b ({nl} of {LAYERS} layers) built and converted in "
          f"{time.perf_counter() - t0:.1f} s ({n_fused} fused-decode layers, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card)",
          flush=True)
    if n_fused != nl:
        fail(f"fused decode on {n_fused} of {nl} layers")
    return model


def phase_serve(torch, nct) -> dict:
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_dot
    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    model = w4a8_model(torch, nct)
    nl = model.cfg.num_hidden_layers
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
    launches = launch_counts()
    fallbacks = dequant_dot.calls
    steps = NEW_TOKENS - 1
    want = expect(w4a8_gemm=len(PROMPTS) * (4 * nl + 1),
                  fused_gemv=len(PROMPTS) * steps * (4 * nl + 1),
                  decode_attn=len(PROMPTS) * steps * nl)
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
    nl = model.cfg.num_hidden_layers
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
        launches = launch_counts()
        fallbacks = dequant_dot.calls
        m = eng.metrics()
        steps = CHUNK * m["decode_dispatches"]
        chunks = m["prefill_chunk_dispatches"]
        paged = mode != "contiguous"
        want = expect(w4a8_gemm=(4 * nl + 1) * (steps + chunks),
                      batched_decode_attn=0 if paged else nl * steps,
                      paged_attn=nl * steps if paged else 0,
                      paged_write=nl * steps if paged else 0)
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
        eng = engine_for(nct, model, mode, n_slots=SLOTS, max_len=MAX_LEN,
                         page_size=PAGE)
        for p in prompts[:SLOTS]:
            eng.submit(p, max_new_tokens=64)
        while eng.queue or "prefill" in eng.slot_state:
            eng.run(max_steps=1, chunk=1)
        profile_window(torch, f"engine {mode} decode dispatch, 8 slots x "
                       f"{CHUNK} steps", lambda: eng.step_many(CHUNK))
        del eng        # not run dry: the profile was all it was for
    return out


# ------------------------------------------------------------------ W4A16
WOQ_MS = (8, 100, 128, 256)     # K8 rows timed at the llama2-7b shapes
WOQ_LAYERS = 4                  # depth of the served W4A16 model (phases 8-9)
WOQ_UNIT_M = 8                  # K8's row of the kernels line: one 8-slot step
WOQ_PREFILL_M = 128             # K8's second unit: one 128-token prefill chunk
# K8's kernels in a profile (its small path, its tile path and the tile
# path's split fold) and K9's
K8_KERNELS = ("dequant_small_kernel", "dequant_gemm_kernel", "splitk_reduce")
K9_KERNELS = ("vpu_gemv_kernel",)
K10_KERNELS = ("vpu_int8act_kernel",)
# DeepSeek-V3's routed experts (K8's few column tiles: K split across blocks)
EXPERT_SHAPES = {"expert_up": (7168, 2048), "expert_down": (2048, 7168)}


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


def woq_faults(pw):
    """Faults planted in a kernel's operands, each of which ``woq_tol``
    must catch: (name, words, scales, zeros). The last swaps two word rows
    of group 0 (their k-slots in every field): the order in which K8's
    small path feeds fields and rows to its MMAs."""
    s, z = pw.scales, pw.zeros
    g7 = s.clone()
    g7[7] *= 1.25
    swapped = pw.packed.clone()
    swapped[[0, 1]] = pw.packed[[1, 0]]
    return (("zeros dropped", pw.packed, s, None),
            ("scales one group late", pw.packed, s.roll(1, dims=0), z),
            ("group 7 scale x1.25", pw.packed, g7, z),
            ("word rows 0 and 1 swapped", swapped, s, z))


def split_faults(torch, pw, plan):
    """Faults at the boundaries of a K9 or K10 plan's blocks (``gemv_plan``
    splits K into blocks of ``per`` units of ``ngk`` groups), planted in
    the scales the kernel is given: (name, scales). The first group of the
    second block lost (its scale 0) or counted twice (doubled); the second
    block's whole partial dropped (its groups' scales 0)."""
    g = plan.per * plan.ngk
    lost, twice, dropped = (pw.scales.clone() for _ in range(3))
    lost[g] = 0.0
    twice[g] *= 2.0
    dropped[g:2 * g] = 0.0
    return (("a group lost at a block boundary", lost),
            ("a group counted twice at a block boundary", twice),
            ("a split's partial dropped", dropped))


def phase_woq_kernels(torch, nct, peaks: dict) -> dict:
    """K8 and K9 at the llama2-7b asym-int4 g128 shapes of the W4A16 path:
    K9 at M = 1, K8 at M = 8, 100, 128 and 256, each against its plain
    version, with its time (event ms over back-to-back launches, weights
    rotated through >200 MB of copies, so L2 is cold; device ms from
    torch.profiler over the same launches), the plain version's, the
    yardstick ``torch.matmul`` of the bf16-dequantized weight
    (dequantization not timed; never called by the port) and the bound.
    At M = 1 and 8 the kernel also runs on faulty operands
    (``woq_faults``; at M = 1 where K9's plan splits K also
    ``split_faults``), and the tolerance must flag each fault; every K8
    and K9 launch is repeated and must give the same bits. K8 at
    DeepSeek-V3's expert shapes (few column tiles: K split across blocks)
    is checked the same way, untimed."""
    from neural_compressor_tpu_torch.kernels import dequant_matmul as dm
    from neural_compressor_tpu_torch.ops import dequantize_packed

    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    rows = {"k8": [], "k9": [], "k8_untimed": []}
    missed, unequal = [], []

    def faults(name, M, x, pw, yp, tol, kw):
        planted = list(woq_faults(pw))
        if M == 1:
            plan = dm.gemv_plan(pw.scales.shape[1], pw.orig_shape[0], G, 4)
            if plan.splits > 1:
                planted += [(f, pw.packed, fs, pw.zeros)
                            for f, fs in split_faults(torch, pw, plan)]
        for fault, fw, fs, fz in planted:
            yf = (dm.vpu_gemv(x, fw, fs, fz, **kw) if M == 1
                  else dm.dequant_gemm(x, fw, fs, fz, None, **kw))
            df = (yf.float() - yp.float()).abs()
            caught = int((df > tol).sum())
            print(f"{'k9' if M == 1 else 'k8'} {name} M={M} planted "
                  f"fault '{fault}': {caught}/{M * yp.shape[-1]} outputs "
                  f"outside the tolerance, max d/tol="
                  f"{float((df / tol).max()):.3g}", flush=True)
            if not caught:
                missed.append(f"{name} M={M} {fault}")
            del yf, df

    for name, (K, N) in dict(SHAPES, **EXPERT_SHAPES).items():
        timed = name in SHAPES
        pw = woq_weight(torch, gen, K, N)
        wbf = dequantize_packed(pw, torch.bfloat16)
        wbytes = K * N // 2 + 2 * (K // G) * N * 4
        cps = [tuple(t.clone() for t in woq_operands(pw))
               for _ in range(n_copies(wbytes) if timed else 0)]
        lcps = [wbf] + [wbf.clone() for _ in range(
            n_copies(K * N * 2) - 1 if timed else 0)]
        for M in ((1,) + WOQ_MS if timed else (WOQ_UNIT_M,)):
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            if M == 1:
                kw = dict(bits=4, group_size=G, out_dtype=torch.bfloat16)
                yk = dm.vpu_gemv(x, *woq_operands(pw), **kw)
                yp = dm.vpu_gemv_plain(x, *woq_operands(pw), **kw)
                if not torch.equal(dm.vpu_gemv(x, *woq_operands(pw), **kw),
                                   yk):
                    unequal.append(f"{name} M=1")
                run = [lambda c=c: dm.vpu_gemv(x, *c, **kw) for c in cps]
                plain = [lambda: dm.vpu_gemv_plain(x, *woq_operands(pw),
                                                   **kw)]
                ops, peak = 2 * K * N, peaks["f32_s"]
            else:
                kw = dict(bits=4, group_size=G, layout="tpu_strided",
                          out_dtype=torch.bfloat16)
                yk = dm.dequant_gemm(x, *woq_operands(pw), None, **kw)
                yp = dm.dequant_gemm_plain(x, *woq_operands(pw), None, **kw)
                again = dm.dequant_gemm(x, *woq_operands(pw), None, **kw)
                if not torch.equal(again, yk):
                    unequal.append(f"{name} M={M}")
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
                faults(name, M, x, pw, yp, tol, kw)
            kind = "k9" if M == 1 else "k8"
            plan = str(dm.gemv_plan(N, K, G, 4) if M == 1 else
                       dm.dequant_plan(M, N, K, G, 4, "tpu_strided"))
            if not timed:
                rows["k8_untimed"].append(dict(shape=name, M=M, err=err,
                                               ok=ok))
                print(f"k8 {name} M={M} K={K} N={N} max d/tol={ratio:.3g} "
                      f"ok={ok} {plan}", flush=True)
                continue
            ms = timed_ms(torch, run, 100 if M == 1 else 30)
            dms = sum(profiled(torch, run, names=K9_KERNELS if M == 1
                               else K8_KERNELS).values())
            pms = timed_ms(torch, plain, 3)
            lms = timed_ms(torch, [lambda b=b: torch.matmul(x, b)
                                   for b in lcps], 30)
            nbytes = M * K * 2 + wbytes + M * N * 2
            bms, by = bound(nbytes, ops, peak, peaks)
            rows[kind].append(dict(shape=name, M=M, K=K, N=N, err=err,
                                   tol_ratio=ratio, ok=ok, ms=ms,
                                   device_ms=dms, plain_ms=pms,
                                   library_ms=lms, bound_ms=bms,
                                   bound_by=by))
            print(f"{kind} {name:8s} M={M:4d} K={K:5d} N={N:5d} asym int4 "
                  f"g{G} max_abs_err={err:.3e} "
                  f"max_tol={float(tol.max()):.3e} max d/tol={ratio:.3g} "
                  f"ok={ok} ms={ms:.4f} device_ms={dms:.4f} "
                  f"plain_ms={pms:.4f} library_ms={lms:.4f} "
                  f"bound_ms={bms:.4f} ({by}) {plan}", flush=True)
        del cps, lcps, wbf
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"K8/K9 disagree with their plain versions: {bad}")
    if missed:
        fail(f"the K8/K9 tolerance missed planted faults: {missed}")
    if unequal:
        fail(f"a repeated K8/K9 launch gave other bits: {unequal}")
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
    # zero points that are not integers (2^23 + off inexact: K8's small
    # path subtracts 2^23 and off apart)
    pw = woq_weight(torch, gen, 512, 384, G=128)
    pw = pw._replace(zeros=pw.zeros + 0.37)
    for M in (3, 17):
        check(f"k8 M={M} zeros + 0.37", x_of(M, 512), pw, k9=False)
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
    # f32 activations: K9 computes in f32; K8 over f32 weights in f32 FMAs
    pw = woq_weight(torch, gen, 512, 384, G=64)
    check("k9 f32 x, f32 out", x_of(1, 512, dtype=torch.float32), pw,
          k9=True, out_dtype=torch.float32)
    check("k8 f32 x, f32 out", x_of(8, 512, dtype=torch.float32), pw,
          k9=False, out_dtype=torch.float32)
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


def woq_model(nct, cfg_or_preset, seed, device=None, kv=None):
    """llama2-7b (or a cut of it) quantized weight-only, asym int4 g128
    with the lm_head, q/k/v and gate/up fused: the W4A16 path; with ``kv``
    built through ``RTNConfig + KVCacheQuantConfig(dtype=kv)`` (the same
    weights, the model flagged for ``kv`` caches)."""
    cfg = nct.RTNConfig(dtype="int4", group_size=G, use_sym=False,
                        quant_lm_head=True)
    if kv is not None:
        cfg = cfg + nct.KVCacheQuantConfig(dtype=kv)
    model = nct.build_quantized(cfg_or_preset, cfg, seed=seed, device=device)
    nct.fuse_for_serving(model)
    return model


def phase_woq_model_check(torch, nct) -> None:
    """``two_layer_check`` for a full-width 2-layer llama2-7b asym-int4
    W4A16 model (K8 prefill, K9 decode, and K5 or K6 attention), and for
    a second model over int4 caches, one whose tokens part at a
    near-tie."""
    from neural_compressor_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                          LlamaConfig)

    torch.set_num_threads(8)
    cfg = LlamaConfig(**dict(LLAMA_PRESETS["llama2-7b"], num_hidden_layers=2))
    m_gpu = woq_model(nct, cfg, seed=7, device="cuda", kv="int4")
    m_cpu = copy.deepcopy(m_gpu).to("cpu")
    ids = torch.randint(0, cfg.vocab_size, (1, 32),
                        generator=torch.Generator().manual_seed(8))
    two_layer_check(torch, f"woq model check (asym int4 g{G})", m_cpu, m_gpu,
                    ids, woq=True)
    del m_cpu, m_gpu
    # a model whose int4-cache run parts at a near-tie: seed 10 built on the
    # CPU, prompt of seed 9 (the CPU's top-2 logits tie at step 5)
    m_cpu = woq_model(nct, cfg, seed=10, device="cpu", kv="int4")
    m_gpu = copy.deepcopy(m_cpu).to("cuda")
    ids = torch.randint(0, cfg.vocab_size, (1, 32),
                        generator=torch.Generator().manual_seed(9))
    two_layer_check(torch, f"woq model check (asym int4 g{G}, seed 10)",
                    m_cpu, m_gpu, ids, woq=True, formats=("int4",))
    del m_cpu, m_gpu


def phase_woq_serve(torch, nct):
    """The slice's path: llama2-7b asym-int4 g128 W4A16 at full width and
    ``WOQ_LAYERS`` of its 32 layers, three greedy requests at B=1
    (prompts of 16, 100 and 371
    tokens, 48 new each, max_len 1024): K8 prefills the two short prompts,
    the 371-token one takes dequantize-then-matmul (M > 256), K9 and K5
    decode. Exact launch counts; then one prefill and 8 decode steps
    profiled. Returns (launches, model)."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_dot
    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    t0 = time.perf_counter()
    # built with RTNConfig + KVCacheQuantConfig for the KV phases (the
    # same weights); the flag is cleared here, for bf16 caches
    from neural_compressor_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                          LlamaConfig)

    # cut to WOQ_LAYERS of llama2-7b's 32 layers, full width: the chip
    # check's time limit (PERF.md §4)
    cfg = LlamaConfig(**dict(LLAMA_PRESETS["llama2-7b"],
                             num_hidden_layers=WOQ_LAYERS))
    model = woq_model(nct, cfg, seed=0, kv="int8")
    nl = model.cfg.num_hidden_layers
    torch.cuda.synchronize()
    print(f"llama2-7b W4A16 (asym int4 g{G}, {WOQ_LAYERS} of "
          f"{LAYERS} layers) built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
          f"KV flags {model.kv_cache_quantized} {model.kv_cache_format}",
          flush=True)
    if not (model.kv_cache_quantized and model.kv_cache_format == "int8"):
        fail("RTNConfig + KVCacheQuantConfig did not flag the int8 cache")
    set_kv_format(model, None)
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
    launches = launch_counts()
    dots = dequant_dot.calls
    steps = NEW_TOKENS - 1
    n_proj = 4 * nl + 1
    short = sum(P <= 256 for P in PROMPTS)
    want = expect(decode_attn=len(PROMPTS) * steps * nl,
                  dequant_gemm=short * n_proj,
                  vpu_gemv=len(PROMPTS) * steps * n_proj)
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
    nl = model.cfg.num_hidden_layers
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
    launches = launch_counts()
    dots = dequant_dot.calls
    if sorted(r.uid for r in done) != sorted(r.uid for r in reqs):
        fail(f"W4A16 engine finished {len(done)} of {len(reqs)} requests")
    m = eng.metrics()
    steps = CHUNK * m["decode_dispatches"]
    n_proj = 4 * nl + 1
    C = eng.prefill_chunk
    k8_chunks = sum(r * C <= 256 for r in chunk_rows)
    if len(chunk_rows) != m["prefill_chunk_dispatches"]:
        fail(f"{len(chunk_rows)} prefill chunks seen, the engine counted "
             f"{m['prefill_chunk_dispatches']}")
    want = expect(batched_decode_attn=nl * steps,
                  dequant_gemm=n_proj * (steps + k8_chunks))
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
    del eng        # not run dry: the profile was all it was for
    return launches



# --------------------------------------------------------- quantized KV caches
def kv_tol(ref):
    """Elementwise tolerance of a quantized-cache attention kernel against
    its plain version: one bf16 rounding of each output (2^-7 |ref|, plus
    2^-20 near 0). Kernel and plain version sum in float64 over exact
    products and round once, so they agree bit for bit but where the order
    of a float64 sum tips a rounding; the tolerance admits one such flip
    an output and no more."""
    return 2.0 ** -7 * ref.float().abs() + 2.0 ** -20


def kv_rows(kq, rows, fmt):
    """bf16 rows [..., T, D] as a cache of ``fmt`` quantized the port's way:
    (codes, scales) for int8/fp8, (token-half-split bytes, scales,
    offsets) for int4 page pools."""
    if fmt == "int4":
        c4, sc, off = kq.kv_quant4_asym_codes(rows)
        return kq.kv_pack_page_int4(c4), sc, off
    return kq.kv_quant(rows, fmt)


def kv_dequant_rows(torch, kq, cache, fmt):
    """The bf16 rows a cache of ``fmt`` holds ([..., T, D])."""
    if fmt == "int4":
        codes, sc, off = cache
        c = torch.cat([codes & 15, codes >> 4], dim=-2).float()
        return ((c - 8) * sc[..., None] + off[..., None]).to(torch.bfloat16)
    return kq.kv_dequant(cache[0], cache[1], torch.bfloat16)


def phase_kv_kernels(torch, nct, peaks: dict) -> dict:
    """The kernels of the quantized-KV path at the llama2-7b shapes, each
    against its plain version within ``kv_tol`` (K12: bit for bit), timed
    as in phase 2 (operands rotated through >200 MB of copies, so L2 is
    cold), beside the yardstick ``scaled_dot_product_attention`` over the
    dequantized bf16 rows (dequantization not timed; never called by the
    port) and the bound:
      * K6 (int8, fp8) at B=1 over a 1024-row cache, pos 0, 517, 1023;
      * K7's quantized branch (int8, fp8), 8 slots at ``SLOT_POS``;
      * K11 and K12 (fp8, int4) over pools of 128-row pages at that step.
    Then planted faults, each of which the tolerance must flag: a K6 that
    attends the quantized new row, scales one token late (K6, K7, K11), a
    K11 int4 that drops the offsets, a K12 int4 that writes the wrong
    nibble."""
    from neural_compressor_tpu_torch import kernels as K
    from neural_compressor_tpu_torch.ops import kv_quant as kq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    rows = {k: [] for k in ("k6", "k7q", "k11_fp8", "k11_int4", "k12_fp8",
                            "k12_int4")}
    missed = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def record(kind, label, out, ref, ms, pms, lms, nbytes, ops, fmt,
               exact=False, dms=None):
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        tol = torch.zeros_like(d) if exact else kv_tol(ref)
        err = float(d.max())
        ok = bool(torch.isfinite(out.float()).all()) and bool((d <= tol).all())
        ratio = (0.0 if err == 0 else float("inf") if exact
                 else float((d / tol).max()))
        bms, by = bound(nbytes, ops, peaks["bf16_s"], peaks)
        rows[kind].append(dict(label=label, fmt=fmt, err=err, tol_ratio=ratio,
                               ok=ok, ms=ms, plain_ms=pms, library_ms=lms,
                               bound_ms=bms, bound_by=by, device_ms=dms))
        lib = "null" if lms is None else f"{lms:.4f}"
        dev_s = "" if dms is None else f" device_ms={dms:.4f}"
        print(f"{kind} {label} max_abs_err={err:.3e} max d/tol={ratio:.3g} "
              f"ok={ok} ms={ms:.4f}{dev_s} plain_ms={pms:.4f} "
              f"library_ms={lib} bound_ms={bms:.4f} ({by})", flush=True)

    def fault(kind, name, out, ref, exact=False):
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        tol = torch.zeros_like(d) if exact else kv_tol(ref)
        caught = int((d > tol).sum())
        print(f"{kind} planted fault '{name}': {caught}/{d.numel()} outputs "
              f"outside the tolerance", flush=True)
        if not caught:
            missed.append(f"{kind} {name}")

    # K6: one B=1 decode step's layer over a 1024-row cache
    H = Hkv = HEADS
    D, T = HEAD_DIM, MAX_LEN
    q = randn(1, H, D)
    q4 = q[:, :, None]
    kn, vn = randn(1, Hkv, D), randn(1, Hkv, D)
    for fmt in ("int8", "fp8_e4m3"):
        caches = [(*kq.kv_quant(randn(1, Hkv, T, D), fmt),
                   *kq.kv_quant(randn(1, Hkv, T, D), fmt))
                  for _ in range(n_copies(2 * Hkv * T * (D + 4)))]
        c0 = caches[0]
        for pos in ATTN_POS:
            L = pos + 1
            out = K.decode_attn_quant(q, kn, vn, *c0, pos)
            ref = K.decode_attn_quant_plain(q, kn, vn, *c0, pos)
            fns = [lambda c=c: K.decode_attn_quant(q, kn, vn, *c, pos)
                   for c in caches]
            ms = timed_ms(torch, fns, 200)
            dms = sum(profiled(torch, fns, names=SPLIT_KERNELS).values())
            pms = timed_ms(torch, [lambda: K.decode_attn_quant_plain(
                q, kn, vn, *c0, pos)], 10)
            deq = [(kq.kv_dequant(c[0][:, :, :L], c[1][:, :, :L], bf16),
                    kq.kv_dequant(c[2][:, :, :L], c[3][:, :, :L], bf16))
                   for c in caches]
            lms = timed_ms(torch, [lambda a=a, b=b: sdpa(q4, a, b)
                                   for a, b in deq], 200)
            del deq
            record("k6", f"{fmt} B=1 H={H} D={D} T={T} pos={pos}", out, ref,
                   ms, pms, lms, 2 * H * D * 2 + 2 * Hkv * D * 2
                   + 2 * Hkv * L * (D + 4), 4 * H * L * D, fmt, dms=dms)
        pos = UNIT_POS
        ref = K.decode_attn_quant_plain(kn, kn, vn, *c0, pos)
        # the new row carries the softmax (q = k_new); a K6 that attended
        # the row's codes instead of the raw row
        kd = kq.kv_dequant(*kq.kv_quant(kn, fmt), bf16)
        vd = kq.kv_dequant(*kq.kv_quant(vn, fmt), bf16)
        fault("k6", f"{fmt}: the quantized new row attended",
              K.decode_attn_quant(kn, kd, vd, *c0, pos), ref)
        kc, ks, vc, vs = c0
        fault("k6", f"{fmt}: scales one token late",
              K.decode_attn_quant(q, kn, vn, kc, ks.roll(1, -1), vc,
                                  vs.roll(1, -1), pos),
              K.decode_attn_quant_plain(q, kn, vn, *c0, pos))
        del caches, c0

    # K7 quantized: one layer's decode step of the 8-slot contiguous engine
    B = SLOTS
    pos = torch.tensor(SLOT_POS, dtype=torch.int32, device=dev)
    Lv = pos.to(torch.int64) + 1
    n_vis = int(Lv.sum())
    Lmax = int(Lv.max())
    mask = (torch.arange(Lmax, device=dev)[None, :] < Lv[:, None])[:, None,
                                                                   None]
    q = randn(B, H, D)
    q4 = q[:, :, None]
    for fmt in ("int8", "fp8_e4m3"):
        caches = [(*kq.kv_quant(randn(B, Hkv, T, D), fmt),
                   *kq.kv_quant(randn(B, Hkv, T, D), fmt))
                  for _ in range(n_copies(2 * B * Hkv * T * (D + 4)))]
        kc, ks, vc, vs = caches[0]
        out = K.batched_decode_attn(q, kc, vc, pos, ks, vs)
        ref = K.batched_decode_attn_plain(q, kc, vc, pos, ks, vs)
        fns = [lambda c=c: K.batched_decode_attn(q, c[0], c[2], pos, c[1],
                                                 c[3]) for c in caches]
        ms = timed_ms(torch, fns, 200)
        dms = sum(profiled(torch, fns, names=SPLIT_KERNELS).values())
        pms = timed_ms(torch, [lambda: K.batched_decode_attn_plain(
            q, kc, vc, pos, ks, vs)], 5)
        deq = [(kq.kv_dequant(c[0][:, :, :Lmax], c[1][:, :, :Lmax], bf16),
                kq.kv_dequant(c[2][:, :, :Lmax], c[3][:, :, :Lmax], bf16))
               for c in caches]
        lms = timed_ms(torch, [lambda a=a, b=b: sdpa(q4, a, b,
                                                      attn_mask=mask)
                               for a, b in deq], 200)
        del deq
        record("k7q", f"{fmt} B={B} H={H} D={D} T={T} pos={SLOT_POS}", out,
               ref, ms, pms, lms, 2 * Hkv * n_vis * (D + 4) + 2 * B * H * D * 2
               + B * 4, 4 * H * n_vis * D, fmt, dms=dms)
        fault("k7q", f"{fmt}: scales one token late",
              K.batched_decode_attn(q, kc, vc, pos, ks.roll(1, -1),
                                    vs.roll(1, -1)), ref)
        del caches

    # K11 and K12 over pools of 128-row pages holding the same slots
    pmax = T // PAGE
    n_pages = B * pmax + 1                      # page 0 is the trash page
    bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                         .manual_seed(12)) + 1).reshape(B, pmax)
    bt = bt.to(torch.int32).to(dev)
    lengths = (pos + 1).contiguous()
    kn, vn = randn(B, Hkv, D), randn(B, Hkv, D)
    attn, write = K.paged_attn, K.paged_write
    for fmt, tag in (("fp8_e4m3", "fp8"), ("int4", "int4")):
        int4 = fmt == "int4"
        code_bytes = D // 2 if int4 else D
        row_bytes = code_bytes + (8 if int4 else 4)

        def pool():
            k = kv_rows(kq, randn(n_pages, Hkv, PAGE, D), fmt)
            v = kv_rows(kq, randn(n_pages, Hkv, PAGE, D), fmt)
            # (k_pages, k_scales, v_pages, v_scales, k_offs, v_offs)
            return (k[0], k[1], v[0], v[1],
                    k[2] if int4 else None, v[2] if int4 else None)

        def args(p):
            return (p[0], p[1], p[2], p[3], bt, lengths, p[4], p[5])

        pools = [pool() for _ in range(n_copies(2 * n_pages * Hkv * PAGE
                                                * row_bytes))]
        p0 = pools[0]
        out = attn(q, *args(p0))
        ref = K.paged_attn_plain(q, *args(p0))
        ms = timed_ms(torch, [lambda p=p: attn(q, *args(p)) for p in pools],
                      200)
        pms = timed_ms(torch, [lambda: K.paged_attn_plain(q, *args(p0))], 5)

        def gathered(p, which):
            pages, sc, off = ((p[0], p[1], p[4]) if which == "k"
                              else (p[2], p[3], p[5]))
            cache = (pages, sc, off) if int4 else (pages, sc)
            rows_ = kv_dequant_rows(torch, kq, cache, fmt)  # [P, Hkv, page, D]
            g = rows_[bt.long()].transpose(1, 2).reshape(B, Hkv, T, D)
            return g[:, :, :Lmax].contiguous()

        gk = [(gathered(p, "k"), gathered(p, "v")) for p in pools]
        lms = timed_ms(torch, [lambda a=a, b=b: sdpa(q4, a, b,
                                                      attn_mask=mask)
                               for a, b in gk], 200)
        del gk
        record(f"k11_{tag}", f"{tag} B={B} H={H} D={D} page={PAGE} "
               f"pmax={pmax} lengths={tuple(lengths.tolist())}", out, ref,
               ms, pms, lms, 2 * Hkv * n_vis * row_bytes + 2 * B * H * D * 2
               + B * pmax * 4 + B * 4, 4 * H * n_vis * D, fmt)
        kp, ks, vp, vs, ko, vo = p0
        fault(f"k11_{tag}", "scales one token late",
              attn(q, kp, ks.roll(1, -1), vp, vs.roll(1, -1), bt, lengths,
                   ko, vo), ref)
        if int4:
            fault("k11_int4", "offsets dropped",
                  attn(q, kp, ks, vp, vs, bt, lengths, torch.zeros_like(ko),
                       torch.zeros_like(vo)), ref)
        del pools

        # K12: the 8 slots' new rows at their positions
        p1 = pool()
        p_ref = [None if t is None else t.clone() for t in p1]

        def wargs(p, at):
            return (p[0], p[1], p[2], p[3], bt, at, p[4], p[5])

        write(kn, vn, *wargs(p1, pos))
        K.paged_write_plain(kn, vn, *wargs(p_ref, pos))
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(p1, p_ref) if a is not None)
        ms = timed_ms(torch, [lambda: write(kn, vn, *wargs(p1, pos))], 500)
        pms = timed_ms(torch, [lambda: K.paged_write_plain(
            kn, vn, *wargs(p_ref, pos))], 20)
        nbytes = (2 * B * Hkv * D * 2 + 2 * B * Hkv * D * (2 if int4 else 1)
                  + 2 * B * Hkv * (8 if int4 else 4) + B * 8)
        rows[f"k12_{tag}"].append(dict(
            label=f"{tag} B={B} Hkv={Hkv} D={D} page={PAGE} pos={SLOT_POS}",
            fmt=fmt, err=err, tol_ratio=0.0 if err == 0 else float("inf"),
            ok=err == 0.0, ms=ms, plain_ms=pms, library_ms=None,
            bound_ms=bound(nbytes, 0, peaks["bf16_s"], peaks)[0],
            bound_by="bytes"))
        print(f"k12_{tag} B={B} Hkv={Hkv} D={D} page={PAGE} pos={SLOT_POS} "
              f"max_abs_err={err:.3e} (bit for bit) ok={err == 0.0} "
              f"ms={ms:.4f} plain_ms={pms:.4f} library_ms=null (no single "
              f"call quantizes and scatters a row) bound_ms="
              f"{rows[f'k12_{tag}'][-1]['bound_ms']:.4f} (bytes)", flush=True)
        if int4:
            # a write to the partner token's nibble: the same byte row, the
            # other half of the page
            half = PAGE // 2
            wrong = torch.where(pos % PAGE >= half, pos - half, pos + half)
            p2 = pool()
            p2_ref = [None if t is None else t.clone() for t in p2]
            write(kn, vn, *wargs(p2, wrong))
            K.paged_write_plain(kn, vn, *wargs(p2_ref, pos))
            fault("k12_int4", "the wrong nibble written", p2[0], p2_ref[0],
                  exact=True)
            del p2, p2_ref
        del p1, p_ref
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"KV-cache kernel disagrees with its plain version: {bad}")
    if missed:
        fail(f"the KV-cache kernels' tolerance missed planted faults: "
             f"{missed}")
    return rows


def phase_kv_envelope(torch) -> None:
    """The quantized-KV kernels where llama2-7b does not take them, each
    equal to its plain version bit for bit: GQA with 4 and 8 query heads a
    KV head, head widths 64 (and 32, 256), all-zero K/V rows (scale 1,
    offset 0), positions at 0, T - 1 and past the end, int4 writes at page
    rows 0, 63, 64 and 127 (both nibbles of one byte row, in both orders),
    zero-length and idle slots on the trash page, rows past the block
    table, and two slots writing one trash-page row (that row excepted)."""
    from neural_compressor_tpu_torch import kernels as K
    from neural_compressor_tpu_torch.ops import kv_quant as kq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(37)
    bad, n = [], 0

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def check(label, a, b):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            bad.append(label)

    def with_zero_rows(x):
        x = x.clone()
        x[..., 3, :] = 0          # a row of zeros: scale 1 (offset 0)
        return x

    # K6 and K7: GQA, head widths, zero rows, positions at the edges
    for H, Hkv, D in ((16, 4, 64), (16, 2, 128), (8, 1, 32), (8, 2, 256)):
        T = 96
        for fmt in ("int8", "fp8_e4m3"):
            kc, ks = kq.kv_quant(with_zero_rows(randn(2, Hkv, T, D)), fmt)
            vc, vs = kq.kv_quant(with_zero_rows(randn(2, Hkv, T, D)), fmt)
            tag = f"H={H} Hkv={Hkv} D={D} {fmt}"
            for pos in (0, 3, T - 1, T, T + 3):
                q, kn, vn = randn(1, H, D), randn(1, Hkv, D), randn(1, Hkv, D)
                if pos == 3:
                    kn, vn = kn * 0, vn * 0
                check(f"k6 {tag} pos={pos}",
                      K.decode_attn_quant(q, kn, vn, kc[:1].contiguous(),
                                          ks[:1].contiguous(),
                                          vc[:1].contiguous(),
                                          vs[:1].contiguous(), pos),
                      K.decode_attn_quant_plain(q, kn, vn, kc[:1], ks[:1],
                                                vc[:1], vs[:1], pos))
                n += 1
            q = randn(2, H, D)
            p = torch.tensor([3, T + 3], dtype=torch.int32, device=dev)
            check(f"k7q {tag}", K.batched_decode_attn(q, kc, vc, p, ks, vs),
                  K.batched_decode_attn_plain(q, kc, vc, p, ks, vs))
            n += 1

    # the split of the keys: caches of three parts and a tail, slots on the
    # parts' boundaries (K6's raw new row on them too), GQA, head widths;
    # fp8 codes and scales at each K6 slot's pos made NaN, which K6 must
    # not read (it attends the raw row there)
    for fmt in ("int8", "fp8_e4m3"):
        T, pk, spos = split_positions(torch, fmt, dev)
        live = spos < T
        for H, Hkv, D in ((32, 32, 128), (16, 2, 128), (8, 1, 32),
                          (8, 2, 256), (32, 2, 64), (12, 2, 512)):
            q = (randn(7, H, D).float() * 4).to(torch.bfloat16)
            kc, ks = kq.kv_quant(with_zero_rows(randn(7, Hkv, T, D)), fmt)
            vc, vs = kq.kv_quant(with_zero_rows(randn(7, Hkv, T, D)), fmt)
            tag = f"H={H} Hkv={Hkv} D={D} T={T} {fmt} pos={spos.tolist()}"
            check(f"k7q split {tag}",
                  K.batched_decode_attn(q, kc, vc, spos, ks, vs),
                  K.batched_decode_attn_plain(q, kc, vc, spos, ks, vs))
            n += 1
            if D > 256:
                continue
            kn, vn = randn(7, Hkv, D), randn(7, Hkv, D)
            if fmt == "fp8_e4m3":
                b_, t_ = torch.nonzero(live).flatten(), spos[live].long()
                for c, sc in ((kc, ks), (vc, vs)):
                    c.view(torch.uint8)[b_, :, t_] = 0x7F    # NaN codes
                    sc[b_, :, t_] = float("nan")
            check(f"k6 split {tag}",
                  K.decode_attn_quant(q, kn, vn, kc, ks, vc, vs, spos),
                  K.decode_attn_quant_plain(q, kn, vn, kc, ks, vc, vs, spos))
            n += 1
        # the planted faults: each slot's query is 8x its dequantized key
        # at p - 1 (K6; p a part's first key) or at p (K7), so that key
        # carries the softmax
        p = torch.tensor([pk, 2 * pk], dtype=torch.int32, device=dev)
        kc, ks = kq.kv_quant(randn(2, 4, T, 128), fmt)
        vc, vs = kq.kv_quant(randn(2, 4, T, 128), fmt)
        kd = kq.kv_dequant(kc, ks, torch.bfloat16)
        kn, vn = randn(2, 4, 128), randn(2, 4, 128)
        q6 = (row_at(kd, p - 1) * 8).repeat_interleave(4, dim=1)
        q7 = (row_at(kd, p) * 8).repeat_interleave(4, dim=1)
        for miss in (
                boundary_fault(
                    torch, f"k6 {fmt}",
                    K.decode_attn_quant(q6, kn, vn, kc, ks, vc, vs, p - 1),
                    K.decode_attn_quant_plain(q6, kn, vn, kc, ks, vc, vs,
                                              p)),
                boundary_fault(
                    torch, f"k7 {fmt}",
                    K.batched_decode_attn(q7, kc, vc, p - 1, ks, vs),
                    K.batched_decode_attn_plain(q7, kc, vc, p, ks, vs))):
            if miss:
                bad.append(miss)

    # K11 and K12 over fp8 and int4 pools
    for (H, Hkv, D, page), fmt in zip(
            ((16, 4, 64, 16), (16, 2, 128, 128), (8, 1, 32, 32),
             (32, 32, 128, 128), (16, 8, 256, 16), (8, 2, 64, 128)),
            ("fp8_e4m3", "int4", "int4", "fp8_e4m3", "fp8_e4m3", "int4")):
        int4 = fmt == "int4"
        attn, write = K.paged_attn, K.paged_write
        pmax, B = 3, 5
        n_pages = (B - 1) * pmax + 1
        k = kv_rows(kq, with_zero_rows(randn(n_pages, Hkv, page, D)),
                    fmt)
        v = kv_rows(kq, with_zero_rows(randn(n_pages, Hkv, page, D)),
                    fmt)
        pool = (k[0], k[1], v[0], v[1], k[2] if int4 else None,
                v[2] if int4 else None)
        bt = torch.arange(1, n_pages, dtype=torch.int32,
                          device=dev).reshape(B - 1, pmax)
        bt = torch.cat([bt, torch.zeros((1, pmax), dtype=torch.int32,
                                        device=dev)])       # slot 4 idle
        lengths = torch.tensor([1, page, 2 * page + 1, 0, pmax * page + 5],
                               dtype=torch.int32, device=dev)
        q = randn(B, H, D)
        tag = f"H={H} Hkv={Hkv} D={D} page={page} {fmt}"
        a = (pool[0], pool[1], pool[2], pool[3], bt, lengths, pool[4],
             pool[5])
        check(f"k11 {tag}", attn(q, *a), K.paged_attn_plain(q, *a))
        n += 1
        # writes: rows 0, page/2 - 1, page/2 and page - 1 of pages (both
        # nibbles of byte rows 0 and page/2 - 1), the trash-page row of two
        # idle slots, and a row past the table, dropped
        bt_w = bt.clone()
        bt_w[3] = 0
        half = page // 2
        for wpos in ([0, half - 1, 2 * page + half, pmax * page - 1,
                      pmax * page - 1],
                     [half, page - 1, 2 * page, pmax * page - 1,
                      pmax * page + 2]):
            wp = torch.tensor(wpos, dtype=torch.int32, device=dev)
            kn, vn = randn(B, Hkv, D), randn(B, Hkv, D)
            kn[1] = 0                       # an all-zero row
            p_k = [None if t is None else t.clone() for t in pool]
            p_p = [None if t is None else t.clone() for t in pool]
            write(kn, vn, p_k[0], p_k[1], p_k[2], p_k[3], bt_w, wp, p_k[4],
                  p_k[5])
            K.paged_write_plain(kn, vn, p_p[0], p_p[1], p_p[2], p_p[3], bt_w,
                                wp, p_p[4], p_p[5])
            torch.cuda.synchronize()
            for a_, b_ in zip(p_k, p_p):
                if a_ is None:
                    continue
                a_, b_ = a_.clone(), b_.clone()
                trash = (half - 1) if (int4 and a_.dtype == torch.uint8) \
                    else page - 1
                a_[0, :, trash] = 0          # the contended trash row
                b_[0, :, trash] = 0
                check(f"k12 {tag} pos={wpos}", a_.view(torch.uint8)
                      if a_.dtype == torch.float8_e4m3fn else a_,
                      b_.view(torch.uint8)
                      if b_.dtype == torch.float8_e4m3fn else b_)
            n += 1
            pool = tuple(p_p)          # the next writes patch these bytes
    # int4 writes at rows 63, 64 and 127 of a 128-row page, one at a time,
    # so both nibbles of byte row 63 are written in turn
    Hkv, D, page = 4, 128, 128
    k = kv_rows(kq, randn(2, Hkv, page, D), "int4")
    v = kv_rows(kq, randn(2, Hkv, page, D), "int4")
    pk = [k[0], k[1], v[0], v[1], k[2], v[2]]
    pp = [t.clone() for t in pk]
    bt = torch.tensor([[1]], dtype=torch.int32, device=dev)
    for r in (63, 64, 127, 0):
        wp = torch.tensor([r], dtype=torch.int32, device=dev)
        kn, vn = randn(1, Hkv, D), randn(1, Hkv, D)
        K.paged_write(kn, vn, pk[0], pk[1], pk[2], pk[3], bt, wp, pk[4],
                      pk[5])
        K.paged_write_plain(kn, vn, pp[0], pp[1], pp[2], pp[3], bt, wp,
                            pp[4], pp[5])
        for a_, b_ in zip(pk, pp):
            check(f"k12 int4 page row {r}", a_, b_)
        n += 1
    print(f"kv envelope: {n} kernel shapes, card vs plain: "
          f"{'all equal' if not bad else bad}", flush=True)
    if bad:
        fail(f"quantized-KV kernels outside the llama2-7b shapes: {bad}")


# ------------------------------------------------------------ speculation
SPEC_K, SPEC_N = 8, 2
SPEC_W = SPEC_K + 1           # a verify window: the last token + k proposals
# window starts of the 8 slots at the engine's shapes: in-page, crossing
# into the next page (122), a page's first row (640), overshooting the
# table (1020: rows 1024-1028 go to the trash page), and two idle slots
# parked at max_len - 1 on all-trash block tables
SPEC_POS = (0, 122, 300, 517, 640, 1020, MAX_LEN - 1, MAX_LEN - 1)
SPEC_IDLE = (6, 7)


def spec_pool(torch, kq, randn, n_pages, Hkv, page, D, fmt):
    """A random pool (k_pages, k_scales, v_pages, v_scales, k_offs,
    v_offs) in ``fmt``, its rows quantized the port's way."""
    if fmt == "bf16":
        return (randn(n_pages, Hkv, page, D), None,
                randn(n_pages, Hkv, page, D), None, None, None)
    k = kv_rows(kq, randn(n_pages, Hkv, page, D), fmt)
    v = kv_rows(kq, randn(n_pages, Hkv, page, D), fmt)
    int4 = fmt == "int4"
    return (k[0], k[1], v[0], v[1], k[2] if int4 else None,
            v[2] if int4 else None)


def pool_bytes_equal(torch, a, b, skip_trash=True) -> bool:
    """Two pools byte for byte, page 0 (the trash page, which several idle
    slots write in one launch) excepted."""
    for x, y in zip(a, b):
        if x is None:
            continue
        if x.dtype == torch.float8_e4m3fn:
            x, y = x.view(torch.uint8), y.view(torch.uint8)
        if skip_trash:
            x, y = x[1:], y[1:]
        if not torch.equal(x, y):
            return False
    return True


def k11_split_emulated(torch, q, kp, ks, vp, vs, bt, lengths, ko=None,
                       vo=None, window=None, softcap=None, fault=None):
    """K11's two launches emulated in float64 on the card, part by part
    (``split_plan``'s parts; the fold in ascending part order) -> [B, H,
    W, D] bf16, equal to the kernel bit for bit; or with a planted fault
    of the split: ``"drop_last_part"`` (the fold drops each slot's last
    part) or ``"part_max"`` (p rounded against its part's own maximum, the
    parts rescaled by exp(m_part - m) in the fold, as a flash-decoding
    fold would)."""
    from neural_compressor_tpu_torch.kernels import paged_attention as pa
    from neural_compressor_tpu_torch.ops import softcap as _softcap

    f64, f32 = torch.float64, torch.float32
    fmt = pa.pool_format(kp, ks, ko)
    B, H, W, D = q.shape
    Hkv = kp.shape[1]
    rep, dev = H // Hkv, q.device
    rows = W * rep
    page = kp.shape[2] * (2 if fmt == "int4" else 1)
    plan = pa.split_plan(B, H, Hkv, W, D, page, bt.shape[1])
    btl = bt.long()
    k = pa._gather_rows(kp, btl)
    v = pa._gather_rows(vp, btl)
    T = k.shape[2]
    qr = (q.reshape(B, Hkv, rep, W, D).transpose(2, 3)
          .reshape(B, Hkv, rows, D).to(f64))
    w_of = torch.div(torch.arange(rows, device=dev), rep,
                     rounding_mode="floor")
    qpos = lengths.long().reshape(B, 1) - W + w_of[None, :]
    t = torch.arange(T, device=dev)[None, None, :]
    valid = t < (qpos + 1).clamp(0, T)[:, :, None]
    if window is not None:
        valid = valid & (qpos[:, :, None] - t < window)
    valid = valid[:, None]                              # [B, 1, rows, T]
    s = torch.einsum("bgrd,bgtd->bgrt", qr, k).to(f32)
    if ks is not None:
        s = s * pa._gather_pages(ks, btl)[:, :, None, :]
    if fmt == "int4":
        s = s + (qr.sum(dim=-1).to(f32)[..., None]
                 * pa._gather_pages(ko, btl)[:, :, None, :])
    s = s * (1.0 / (D ** 0.5))
    if softcap is not None:
        s = _softcap(s, softcap)
    masked = torch.where(valid, s, torch.tensor(-float("inf"), device=dev))
    cuts = [(i * plan.part_keys, min((i + 1) * plan.part_keys, T))
            for i in range(plan.parts)]
    m_part = torch.stack([masked[..., a:b].amax(dim=-1) for a, b in cuts],
                         dim=-1)                        # [B, Hkv, rows, P]
    m = m_part.amax(dim=-1, keepdim=True)
    vsc = pa._gather_pages(vs, btl)[:, :, None, :] if ks is not None else None
    voff = (pa._gather_pages(vo, btl).to(f64)[:, :, None, :]
            if fmt == "int4" else None)
    # each slot's last part: the one holding its last key
    last = torch.div(lengths.long().clamp(1, T) - 1, plan.part_keys,
                     rounding_mode="floor")
    zero = torch.zeros((), dtype=f64, device=dev)
    acc = torch.zeros(qr.shape, dtype=f64, device=dev)
    l = torch.zeros(qr.shape[:-1], dtype=f64, device=dev)
    corr = torch.zeros_like(l)
    for i, (a, b) in enumerate(cuts):
        mi = m_part[..., i:i + 1] if fault == "part_max" else m
        vi = valid[..., a:b]
        e = torch.where(vi, torch.exp(s[..., a:b].to(f64) - mi.to(f64)), zero)
        pe = e.to(f32)
        if vsc is not None:
            pe = pe * vsc[..., a:b]
        acc_i = torch.einsum("bgrt,bgtd->bgrd",
                             pe.to(torch.bfloat16).to(f64), v[:, :, a:b])
        l_i = e.sum(dim=-1)
        c_i = ((e.to(f32).to(f64) * voff[..., a:b]).sum(dim=-1)
               if voff is not None else torch.zeros_like(l_i))
        if fault == "part_max":
            rescale = torch.where(torch.isfinite(mi), torch.exp(
                mi.to(f64) - m.to(f64)), zero)          # [B, Hkv, rows, 1]
            acc_i, l_i, c_i = (acc_i * rescale, l_i * rescale[..., 0],
                               c_i * rescale[..., 0])
        if fault == "drop_last_part":
            keep = (last != i).to(f64).reshape(B, 1, 1)
            acc_i, l_i, c_i = acc_i * keep[..., None], l_i * keep, c_i * keep
        acc, l, corr = acc + acc_i, l + l_i, corr + c_i
    out = acc.to(f32)
    if fmt == "int4":
        out = out + corr.to(f32)[..., None]
    out = out / l.to(f32).clamp_min(1e-30)[..., None]
    return (out.reshape(B, Hkv, W, rep, D).transpose(2, 3)
            .reshape(B, H, W, D).to(torch.bfloat16))


def phase_spec_kernels(torch, nct, peaks: dict) -> dict:
    """The speculative verify window's kernels at the llama2-7b engine's
    shapes: 8 slots, Hkv 32, D 128, pools of 128-row pages, W = 9 at
    ``SPEC_POS`` (in-page, crossing, overshooting, idle), in each pool
    format (bf16, int8, fp8, int4):
      * K13 (``paged_write_window_kernel``) byte for byte equal to its plain
        version on every page but the trash page; planted faults flagged:
        the crossing block left unwritten, the partner nibble dropped
        (int4), the window one row late;
      * K11's W-query window (``paged_window_attn``) bit for bit equal to
        its plain version, and each window row w bit for bit equal to
        single-query K11 at length ``lengths - W + w + 1``; a planted fault
        flagged: every row attending the whole window.
    Timed as in phase 2, beside the bound and a library yardstick never
    used by the port: index assignment of the bf16 window rows into a bf16
    pool (K13; no single call quantizes and scatters), and
    ``scaled_dot_product_attention`` with a causal mask over the rows
    gathered out of the pages, dequantized (K11's window)."""
    from neural_compressor_tpu_torch import kernels as K
    from neural_compressor_tpu_torch.kernels.paged_attention import \
        window_targets
    from neural_compressor_tpu_torch.ops import kv_quant as kq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    rows = {"k13": [], "k11w": []}
    missed, bad = [], []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    B, H, Hkv, D, T, W = SLOTS, HEADS, HEADS, HEAD_DIM, MAX_LEN, SPEC_W
    pmax = T // PAGE
    n_pages = (B - len(SPEC_IDLE)) * pmax + 1   # page 0 is the trash page
    bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                         .manual_seed(42)) + 1).reshape(-1, pmax)
    bt = torch.cat([bt, torch.zeros((len(SPEC_IDLE), pmax),
                                    dtype=bt.dtype)]).to(torch.int32).to(dev)
    pos = torch.tensor(SPEC_POS, dtype=torch.int32, device=dev)
    lengths = (pos + W).contiguous()
    kn, vn = randn(B, Hkv, W, D), randn(B, Hkv, W, D)
    q = randn(B, H, W, D)
    # keys each slot's window needs (at most the table), and per row
    Lrow = (lengths.long()[:, None] - W + torch.arange(W, device=dev)[None]
            + 1).clamp(0, pmax * PAGE)                    # [B, W]
    n_vis = int(Lrow.max(dim=1).values.sum())
    n_pairs = int(Lrow.sum())
    Lmax = int(Lrow.max())
    mask = (torch.arange(Lmax, device=dev)[None, None, :]
            < Lrow[:, :, None])[:, None]                  # [B, 1, W, Lmax]

    def record(kind, label, fmt, err, ok, ms, pms, lms, nbytes, ops):
        bms, by = bound(nbytes, ops, peaks["bf16_s"], peaks)
        rows[kind].append(dict(label=label, fmt=fmt, err=err, ok=ok, ms=ms,
                               plain_ms=pms, library_ms=lms, bound_ms=bms,
                               bound_by=by))
        lib = "null" if lms is None else f"{lms:.4f}"
        print(f"{kind} {label} max_abs_err={err:.3e} (bit for bit) ok={ok} "
              f"ms={ms:.4f} plain_ms={pms:.4f} library_ms={lib} "
              f"bound_ms={bms:.4f} ({by})", flush=True)
        if not ok:
            bad.append(f"{kind} {label}")

    def planted(kind, name, caught, total):
        print(f"{kind} planted fault '{name}': {caught}/{total} outputs "
              "differ", flush=True)
        if not caught:
            missed.append(f"{kind} {name}")

    def pool_diff(a, b) -> int:
        n = 0
        for x, y in zip(a, b):
            if x is None:
                continue
            if x.dtype == torch.float8_e4m3fn:
                x, y = x.view(torch.uint8), y.view(torch.uint8)
            n += int((x[1:] != y[1:]).sum())
        return n

    for fmt in POOL_FORMATS:
        int4 = fmt == "int4"
        esize = {"bf16": 2, "int8": 1, "fp8_e4m3": 1, "int4": 0.5}[fmt]
        sc_bytes = {"bf16": 0, "int8": 4, "fp8_e4m3": 4, "int4": 8}[fmt]

        def wargs(p, at, table=bt):
            return (p[0], p[1], p[2], p[3], table, at, p[4], p[5])

        # K13: the 8 slots' windows at their starts
        p1 = spec_pool(torch, kq, randn, n_pages, Hkv, PAGE, D, fmt)
        p_ref = [None if t is None else t.clone() for t in p1]
        K.paged_write_window_kernel(kn, vn, *wargs(p1, pos))
        K.paged_write_window_plain(kn, vn, *wargs(p_ref, pos))
        torch.cuda.synchronize()
        ok = pool_bytes_equal(torch, p1, p_ref)
        err = max(float((a[1:].float() - b[1:].float()).abs().max())
                  for a, b in zip(p1, p_ref) if a is not None)
        ms = timed_ms(torch, [lambda: K.paged_write_window_kernel(
            kn, vn, *wargs(p1, pos))], 500)
        pms = timed_ms(torch, [lambda: K.paged_write_window_plain(
            kn, vn, *wargs(p_ref, pos))], 10)
        lms = None
        if fmt == "bf16":
            pid, r = window_targets(bt, pos, PAGE, W)
            kr, vr = kn.transpose(1, 2), vn.transpose(1, 2)  # [B, W, Hkv, D]

            def index_assign():
                p1[0][pid, :, r] = kr
                p1[2][pid, :, r] = vr

            lms = timed_ms(torch, [index_assign], 500)
        nbytes = (2 * B * W * Hkv * D * 2 + 2 * B * W * Hkv * D * esize
                  + 2 * B * W * Hkv * sc_bytes + B * 4 + B * pmax * 4)
        record("k13", f"{fmt} B={B} Hkv={Hkv} D={D} page={PAGE} W={W} "
               f"pos={SPEC_POS}", fmt, err, ok, ms, pms, lms, nbytes, 0)
        # planted faults, each against the plain version's pool
        fresh = spec_pool(torch, kq, randn, n_pages, Hkv, PAGE, D, fmt)
        want = [None if t is None else t.clone() for t in fresh]
        K.paged_write_window_plain(kn, vn, *wargs(want, pos))
        # the crossing block left unwritten: slot 1's successor page
        # swapped for the trash page
        f1 = [None if t is None else t.clone() for t in fresh]
        bt_f = bt.clone()
        bt_f[1, SPEC_POS[1] // PAGE + 1] = 0
        K.paged_write_window_kernel(kn, vn, *wargs(f1, pos, bt_f))
        planted("k13", f"{fmt}: the crossing block left unwritten",
                pool_diff(f1, want), p1[0][1:].numel())
        # the window one row late
        f2 = [None if t is None else t.clone() for t in fresh]
        K.paged_write_window_kernel(kn, vn, *wargs(f2, pos + 1))
        planted("k13", f"{fmt}: the window one row late",
                pool_diff(f2, want), p1[0][1:].numel())
        if int4:
            # the partner nibble dropped: the targets' byte rows zeroed
            # before the write, so only the written nibble survives
            f3 = [None if t is None else t.clone() for t in fresh]
            pid, r = window_targets(bt, pos, PAGE, W)
            for pages in (f3[0], f3[2]):
                pages[pid, :, r % (PAGE // 2)] = 0
            K.paged_write_window_kernel(kn, vn, *wargs(f3, pos))
            planted("k13", "int4: the partner nibble dropped",
                    pool_diff(f3, want), p1[0][1:].numel())
        del p1, p_ref, fresh, want

        # K11's W-query window over the pool the windows were written into
        row_bytes = D * esize + sc_bytes
        pools = [spec_pool(torch, kq, randn, n_pages, Hkv, PAGE, D, fmt)
                 for _ in range(n_copies(int(2 * n_pages * Hkv * PAGE
                                             * row_bytes)))]
        p0 = pools[0]

        def aargs(p, ln=lengths):
            return (p[0], p[1], p[2], p[3], bt, ln, p[4], p[5])

        out = K.paged_window_attn(q, *aargs(p0))
        ref = K.paged_window_attn_plain(q, *aargs(p0))
        torch.cuda.synchronize()
        ok = torch.equal(out, ref)
        err = float((out.float() - ref.float()).abs().max())
        rows_ok = True
        for w in range(W):
            one = K.paged_attn(q[:, :, w].contiguous(),
                               *aargs(p0, (lengths - W + w + 1).contiguous()))
            rows_ok &= torch.equal(out[:, :, w], one)
        if not rows_ok:
            bad.append(f"k11w {fmt}: a window row differs from "
                       "single-query K11 at its length")
        ms = timed_ms(torch, [lambda p=p: K.paged_window_attn(q, *aargs(p))
                              for p in pools], 200)
        pms = timed_ms(torch, [lambda: K.paged_window_attn_plain(
            q, *aargs(p0))], 3)

        def gathered(p, which):
            pages, sc, off = ((p[0], p[1], p[4]) if which == "k"
                              else (p[2], p[3], p[5]))
            if fmt == "bf16":
                rows_ = pages
            else:
                cache = (pages, sc, off) if int4 else (pages, sc)
                rows_ = kv_dequant_rows(torch, kq, cache, fmt)
            g = rows_[bt.long()].transpose(1, 2).reshape(B, Hkv, T, D)
            return g[:, :, :Lmax].contiguous()

        gk = [(gathered(p, "k"), gathered(p, "v")) for p in pools]
        lms = timed_ms(torch, [lambda a=a, b=b: sdpa(q, a, b,
                                                      attn_mask=mask)
                               for a, b in gk], 200)
        del gk
        record("k11w", f"{fmt} B={B} H={H} D={D} page={PAGE} pmax={pmax} "
               f"W={W} lengths={tuple(lengths.tolist())} rows bit-equal to "
               f"single-query K11: {rows_ok}", fmt, err, ok, ms, pms, lms,
               int(2 * Hkv * n_vis * row_bytes + 2 * B * H * W * D * 2
                   + B * pmax * 4 + B * 4), 4 * H * n_pairs * D)
        # every row attending the whole window: no causal limit
        whole = torch.stack([K.paged_attn(q[:, :, w].contiguous(),
                                          *aargs(p0)) for w in range(W)],
                            dim=2)
        d = (whole.float() - ref.float()).abs()
        planted("k11w", f"{fmt}: no causal limit in the window",
                int((d > kv_tol(ref)).sum()), d.numel())
        # the split's own faults, planted in its emulation, which without a
        # fault equals the kernel bit for bit
        if not torch.equal(k11_split_emulated(torch, q, *aargs(p0)), out):
            bad.append(f"k11w {fmt}: the split's emulation differs from "
                       "the kernel")
        faulty = k11_split_emulated(torch, q, *aargs(p0), fault="part_max")
        planted("k11w", f"{fmt}: p against its part's own maximum "
                "(torch.equal)", int((faulty != out).sum()), out.numel())
        faulty = k11_split_emulated(torch, q, *aargs(p0),
                                    fault="drop_last_part")
        d = (out.float() - faulty.float()).abs()
        planted("k11w", f"{fmt}: the fold drops each slot's last part",
                int((d > kv_tol(faulty)).sum()), d.numel())
        del pools, p0, faulty
    if bad:
        fail(f"speculative kernels disagree with their plain versions: {bad}")
    if missed:
        fail(f"the speculative kernels' checks missed planted faults: "
             f"{missed}")
    return rows


def phase_spec_envelope(torch) -> None:
    """The attention kernels over long contexts, none of which may raise,
    each bit for bit equal to its plain version: K5 and K6 (int8, fp8) at
    rep 1 over T 65,536; K7 (bf16, int8) at rep 4 over T 16,384; K11
    single-query and its W-query window (W 9 at rep 4: 36 query rows, five
    groups) over 128 pages of 128 rows in each pool format, each window
    row equal to single-query K11 at its length."""
    from neural_compressor_tpu_torch import kernels as K
    from neural_compressor_tpu_torch.ops import kv_quant as kq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(43)
    bad, n = [], 0

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def check(label, a, b):
        nonlocal n
        torch.cuda.synchronize()
        n += 1
        if not torch.equal(a, b):
            bad.append(label)

    D = HEAD_DIM
    T = 65536
    H = Hkv = 8
    k, v = randn(1, Hkv, T, D), randn(1, Hkv, T, D)
    for pos in (T - 1, 40000):
        q = randn(1, H, D)
        check(f"k5 rep 1 T={T} pos={pos}", K.decode_attn(q, k, v, pos),
              K.decode_attn_plain(q, k, v, pos))
    for fmt in ("int8", "fp8_e4m3"):
        kc, ks = kq.kv_quant(k, fmt)
        vc, vs = kq.kv_quant(v, fmt)
        for pos in (T - 1, T + 2):
            q, kn, vn = randn(1, H, D), randn(1, Hkv, D), randn(1, Hkv, D)
            check(f"k6 {fmt} rep 1 T={T} pos={pos}",
                  K.decode_attn_quant(q, kn, vn, kc, ks, vc, vs, pos),
                  K.decode_attn_quant_plain(q, kn, vn, kc, ks, vc, vs, pos))
    del k, v, kc, ks, vc, vs
    T, H, Hkv = 16384, 16, 4
    p = torch.tensor([T - 1, 9000], dtype=torch.int32, device=dev)
    k, v = randn(2, Hkv, T, D), randn(2, Hkv, T, D)
    q = randn(2, H, D)
    check(f"k7 bf16 rep 4 T={T}", K.batched_decode_attn(q, k, v, p),
          K.batched_decode_attn_plain(q, k, v, p))
    for fmt in ("int8", "fp8_e4m3"):
        kc, ks = kq.kv_quant(k, fmt)
        vc, vs = kq.kv_quant(v, fmt)
        check(f"k7 {fmt} rep 4 T={T}",
              K.batched_decode_attn(q, kc, vc, p, ks, vs),
              K.batched_decode_attn_plain(q, kc, vc, p, ks, vs))
    del k, v, kc, ks, vc, vs
    pmax, W = 128, SPEC_W
    n_pages = 2 * pmax + 1
    bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                         .manual_seed(44)) + 1).reshape(2, pmax)
    bt = bt.to(torch.int32).to(dev)
    lengths = torch.tensor([pmax * PAGE, 10000], dtype=torch.int32,
                           device=dev)
    for fmt in POOL_FORMATS:
        pool = spec_pool(torch, kq, randn, n_pages, Hkv, PAGE, D, fmt)
        a = (pool[0], pool[1], pool[2], pool[3], bt)
        ofs = (pool[4], pool[5])
        q = randn(2, H, D)
        check(f"k11 {fmt} rep 4 {pmax} pages of {PAGE}",
              K.paged_attn(q, *a, lengths, *ofs),
              K.paged_attn_plain(q, *a, lengths, *ofs))
        qw = randn(2, H, W, D)
        out = K.paged_window_attn(qw, *a, lengths, *ofs)
        check(f"k11 window {fmt} rep 4 W={W} {pmax} pages of {PAGE}", out,
              K.paged_window_attn_plain(qw, *a, lengths, *ofs))
        for w in range(W):
            check(f"k11 window {fmt} row {w} vs single-query",
                  out[:, :, w], K.paged_attn(
                      qw[:, :, w].contiguous(), *a,
                      (lengths - W + w + 1).contiguous(), *ofs))
        del pool
    # the split's boundaries: lengths on a part's last key, its first and
    # the one after (parts of 512 keys at pages of 128 and 16, of 500 at
    # pages of 100), a band starting inside a part with whole parts before
    # it, the softcap, a slot of length 0
    from neural_compressor_tpu_torch.kernels.paged_attention import \
        split_plan

    H, Hkv, Wq = 4, 2, 4
    for page in (128, 16, 100):
        pk = split_plan(1, H, Hkv, 1, D, page, 1).part_keys
        pmax = -(-1600 // page)
        lens = (pk, pk + 1, pk + 2, 1500, 0)
        n_pages = len(lens) * pmax + 1
        bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                             .manual_seed(45)) + 1).reshape(len(lens), pmax)
        bt = bt.to(torch.int32).to(dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for fmt in POOL_FORMATS:
            pool = spec_pool(torch, kq, randn, n_pages, Hkv, page, D, fmt)
            a = (pool[0], pool[1], pool[2], pool[3], bt, lengths, pool[4],
                 pool[5])
            q = (randn(len(lens), H, D).float() * 4).to(torch.bfloat16)
            tag = f"{fmt} page={page} lengths={lens}"
            check(f"k11 split {tag}", K.paged_attn(q, *a),
                  K.paged_attn_plain(q, *a))
            for kw in (dict(window=700, softcap=50.0), dict(softcap=50.0)):
                check(f"k11 split gemma {kw} {tag}",
                      K.paged_attn_gemma(q, *a, **kw),
                      K.paged_attn_plain(q, *a, **kw))
            qw = randn(len(lens), H, Wq, D)
            out = K.paged_window_attn(qw, *a)
            check(f"k11 split window W={Wq} {tag}", out,
                  K.paged_window_attn_plain(qw, *a))
            for w in range(Wq):
                ln = (lengths - Wq + w + 1).clamp_min(0).contiguous()
                check(f"k11 split window {tag} row {w} vs single-query",
                      out[:, :, w], K.paged_attn(qw[:, :, w].contiguous(),
                                                 *a[:5], ln, *a[6:]))
            del pool
    print(f"spec envelope (long contexts): {n} checks, card vs plain: "
          f"{'all equal, none raised' if not bad else bad}", flush=True)
    if bad:
        fail(f"attention kernels over long contexts: {bad}")


def repeating_prompt(torch, V: int, n: int, seed: int):
    """A random [1, n] prompt that repeats a 6-gram every 15 tokens, so
    that prompt lookup has matches to propose."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, V, (1, n), generator=gen)
    unit = torch.randint(0, V, (6,), generator=gen)
    for at in range(0, n - 6, 15):
        ids[0, at:at + 6] = unit
    return ids


def loop_prompt(torch, nct, model, seed: int):
    """The last 40 tokens of the model's 160-token greedy run from a random
    8-token prompt, made on the card: a random model's greedy run falls
    into cycles, so prompt lookup proposes tokens it repeats and verify
    rounds accept several (as ``bench.py``'s prompt does)."""
    p = repeating_prompt(torch, model.cfg.vocab_size, 8, seed)
    return nct.greedy_search(model, p, max_new_tokens=160)[:, -40:].cpu()


def spec_launches(layers: int, rounds: int, chunks: int, paged: bool) -> dict:
    """The exact launches of speculative serving on a W4A8 model: K1 for
    every projection (4 a layer and the lm_head) of every verify window and
    prefill chunk; over a page pool K13 writes and K11's window attends
    each window, once a layer (a contiguous cache's window attends in plain
    PyTorch, as JAX's prefill branch does)."""
    want = dict(w4a8_gemm=(4 * layers + 1) * (rounds + chunks))
    if paged:
        want.update(paged_write_window=layers * rounds,
                    paged_window_attn=layers * rounds)
    return want


def card_cpu_tie(torch, m_cpu, m_gpu, fmt, prefix, tok_cpu: int,
                 tok_card: int) -> tuple:
    """Where the card and the CPU chose ``tok_card`` and ``tok_cpu`` after
    the common ``prefix``: the CPU's top-2 gap between them, and the
    measured card-CPU logit difference there (one prefill of the prefix
    over a cache of ``fmt`` on each side). Returns (gap, diff)."""
    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    ids = torch.tensor([list(prefix)])
    rows = []
    for m in (m_cpu, m_gpu):
        caches = init_kv_cache(m.cfg, 1, ids.shape[1], quantized=fmt or False,
                               device=m.device)
        with torch.no_grad():
            lg, _ = m(ids.to(m.device), None, caches, 0)
        rows.append(lg[0, -1].float().cpu())
    cpu, card = rows
    return float(cpu[tok_cpu] - cpu[tok_card]), float((cpu - card).abs().max())


def phase_spec_model_check(torch, nct) -> None:
    """Greedy speculation on full-width 2-layer models, the card (kernels)
    against the CPU (plain versions), the same weights and prompts:
    ``ngram_speculative_greedy_search`` on W4A8 (fused decode) and W4A16
    targets, ``speculative_greedy_search`` with a W4A8 target and another
    2-layer W4A8 model of its own seed as the draft, and the engine with
    ``speculative="ngram"`` in every pool mode (contiguous bf16, int8,
    fp8, int4; paged bf16, int8, fp8, int4; 128-row pages, so that K13 and
    K11's window run). Tokens and statistics must be equal, and the
    card's launches exact (B=1) or present (the engine's path); an engine
    request may part only where the CPU's top-2 gap is at most the
    measured card-CPU logit difference there (``card_cpu_tie``; as
    ``two_layer_check`` allows it over int4 caches)."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                          LlamaConfig)

    torch.set_num_threads(8)
    t0 = time.perf_counter()
    cfg = LlamaConfig(**dict(LLAMA_PRESETS["llama2-7b"], num_hidden_layers=2))
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    held = {}  # the CPU's unpacked weights, cleared with their models

    def w4a8(seed):
        return w4a8_pair(nct, cfg, nct.RTNConfig(
            dtype="int4", group_size=G, quant_lm_head=True), seed)

    def both(fn, m_cpu, m_gpu, label, want_fn, woq=False):
        t1 = time.perf_counter()
        kernels.reset_launch_counts()
        got, gst = fn(m_gpu)
        launched = launch_counts()
        if woq:
            set_woq_impl(m_cpu, "pallas")   # the card's K8 at M = 9 and 32
        with unpack_once(held):
            want, wst = fn(m_cpu)
        want_l = expect(**want_fn(gst))
        ok = (torch.equal(got.cpu(), want) and gst == wst
              and launched == want_l)
        print(f"spec model check {label} (2 layers, full width): card "
              f"{got[0, -16:].tolist()} cpu {want[0, -16:].tolist()} stats "
              f"card {gst} cpu {wst} launches "
              f"{ {k: v for k, v in launched.items() if v} } "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
        if not ok:
            fail(f"spec model check {label}: card and CPU differ or launches "
                 f"{launched} != {want_l}")

    new = 8
    m_cpu, m_gpu = w4a8(4)
    ids = loop_prompt(torch, nct, m_gpu, 51)

    def ngram(m):
        return nct.ngram_speculative_greedy_search(
            m, ids, max_new_tokens=new, k=SPEC_K, n=SPEC_N, max_len=128,
            return_stats=True)

    both(ngram, m_cpu, m_gpu, "ngram W4A8",
         lambda st: spec_launches(L, st["rounds"], 1, False))
    d_cpu, d_gpu = w4a8(5)

    def draft(m):
        return nct.speculative_greedy_search(
            m, d_gpu if m is m_gpu else d_cpu, ids, max_new_tokens=new,
            k=4, max_len=128, return_stats=True)

    # the draft's k+1 single-token steps a round carry position tensors:
    # K5 at B=1 (bf16 cache), as JAX's dispatch sends every B=1 call,
    # after its fused projections (K4)
    both(draft, m_cpu, m_gpu, "draft-verify W4A8",
         lambda st: dict(w4a8_gemm=(4 * L + 1) * (st["rounds"] + 2),
                         fused_gemv=(4 * L + 1) * 5 * st["rounds"],
                         decode_attn=L * 5 * st["rounds"]))
    held.clear()
    del d_cpu, d_gpu

    # the engine in every pool mode: a looping prompt and a random one
    prompts = [ids[0].numpy(), repeating_prompt(torch, V, 20, 61)[0].numpy()]
    news = (5, 4)
    kw = dict(n_slots=4, max_len=256, prefill_chunk=32, page_size=PAGE,
              speculative="ngram", spec_k=SPEC_K, spec_n=SPEC_N)
    for mode in ENGINE_MODES:
        t1 = time.perf_counter()
        kernels.reset_launch_counts()
        eng, got, _s = serve_engine(torch, nct, m_gpu, mode, prompts, news,
                                    chunk=2, **kw)
        launched = launch_counts()
        mg = eng.metrics()
        with unpack_once(held):
            eng, want, _s = serve_engine(torch, nct, m_cpu, mode, prompts,
                                         news, chunk=2, **kw)
        mc = eng.metrics()
        toks = [r.generated for r in got]
        paged = mode.startswith("paged")
        path = (("paged_write_window", "paged_window_attn") if paged
                else ("w4a8_gemm",))
        keys = ("spec_rounds", "spec_accepted", "decode_dispatches")
        parted = []
        for i, (a, b) in enumerate(zip(toks, [r.generated for r in want])):
            n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if n is not None:
                with unpack_once(held):
                    gap, diff = card_cpu_tie(torch, m_cpu, m_gpu,
                                             ENGINE_MODES[mode][1],
                                             list(prompts[i]) + b[:n], b[n],
                                             a[n])
                parted.append(dict(request=i, step=n, card=a[n], cpu=b[n],
                                   gap=gap, diff=diff))
        ok = (all(p_["gap"] <= p_["diff"] for p_ in parted)
              and (parted or all(mg[k] == mc[k] for k in keys))
              and all(launched[k] > 0 for k in path)
              and (paged or launched["paged_window_attn"] == 0))
        print(f"spec engine check {mode} (2 layers, full width): card "
              f"tokens {toks} cpu {[r.generated for r in want]} "
              f"{ {k: mg[k] for k in keys} } near-ties {parted} launches "
              f"{ {k: v for k, v in launched.items() if v} } "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
        if not ok:
            fail(f"spec engine {mode}: card and CPU differ or the path's "
                 "kernels did not run")
    held.clear()
    del m_cpu, m_gpu

    # a W4A16 target: windows and the prefill on K8 (the CPU forced onto
    # the plain K8, as two_layer_check forces it)
    m_gpu = woq_model(nct, cfg, seed=7, device="cuda")
    m_cpu = copy.deepcopy(m_gpu).to("cpu")
    ids = loop_prompt(torch, nct, m_gpu, 52)
    both(ngram, m_cpu, m_gpu, "ngram W4A16",
         lambda st: dict(dequant_gemm=(4 * L + 1) * (st["rounds"] + 1)),
         woq=True)
    held.clear()
    del m_cpu, m_gpu
    print(f"spec model check done in {time.perf_counter() - t0:.1f} s",
          flush=True)


def parting_gap(torch, model, prefix, tok_a: int, tok_b: int) -> tuple:
    """At a step where two paths chose ``tok_a`` (greedy) and ``tok_b``
    (speculative) after the common ``prefix`` (a list of token ids), the
    decode path's top-2 gap between them and the measured logit difference
    between the decode path and the verify window's path at that step:
    (a) the prefix less its last token prefilled, the last token decoded
    (the fused B=1 step); (b) the prefix less its last SPEC_W tokens
    prefilled, those tokens one verify window (K1 at M = SPEC_W). Returns
    (gap, diff)."""
    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    ids = torch.tensor([prefix], device="cuda")
    P = ids.shape[1]
    with torch.no_grad():
        caches = init_kv_cache(model.cfg, 1, P + 1)
        model(ids[:, :-1], None, caches, 0)
        a, _ = model(ids[:, -1:], torch.full((1, 1), P - 1, device="cuda"),
                     caches, P - 1)
        caches = init_kv_cache(model.cfg, 1, P + 1)
        model(ids[:, :P - SPEC_W], None, caches, 0)
        b, _ = model(ids[:, P - SPEC_W:],
                     torch.arange(P - SPEC_W, P, device="cuda")[None],
                     caches, P - SPEC_W)
    a, b = a[0, -1].float(), b[0, -1].float()
    return float(a[tok_a] - a[tok_b]), float((a - b).abs().max())


def token_rule(torch, model, label, prompt, want, got) -> dict:
    """Speculative tokens ``got`` against greedy's ``want`` after
    ``prompt``: equal, or parted first where the greedy path's top-2 gap is
    at most the measured logit difference between the decode and the
    window paths (``parting_gap``). Returns the parting (or {})."""
    n = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if n is None:
        return {}
    gap, diff = parting_gap(torch, model, list(prompt) + list(want[:n]),
                            want[n], got[n])
    part = dict(step=n, greedy=want[n], spec=got[n], gap=gap, diff=diff)
    print(f"{label}: parts from greedy at new token {n}: {part}",
          flush=True)
    if gap > diff:
        fail(f"{label}: speculative tokens part from greedy's where the "
             f"greedy top-2 gap {gap} exceeds the paths' difference {diff}")
    return part


def phase_spec_serve(torch, nct, model) -> dict:
    """Greedy speculation on phase 5's llama2-7b W4A8 model:
      * B=1, ``bench.py``'s path: the prompt is the last 128 tokens of a
        192-token ``greedy_search`` from ``arange(16) % 256``;
        ``ngram_speculative_greedy_search`` with k 8, n 2, max_len 512 and
        128 new tokens against ``greedy_search`` on the same prompt
        (tok/s of both, tokens a round, the acceptance histogram);
      * the 8-slot engine with ``speculative="ngram"`` (k 8, n 2) over
        contiguous bf16 caches and the paged int8 pool: 16 requests, half
        of phase 7's prompts, half the model's own greedy continuations;
        tok/s against the plain engine on the same requests in this run,
        ``spec_rounds`` and ``spec_accepted``; one spec dispatch profiled.
    Exact launch counts (K1, and K13 and K11's window over the pool); the
    tokens obey ``token_rule`` against the plain paths. Returns
    {path: launches}."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    V = model.cfg.vocab_size
    out = {}
    seed_ids = (torch.arange(16)[None] % 256).cuda()
    warm = nct.greedy_search(model, seed_ids, max_new_tokens=192,
                             max_len=512)
    prompt = warm[:, -128:]
    P, new = prompt.shape[1], 128

    def timed(fn):
        fn()                                   # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    greedy, g_s = timed(lambda: nct.greedy_search(
        model, prompt, max_new_tokens=new, max_len=512))
    kernels.reset_launch_counts()
    (spec, st), s_s = timed(lambda: nct.ngram_speculative_greedy_search(
        model, prompt, max_new_tokens=new, k=SPEC_K, n=SPEC_N, max_len=512,
        return_stats=True))
    launches = launch_counts()
    # two runs counted from the reset (the warm run and the timed one)
    want = expect(**{k: 2 * v for k, v in spec_launches(
        model.cfg.num_hidden_layers, st["rounds"], 1, False).items()})
    print(f"spec B=1 (bench.py's path, prompt {P}, {new} new, k {SPEC_K}, "
          f"n {SPEC_N}): greedy {new / g_s:.2f} tok/s, speculative "
          f"{new / s_s:.2f} tok/s, {json.dumps(st)}", flush=True)
    print(f"spec B=1 kernels {json.dumps(launches)} expected "
          f"{json.dumps(want)}", flush=True)
    if launches != want:
        fail(f"spec B=1: launch counts {launches} != {want}")
    g, s_ = greedy[0, P:].tolist(), spec[0, P:].tolist()
    if len(s_) != new or min(s_) < 0 or max(s_) >= V:
        fail(f"spec B=1: bad output {s_}")
    token_rule(torch, model, "spec B=1", prompt[0].tolist(), g, s_)
    out["spec_greedy_b1"] = {k: v // 2 for k, v in launches.items()}
    # where the time goes at B=1: one verify round (a 9-token window
    # forward over the prompt's cache, proposals from the greedy tokens)
    with torch.no_grad():
        caches = init_kv_cache(model.cfg, 1, 512)
        model(prompt, None, caches, 0)
        win = greedy[:, P - 1:P - 1 + SPEC_W]
        at = torch.arange(P - 1, P - 1 + SPEC_W, device="cuda")[None]
        model(win, at, caches, P - 1)                  # warm
        profile_window(torch, f"spec B=1 one verify round ({SPEC_W}-token "
                       "window)", lambda: model(win, at, caches, P - 1))
        del caches

    # the engine: half phase 7's prompts, half greedy continuations
    gen = torch.Generator().manual_seed(6)
    p7 = [torch.randint(0, V, (PROMPTS[i % len(PROMPTS)],),
                        generator=gen).numpy()
          for i in range(ENGINE_REQUESTS)]
    starts = (torch.arange(16)[None] + 16 * torch.arange(SLOTS)[:, None]) \
        % 256
    cont = nct.greedy_search(model, starts.cuda(), max_new_tokens=192,
                             max_len=512)[:, -128:].cpu().numpy()
    prompts = [p7[i] for i in range(ENGINE_REQUESTS // 2)] + list(cont)
    news = [48 + (7 * i) % 17 for i in range(ENGINE_REQUESTS)]
    spec_kw = dict(speculative="ngram", spec_k=SPEC_K, spec_n=SPEC_N)
    for mode in ("contiguous", "paged_int8"):
        paged = mode != "contiguous"
        _e, plain, plain_s = serve_engine(torch, nct, model, mode, prompts,
                                          news, n_slots=SLOTS,
                                          max_len=MAX_LEN, page_size=PAGE)
        plain_tok_s = _e.metrics()["generated_tok_s"]
        del _e
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        eng, reqs, seconds = serve_engine(torch, nct, model, mode, prompts,
                                          news, n_slots=SLOTS,
                                          max_len=MAX_LEN, page_size=PAGE,
                                          **spec_kw)
        launches = launch_counts()
        m = eng.metrics()
        rounds = CHUNK * m["decode_dispatches"]
        want = expect(**spec_launches(model.cfg.num_hidden_layers, rounds,
                                      m["prefill_chunk_dispatches"], paged))
        counters = {k: m[k] for k in (
            "generated_tokens", "prefill_chunk_dispatches",
            "decode_dispatches", "combined_dispatches", "spec_rounds",
            "spec_accepted", "spec_suppressed_dispatches")}
        print(f"spec engine {mode}: {len(reqs)} requests in {seconds:.3f} s, "
              f"generated {m['generated_tok_s']:.2f} tok/s against the plain "
              f"engine's {plain_tok_s:.2f} on the same requests, tokens a "
              f"round {m['spec_accepted'] / max(m['spec_rounds'], 1):.3f}, "
              f"{json.dumps(counters)}", flush=True)
        print(f"spec engine {mode} kernels {json.dumps(launches)} expected "
              f"{json.dumps(want)}", flush=True)
        if launches != want:
            fail(f"spec engine {mode}: launch counts {launches} != {want}")
        parted = []
        for i, (r, q, p) in enumerate(zip(reqs, plain, prompts)):
            if len(r.generated) != news[i] or min(r.generated) < 0 \
                    or max(r.generated) >= V:
                fail(f"spec engine {mode}: bad output {r.generated}")
            part = token_rule(torch, model, f"spec engine {mode} request {i}",
                              list(p), q.generated, r.generated)
            if part:
                parted.append(i)
        print(f"spec engine {mode}: {ENGINE_REQUESTS - len(parted)} of "
              f"{ENGINE_REQUESTS} requests equal to the plain engine's "
              f"tokens, parted at near-ties: {parted}", flush=True)
        out[f"spec_engine_{mode}"] = launches

        # where the time goes: one spec dispatch with every slot live
        eng = engine_for(nct, model, mode, n_slots=SLOTS, max_len=MAX_LEN,
                         page_size=PAGE, **spec_kw)
        for p in prompts[SLOTS:]:
            eng.submit(p, max_new_tokens=64)
        while eng.queue or "prefill" in eng.slot_state:
            eng.run(max_steps=1, chunk=1)
        profile_window(torch, f"spec engine {mode} dispatch, 8 slots x "
                       f"{CHUNK} verify rounds of {SPEC_W} tokens",
                       lambda: eng._spec_step(CHUNK))
        del eng        # not run dry: the profile was all it was for
    return out


def phase_kv_serve(torch, nct, model) -> dict:
    """The slice's path at full width, ``WOQ_LAYERS`` deep: llama2-7b
    asym-int4 g128 W4A16 (built with ``RTNConfig + KVCacheQuantConfig``)
    with int8 and with
    fp8 caches, three greedy requests at B=1 each (prompts of 16, 100 and
    371 tokens, 48 new, max_len 1024): prefill on the codes, K6 decode
    attention, K9 decode projections, K8 (M <= 256) and dequantize-then-
    matmul prefill. Exact launch counts; tok/s and peak memory; one decode
    window of 8 steps profiled per format. Returns {format: launches}."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_dot
    from neural_compressor_tpu_torch.models.llama import init_kv_cache
    nl = model.cfg.num_hidden_layers

    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, model.cfg.vocab_size, (1, P), generator=gen)
               for P in PROMPTS]
    steps = NEW_TOKENS - 1
    n_proj = 4 * nl + 1
    short = sum(P <= 256 for P in PROMPTS)
    out = {}
    for fmt in ("int8", "fp8_e4m3"):
        set_kv_format(model, fmt)
        nct.greedy_search(model, prompts[0], max_new_tokens=4,
                          max_len=MAX_LEN)
        prefill_ms = []
        with torch.no_grad():
            for ids in prompts:
                caches = init_kv_cache(model.cfg, 1, MAX_LEN, quantized=fmt,
                                       device=model.device)
                torch.cuda.synchronize()
                t = time.perf_counter()
                model(ids.cuda(), None, caches, 0)
                torch.cuda.synchronize()
                prefill_ms.append((time.perf_counter() - t) * 1e3)
                del caches
        gc.collect()       # earlier engines' caches, held by cycles
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        dequant_dot.calls = 0
        req_s, outs = [], []
        for ids in prompts:
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs.append(nct.greedy_search(model, ids,
                                          max_new_tokens=NEW_TOKENS,
                                          max_len=MAX_LEN))
            torch.cuda.synchronize()
            req_s.append(time.perf_counter() - t)
        launches = launch_counts()
        dots = dequant_dot.calls
        # K6 attends, K12 writes the row (paged_write for int8 codes)
        write = "paged_write" if fmt == "int8" else "paged_write_fp8"
        want = expect(decode_attn_quant=len(PROMPTS) * steps * nl,
                      **{write: len(PROMPTS) * steps * nl},
                      dequant_gemm=short * n_proj,
                      vpu_gemv=len(PROMPTS) * steps * n_proj)
        want_dots = (len(PROMPTS) - short) * n_proj
        cache_gib = (2 * nl * HEADS * MAX_LEN
                     * (HEAD_DIM + 4)) / 2**30
        print(f"kv {fmt} B=1 kernels {json.dumps(launches)} expected "
              f"{json.dumps(want)}; dequantize-then-matmul calls {dots} "
              f"(expected {want_dots}); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({fmt} "
              f"cache of {MAX_LEN} rows: {cache_gib:.3f} GiB)", flush=True)
        for ids, o, s_, pms in zip(prompts, outs, req_s, prefill_ms):
            P = ids.shape[1]
            if (tuple(o.shape) != (1, P + NEW_TOKENS)
                    or not torch.equal(o[:, :P].cpu(), ids.to(torch.int32))
                    or int(o.min()) < 0
                    or int(o.max()) >= model.cfg.vocab_size):
                fail(f"bad {fmt} greedy output for prompt {P}: {o}")
            print(f"kv {fmt} request prompt={P} new={NEW_TOKENS}: "
                  f"{s_ * 1e3:.1f} ms, prefill {pms:.2f} ms, decode "
                  f"{steps / (s_ - pms / 1e3):.2f} tok/s (first new tokens "
                  f"{o[0, P:P + 8].tolist()})", flush=True)
        if launches != want or dots != want_dots:
            fail(f"{fmt} B=1 launch counts {launches} != {want} or "
                 f"dequantize-then-matmul calls {dots} != {want_dots}")
        out[fmt] = launches

        ids = prompts[1].cuda()
        P = ids.shape[1]
        with torch.no_grad():
            caches = init_kv_cache(model.cfg, 1, MAX_LEN, quantized=fmt,
                                   device=model.device)
            model(ids, None, caches, 0)
            tok = ids[:, -1:]

            def decode8():
                for i in range(8):
                    model(tok, torch.full((1, 1), P + i, device="cuda"),
                          caches, P + i)

            decode8()
            profile_window(torch, f"kv {fmt} B=1 decode x8", decode8)
            del caches
    set_kv_format(model, None)
    return out


def phase_kv_engine(torch, nct, model) -> dict:
    """The W4A16 llama2-7b behind ``ContinuousBatchingEngine(n_slots=8,
    max_len=1024)``, 16 greedy requests ``run(chunk=8)`` over contiguous
    int8, fp8 and int4 caches and paged fp8 and int4 pools of 128-row
    pages. Each decode step runs K8 at M = 8 and, per layer, K7's quantized
    branch (int8, fp8), the int4 code-domain attention (plain PyTorch, as
    in JAX), or K12 + K11 (fp8, int4 pools); prefill chunk row counts are
    observed to derive K8 (M <= 256) against dequantize-then-matmul. Exact
    launch counts, tok/s, cache bytes and peak memory; one B=8 decode
    dispatch profiled per mode. Returns {mode: launches}."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_dot

    V = model.cfg.vocab_size
    nl = model.cfg.num_hidden_layers
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, V, (PROMPTS[i % len(PROMPTS)],),
                             generator=gen).numpy()
               for i in range(ENGINE_REQUESTS)]
    new = [48 + (7 * i) % 17 for i in range(ENGINE_REQUESTS)]   # 48-64
    n_proj = 4 * nl + 1
    out = {}
    for mode in KV_MODES:
        _kw, fmt = ENGINE_MODES[mode]
        paged = mode.startswith("paged")
        eng = engine_for(nct, model, mode, n_slots=SLOTS, max_len=MAX_LEN,
                         page_size=PAGE)
        chunk_rows = []
        prefill_forward = eng._prefill_forward

        def observed(target, ids, *args, _f=prefill_forward):
            chunk_rows.append(int(ids.shape[0]))
            return _f(target, ids, *args)

        eng._prefill_forward = observed
        reqs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, new)]
        gc.collect()       # earlier engines' caches, held by cycles
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        dequant_dot.calls = 0
        t = time.perf_counter()
        done = eng.run(chunk=CHUNK)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = launch_counts()
        dots = dequant_dot.calls
        if sorted(r.uid for r in done) != sorted(r.uid for r in reqs):
            fail(f"kv engine {mode} finished {len(done)} of {len(reqs)}")
        m = eng.metrics()
        steps = CHUNK * m["decode_dispatches"]
        C = eng.prefill_chunk
        k8_chunks = sum(r * C <= 256 for r in chunk_rows)
        if len(chunk_rows) != m["prefill_chunk_dispatches"]:
            fail(f"{mode}: {len(chunk_rows)} prefill chunks seen, the engine "
                 f"counted {m['prefill_chunk_dispatches']}")
        attn = {"contiguous_int8": dict(batched_decode_attn_quant=1,
                                        paged_write=1),
                "contiguous_fp8": dict(batched_decode_attn_quant=1,
                                       paged_write_fp8=1),
                "contiguous_int4": {},
                "paged_fp8": dict(paged_attn_fp8=1, paged_write_fp8=1),
                "paged_int4": dict(paged_attn_int4=1,
                                   paged_write_int4=1)}[mode]
        want = expect(dequant_gemm=n_proj * (steps + k8_chunks),
                      **{k: nl * steps for k in attn})
        want_dots = n_proj * (len(chunk_rows) - k8_chunks)
        counters = {k: m[k] for k in (
            "requests", "prompt_tokens", "generated_tokens",
            "prefill_chunk_dispatches", "decode_dispatches",
            "combined_dispatches", "preemptions")}
        kv = (f"{eng.n_pages} pages of {PAGE} rows" if paged
              else f"{SLOTS} x {MAX_LEN} rows")
        print(f"kv engine {mode} ({kv}, {m['kv_cache_format']}, "
              f"{m['kv_cache_bytes'] / 2**30:.3f} GiB of cache): {len(reqs)} "
              f"requests in {seconds:.3f} s, generated "
              f"{m['generated_tok_s']:.2f} tok/s (metrics wall "
              f"{m['wall_s']:.3f} s), {json.dumps(counters)}, prefill chunk "
              f"rows {chunk_rows} (chunk {C}), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        print(f"kv engine {mode} kernels {json.dumps(launches)} expected "
              f"{json.dumps(want)}; dequantize-then-matmul calls {dots} "
              f"(expected {want_dots}, M > 256 only)", flush=True)
        for r, p, n_ in zip(reqs, prompts, new):
            if (len(r.generated) != n_ or min(r.generated) < 0
                    or max(r.generated) >= V
                    or not all(math.isfinite(x) for x in r.logprobs)):
                fail(f"kv engine {mode}: bad output for a {len(p)}-token "
                     f"prompt: {r.generated}")
        print(f"kv engine {mode} first new tokens "
              f"{[r.generated[:4] for r in reqs[:3]]}", flush=True)
        if launches != want or dots != want_dots:
            fail(f"kv engine {mode}: launch counts {launches} != {want} or "
                 f"dequantize-then-matmul calls {dots} != {want_dots}")
        out[mode] = launches
        del eng
        eng = engine_for(nct, model, mode, n_slots=SLOTS, max_len=MAX_LEN,
                         page_size=PAGE)
        for p in prompts[:SLOTS]:
            eng.submit(p, max_new_tokens=64)
        while eng.queue or "prefill" in eng.slot_state:
            eng.run(max_steps=1, chunk=1)
        profile_window(torch, f"kv engine {mode} decode dispatch, 8 slots x "
                       f"{CHUNK} steps", lambda: eng.step_many(CHUNK))
        del eng        # not run dry: the profile was all it was for
    return out


# ------------------------------------------------------------------ Gemma
# gemma2-9b's attention at the engine's shapes: 8 slots over 8192-row
# contexts of 128-row pages, 16 query heads on 8 KV heads of 256; the band
# binds on the slots past 4096
GEMMA_PRESET = "gemma2-9b"
# depth of the served gemma2-9b, cut from 42 to keep the whole check
# inside its time limit: 3 sliding and 3 global layers (21 in PR 8-9)
GEMMA_LAYERS = 6
GEMMA_POS = (0, 1023, 4095, 4096, 4097, 5000, 6500, 8191)
GEMMA_MAX_LEN = 8192
GEMMA_WINDOW, GEMMA_SOFTCAP = 4096, 50.0
GEMMA_PROMPTS, GEMMA_NEW = (16, 371, 4500), 48
# the engine: 8 requests, 2 of them past the window (cut from 16 to keep
# the whole check inside its time limit)
GEMMA_ENGINE_REQUESTS = 8
GEMMA_ENGINE_PROMPTS = (16, 100, 371, 4200)
GEMMA_ENGINE_NEW = 8
# the 2-layer checks cut the window to 64 so a 100-token prompt binds it
# (reduced: gemma2-9b's is 4096, gemma3-4b-text's 1024)
GEMMA_CHECK_WINDOW, GEMMA_CHECK_PROMPT = 64, 100
# the 2-layer checks' models and seeds
GEMMA_CHECK_PRESETS = ((GEMMA_PRESET, 11), ("gemma3-4b-text", 12))


def gemma_cfg(nct, preset, **cut):
    """A ``GemmaConfig`` of ``preset`` with the cuts ``cut`` (depth, window,
    layer types)."""
    from neural_compressor_tpu_torch.models.gemma import (GEMMA_PRESETS,
                                                          GemmaConfig)

    return GemmaConfig(**dict(GEMMA_PRESETS[preset], **cut))


def gemma_model(nct, cfg, seed, device=None, kv=None):
    """A gemma quantized weight-only, asym int4 g128 (the tied embedding
    stays bf16), built layer by layer on ``device`` with ``RTNConfig`` (+
    ``KVCacheQuantConfig(dtype=kv)``)."""
    from neural_compressor_tpu_torch.models import gemma

    qc = nct.RTNConfig(dtype="int4", group_size=G, use_sym=False)
    if kv is not None:
        qc = qc + nct.KVCacheQuantConfig(dtype=kv)
    return gemma.build_quantized(cfg, qc, seed=seed, device=device)


def gemma_after_mask(torch, q, kp, vp, bt, lengths, window, cap):
    """The planted fault "softcap after the mask" over a bf16 pool: masked
    scores are the softcap of the -1e30 sentinel, -cap, and take part in
    the softmax (the dense form of the fault)."""
    from neural_compressor_tpu_torch.kernels.paged_attention import \
        _gather_rows
    from neural_compressor_tpu_torch.ops import softcap

    B, H, D = q.shape
    Hkv = kp.shape[1]
    k = _gather_rows(kp, bt.long())
    v = _gather_rows(vp, bt.long())
    T = k.shape[2]
    qr = q.reshape(B, Hkv, H // Hkv, D).double()
    s = torch.einsum("bgrd,bgtd->bgrt", qr, k).float() * (1.0 / D ** 0.5)
    t = torch.arange(T, device=q.device)[None, :]
    qpos = (lengths.long() - 1)[:, None]
    valid = ((t <= qpos) & (qpos - t < window))[:, None, None]
    s = softcap(torch.where(valid, s, torch.tensor(-1e30, device=q.device)),
                cap)
    p = torch.softmax(s.double(), dim=-1)
    out = torch.einsum("bgrt,bgtd->bgrd", p.float().bfloat16().double(), v)
    return out.float().reshape(B, H, D).bfloat16()


def phase_gemma_kernels(torch, nct, peaks: dict) -> dict:
    """K11 with gemma's band and softcap at gemma2-9b's shapes: 8 slots at
    ``GEMMA_POS`` over 8192-row contexts (pools of 128-row pages, Hkv 8,
    rep 2, D 256), each pool format with the band on (a sliding layer:
    window 4096 and softcap 50) and off (a global layer: softcap 50), each
    against its plain version within ``kv_tol``, timed with L2 cold, and
    the yardstick SDPA over the gathered rows with the band mask (SDPA has
    no softcap). q is the pre-folded gemma2-9b query (scaling * sqrt(D) =
    1) at 6x unit scale, so scores reach the softcap's curve. Planted
    faults, each of which the check must flag: the band off by one (keys
    with q - k <= window), the softcap applied after the mask, the softcap
    dropped, the band applied to a global layer."""
    from neural_compressor_tpu_torch.kernels import (paged_attn_gemma,
                                                     paged_attn_plain)
    from neural_compressor_tpu_torch.ops import kv_quant as kq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, Hkv, rep, D = SLOTS, 8, 2, 256
    H, T, W, cap = Hkv * rep, GEMMA_MAX_LEN, GEMMA_WINDOW, GEMMA_SOFTCAP
    pmax = T // PAGE
    n_pages = B * pmax + 1                      # page 0 is the trash page
    bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                         .manual_seed(32)) + 1).reshape(B, pmax)
    bt = bt.to(torch.int32).to(dev)
    lengths = torch.tensor(GEMMA_POS, dtype=torch.int32, device=dev) + 1
    L = lengths.long()
    Lmax = int(L.max())
    q = (randn(B, H, D, dtype=torch.float32) * 6).to(torch.bfloat16)
    q4 = q[:, :, None]
    rows = []
    for fmt in POOL_FORMATS:
        row_b = {"bf16": 2 * D, "int8": D + 4, "fp8_e4m3": D + 4,
                 "int4": D // 2 + 8}[fmt]
        pools = [spec_pool(torch, kq, randn, n_pages, Hkv, PAGE, D, fmt)
                 for _ in range(n_copies(2 * n_pages * Hkv * PAGE * row_b))]

        def args(p):
            return (p[0], p[1], p[2], p[3], bt, lengths, p[4], p[5])

        def rows_of(p, i):
            """The bf16 rows [B, Hkv, Lmax, D] pool ``p``'s K (i = 0) or V
            (i = 2) holds, gathered: the yardstick's operands."""
            if fmt == "bf16":
                r = p[i]
            elif fmt == "int4":
                r = kv_dequant_rows(torch, kq, (p[i], p[i + 1], p[4 + i // 2]),
                                    fmt)
            else:
                r = kv_dequant_rows(torch, kq, (p[i], p[i + 1]), fmt)
            g = r[bt.long()].transpose(1, 2).reshape(B, Hkv, T, D)
            return g[:, :, :Lmax].contiguous()

        gk = [(rows_of(p, 0), rows_of(p, 2)) for p in pools[:2]]
        t_idx = torch.arange(Lmax, device=dev)[None, :]
        for window in (W, None):
            kw = dict(window=window, softcap=cap)
            out = paged_attn_gemma(q, *args(pools[0]), **kw)
            ref = paged_attn_plain(q, *args(pools[0]), **kw)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            tol = kv_tol(ref)
            err, ok = float(d.max()), bool((d <= tol).all())
            ms = timed_ms(torch, [lambda p=p: paged_attn_gemma(
                q, *args(p), **kw) for p in pools], 50)
            pms = timed_ms(torch, [lambda: paged_attn_plain(
                q, *args(pools[0]), **kw)], 3)
            valid = t_idx < L[:, None]
            if window is not None:
                valid = valid & (t_idx >= L[:, None] - window)
            mask = valid[:, None, None]
            lms = timed_ms(torch, [lambda a=a, b=b: sdpa(
                q4, a, b, attn_mask=mask, enable_gqa=True)
                for a, b in gk], 50)
            n_vis = int(valid.sum())
            nbytes = (2 * Hkv * n_vis * row_b + 2 * B * H * D * 2
                      + B * pmax * 4 + B * 4)
            bms, by = bound(nbytes, 4 * H * n_vis * D, peaks["bf16_s"],
                            peaks)
            branch = "band" if window else "softcap"
            rows.append(dict(fmt=fmt, branch=branch, err=err, ok=ok, ms=ms,
                             plain_ms=pms, library_ms=lms, bound_ms=bms,
                             bound_by=by))
            print(f"gemma k11 {branch} {fmt} B={B} H={H} Hkv={Hkv} D={D} "
                  f"page={PAGE} window={window} softcap={cap} lengths="
                  f"{tuple(lengths.tolist())} max_abs_err={err:.3e} "
                  f"max d/tol={float((d / tol).max()):.3g} ok={ok} "
                  f"ms={ms:.4f} plain_ms={pms:.4f} library_ms={lms:.4f} "
                  f"(SDPA with the band mask and no softcap: SDPA has none) "
                  f"bound_ms={bms:.4f} ({by})", flush=True)
        del gk
        if fmt == "bf16":
            gemma_faults(torch, paged_attn_gemma, paged_attn_plain, q,
                         pools[0], bt, lengths, W, cap, randn)
        del pools
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"K11's gemma branches disagree with their plain version: {bad}")
    return rows


def gemma_faults(torch, kernel, plain, q, pool, bt, lengths, W, cap,
                 randn) -> None:
    """The planted faults of K11's gemma branches, each a faulty reference
    the check must flag against the kernel (elements outside ``kv_tol``).
    The band's first excluded key of each slot past the window is planted
    with q's direction, so the off-by-one and the dropped softcap move the
    output; "softcap after the mask" runs on a pool whose keys all score
    near -2 cap, where the masked keys' -cap counts."""
    kp, _s, vp = pool[0].clone(), None, pool[2]
    B, H, D = q.shape
    Hkv = kp.shape[1]
    page = kp.shape[2]
    for b, n in enumerate(lengths.tolist()):
        t = n - 1 - W                       # the first key outside the band
        if t < 0:
            continue
        qd = q[b].float().reshape(Hkv, H // Hkv, D).sum(dim=1)
        qd = qd / qd.norm(dim=-1, keepdim=True) * 40.0
        kp[int(bt[b, t // page]), :, t % page] = qd.to(kp.dtype)
    base = (kp, None, vp, None, bt, lengths)
    band = kernel(q, *base, window=W, softcap=cap)
    glob = kernel(q, *base, window=None, softcap=cap)
    # all keys u (+ noise), q = -6.25 u: scores ~ -100, softcapped ~ -48.2,
    # beside the masked keys' -50
    u = randn(D, dtype=torch.float32)
    ku = (u + 0.01 * randn(*kp.shape, dtype=torch.float32)).to(kp.dtype)
    qu = (-6.25 * u).expand(B, H, D).to(torch.bfloat16).contiguous()
    under = kernel(qu, ku, None, vp, None, bt, lengths, window=W,
                   softcap=cap)
    cut = k11_split_emulated(torch, q[:, :, None], *base, window=W,
                             softcap=cap, fault="drop_last_part")[:, :, 0]
    faults = {
        "the fold drops each slot's last part": (band, cut),
        "band off by one (q - k <= window)": (
            band, plain(q, *base, window=W + 1, softcap=cap)),
        "softcap applied after the mask": (
            under, gemma_after_mask(torch, qu, ku, vp, bt, lengths, W, cap)),
        "softcap dropped": (band, plain(q, *base, window=W, softcap=None)),
        "band applied to a global layer": (
            glob, plain(q, *base, window=W, softcap=cap)),
    }
    missed = []
    for name, (got, faulty) in faults.items():
        torch.cuda.synchronize()
        caught = int(((got.float() - faulty.float()).abs()
                      > kv_tol(faulty)).sum())
        print(f"gemma k11 planted fault '{name}': {caught}/{got.numel()} "
              "outputs outside the tolerance", flush=True)
        if not caught:
            missed.append(name)
    if missed:
        fail(f"K11's gemma check missed planted faults: {missed}")


def phase_k11_profile(torch, part_keys=None) -> dict:
    """K11's two launches under torch.profiler at the main paths' shapes,
    operands rotated through >200 MB of copies as in ``timed_ms``: the
    llama2-7b 8-slot step over the int8 pool (``SLOT_POS``), its 9-row
    verify window (``SPEC_POS``), and gemma2-9b's band and softcap steps
    over its int8 pool (``GEMMA_POS``). Prints the device time a call of
    the scores launch and of the PV-and-fold launch, and the event time a
    call (``timed_ms``; host-paced where it exceeds their sum), at the
    plan's part size, or at each of ``part_keys`` (``PART_KEYS`` set for
    the measurement, then restored). Returns {(case, part keys): (scores
    ms, pv ms, event ms)}."""
    from neural_compressor_tpu_torch import kernels as K
    from neural_compressor_tpu_torch.kernels import paged_attention as pa
    from neural_compressor_tpu_torch.ops import kv_quant as kq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(47)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def table(B, pmax, seed):
        n_pages = B * pmax + 1
        bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                             .manual_seed(seed)) + 1).reshape(B, pmax)
        return n_pages, bt.to(torch.int32).to(dev)

    cases = {}
    n_pages, bt = table(SLOTS, MAX_LEN // PAGE, 12)
    lengths = torch.tensor(SLOT_POS, dtype=torch.int32, device=dev) + 1
    row_b = 2 * n_pages * HEADS * PAGE * (HEAD_DIM + 4)
    pools = [spec_pool(torch, kq, randn, n_pages, HEADS, PAGE, HEAD_DIM,
                       "int8") for _ in range(n_copies(row_b))]
    q = randn(SLOTS, HEADS, HEAD_DIM)
    cases["single query, llama2-7b int8"] = [
        lambda p=p: K.paged_attn(q, *p[:4], bt, lengths) for p in pools]
    qw = randn(SLOTS, HEADS, SPEC_W, HEAD_DIM)
    lw = torch.tensor(SPEC_POS, dtype=torch.int32, device=dev) + SPEC_W
    cases["window W=9, llama2-7b int8"] = [
        lambda p=p: K.paged_window_attn(qw, *p[:4], bt, lw) for p in pools]
    Hkv, D = 8, 256
    g_pages, gbt = table(SLOTS, GEMMA_MAX_LEN // PAGE, 32)
    glen = torch.tensor(GEMMA_POS, dtype=torch.int32, device=dev) + 1
    gpools = [spec_pool(torch, kq, randn, g_pages, Hkv, PAGE, D, "int8")
              for _ in range(n_copies(2 * g_pages * Hkv * PAGE * (D + 4)))]
    qg = (randn(SLOTS, 2 * Hkv, D).float() * 6).to(torch.bfloat16)
    for label, kw in (("band", dict(window=GEMMA_WINDOW,
                                    softcap=GEMMA_SOFTCAP)),
                      ("softcap", dict(softcap=GEMMA_SOFTCAP))):
        cases[f"gemma2-9b {label}, int8"] = [
            lambda p=p, kw=kw: K.paged_attn_gemma(qg, *p[:4], gbt, glen,
                                                  **kw) for p in gpools]
    out = {}
    default = pa.PART_KEYS
    for pk, (label, fns) in ((pk, c) for pk in (part_keys or (default,))
                             for c in cases.items()):
        pa.PART_KEYS = pk
        pa.split_plan.cache_clear()
        try:
            ev_ms = timed_ms(torch, fns, 100)
            dev_ms = profiled(torch, fns)
        finally:
            pa.PART_KEYS = default
            pa.split_plan.cache_clear()
        a, b = dev_ms.get("scores_kernel", 0.0), dev_ms.get("pv_kernel", 0.0)
        print(f"k11 device time {label}, parts of {pk} keys: scores "
              f"{a:.4f} ms + pv and fold {b:.4f} ms = {a + b:.4f} ms a call; "
              f"event time {ev_ms:.4f} ms a call", flush=True)
        out[(label, pk)] = (a, b, ev_ms)
    return out


def backlog_ms(torch, fns, n: int) -> float:
    """Device ms a call with the host far ahead: a sleeping kernel holds the
    stream while ``n`` calls of ``fns`` (cycled) are enqueued, so they run
    back to back and no launch waits for the host; the device time a call
    of kernels that overlap through dependent launches."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for i in range(n):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profiled(torch, fns, n: int = 40,
             names=("scores_kernel", "pv_kernel"), counts=None) -> dict:
    """Device ms a call of the kernels ``names`` (by default K11's two)
    over ``n`` calls of ``fns`` (cycled), from torch.profiler: {name:
    ms}; ``counts``, a dict, receives the launches it saw of each."""
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    dev_ms = {}
    for e in prof.key_averages():
        for kname in names:
            if kname in e.key:
                dev_ms[kname] = (dev_ms.get(kname, 0.0)
                                 + e.self_device_time_total / 1e3 / n)
                if counts is not None:
                    counts[kname] = counts.get(kname, 0) + e.count
    return dev_ms


def phase_gemma_envelope(torch, nct) -> None:
    """The repair's shapes on the card: K5, K6 (int8, fp8) and K7 (bf16,
    int8) at rep 16 (32 query heads on 2 KV heads), K8 with float32
    activations at gemma2-9b's widths, K4 at K = 65,536 (past the old
    48 Ki), each against its plain version; and where JAX declines its
    kernel and the port's cannot take the shape, the plain path on the
    card, its calls counted: K7 at D 320 (``batched_decode_attention``
    returns None; since the head-width repair K7 takes D 96), a 2-layer
    D-320 llama's B=2 greedy (card tokens equal to the CPU's, 2 plain calls
    a step), and ``dequant_matmul`` at N 200 (``dequant_dot``)."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_matmul as dm
    from neural_compressor_tpu_torch.kernels import (
        batched_decode_attn, batched_decode_attn_plain, decode_attn,
        decode_attn_plain, decode_attn_quant, decode_attn_quant_plain,
        fused_gemv, fused_gemv_plain)
    from neural_compressor_tpu_torch.models.llama import LlamaConfig
    from neural_compressor_tpu_torch.ops import kv_quant as kq
    from neural_compressor_tpu_torch.ops import (pack_qtensor,
                                                 quantize_tensor, to_hopper)

    da = sys.modules["neural_compressor_tpu_torch.kernels.decode_attention"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    bad, n = [], 0

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(label, got, want, tol):
        nonlocal n
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        if not (bool(torch.isfinite(got.float()).all())
                and bool((d <= tol).all())):
            bad.append(f"{label} err={float(d.max()):.3e}")
        n += 1

    # rep 16: 32 query heads on 2 KV heads of 128, T 1024
    B, H, Hkv, D, T = 4, 32, 2, 128, 1024
    q = randn(1, H, D)
    k, v = randn(1, Hkv, T, D), randn(1, Hkv, T, D)
    for pos in (0, 700, T - 1):
        check(f"k5 rep 16 pos={pos}", decode_attn(q, k, v, pos),
              decode_attn_plain(q, k, v, pos), TOL["attn"])
    kn, vn = randn(1, Hkv, D), randn(1, Hkv, D)
    for fmt in ("int8", "fp8_e4m3"):
        kc, ksc = kv_rows(kq, k, fmt)
        vc, vsc = kv_rows(kq, v, fmt)
        p = torch.tensor([700], dtype=torch.int32, device=dev)
        ref = decode_attn_quant_plain(q, kn, vn, kc, ksc, vc, vsc, p)
        check(f"k6 rep 16 {fmt}", decode_attn_quant(q, kn, vn, kc, ksc, vc,
                                                    vsc, p), ref, kv_tol(ref))
    qb = randn(B, H, D)
    kb, vb = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
    pos = torch.tensor([0, 300, 700, T - 1], dtype=torch.int32, device=dev)
    check("k7 rep 16 bf16", batched_decode_attn(qb, kb, vb, pos),
          batched_decode_attn_plain(qb, kb, vb, pos), TOL["batched"])
    kc, ksc = kv_rows(kq, kb, "int8")
    vc, vsc = kv_rows(kq, vb, "int8")
    ref = batched_decode_attn_plain(qb, kc, vc, pos, ksc, vsc)
    check("k7 rep 16 int8", batched_decode_attn(qb, kc, vc, pos, ksc, vsc),
          ref, kv_tol(ref))
    # K8 with float32 activations at gemma2-9b's widths (q and down)
    for K, N in ((3584, 4096), (14336, 3584)):
        pw = woq_weight(torch, gen, K, N)
        for M in (8, 100, 256):
            x = torch.randn((M, K), generator=gen, device=dev)
            kw = dict(bits=4, group_size=G, layout="tpu_strided",
                      out_dtype=torch.float32)
            before = kernels.dequant_gemm.launches
            yk = dm.dequant_gemm(x, *woq_operands(pw), None, **kw)
            yp = dm.dequant_gemm_plain(x, *woq_operands(pw), None, **kw)
            if kernels.dequant_gemm.launches != before + 1:
                bad.append("k8 f32 did not launch")
            check(f"k8 f32 x M={M} K={K} N={N}", yk, yp,
                  woq_tol(torch, x, pw, yp, k9=False))
    # K4 past the old 48 Ki: K = 65,536, its codes in dynamic shared memory
    K, N = 64 * 1024, 512
    w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
    pw = to_hopper(pack_qtensor(quantize_tensor(w, bits=4, group_size=G)))
    x = randn(K)
    args = (x, None, pw.packed, pw.scales, None, None)
    kw = dict(eps=1e-6, silu=False, out_dtype=torch.bfloat16)
    ref = fused_gemv_plain(*args, **kw)
    check("k4 K=65536", fused_gemv(*args, **kw), ref,
          TOL["gemv"] * float(ref.float().abs().max()))
    # the plain paths where JAX's dispatch declines and K7 takes no such
    # head width (D % 128 and outside BATCHED_KERNEL_D): K7 at D 320
    q320 = randn(4, 8, 1, 320)
    kv320 = randn(4, 4, 128, 320)
    before = da.batched_decode_attention.plain_calls
    if da.batched_decode_attention(q320, kv320, kv320, pos) is not None or \
            da.batched_decode_attention.plain_calls != before + 1:
        bad.append("K7 at D 320 did not decline to the plain path")
    n += 1
    # a 2-layer llama with D 320: B=2 greedy on the card (plain attention,
    # counted) against the CPU
    cfg = LlamaConfig(vocab_size=512, hidden_size=1280, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=4, max_position_embeddings=128)
    m_cpu = nct.LlamaForCausalLM(cfg, device="cpu", seed=3)
    m_gpu = copy.deepcopy(m_cpu).to("cuda")
    ids = torch.randint(0, 512, (2, 12), generator=torch.Generator()
                        .manual_seed(4))
    kernels.reset_launch_counts()
    before = da.batched_decode_attention.plain_calls
    got = nct.greedy_search(m_gpu, ids, max_new_tokens=6).cpu()
    calls = da.batched_decode_attention.plain_calls - before
    want = nct.greedy_search(m_cpu, ids, max_new_tokens=6)
    launched = launch_counts()
    if not (torch.equal(got, want) and calls == 2 * 5
            and launched == expect()):
        bad.append(f"D-320 llama B=2: card {got.tolist()} cpu "
                   f"{want.tolist()}, {calls} plain calls, {launched}")
    n += 1
    # dequant_matmul where the weight does not tile (N % 128): dequant_dot
    pw = woq_weight(torch, gen, 512, 200, G=64)
    x = randn(8, 512)
    before = dm.dequant_dot.calls
    y = dm.dequant_matmul(x, pw)
    if dm.dequant_dot.calls != before + 1:
        bad.append("dequant_matmul at N 200 did not take dequant_dot")
    check("dequant_dot N=200", y, dm.dequant_matmul(
        x.cpu(), pw._replace(packed=pw.packed.cpu(), scales=pw.scales.cpu(),
                             zeros=pw.zeros.cpu())).to(dev),
          woq_tol(torch, x, pw, y, k9=False))
    print(f"gemma envelope: {n} cases (K5/K6/K7 at rep 16, K8 with f32 x, "
          f"K4 at K 65536, plain paths where JAX declines), card vs plain: "
          f"{'all within tolerance' if not bad else bad}", flush=True)
    if bad:
        fail(f"the repaired envelope: {bad}")


def gemma_launches(fmt, L: int, n_sliding: int, softcap: bool,
                   steps: int) -> dict:
    """The kernels of ``steps`` paged decode steps of an L-layer gemma with
    ``n_sliding`` sliding layers, by kernels-line entry: K12 writes every
    layer's row, K11 attends (the band on sliding layers, the softcap alone
    on global ones, plain K11 on a global layer without a softcap)."""
    write = {"bf16": "paged_write", "int8": "paged_write",
             "fp8_e4m3": "paged_write_fp8", "int4": "paged_write_int4"}[fmt]
    attn = {"bf16": "paged_attn", "int8": "paged_attn",
            "fp8_e4m3": "paged_attn_fp8", "int4": "paged_attn_int4"}[fmt]
    out = {write: L * steps, "paged_attn_gemma_band": n_sliding * steps}
    if softcap:
        out["paged_attn_gemma_softcap"] = (L - n_sliding) * steps
    else:
        out[attn] = (L - n_sliding) * steps
    return out


def phase_gemma_model_check(torch, nct) -> None:
    """Full-width 2-layer gemma2-9b and gemma3-4b-text (one sliding and one
    global layer each, the window cut to 64 so a 100-token prompt binds
    it), RTN asym-int4 g128 W4A16, on the card (kernels) against the same
    weights on the CPU (plain versions): greedy at B=1 over contiguous
    caches in each KV format (``two_layer_check``: K8 prefill, K9 decode,
    attention in plain PyTorch as JAX runs it in XLA), and the engine in
    each pool mode, contiguous bf16/int8/fp8/int4 and paged
    bf16/int8/fp8/int4 (K11's gemma branches and K12 over the pools).
    Tokens equal, but where the CPU's top-2 gap is at most the measured
    card-CPU difference (``card_cpu_tie``)."""
    from neural_compressor_tpu_torch import kernels

    torch.set_num_threads(8)
    for preset, seed in GEMMA_CHECK_PRESETS:
        t0 = time.perf_counter()
        cfg = gemma_cfg(nct, preset, num_hidden_layers=2,
                        sliding_window=GEMMA_CHECK_WINDOW,
                        layer_types=("sliding_attention", "full_attention"))
        m_gpu = gemma_model(nct, cfg, seed=seed, device="cuda", kv="int8")
        if not (m_gpu.kv_cache_quantized and m_gpu.kv_cache_format == "int8"):
            fail("RTNConfig + KVCacheQuantConfig did not flag the gemma's "
                 "int8 cache")
        set_kv_format(m_gpu, None)
        m_cpu = copy.deepcopy(m_gpu).to("cpu")
        ids = torch.randint(0, cfg.vocab_size, (1, GEMMA_CHECK_PROMPT),
                            generator=torch.Generator().manual_seed(seed))
        n_proj = 7 * cfg.num_hidden_layers
        held = {}  # the CPU's unpacked weights, shared by every check below
        two_layer_check(
            torch, f"gemma check {preset}", m_cpu, m_gpu, ids, woq=True,
            max_len=GEMMA_CHECK_PROMPT + 16, tie_any=True,
            want_fn=lambda fmt: expect(dequant_gemm=n_proj,
                                       vpu_gemv=8 * n_proj), held=held)
        set_woq_impl(m_cpu, "pallas")
        gen = torch.Generator().manual_seed(seed + 1)
        prompts = [torch.randint(0, cfg.vocab_size, (P,), generator=gen)
                   .numpy() for P in (70, 90, 20)]
        new = (3, 2, 3)
        kw = dict(n_slots=4, max_len=128, prefill_chunk=32, page_size=32)
        softcap = cfg.attn_logit_softcapping is not None
        for mode, (mkw, fmt) in ENGINE_MODES.items():
            t1 = time.perf_counter()
            kernels.reset_launch_counts()
            eng, got, _s = serve_engine(torch, nct, m_gpu, mode, prompts,
                                        new, chunk=2, **kw)
            launched = launch_counts()
            with unpack_once(held):
                _e, want, _s = serve_engine(torch, nct, m_cpu, mode, prompts,
                                            new, chunk=2, **kw)
            toks = [r.generated for r in got]
            ties = []
            for p, a, b in zip(prompts, toks, [r.generated for r in want]):
                i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         None)
                if i is not None:
                    gap, diff = card_cpu_tie(torch, m_cpu, m_gpu, fmt,
                                             list(p) + b[:i], b[i], a[i])
                    ties.append(dict(step=i, card=a[i], cpu=b[i], gap=gap,
                                     diff=diff))
                    if gap > diff:
                        fail(f"gemma engine {preset} {mode}: card {a} cpu "
                             f"{b}, the CPU's top-2 gap {gap} exceeds the "
                             f"card-CPU difference {diff}")
            steps = 2 * eng.metrics()["decode_dispatches"]
            path = (gemma_launches(fmt or "bf16", 2, 1, softcap, steps)
                    if mkw.get("paged") else {})
            ok = all(launched[k] == v for k, v in path.items()) and \
                launched["dequant_gemm"] > 0
            print(f"gemma engine check {preset} {mode} (2 layers, full "
                  f"width): card tokens {toks} cpu tokens "
                  f"{[r.generated for r in want]} near-ties {ties} launches "
                  f"{ {k: v for k, v in launched.items() if v} } "
                  f"({time.perf_counter() - t1:.1f} s)", flush=True)
            if not ok:
                fail(f"gemma engine {preset} {mode}: the path's kernels did "
                     f"not run as expected ({path})")
        print(f"gemma check {preset} done in {time.perf_counter() - t0:.1f} "
              "s", flush=True)
        held.clear()
        del m_cpu, m_gpu
        gc.collect()
        torch.cuda.empty_cache()


def gemma_paged_gap(torch, model, fmt, prefix, tok_a: int,
                    tok_b: int) -> tuple:
    """At a step where greedy over contiguous caches chose ``tok_a`` and
    the paged engine ``tok_b`` after ``prefix``: greedy's top-2 gap there
    and the measured logit difference between the two paths on that step.
    The prefix less its last token is prefilled once into a contiguous
    bf16 cache and copied into a pool of ``fmt`` (quantized as the
    engine's staging copy quantizes it); the last token is decoded over
    each, every projection on K8 as in the engine's and the batched
    greedy's decode. Returns (gap, diff)."""
    from neural_compressor_tpu_torch.models.llama import (init_kv_cache,
                                                          init_paged_pool)
    from neural_compressor_tpu_torch.ops import kv_quant as kq

    P, dev = len(prefix), model.device
    ids = torch.tensor([prefix], device=dev)
    tok = ids[:, -1:]
    pos = torch.full((1, 1), P - 1, device=dev)
    n = -(-P // PAGE)
    set_woq_impl(model, "pallas")
    try:
        with torch.no_grad():
            caches = init_kv_cache(model.cfg, 1, n * PAGE, device=dev)
            model(ids[:, :-1], None, caches, 0)
            pools = init_paged_pool(model.cfg, n + 1, 1, n * PAGE,
                                    page_size=PAGE, quantized=fmt or False,
                                    device=dev)
            bt = torch.arange(1, n + 1, dtype=torch.int32,
                              device=dev)[None]
            pools = [p._replace(block_tables=bt) for p in pools]
            for pool, c in zip(pools, caches):
                for rows, pages, scales in ((c.k, pool.k_pages,
                                             pool.k_scales),
                                            (c.v, pool.v_pages,
                                             pool.v_scales)):
                    r = rows[0, :, :P - 1].reshape(
                        model.cfg.num_key_value_heads, -1,
                        model.cfg.head_dim)
                    for j in range(n):
                        blk = r[:, j * PAGE:(j + 1) * PAGE]
                        m = blk.shape[1]
                        if fmt:
                            codes, sc = kq.kv_quant(blk, fmt)
                            pages[1 + j, :, :m] = codes
                            scales[1 + j, :, :m] = sc
                        else:
                            pages[1 + j, :, :m] = blk
            a, _ = model(tok, pos, caches, P - 1)
            b, _ = model(tok, pos, pools, pos[:, 0].to(torch.int32))
    finally:
        set_woq_impl(model, "auto")
    a, b = a[0, -1].float(), b[0, -1].float()
    return float(a[tok_a] - a[tok_b]), float((a - b).abs().max())


def phase_gemma_serve(torch, nct) -> dict:
    """The slice's path at full width: gemma2-9b cut to ``GEMMA_LAYERS`` =
    6 of its 42 layers (3 sliding), RTN asym-int4 g128 W4A16, random
    weights from a seed made on
    the card. Three B=1 greedy requests over contiguous bf16 caches
    (prompts of 16, 371 and 4,500 tokens, the last through the chunked
    prefill, 48 new each; K8 prefills the 16-token prompt, the others take
    dequantize-then-matmul, K9 decodes); then ``ContinuousBatchingEngine(
    n_slots=8, max_len=8192, paged=True)`` over bf16 and int8 pools, 8
    requests (prompts of 16, 100, 371 and 4,200 tokens, 2 each, the last
    past the window; 8 new), ``run(chunk=8)``, its tokens held against
    ``greedy_search`` on the same model, the 2 prompts of a length at once
    (equal, or parted where greedy's top-2 gap is at most the paths'
    measured difference, ``gemma_paged_gap``), exact launch counts of
    K11's band and softcap branches, K12, K8 and K9, tok/s, cache bytes,
    peak memory, one decode dispatch over the int8 pool profiled. Returns
    {path: launches}."""
    import numpy as np

    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_dot
    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    t0 = time.perf_counter()
    full = gemma_cfg(nct, GEMMA_PRESET)
    cfg = gemma_cfg(nct, GEMMA_PRESET, num_hidden_layers=GEMMA_LAYERS,
                    layer_types=full.layer_types[:GEMMA_LAYERS])
    model = gemma_model(nct, cfg, seed=0, kv="int8")
    set_kv_format(model, None)
    nl, V = cfg.num_hidden_layers, cfg.vocab_size
    n_sl = sum(t == "sliding_attention" for t in cfg.layer_types)
    n_proj = 7 * nl
    torch.cuda.synchronize()
    print(f"{GEMMA_PRESET} W4A16 (asym int4 g{G}, {nl} layers, {n_sl} "
          f"sliding, window {cfg.sliding_window}) built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    out = {}
    gen = torch.Generator().manual_seed(41)
    prompts = [torch.randint(0, V, (1, P), generator=gen)
               for P in GEMMA_PROMPTS]
    nct.greedy_search(model, prompts[0], max_new_tokens=2)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    dequant_dot.calls = 0
    outs, req_s = [], []
    for ids in prompts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(nct.greedy_search(model, ids, max_new_tokens=GEMMA_NEW))
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t)
    launches = launch_counts()
    dots = dequant_dot.calls
    steps = GEMMA_NEW - 1
    short = sum(P <= 256 for P in GEMMA_PROMPTS)
    want = expect(dequant_gemm=short * n_proj,
                  vpu_gemv=len(GEMMA_PROMPTS) * steps * n_proj)
    want_dots = (len(GEMMA_PROMPTS) - short) * n_proj
    print(f"gemma B=1 kernels {json.dumps(launches)} expected "
          f"{json.dumps(want)}; dequantize-then-matmul calls {dots} "
          f"(expected {want_dots}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for ids, o, s_ in zip(prompts, outs, req_s):
        P = ids.shape[1]
        if (tuple(o.shape) != (1, P + GEMMA_NEW)
                or not torch.equal(o[:, :P].cpu(), ids.to(torch.int32))
                or int(o.min()) < 0 or int(o.max()) >= V):
            fail(f"bad gemma greedy output for prompt {P}: {o}")
        print(f"gemma request prompt={P} new={GEMMA_NEW}: {s_ * 1e3:.1f} ms "
              f"({GEMMA_NEW / s_:.2f} tok/s with the prefill; first new "
              f"tokens {o[0, P:P + 8].tolist()})", flush=True)
    if launches != want or dots != want_dots:
        fail(f"gemma B=1 launch counts {launches} != {want} or dequantize-"
             f"then-matmul calls {dots} != {want_dots}")
    out["gemma_greedy_b1"] = launches
    tok = outs[0][:, -1:].to(model.device)
    at = torch.full((1, 1), 16, device=model.device)
    with torch.no_grad():
        profile_window(torch, "gemma B=1 decode step", lambda: model(
            tok, at, init_kv_cache(cfg, 1, 64, device=model.device), 16))

    # the engine over paged pools, its tokens against greedy's
    gen = torch.Generator().manual_seed(42)
    e_prompts = [torch.randint(0, V, (GEMMA_ENGINE_PROMPTS[i % 4],),
                               generator=gen).numpy()
                 for i in range(GEMMA_ENGINE_REQUESTS)]
    # the references: greedy_search over each prompt length's 2 prompts
    # at once (B=2: K8 decodes, as in the engine)
    refs = [None] * GEMMA_ENGINE_REQUESTS
    for P in GEMMA_ENGINE_PROMPTS:
        idx = [i for i, p in enumerate(e_prompts) if len(p) == P]
        o = nct.greedy_search(model, torch.from_numpy(
            np.stack([e_prompts[i] for i in idx])),
            max_new_tokens=GEMMA_ENGINE_NEW)
        for i, row in zip(idx, o[:, P:].tolist()):
            refs[i] = row
    news = [GEMMA_ENGINE_NEW] * GEMMA_ENGINE_REQUESTS
    for mode in ("paged_bf16", "paged_int8"):
        fmt = ENGINE_MODES[mode][1]
        eng = engine_for(nct, model, mode, n_slots=SLOTS,
                         max_len=GEMMA_MAX_LEN, page_size=PAGE)
        chunk_rows = []
        prefill_forward = eng._prefill_forward

        def observed(target, ids, *args, _f=prefill_forward):
            chunk_rows.append(int(ids.shape[0]))
            return _f(target, ids, *args)

        eng._prefill_forward = observed
        reqs = [eng.submit(p, max_new_tokens=m)
                for p, m in zip(e_prompts, news)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        dequant_dot.calls = 0
        t = time.perf_counter()
        done = eng.run(chunk=CHUNK)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = launch_counts()
        dots = dequant_dot.calls
        if sorted(r.uid for r in done) != sorted(r.uid for r in reqs):
            fail(f"gemma engine {mode} finished {len(done)} of {len(reqs)}")
        m = eng.metrics()
        steps = CHUNK * m["decode_dispatches"]
        C = eng.prefill_chunk
        k8_chunks = sum(r * C <= 256 for r in chunk_rows)
        want = expect(dequant_gemm=n_proj * (steps + k8_chunks),
                      **gemma_launches(fmt or "bf16", nl, n_sl, True, steps))
        want_dots = n_proj * (len(chunk_rows) - k8_chunks)
        counters = {k: m[k] for k in (
            "requests", "prompt_tokens", "generated_tokens",
            "prefill_chunk_dispatches", "decode_dispatches",
            "combined_dispatches", "preemptions")}
        print(f"gemma engine {mode} ({eng.n_pages} pages of {PAGE} rows, "
              f"{m['kv_cache_format']}, {m['kv_cache_bytes'] / 2**30:.3f} "
              f"GiB of cache): {len(reqs)} requests in {seconds:.3f} s, "
              f"generated {m['generated_tok_s']:.2f} tok/s (metrics wall "
              f"{m['wall_s']:.3f} s), {json.dumps(counters)}, prefill chunk "
              f"rows {chunk_rows} (chunk {C}), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        print(f"gemma engine {mode} kernels {json.dumps(launches)} expected "
              f"{json.dumps(want)}; dequantize-then-matmul calls {dots} "
              f"(expected {want_dots})", flush=True)
        if launches != want or dots != want_dots:
            fail(f"gemma engine {mode}: launch counts {launches} != {want} "
                 f"or dequantize-then-matmul calls {dots} != {want_dots}")
        parted = []
        for p, r, ref in zip(e_prompts, reqs, refs):
            got = r.generated
            if len(got) != GEMMA_ENGINE_NEW or not all(
                    math.isfinite(x) for x in r.logprobs):
                fail(f"gemma engine {mode}: bad output {got}")
            i = next((i for i, (a, b) in enumerate(zip(ref, got))
                      if a != b), None)
            if i is None:
                continue
            gap, diff = gemma_paged_gap(torch, model, fmt,
                                        list(p) + ref[:i], ref[i], got[i])
            parted.append(dict(prompt=len(p), step=i, greedy=ref[i],
                               engine=got[i], gap=gap, diff=diff))
            if gap > diff:
                fail(f"gemma engine {mode}: parts from greedy at new token "
                     f"{i} of a {len(p)}-token prompt where greedy's top-2 "
                     f"gap {gap} exceeds the paths' difference {diff}")
        print(f"gemma engine {mode}: {GEMMA_ENGINE_REQUESTS - len(parted)} "
              f"of {GEMMA_ENGINE_REQUESTS} requests equal to greedy_search; "
              f"partings "
              f"{parted}", flush=True)
        out[f"gemma_engine_{mode}"] = launches
        # the observed prefill holds the engine in a cycle: free its pools
        # before the next mode's peak is read
        del eng, observed, prefill_forward
        gc.collect()
        torch.cuda.empty_cache()
    # where the time goes: one decode dispatch over the int8 pool, the 8
    # slots at the first 8 requests' prompt lengths
    eng = engine_for(nct, model, "paged_int8", n_slots=SLOTS,
                     max_len=GEMMA_MAX_LEN, page_size=PAGE)
    for p in e_prompts[:SLOTS]:
        eng.submit(p, max_new_tokens=64)
    while eng.queue or "prefill" in eng.slot_state:
        eng.run(max_steps=1, chunk=1)
    profile_window(torch, f"gemma engine paged_int8 decode dispatch, 8 "
                   f"slots x {CHUNK} steps", lambda: eng.step_many(CHUNK))
    del eng        # not run dry: the profile was all it was for
    del model
    return out


DS_PRESET = "deepseek-v3"
# the 8 slots of the K14 check: lengths (the new row included) over a
# 4096-row table of 128-row pages
DS_LENGTHS = (1, 127, 128, 129, 1000, 2048, 3000, 4096)
DS_MAX_LEN = 4096


# K14's attention kernels (csrc/paged_latent.cuh), as torch.profiler names
# them: the scores launch, PV, the fold
LATENT_KERNELS = ("nctt_lat::scores_kernel", "nctt_lat::pv_kernel",
                  "nctt_lat::fold_kernel")
# the H100 SXM's dense float64 tensor-core rate (data sheet): K14's floor
# for the float64 sums its tolerance rests on
FP64_TENSOR_S = 67e12


def lat_tol(ref):
    """Elementwise tolerance of K14's attention against its plain version:
    1e-5 of each slot's largest |output|. Both sum in float64 over exact
    products and round once, so they differ only where a float64 sum's
    order tips a float32 rounding."""
    return 1e-5 * ref.float().abs().amax(dim=(1, 2), keepdim=True) + 1e-30


def ds_table(torch, B, pmax, seed, dev):
    """[B, pmax] int32 block tables over B * pmax + 1 pages, scattered
    (page 0 is the trash page)."""
    bt = torch.randperm(B * pmax, generator=torch.Generator()
                        .manual_seed(seed)) + 1
    return bt.reshape(B, pmax).to(torch.int32).to(dev)


def latent_sdpa(torch, q, pages, bt, lengths, r, scale):
    """The yardstick: ``scaled_dot_product_attention`` with q [B, H, 1, C]
    against the gathered rows [B, 1, Lmax, C] expanded over H as keys, their
    first r columns as values, a length mask and ``scale``; returns a
    closure over the gathered operands (gathered once, outside the timing).
    """
    B, H, C = q.shape
    Lmax = int(lengths.max())
    page = pages.shape[2]
    g = pages[bt.long()].transpose(1, 2).reshape(B, 1, -1, C)[:, :, :Lmax]
    k = g.expand(B, H, Lmax, C)
    v = g[..., :r].expand(B, H, Lmax, r)
    mask = (torch.arange(Lmax, device=q.device)[None, :]
            < lengths.long()[:, None])[:, None, None]
    q4 = q[:, :, None]
    del page
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask, scale=scale)


def phase_deepseek_kernels(torch, nct, peaks: dict) -> dict:
    """K14 at deepseek-v3's shapes: 8 slots at ``DS_LENGTHS`` over a
    4096-row table of 128-row pages, H 128, C = r + dr = 576, r 512,
    ``attn_scale`` = 192^-1/2. The write (one row a slot, bit for bit
    against its plain version over the whole pool) and the attention
    (within ``lat_tol``), each timed with L2 cold beside its plain version,
    a yardstick (an index assignment; SDPA over the gathered rows) and its
    bound; the attention's device time a call back to back and its three
    launches by torch.profiler, beside the float64 tensor-core floor of its
    sums. Planted faults, each of which
    the check must flag: the value product over the wrong r columns (the
    rope part in the value), the scale taken from C, lengths that leave out
    the current row, a lost part-boundary row (the kernel at length L - 1
    against the plain version at L, row L - 1 a part's last), a write one
    row late, a write into another slot's page."""
    from neural_compressor_tpu_torch.kernels import paged_attention as pa
    from neural_compressor_tpu_torch.models.deepseek import DEEPSEEK_PRESETS
    from neural_compressor_tpu_torch.models.deepseek import DeepseekConfig

    cfg = DeepseekConfig(**DEEPSEEK_PRESETS[DS_PRESET])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(51)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    B, H = SLOTS, cfg.num_attention_heads
    r = cfg.kv_lora_rank
    C = r + cfg.qk_rope_head_dim
    scale = cfg.attn_scale
    pmax = DS_MAX_LEN // PAGE
    n_pages = B * pmax + 1
    bt = ds_table(torch, B, pmax, 52, dev)
    lengths = torch.tensor(DS_LENGTHS, dtype=torch.int32, device=dev)
    pos = lengths - 1
    nbytes_pool = n_pages * PAGE * C * 2
    pools = [randn(n_pages, 1, PAGE, C) for _ in range(n_copies(nbytes_pool))]
    q = randn(B, H, C)
    rows = {}

    # the write: each slot's row at pos = lengths - 1
    row = randn(B, C)
    got, want = pools[0].clone(), pools[0].clone()
    pa.paged_latent_write(row, got, bt, pos)
    pa.paged_latent_write_plain(row, want, bt, pos)
    torch.cuda.synchronize()
    ok_w = torch.equal(got, want)
    copies = [p.clone() for p in pools]
    ms = timed_ms(torch, [lambda p=p: pa.paged_latent_write(row, p, bt, pos)
                          for p in copies], 200)
    pms = timed_ms(torch, [lambda: pa.paged_latent_write_plain(
        row, copies[0], bt, pos)], 20)
    pid = bt.long()[torch.arange(B, device=dev), pos.long() // PAGE]
    off = pos.long() % PAGE
    lms = timed_ms(torch, [lambda p=p: p.index_put_(
        (pid, torch.zeros_like(pid), off), row) for p in copies], 200)
    del copies
    bms, by = bound(2 * B * C * 2 + B * 8, 0, peaks["bf16_s"], peaks)
    rows["write"] = dict(err=0.0 if ok_w else float("inf"), ok=ok_w, ms=ms,
                         plain_ms=pms, library_ms=lms, bound_ms=bms,
                         bound_by=by)
    print(f"deepseek k14 write B={B} C={C} page={PAGE} pos="
          f"{tuple(pos.tolist())}: bit-equal={ok_w} ms={ms:.4f} "
          f"plain_ms={pms:.4f} library_ms={lms:.4f} (index_put_) "
          f"bound_ms={bms:.5f} ({by})", flush=True)

    # the attention
    out = pa.paged_latent_attn(q, pools[0], bt, lengths, r, scale)
    ref = pa.paged_latent_attn_plain(q, pools[0], bt, lengths, r, scale)
    torch.cuda.synchronize()
    d = (out - ref).abs()
    tol = lat_tol(ref)
    err, ok_a = float(d.max()), bool((d <= tol).all()) and bool(
        torch.isfinite(out).all())
    fns = [lambda p=p: pa.paged_latent_attn(q, p, bt, lengths, r, scale)
           for p in pools]
    ms = timed_ms(torch, fns, 20)
    dev_ms = profiled(torch, fns, names=LATENT_KERNELS)
    b2b_ms = backlog_ms(torch, fns, 50)
    pms = timed_ms(torch, [lambda: pa.paged_latent_attn_plain(
        q, pools[0], bt, lengths, r, scale)], 2)
    sd = [latent_sdpa(torch, q, p, bt, lengths, r, scale) for p in pools[:2]]
    lms = timed_ms(torch, sd, 20)
    del sd
    n_rows = int(lengths.sum())
    nbytes = n_rows * C * 2 + B * H * C * 2 + B * H * r * 4 + B * pmax * 4
    bms, by = bound(nbytes, 2 * H * n_rows * (C + r), peaks["bf16_s"], peaks)
    f64_ms = 2 * H * n_rows * (C + r) / FP64_TENSOR_S * 1e3
    plan = pa.latent_plan(B, H, C, r, PAGE, pmax)
    rows["attn"] = dict(err=err, ok=ok_a, ms=ms, plain_ms=pms,
                        library_ms=lms, bound_ms=bms, bound_by=by,
                        device_ms=b2b_ms)
    print(f"deepseek k14 attention B={B} H={H} C={C} r={r} page={PAGE} "
          f"lengths={DS_LENGTHS} max_abs_err={err:.3e} "
          f"max d/tol={float((d / tol).max()):.3g} ok={ok_a} ms={ms:.4f} "
          f"device ms a call {b2b_ms:.4f} (back to back); torch.profiler "
          f"a call: scores {dev_ms.get(LATENT_KERNELS[0], 0.0):.4f}, pv "
          f"{dev_ms.get(LATENT_KERNELS[1], 0.0):.4f}, fold "
          f"{dev_ms.get(LATENT_KERNELS[2], 0.0):.4f} (a dependent launch's "
          f"time includes its wait for the one before) (plan: "
          f"{pa.HEAD_GROUP} heads a group, parts of {plan.part_rows} rows) "
          f"plain_ms={pms:.4f} library_ms={lms:.4f} (SDPA over the gathered "
          f"rows, Ev = r) bound_ms={bms:.5f} ({by}); float64 tensor floor "
          f"{f64_ms:.4f} ms", flush=True)

    # planted faults: each faulty reference must leave outputs outside the
    # tolerance (or pools unequal)
    def rope_in_value():
        shifted = torch.cat([pools[0][..., C - r:], pools[0][..., :C - r]],
                            dim=-1).contiguous()
        qs = torch.cat([q[..., C - r:], q[..., :C - r]], dim=-1).contiguous()
        return pa.paged_latent_attn_plain(qs, shifted, bt, lengths, r, scale)

    faults = {
        "the value over the wrong r columns (the rope part in it)":
            rope_in_value(),
        "the scale from C": pa.paged_latent_attn_plain(
            q, pools[0], bt, lengths, r, C ** -0.5),
        "lengths without the current row": pa.paged_latent_attn_plain(
            q, pools[0], bt, lengths - 1, r, scale),
    }
    # a lost part-boundary row: the kernel at length L - 1 against the
    # plain version at L, the last attended row L - 1 a part's last row
    pr = plan.part_rows
    lb = torch.tensor([pr * (1 + i % 2) for i in range(B)],
                      dtype=torch.int32, device=dev)
    lost = {"a lost part-boundary row": (
        pa.paged_latent_attn(q, pools[0], bt, lb - 1, r, scale),
        pa.paged_latent_attn_plain(q, pools[0], bt, lb, r, scale))}
    missed = []
    for name, (got_f, faulty) in [*((n, (out, f)) for n, f in faults.items()),
                                  *lost.items()]:
        torch.cuda.synchronize()
        caught = int(((got_f - faulty).abs() > lat_tol(faulty)).sum())
        print(f"deepseek k14 planted fault '{name}': {caught}/{out.numel()} "
              "outputs outside the tolerance", flush=True)
        if not caught:
            missed.append(name)
    late, other = pools[0].clone(), pools[0].clone()
    pa.paged_latent_write_plain(row, late, bt, pos + 1)
    pa.paged_latent_write_plain(row, other, bt.roll(1, dims=0), pos)
    for name, faulty in (("a write one row late", late),
                         ("a write into another slot's page", other)):
        caught = not torch.equal(got, faulty)
        print(f"deepseek k14 planted fault '{name}': flagged={caught}",
              flush=True)
        if not caught:
            missed.append(name)
    if missed:
        fail(f"the K14 check missed planted faults: {missed}")
    if not (ok_w and ok_a):
        fail(f"K14 disagrees with its plain version: write {ok_w}, "
             f"attention {ok_a} (err {err})")
    return rows


def phase_deepseek_envelope(torch, nct) -> None:
    """K14 at shapes deepseek-v3's main path does not give it, and the
    repair of the other kernels' envelope, each against its plain version.
    K14: H not a multiple of 16 (deepseek-test's H 4, C 24, r 16 and
    tiny_mla's H 4, C 144, r 128), pages of 8, 16 and 64, a PMAX that is
    not a multiple of 4, zero-length slots and idle slots on the trash page
    (their duplicate writes, the last slot's row standing), lengths at page
    boundaries, and contexts of 16,384 and 32,768 rows at deepseek-v3's
    widths; K14's split at part boundaries (a part's last row, its first,
    the row after, the full table) at deepseek-v3's widths, at a C that is
    not a multiple of 8, and at an H that is not a multiple of the plan's
    head group. The repair: K5, K6 (int8, fp8), K7 (bf16, int8), K11 (bf16,
    int8, int4) and K13 (bf16, int8, int4) at D 16, 80 and 96; K7 at D 384;
    K1 at group sizes 8, 16 and 24; K4 at K 262,144 (codes in global
    memory); and a 2-layer D-80 llama's B=1 greedy on the card against the
    CPU, its tokens equal, with no plain attention calls."""
    from neural_compressor_tpu_torch import kernels as K
    from neural_compressor_tpu_torch.kernels import paged_attention as pa
    from neural_compressor_tpu_torch.models.llama import LlamaConfig
    from neural_compressor_tpu_torch.ops import kv_quant as kq
    from neural_compressor_tpu_torch.ops import (pack_qtensor,
                                                 quantize_act_per_token,
                                                 quantize_tensor, to_hopper)

    da = sys.modules["neural_compressor_tpu_torch.kernels.decode_attention"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(53)
    bad, n = [], 0

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(label, got, want, tol=None):
        nonlocal n
        torch.cuda.synchronize()
        n += 1
        if tol is None:
            ok = torch.equal(got, want)
        else:
            d = (got.float() - want.float()).abs()
            ok = bool(torch.isfinite(got.float()).all()) and bool(
                (d <= tol).all())
        if not ok:
            bad.append(label)

    # K14 at ragged H, small pages, PMAX % 4, idle and zero-length slots
    for H, C, r in ((4, 24, 16), (4, 144, 128), (20, 576, 512)):
        for page, pmax in ((8, 5), (16, 3), (64, 6)):
            B = 6
            n_pages = B * pmax + 1
            bt = ds_table(torch, B, pmax, page + H, dev)
            bt[4:] = 0                      # slots 4 and 5 idle (trash page)
            T = pmax * page
            lengths = torch.tensor([1, page, page + 1, T, T, 0],
                                   dtype=torch.int32, device=dev)
            pos = (lengths - 1).clamp(min=0)
            pos[4:] = T - 1                 # idle slots park on the trash page
            pages = randn(n_pages, 1, page, C)
            row = randn(B, C)
            got, want = pages.clone(), pages.clone()
            pa.paged_latent_write(row, got, bt, pos)
            pa.paged_latent_write_plain(row, want, bt, pos)
            check(f"k14 write H={H} C={C} page={page} pmax={pmax}", got,
                  want)
            # a page index past the table: the trash page's row pos % page
            past = torch.full((B,), T + 3, dtype=torch.int32, device=dev)
            got2, want2 = pages.clone(), pages.clone()
            pa.paged_latent_write(row, got2, bt, past)
            pa.paged_latent_write_plain(row, want2, bt, past)
            check(f"k14 write past the table page={page}", got2, want2)
            q = randn(B, H, C)
            scale = (C - r + 8) ** -0.5
            ref = pa.paged_latent_attn_plain(q, got, bt, lengths, r, scale)
            check(f"k14 attention H={H} C={C} r={r} page={page} pmax={pmax}",
                  pa.paged_latent_attn(q, got, bt, lengths, r, scale), ref,
                  lat_tol(ref))
    # long contexts at deepseek-v3's widths
    H, C, r = 128, 576, 512
    for T in (16384, 32768):
        B, pmax = 2, T // PAGE
        bt = ds_table(torch, B, pmax, T, dev)
        pages = randn(B * pmax + 1, 1, PAGE, C)
        lengths = torch.tensor([T, T // 2 + 1], dtype=torch.int32, device=dev)
        q = randn(B, H, C)
        ref = pa.paged_latent_attn_plain(q, pages, bt, lengths, r, 192 ** -0.5)
        check(f"k14 attention T={T}", pa.paged_latent_attn(
            q, pages, bt, lengths, r, 192 ** -0.5), ref, lat_tol(ref))
        del pages, ref
    # K14's split (latent_plan): lengths on part boundaries at deepseek-v3's
    # widths (a part's last row, its first, the row after, a later part's,
    # the full table; a zero-length slot), a C that is not a multiple of 8
    # (scalar staging), and H not a multiple of the head group
    for H, C, r, page in ((128, 576, 512, PAGE), (128, 576, 512, 16),
                          (32, 150, 128, 64), (100, 576, 512, PAGE)):
        B = 8
        pr = pa.latent_plan(1, 1, 8, 8, page, 1).part_rows
        pmax = -(-(3 * pr + 40) // page)
        T = pmax * page
        bt = ds_table(torch, B, pmax, H + page, dev)
        pages = randn(B * pmax + 1, 1, page, C)
        lengths = torch.tensor([pr, pr + 1, pr + 2, 2 * pr, 2 * pr + 1, T,
                                0, 1], dtype=torch.int32, device=dev)
        q = randn(B, H, C)
        ref = pa.paged_latent_attn_plain(q, pages, bt, lengths, r, 0.125)
        check(f"k14 attention part boundaries H={H} C={C} r={r} page={page} "
              f"(groups of {pa.HEAD_GROUP}, parts of {pr})",
              pa.paged_latent_attn(q, pages, bt, lengths, r, 0.125), ref,
              lat_tol(ref))
        if H == 100 and H % pa.HEAD_GROUP == 0:
            bad.append(f"k14: H={H} is a multiple of its head group "
                       f"{pa.HEAD_GROUP}")
        del pages, ref

    # the repair: any head width (K5, K6, K7, K11, K13)
    for D in (16, 80, 96):
        Hkv, rep, T = 2, 4, 300
        H = Hkv * rep
        q = randn(1, H, D)
        k, v = randn(1, Hkv, T, D), randn(1, Hkv, T, D)
        for p_ in (0, 150, T - 1):
            check(f"k5 D={D} pos={p_}", K.decode_attn(q, k, v, p_),
                  K.decode_attn_plain(q, k, v, p_))
        kn, vn = randn(1, Hkv, D), randn(1, Hkv, D)
        for fmt in ("int8", "fp8_e4m3"):
            kc, ks = kq.kv_quant(k, fmt)
            vc, vs = kq.kv_quant(v, fmt)
            p_ = torch.tensor([150], dtype=torch.int32, device=dev)
            check(f"k6 {fmt} D={D}",
                  K.decode_attn_quant(q, kn, vn, kc, ks, vc, vs, p_),
                  K.decode_attn_quant_plain(q, kn, vn, kc, ks, vc, vs, p_))
        qb = randn(4, H, D)
        kb, vb = randn(4, Hkv, T, D), randn(4, Hkv, T, D)
        pb = torch.tensor([0, 100, 257, T - 1], dtype=torch.int32,
                          device=dev)
        check(f"k7 bf16 D={D}", K.batched_decode_attn(qb, kb, vb, pb),
              K.batched_decode_attn_plain(qb, kb, vb, pb))
        kc, ks = kq.kv_quant(kb, "int8")
        vc, vs = kq.kv_quant(vb, "int8")
        check(f"k7 int8 D={D}", K.batched_decode_attn(qb, kc, vc, pb, ks, vs),
              K.batched_decode_attn_plain(qb, kc, vc, pb, ks, vs))
        pmax, page = 4, 32
        bt = ds_table(torch, 4, pmax, D, dev)
        lengths = torch.tensor([1, 32, 33, 128], dtype=torch.int32,
                               device=dev)
        for fmt in ("bf16", "int8", "int4"):
            pool = spec_pool(torch, kq, randn, 4 * pmax + 1, Hkv, page, D,
                             fmt)
            a = (pool[0], pool[1], pool[2], pool[3], bt)
            ofs = (pool[4], pool[5])
            check(f"k11 {fmt} D={D}", K.paged_attn(qb, *a, lengths, *ofs),
                  K.paged_attn_plain(qb, *a, lengths, *ofs))
            kw_, vw_ = randn(4, Hkv, 3, D), randn(4, Hkv, 3, D)
            got = [t.clone() if t is not None else None for t in pool]
            want = [t.clone() if t is not None else None for t in pool]
            wpos = (lengths - 2).clamp(min=0)
            K.paged_write_window_kernel(kw_, vw_, got[0], got[1], got[2],
                                        got[3], bt, wpos, got[4], got[5])
            K.paged_write_window_plain(kw_, vw_, want[0], want[1], want[2],
                                       want[3], bt, wpos, want[4], want[5])
            torch.cuda.synchronize()
            n += 1
            if not pool_bytes_equal(torch, got, want):
                bad.append(f"k13 {fmt} D={D}")
    # K7 at D 384 (JAX's dispatch runs D % 128 == 0)
    qb, kb, vb = randn(4, 8, 384), randn(4, 2, 256, 384), randn(4, 2, 256, 384)
    pb = torch.tensor([0, 100, 200, 255], dtype=torch.int32, device=dev)
    check("k7 bf16 D=384", K.batched_decode_attn(qb, kb, vb, pb),
          K.batched_decode_attn_plain(qb, kb, vb, pb))
    # K1 at group sizes 8, 16 and 24 (JAX's tpu_strided K1 runs them)
    for Gs in (8, 16, 24):
        Kd, N = 48 * Gs, 256
        w = torch.randn((Kd, N), generator=gen, device=dev) * Kd ** -0.5
        pw = to_hopper(pack_qtensor(quantize_tensor(w, bits=4,
                                                    group_size=Gs)))
        for M in (1, 17, 130):
            xq, xs = quantize_act_per_token(randn(M, Kd), bits=8)
            before = K.w4a8_gemm.launches
            y = K.w4a8_gemm(xq, pw.packed, pw.scales, xs.reshape(-1))
            if K.w4a8_gemm.launches != before + 1:
                bad.append(f"k1 G={Gs} did not launch")
            ref = K.w4a8_gemm_plain(xq, pw.packed, pw.scales, xs.reshape(-1))
            check(f"k1 G={Gs} M={M}", y, ref,
                  TOL["gemm"] * ref.abs().amax() + 1e-30)
    # K4 at K 262,144: past MAX_K, the codes in global memory
    Kd, N = 256 * 1024, 256
    w = torch.randn((Kd, N), generator=gen, device=dev) * Kd ** -0.5
    pw = to_hopper(pack_qtensor(quantize_tensor(w, bits=4, group_size=G)))
    x = randn(Kd)
    rms_w = torch.rand(Kd, generator=gen, device=dev) + 0.5
    for rw in (None, rms_w):
        args = (x, rw, pw.packed, pw.scales, None, None)
        kw = dict(eps=1e-6, silu=False, out_dtype=torch.bfloat16)
        ref = K.fused_gemv_plain(*args, **kw)
        check(f"k4 K={Kd} rms={rw is not None}", K.fused_gemv(*args, **kw),
              ref, TOL["gemv"] * float(ref.float().abs().max()))
    del w, pw
    # a 2-layer llama with D 80: B=1 greedy on the card (K5 at D 80)
    cfg = LlamaConfig(vocab_size=512, hidden_size=320, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=128)
    m_cpu = nct.LlamaForCausalLM(cfg, device="cpu", seed=5)
    m_gpu = copy.deepcopy(m_cpu).to("cuda")
    ids = torch.randint(0, 512, (1, 12), generator=torch.Generator()
                        .manual_seed(6))
    K.reset_launch_counts()
    before = da.batched_decode_attention.plain_calls
    got = nct.greedy_search(m_gpu, ids, max_new_tokens=8).cpu()
    calls = da.batched_decode_attention.plain_calls - before
    launched = launch_counts()
    want = nct.greedy_search(m_cpu, ids, max_new_tokens=8)
    n += 1
    if not (torch.equal(got, want) and calls == 0
            and launched == expect(decode_attn=2 * 7)):
        bad.append(f"D-80 llama B=1: card {got.tolist()} cpu "
                   f"{want.tolist()}, {calls} plain calls, {launched}")
    print(f"deepseek envelope: {n} cases (K14 at ragged H, pages 8/16/64, "
          f"PMAX % 4, idle and zero-length slots, 16k-32k rows, part "
          f"boundaries, C % 8, H % head group; K5/K6/K7/"
          f"K11/K13 at D 16/80/96, K7 at D 384, K1 at G 8/16/24, K4 at K "
          f"262144, a D-80 llama), card vs plain: "
          f"{'all within tolerance' if not bad else bad}", flush=True)
    if bad:
        fail(f"the deepseek envelope: {bad}")


# the 2-layer check: deepseek-v3's widths, layer 0 dense and layer 1 MoE,
# 32 routed experts (4 a group: top-4 of 8 groups leaves 16 to choose 8
# from); reduced from 61 layers and 256 experts
DS_CHECK = dict(num_hidden_layers=2, first_k_dense_replace=1,
                n_routed_experts=32)
# (latent, KV format) of the 2-layer check's greedy runs
DS_CACHE_MODES = ((False, None), (True, None), (True, "int8"),
                  (True, "fp8_e4m3"), (True, "int4"))
# the served model: 2 of deepseek-v3's 61 layers, one dense layer and one
# MoE layer with all 256 routed experts and the shared one (4 in PR 8-9,
# its 3 dense layers and the MoE layer: the check's time limit)
DS_LAYERS = 2
DS_PROMPTS, DS_NEW = (16, 371, 2000), 16
DS_ENGINE_PROMPTS, DS_ENGINE_NEW = (16, 371, 1000, 3000), 16
# the deepseek engine's requests: 4, one a prompt length, for the check's
# 1,200 s (PERF.md §4)
DS_ENGINE_REQUESTS = 4


def ds_model(nct, seed, device, **cut):
    """deepseek-v3 (cut by ``cut``) RTN asym int4 g128 W4A16 (router
    float32, embedding and lm_head bf16), built module by module on
    ``device``, switched to the latent cache (``use_latent_cache`` toggles
    the caches ``init_caches`` makes; the absorbed factors stay)."""
    from neural_compressor_tpu_torch.models import deepseek

    model = deepseek.build_quantized(
        DS_PRESET, nct.RTNConfig(dtype="int4", group_size=G, use_sym=False),
        seed=seed, device=device, **cut)
    nct.enable_mla_latent_cache(model)
    return model


def ds_kernel_projections(cfg, latent: bool) -> int:
    """W4A16 projections that run on K8/K9 in one forward: q_a, q_b, o
    (and kv_b, expanded only) a layer, 3 a dense MLP, 3 an expert (routed
    and shared); kv_a_proj (N = 576, not a multiple of 128) takes
    dequantize-then-matmul, as JAX takes XLA."""
    L, dense = cfg.num_hidden_layers, cfg.first_k_dense_replace
    moe = L - dense
    return (L * (3 if latent else 4) + 3 * dense
            + 3 * moe * (cfg.n_routed_experts + cfg.n_shared_experts))


def ds_card_cpu_tie(torch, m_cpu, m_gpu, fmt, prefix, tok_cpu: int,
                    tok_card: int) -> tuple:
    """``card_cpu_tie`` over the model's own caches (``init_caches`` in
    its mode and ``fmt``): the CPU's top-2 gap and the measured card-CPU
    logit difference after ``prefix``."""
    ids = torch.tensor([list(prefix)])
    rows = []
    for m in (m_cpu, m_gpu):
        with torch.no_grad():
            lg, _ = m(ids.to(m.device), None,
                      m.init_caches(1, ids.shape[1], quantized=fmt or False),
                      0)
        rows.append(lg[0, -1].float().cpu())
    cpu, card = rows
    return float(cpu[tok_cpu] - cpu[tok_card]), float((cpu - card).abs().max())


def phase_deepseek_model_check(torch, nct) -> None:
    """deepseek-v3 at full width, cut to ``DS_CHECK`` (2 layers, 32 routed
    experts), RTN asym int4 g128 W4A16, built on the card and copied to the
    CPU: greedy at B=1 (a 32-token prefill, 8 steps) over the expanded bf16
    caches and the latent caches in bf16, int8, fp8 and int4, card
    (K8 prefill, K9 decode, attention in plain PyTorch as JAX runs it in
    XLA) against CPU (plain K8 and K9), the CPU fed the card's tokens:
    logits within 5e-2 of max|logit|, tokens equal but where the CPU's
    top-2 gap is at most the measured difference; exact launch counts.
    Then the engine on both, contiguous over latent bf16 caches and paged
    over the latent pool (K14's write and attention, their launches
    exact), tokens under the same near-tie rule."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_dot

    torch.set_num_threads(8)
    t0 = time.perf_counter()
    m_gpu = ds_model(nct, seed=21, device="cuda", **DS_CHECK)
    m_cpu = copy.deepcopy(m_gpu).to("cpu")
    cfg = m_gpu.cfg
    L = cfg.num_hidden_layers
    print(f"deepseek check model (2 layers, 32 experts, full width) built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    ids = torch.randint(0, cfg.vocab_size, (1, 32),
                        generator=torch.Generator().manual_seed(22))
    P = ids.shape[1]

    @torch.no_grad()
    def run(model, fmt, forced=None):
        dev = model.device
        caches = model.init_caches(1, P + 16, quantized=fmt or False)
        cpu = dev.type == "cpu"
        if cpu:
            set_woq_impl(model, "pallas")
        logits, caches = model(ids.to(dev), torch.arange(P, device=dev)[None],
                               caches, 0)
        if cpu:
            set_woq_impl(model, "vpu")
        rows, toks = [logits[0, -1].float().cpu()], []
        for i in range(8):
            tok = int(torch.argmax(rows[-1])) if forced is None else forced[i]
            toks.append(tok)
            logits, caches = model(torch.tensor([[tok]], device=dev),
                                   torch.full((1, 1), P + i, device=dev),
                                   caches, P + i)
            rows.append(logits[0, -1].float().cpu())
        if cpu:
            set_woq_impl(model, "auto")
        return torch.stack(rows), toks, caches

    def flipped_codes(c_gpu, c_cpu) -> int:
        """Code elements of quantized latent caches that differ between the
        card and the CPU (0 for float caches)."""
        n = 0
        for a, b in zip(c_gpu, c_cpu):
            for x, y in zip(a, b):
                if x.dtype in (torch.int8, torch.uint8, torch.float8_e4m3fn):
                    n += int((x.cpu().view(torch.uint8)
                              != y.view(torch.uint8)).sum())
        return n

    with unpack_once():
        for latent, fmt in DS_CACHE_MODES:
            t1 = time.perf_counter()
            m_gpu.use_latent_cache = m_cpu.use_latent_cache = latent
            kernels.reset_launch_counts()
            dequant_dot.calls = 0
            lg_gpu, tok_gpu, c_gpu = run(m_gpu, fmt)
            launched, dots = launch_counts(), dequant_dot.calls
            lg_cpu, _, c_cpu = run(m_cpu, fmt, forced=tok_gpu)
            flips = flipped_codes(c_gpu, c_cpu)
            del c_gpu, c_cpu
            diff = (lg_gpu - lg_cpu).abs().amax(dim=1)
            err, ref = float(diff.max()), float(lg_cpu.abs().max())
            cpu_tok = lg_cpu.argmax(dim=1).tolist()
            card_tok = tok_gpu + [int(lg_gpu[-1].argmax())]
            ties, parted = [], []
            for i, (a, b) in enumerate(zip(card_tok, cpu_tok)):
                if a != b:
                    gap = float(lg_cpu[i, b] - lg_cpu[i, a])
                    (ties if gap <= float(diff[i]) else parted).append(
                        dict(step=i, card=a, cpu=b, gap=gap,
                             diff=float(diff[i])))
            n_k = ds_kernel_projections(cfg, latent)
            want = expect(dequant_gemm=n_k, vpu_gemv=8 * n_k)
            label = f"{'latent' if latent else 'expanded'} {fmt or 'bf16'}"
            # the logits within 5e-2 of max|logit| where the card's and the
            # CPU's cache codes agree; a code that one ulp of its row moves
            # (an fp8 step is 2^-3 of the value, an int4 step 1/15 of the
            # part's range, and the latent row is every head's K and V)
            # moves logits by more, and leaves the token rule
            close = err <= 5e-2 * ref or flips > 0
            ok = (not parted and math.isfinite(err) and close
                  and launched == want and dots == 9 * L)
            print(f"deepseek check {label} (2 layers, full width): tokens "
                  f"equal={not ties and not parted} near-ties {ties} "
                  f"cache codes that differ card-CPU {flips} "
                  f"max|logit diff|={err:.4e} tol={5e-2 * ref:.4e} card "
                  f"launches { {k: v for k, v in launched.items() if v} } "
                  f"dequantize-then-matmul {dots} "
                  f"({time.perf_counter() - t1:.1f} s)", flush=True)
            if not ok:
                fail(f"deepseek check {label}: card tokens {card_tok} vs CPU "
                     f"{cpu_tok} (parted {parted}), err {err}, launches "
                     f"{launched} != {want} or dots {dots} != {9 * L}")
        m_gpu.use_latent_cache = m_cpu.use_latent_cache = True
        set_woq_impl(m_cpu, "pallas")
        gen = torch.Generator().manual_seed(23)
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen)
                   .numpy() for n in (40, 70, 20)]
        new = (3, 2, 3)
        kw = dict(n_slots=4, max_len=128, prefill_chunk=32, page_size=32)
        for mode in ("contiguous", "paged_bf16"):
            t1 = time.perf_counter()
            kernels.reset_launch_counts()
            eng, got, _s = serve_engine(torch, nct, m_gpu, mode, prompts,
                                        new, chunk=2, **kw)
            launched = launch_counts()
            _e, want, _s = serve_engine(torch, nct, m_cpu, mode, prompts,
                                        new, chunk=2, **kw)
            toks = [r.generated for r in got]
            ties = []
            for p, a, b in zip(prompts, toks, [r.generated for r in want]):
                i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         None)
                if i is not None:
                    gap, diff = ds_card_cpu_tie(torch, m_cpu, m_gpu, None,
                                                list(p) + b[:i], b[i], a[i])
                    ties.append(dict(step=i, card=a[i], cpu=b[i], gap=gap,
                                     diff=diff))
                    if gap > diff:
                        fail(f"deepseek engine {mode}: card {a} cpu {b}, the "
                             f"CPU's top-2 gap {gap} exceeds the card-CPU "
                             f"difference {diff}")
            steps = 2 * eng.metrics()["decode_dispatches"]
            k14 = L * steps if mode == "paged_bf16" else 0
            ok = (launched["paged_latent_write"] == k14
                  and launched["paged_latent_attn"] == k14
                  and launched["dequant_gemm"] > 0)
            print(f"deepseek engine check {mode} (2 layers, full width): card "
                  f"tokens {toks} cpu tokens {[r.generated for r in want]} "
                  f"near-ties {ties} launches "
                  f"{ {k: v for k, v in launched.items() if v} } "
                  f"({time.perf_counter() - t1:.1f} s)", flush=True)
            if not ok:
                fail(f"deepseek engine {mode}: K14 launches "
                     f"{launched['paged_latent_write']}/"
                     f"{launched['paged_latent_attn']} != {k14}")
    print(f"deepseek check done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del m_cpu, m_gpu
    gc.collect()
    torch.cuda.empty_cache()


def phase_deepseek_serve(torch, nct) -> dict:
    """The slice's path at full width: deepseek-v3 cut to ``DS_LAYERS`` = 2
    of its 61 layers (one dense layer and one MoE layer with all 256
    routed experts and the shared one), RTN asym-int4 g128 W4A16 (router
    float32, embedding and lm_head bf16), random weights made on the card
    from a seed, in latent mode. Three B=1 greedy requests over the
    contiguous latent cache (prompts of 16, 371 and 2,000 tokens, 16 new,
    max_len 4096: K8 prefills the 16-token prompt, the others take
    dequantize-then-matmul, K9 decodes, attention in plain PyTorch as JAX
    runs it in XLA); then ``ContinuousBatchingEngine(n_slots=8,
    max_len=4096, paged=True)`` over the latent pool (pages of 128 rows,
    the default n_pages), ``DS_ENGINE_REQUESTS`` = 4 requests (prompts of
    16, 371, 1,000 and 3,000 tokens, 16 new), ``run(chunk=8)``: each decode step of each
    layer writes with K14's write and attends with K14's attention, the
    projections on K8 (M = 8). Its tokens held against ``greedy_search``
    (over the contiguous latent cache), equal or parted
    where greedy's top-2 gap is at most the two paths' logit difference at
    that step, both recorded in this run (a forward hook keeps each
    call's logits); exact launch counts of K14's write and attention,
    K8, K9 and the dequantize-then-matmul calls; tok/s, the pool's bytes
    against an expanded bf16 cache of the same rows, peak memory, the
    run's first decode dispatch with two slots decoding profiled.
    Returns {path: launches}."""
    import numpy as np

    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.kernels import dequant_dot

    t0 = time.perf_counter()
    model = ds_model(nct, seed=0, device="cuda", num_hidden_layers=DS_LAYERS,
                     first_k_dense_replace=DS_LAYERS - 1)
    cfg = model.cfg
    L, V, H = cfg.num_hidden_layers, cfg.vocab_size, cfg.num_attention_heads
    n_k = ds_kernel_projections(cfg, True)
    torch.cuda.synchronize()
    print(f"{DS_PRESET} W4A16 (asym int4 g{G}, {L} of 61 layers: "
          f"{cfg.first_k_dense_replace} dense, {L - cfg.first_k_dense_replace}"
          f" MoE of {cfg.n_routed_experts} routed experts top-"
          f"{cfg.num_experts_per_tok} + {cfg.n_shared_experts} shared; "
          f"{n_k} K8/K9 projections a forward) built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    out = {}
    gen = torch.Generator().manual_seed(61)
    prompts = [torch.randint(0, V, (1, P), generator=gen) for P in DS_PROMPTS]
    nct.greedy_search(model, prompts[0], max_new_tokens=2)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    dequant_dot.calls = 0
    outs, req_s = [], []
    for ids in prompts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(nct.greedy_search(model, ids, max_new_tokens=DS_NEW,
                                      max_len=DS_MAX_LEN))
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t)
    launches, dots = launch_counts(), dequant_dot.calls
    short = sum(P <= 256 for P in DS_PROMPTS)
    want = expect(dequant_gemm=short * n_k,
                  vpu_gemv=len(DS_PROMPTS) * (DS_NEW - 1) * n_k)
    want_dots = (len(DS_PROMPTS) * DS_NEW * L
                 + (len(DS_PROMPTS) - short) * n_k)
    print(f"deepseek B=1 kernels {json.dumps(launches)} expected "
          f"{json.dumps(want)}; dequantize-then-matmul calls {dots} "
          f"(expected {want_dots}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for ids, o, s_ in zip(prompts, outs, req_s):
        P = ids.shape[1]
        if (tuple(o.shape) != (1, P + DS_NEW)
                or not torch.equal(o[:, :P].cpu(), ids.to(torch.int32))
                or int(o.min()) < 0 or int(o.max()) >= V):
            fail(f"bad deepseek greedy output for prompt {P}: {o}")
        print(f"deepseek request prompt={P} new={DS_NEW}: {s_ * 1e3:.1f} ms "
              f"({DS_NEW / s_:.2f} tok/s with the prefill; first new tokens "
              f"{o[0, P:P + 8].tolist()})", flush=True)
    if launches != want or dots != want_dots:
        fail(f"deepseek B=1 launch counts {launches} != {want} or dequantize-"
             f"then-matmul calls {dots} != {want_dots}")
    out["deepseek_greedy_b1"] = launches

    # the engine over the paged latent pool, its tokens against greedy's
    gen = torch.Generator().manual_seed(62)
    e_prompts = [torch.randint(0, V, (DS_ENGINE_PROMPTS[i % 4],),
                               generator=gen).numpy()
                 for i in range(DS_ENGINE_REQUESTS)]
    sink = []  # each model call's logits while a hook records

    def recording():
        return model.register_forward_hook(lambda _m, _a, out: sink.append(
            out[0] if isinstance(out, tuple) else out))

    # the references: greedy_search over each prompt length's prompts at
    # once (one at a time for the 3,000-token ones, whose float64 prefill
    # attention would not fit four at once), and the logits that chose each
    # of their tokens
    refs, ref_rows = [None] * len(e_prompts), [None] * len(e_prompts)
    for P in DS_ENGINE_PROMPTS:
        idx = [i for i, p in enumerate(e_prompts) if len(p) == P]
        for batch in ([idx] if P <= 1000 else [[i] for i in idx]):
            hook = recording()
            try:
                o = nct.greedy_search(model, torch.from_numpy(np.stack(
                    [e_prompts[i] for i in batch])),
                    max_new_tokens=DS_ENGINE_NEW)
            finally:
                hook.remove()
            for b_, i in enumerate(batch):
                refs[i] = o[b_, P:].tolist()
                ref_rows[i] = torch.stack([lg[b_, -1] for lg in sink])
            sink.clear()
    eng = nct.ContinuousBatchingEngine(model, n_slots=SLOTS,
                                       max_len=DS_MAX_LEN, paged=True,
                                       page_size=PAGE)
    chunk_rows = []
    eng_rows = {}  # (request uid, new-token index) -> the logits that chose it
    prefill_forward, decode_forward = eng._prefill_forward, eng._decode_forward

    def observed(target, ids, rows, starts, last_idx, _f=prefill_forward):
        """A prefill chunk: the logits of the rows that complete a prompt."""
        chunk_rows.append(int(ids.shape[0]))
        slot_of = {r: s_ for s_, r in eng._staging_of.items()}
        rows_h, last_h = rows.tolist(), last_idx.tolist()
        done_rows = []
        for i, r in enumerate(rows_h):
            if i and r == rows_h[0]:
                break                      # the padding repeats row 0
            req = eng.slot_req[slot_of[r]]
            if req.prefill_pos + eng.prefill_chunk >= len(eng._prompt_of(req)):
                done_rows.append((i, req.uid, len(req.generated)))
        sink.clear()
        out = _f(target, ids, rows, starts, last_idx)
        for i, uid, k in done_rows:
            eng_rows[(uid, k)] = sink[-1][i, last_h[i]].clone()
        sink.clear()
        return out

    profiled = []

    def observed_decode(k, _f=decode_forward):
        """A decode dispatch: step j's logits chose each decoding slot's
        token j of the dispatch. The first dispatch with two slots
        decoding (the most this prefill-bound run reaches) runs under the
        profiler (where the time goes; it adds the profiler's cost to the
        run's wall). Every slot runs the step: idle ones park at the last
        row, so K14 attends 4096 rows of the trash page for them."""
        base = {s_: (eng.slot_req[s_].uid, len(eng.slot_req[s_].generated))
                for s_ in range(eng.n_slots)
                if eng.slot_state[s_] == "decode"}
        sink.clear()
        if not profiled and len(base) >= 2:
            profiled.append(k)
            holder = []
            profile_window(torch, f"deepseek engine paged latent decode "
                           f"dispatch, {eng.n_slots} slots ({len(base)} "
                           f"decoding, the idle ones at 4096 trash rows) x "
                           f"{k} steps",
                           lambda: holder.append(_f(k)))
            out = holder[0]
        else:
            out = _f(k)
        for j, lg in enumerate(sink):
            for s_, (uid, n0) in base.items():
                eng_rows[(uid, n0 + j)] = lg[s_, 0].clone()
        sink.clear()
        return out

    eng._prefill_forward = observed
    eng._decode_forward = observed_decode
    hook = recording()
    reqs = [eng.submit(p, max_new_tokens=DS_ENGINE_NEW) for p in e_prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    dequant_dot.calls = 0
    t = time.perf_counter()
    try:
        done = eng.run(chunk=CHUNK)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches, dots = launch_counts(), dequant_dot.calls
    if sorted(r.uid for r in done) != sorted(r.uid for r in reqs):
        fail(f"deepseek engine finished {len(done)} of {len(reqs)}")
    m = eng.metrics()
    steps = CHUNK * m["decode_dispatches"]
    C = eng.prefill_chunk
    k8_chunks = sum(r * C <= 256 for r in chunk_rows)
    want = expect(dequant_gemm=n_k * (steps + k8_chunks),
                  paged_latent_write=L * steps, paged_latent_attn=L * steps)
    want_dots = L * (steps + len(chunk_rows)) + n_k * (len(chunk_rows)
                                                       - k8_chunks)
    C_lat = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    expanded = (eng.n_pages * PAGE * L * H
                * (cfg.qk_head_dim + cfg.v_head_dim) * 2)
    counters = {k: m[k] for k in (
        "requests", "prompt_tokens", "generated_tokens",
        "prefill_chunk_dispatches", "decode_dispatches",
        "combined_dispatches", "preemptions")}
    print(f"deepseek engine paged latent ({eng.n_pages} pages of {PAGE} rows "
          f"of {C_lat} bf16, {m['kv_cache_format']}): {len(reqs)} requests "
          f"in {seconds:.3f} s, generated {m['generated_tok_s']:.2f} tok/s "
          f"(metrics wall {m['wall_s']:.3f} s), {json.dumps(counters)}, "
          f"prefill chunk rows {chunk_rows} (chunk {C}), pool "
          f"{m['kv_cache_bytes'] / 2**20:.1f} MiB against "
          f"{expanded / 2**20:.1f} MiB for the same rows as expanded bf16 "
          f"K/V ({expanded / m['kv_cache_bytes']:.1f}x: "
          f"{H * (cfg.qk_head_dim + cfg.v_head_dim)} against {C_lat} values "
          f"a token), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"deepseek engine kernels {json.dumps(launches)} expected "
          f"{json.dumps(want)}; dequantize-then-matmul calls {dots} "
          f"(expected {want_dots})", flush=True)
    if launches != want or dots != want_dots:
        fail(f"deepseek engine: launch counts {launches} != {want} or "
             f"dequantize-then-matmul calls {dots} != {want_dots}")
    parted = []
    for p, r, ref, rows in zip(e_prompts, reqs, refs, ref_rows):
        got = r.generated
        if len(got) != DS_ENGINE_NEW or not all(
                math.isfinite(x) for x in r.logprobs):
            fail(f"deepseek engine: bad output {got}")
        i = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
                 None)
        if i is None:
            continue
        # greedy's top-2 gap and the two paths' logit difference, each row
        # the logits that chose new token i
        a, b = rows[i].float(), eng_rows[(r.uid, i)].float()
        gap = float(a[ref[i]] - a[got[i]])
        diff = float((a - b).abs().max())
        parted.append(dict(prompt=len(p), step=i, greedy=ref[i],
                           engine=got[i], gap=gap, diff=diff))
        if gap > diff:
            fail(f"deepseek engine: parts from greedy at new token {i} of a "
                 f"{len(p)}-token prompt where greedy's top-2 gap {gap} "
                 f"exceeds the paths' difference {diff}")
    print(f"deepseek engine: {DS_ENGINE_REQUESTS - len(parted)} of "
          f"{DS_ENGINE_REQUESTS} requests equal to greedy_search; partings "
          f"{parted}", flush=True)
    out["deepseek_engine_paged_latent"] = launches
    if not profiled:
        fail("deepseek engine: no decode dispatch with two slots decoding "
             "to profile")
    del eng, observed, observed_decode, prefill_forward, decode_forward
    del eng_rows, ref_rows, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ flag-selected variants
# K15-K18: the switches of the fused B=1 W4A8 decode layer and the engine's
# paged v1 kernel, each set through the port's own switch
VARIANT_FLAGS = ("omlp", "attn_o", "write", "hbm")
VARIANT_PROMPTS = (16, 371)
# at most this share of a variant kernel's outputs may sit one bf16 ulp off
# its plain version (the two take float64 sums in other orders; a rounding
# flips only where that order decides it) and none further
VARIANT_ULP_SHARE = 1e-3


def port_module(name: str):
    """A kernels module of the port (the package exports functions named
    like some of its modules)."""
    import importlib

    return importlib.import_module(f"neural_compressor_tpu_torch.kernels."
                                   f"{name}")


@contextlib.contextmanager
def variant(flag):
    """The port's switches set for ``flag`` ("omlp": K17, "attn_o": K18,
    "write": K16's in-kernel write, "hbm": K16's bulk copies, "v1": K15;
    None: the default path), restored after."""
    da, fm = port_module("decode_attention"), port_module("fused_matvec")
    om, pa = port_module("omlp_matvec"), port_module("paged_attention")
    om.set_omlp_fused(flag == "omlp")
    fm.ATTN_O_FUSED = flag == "attn_o"
    da.set_cache_write_mode("kernel" if flag == "write" else "outside")
    da.set_ro_cache_space("hbm" if flag == "hbm" else "vmem")
    pa.set_paged_v2(flag != "v1")
    try:
        yield
    finally:
        om.set_omlp_fused(False)
        fm.ATTN_O_FUSED = False
        da.set_cache_write_mode("outside")
        da.set_ro_cache_space("vmem")
        pa.set_paged_v2(True)


def ulp_check(torch, out, ref) -> tuple:
    """A bf16 output against its plain version: (max |diff|, the share of
    outputs off by one bf16 ulp of the reference, ok): ok when no output is
    off by more than one ulp and at most ``VARIANT_ULP_SHARE`` by one."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    ulp = torch.where(ref == 0, torch.full_like(ref, 2.0 ** -133),
                      2.0 ** (torch.floor(torch.log2(ref.abs())) - 7))
    off = diff > 0
    share = float(off.float().mean())
    ok = bool(torch.isfinite(out).all()) and bool((diff <= ulp).all()) \
        and share <= VARIANT_ULP_SHARE
    return float(diff.max()), share, ok


def phase_variant_kernels(torch, nct, peaks: dict) -> dict:
    """K15-K18 against their plain versions at llama2-7b's shapes, with
    their times, the plain version's, one PyTorch yardstick's (never used
    by the port) and the bound:
      * K15 (``paged_attn_v1``) over the 8-slot pools of 128-row pages at
        ``SLOT_POS``, bf16, int8 and fp8 (yardstick: SDPA over the rows
        gathered out of the pages), also against a float64 emulation of
        its split (``v1_split_emulated``); faults: one softmax over all
        pages (K11's order), the v scale applied after the bf16 cast, the
        running maximum restarted at each part, a lost part-boundary row;
      * K16's write (``decode_attn_write``) at B=1, T 1024, pos 0/517/1023,
        bf16 (equal to K5 plus the outside write bit for bit) and int8
        (codes and scales bit for bit, an all-zero row among the new ones;
        faults: the raw row attended, ``_kv_quant``'s rule, and in both
        formats a part's boundary key lost: the new row at a part's first
        key carrying the softmax, against the plain version without it);
        K16's bulk copies (``decode_attn_hbm``, equal to K5 bit for bit);
        yardstick SDPA over the visited rows; the write's rows also give
        back-to-back ms (``backlog_ms``) beside SDPA's;
      * K17 (``omlp``) at o 4096x4096, gate_up 4096x22016, down 11008x4096,
        with and without o (yardstick: three ``torch.matmul`` of the bf16
        weights); faults: one h scale a token, x1 through bf16;
      * K18 (``attn_o``) at H 32, D 128, T 1024 (yardstick: SDPA and a
        ``torch.matmul``, back to back beside the kernel's too); faults:
        the bf16-rounded output quantized, one scale a head, one amax a
        part (the rows one PV block emits, not all heads'), a part's
        boundary key lost.
    Outputs within ``ulp_check``; every planted fault must fail it."""
    from neural_compressor_tpu_torch import kernels as K
    from neural_compressor_tpu_torch.kernels.decode_attention import \
        _attend_plain
    from neural_compressor_tpu_torch.ops import (dequantize_packed,
                                                 pack_qtensor,
                                                 quantize_tensor, to_hopper)
    from neural_compressor_tpu_torch.ops import kv_quant as kq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(61)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    rows = {"k15": [], "k16w": [], "k16h": [], "k17": [], "k18": []}
    missed = []

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def record(kind, label, out, ref, ms, pms, lms, nbytes, ops, extra_ok=True,
               **extra):
        torch.cuda.synchronize()
        err, share, ok = ulp_check(torch, out, ref)
        ok = ok and extra_ok
        bms, by = bound(nbytes, ops, peaks["int8_s" if kind in ("k17", "k18")
                                            else "bf16_s"], peaks)
        rows[kind].append(dict(label=label, err=err, ulp_share=share, ok=ok,
                               ms=ms, plain_ms=pms, library_ms=lms,
                               bound_ms=bms, bound_by=by, **extra))
        lib = "null" if lms is None else f"{lms:.4f}"
        dev_s = (f" device_ms={extra['device_ms']:.4f}"
                 if "device_ms" in extra else "")
        if "b2b_ms" in extra:
            dev_s += (f" back_to_back_ms={extra['b2b_ms']:.4f} "
                      f"library_back_to_back_ms="
                      f"{extra['library_b2b_ms']:.4f}")
        print(f"{kind} {label} max_abs_err={err:.3e} ulp_share={share:.2e} "
              f"ok={ok} ms={ms:.4f}{dev_s} plain_ms={pms:.4f} "
              f"library_ms={lib} bound_ms={bms:.4f} ({by})", flush=True)

    def fault(label, out, faulty_ref, extra_flag=False):
        torch.cuda.synchronize()
        _e, _s, ok = ulp_check(torch, out, faulty_ref)
        flagged = not ok or extra_flag
        print(f"  planted fault {label}: flagged={flagged}", flush=True)
        if not flagged:
            missed.append(label)

    B, H, Hkv, D, T = SLOTS, HEADS, HEADS, HEAD_DIM, MAX_LEN

    # K15 over the engine's pools at SLOT_POS
    pos = torch.tensor(SLOT_POS, dtype=torch.int32, device=dev)
    lengths = (pos + 1).contiguous()
    L = lengths.long()
    n_vis = int(L.sum())
    Lmax = int(L.max())
    mask = (torch.arange(Lmax, device=dev)[None, :] < L[:, None])[:, None,
                                                                 None]
    pmax = T // PAGE
    n_pages = B * pmax + 1
    bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                         .manual_seed(62)) + 1).reshape(B, pmax)
    bt = bt.to(torch.int32).to(dev)
    q = randn(B, H, D)
    q4 = q[:, :, None]
    for fmt in ("bf16", "int8", "fp8_e4m3"):
        esize = 2 if fmt == "bf16" else 1

        def make_pool():
            kr = randn(n_pages, Hkv, PAGE, D)
            vr = randn(n_pages, Hkv, PAGE, D)
            if fmt == "bf16":
                return kr, None, vr, None
            return (*kq.kv_quant(kr, fmt), *kq.kv_quant(vr, fmt))

        pool_bytes = 2 * n_pages * Hkv * PAGE * D * esize
        pools = [make_pool() for _ in range(n_copies(pool_bytes))]
        kp, ks, vp, vs = pools[0]
        out = K.paged_attn_v1(q, kp, ks, vp, vs, bt, lengths)
        ref = K.paged_attn_v1_plain(q, kp, ks, vp, vs, bt, lengths)
        ms = timed_ms(torch, [lambda p=p: K.paged_attn_v1(q, *p, bt, lengths)
                              for p in pools], 200)
        pms = timed_ms(torch, [lambda: K.paged_attn_v1_plain(
            q, kp, ks, vp, vs, bt, lengths)], 5)

        def gathered(pages, scales):
            g = pages[bt.long()].transpose(1, 2).reshape(B, Hkv, T, D)
            if scales is not None:
                s_ = scales[bt.long()].transpose(1, 2).reshape(B, Hkv, T)
                g = g.float() * s_[..., None]
            return g[:, :, :Lmax].to(bf16).contiguous()

        gk = [(gathered(p[0], p[1]), gathered(p[2], p[3])) for p in pools]
        lms = timed_ms(torch, [lambda a=a, b=b: sdpa(q4, a, b, attn_mask=mask)
                               for a, b in gk], 200)
        del gk
        fns = [lambda p=p: K.paged_attn_v1(q, *p, bt, lengths)
               for p in pools]
        dms = sum(profiled(torch, fns, names=V1_KERNELS).values())
        # the split's float64 emulation equals the kernel (ulp_check)
        emu = v1_split_emulated(torch, q, kp, ks, vp, vs, bt, lengths)
        record("k15", f"{fmt} B={B} H={H} D={D} page={PAGE} pmax={pmax} "
               f"lengths={tuple(lengths.tolist())}", out, ref, ms, pms, lms,
               2 * Hkv * n_vis * (D * esize + (4 if ks is not None else 0))
               + 2 * B * H * D * 2 + B * pmax * 4 + B * 4,
               4 * H * n_vis * D, extra_ok=ulp_check(torch, out, emu)[2],
               fmt=fmt, device_ms=dms)
        # faults: K11's one softmax over all pages; v scale after the cast;
        # the running maximum restarted at each part; a lost part-boundary
        # row (the kernel at length L - 1 against the plain version at L,
        # key L - 1 a part's first, carrying its slot's softmax)
        fault(f"k15 {fmt} one softmax over all pages", out,
              K.paged_attn_plain(q, kp, ks, vp, vs, bt, lengths))
        if ks is not None:
            fault(f"k15 {fmt} v scale after the bf16 cast", out,
                  v1_scale_after_cast(torch, q, kp, ks, vp, vs, bt, lengths))
        fault(f"k15 {fmt} running maximum restarted at each part", out,
              v1_split_emulated(torch, q, kp, ks, vp, vs, bt, lengths,
                                "restart"))
        pa = port_module("paged_attention")
        pk = pa.v1_plan(B, H, Hkv, D, PAGE, pmax).part_keys
        lb = torch.full((B,), pk + 1, dtype=torch.int32, device=dev)
        kb = pa._gather_rows(kp, bt.long())[:, :, pk]        # [B, Hkv, D]
        if ks is not None:
            kb = kb * pa._gather_pages(ks, bt.long())[:, :, pk, None]
        qb = (kb * 8).to(bf16).repeat_interleave(H // Hkv, dim=1)
        fault(f"k15 {fmt} a lost part-boundary row",
              K.paged_attn_v1(qb, kp, ks, vp, vs, bt, lb - 1),
              K.paged_attn_v1_plain(qb, kp, ks, vp, vs, bt, lb))
        del pools, kp, ks, vp, vs

    # K16 at B=1, T 1024
    q1 = randn(1, H, D)
    for p_ in ATTN_POS:
        posd = torch.tensor([p_], dtype=torch.int32, device=dev)
        L1 = p_ + 1
        kn, vn = randn(1, Hkv, D), randn(1, Hkv, D)
        kv = [(randn(1, Hkv, T, D), randn(1, Hkv, T, D))
              for _ in range(n_copies(2 * Hkv * T * D * 2))]
        k, v = kv[0]
        # bf16 write: equal to K5 plus the outside write, bit for bit
        k1, v1 = k.clone(), v.clone()
        out = K.decode_attn_write(q1, kn, vn, k1, None, v1, None, posd)
        k2, v2 = k.clone(), v.clone()
        k2[:, :, p_], v2[:, :, p_] = kn, vn
        ref = K.decode_attn(q1, k2, v2, posd)
        torch.cuda.synchronize()
        same = (torch.equal(out, ref) and torch.equal(k1, k2)
                and torch.equal(v1, v2))
        fns = [lambda a=a, b=b: K.decode_attn_write(
            q1, kn, vn, a, None, b, None, posd) for a, b in kv]
        ms = timed_ms(torch, fns, 200)
        pms = timed_ms(torch, [lambda: K.decode_attn_write_plain(
            q1, kn, vn, k2.clone(), None, v2.clone(), None, posd)], 5)
        lfns = [lambda a=a, b=b: sdpa(q1[:, :, None], a[:, :, :L1],
                                      b[:, :, :L1]) for a, b in kv]
        lms = timed_ms(torch, lfns, 200)
        nb = 2 * Hkv * L1 * D * 2 + H * D * 2 * 2 + 2 * Hkv * D * 2 * 2
        record("k16w", f"bf16 pos={p_} T={T} H={H} D={D} (== K5 + write: "
               f"{same})", out, ref, ms, pms, lms, nb, 4 * H * L1 * D,
               extra_ok=same, fmt="bf16", pos=p_,
               b2b_ms=backlog_ms(torch, fns, 300),
               library_b2b_ms=backlog_ms(torch, lfns, 300))
        # the bulk-copy kernel: equal to K5 bit for bit
        out = K.decode_attn_hbm(q1, k2, v2, posd)
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        ms = timed_ms(torch, [lambda a=a, b=b: K.decode_attn_hbm(
            q1, a, b, posd) for a, b in kv], 200)
        pms = timed_ms(torch, [lambda: K.decode_attn_hbm_plain(
            q1, k2, v2, posd)], 5)
        record("k16h", f"pos={p_} T={T} H={H} D={D} (== K5: {same})", out,
               ref, ms, pms, lms, nb - 2 * Hkv * D * 2 * 2, 4 * H * L1 * D,
               extra_ok=same, pos=p_)
        del kv, k1, v1, k2, v2
        # int8 write: codes and scales bit for bit, one all-zero new row
        kn8 = kn.clone()
        kn8[0, 1] = 0
        rk, rv = randn(1, Hkv, T, D), randn(1, Hkv, T, D)
        cache = (*kq.kv_quant(rk, "int8"), *kq.kv_quant(rv, "int8"))
        c_k = [t.clone() for t in cache]
        c_p = [t.clone() for t in cache]
        out = K.decode_attn_write(q1, kn8, vn, *c_k, posd)
        ref = K.decode_attn_write_plain(q1, kn8, vn, *c_p, posd)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(c_k, c_p))
        copies = [[t.clone() for t in cache]
                  for _ in range(n_copies(2 * Hkv * T * (D + 4)))]
        fns = [lambda c=c: K.decode_attn_write(q1, kn8, vn, *c, posd)
               for c in copies]
        ms = timed_ms(torch, fns, 200)
        pms = timed_ms(torch, [lambda: K.decode_attn_write_plain(
            q1, kn8, vn, *[t.clone() for t in cache], posd)], 5)
        deq = [(kq.kv_dequant(c[0], c[1], bf16), kq.kv_dequant(c[2], c[3],
                                                               bf16))
               for c in copies[:2]]
        lfns = [lambda a=a, b=b: sdpa(q1[:, :, None], a[:, :, :L1],
                                      b[:, :, :L1]) for a, b in deq]
        lms = timed_ms(torch, lfns, 200)
        record("k16w", f"int8 pos={p_} T={T} H={H} D={D} (codes and scales "
               f"bit-equal: {same})", out, ref, ms, pms, lms,
               2 * Hkv * L1 * (D + 4) + H * D * 4 + 2 * Hkv * (D * 3 + 4),
               4 * H * L1 * D, extra_ok=same, fmt="int8", pos=p_,
               b2b_ms=backlog_ms(torch, fns, 300),
               library_b2b_ms=backlog_ms(torch, lfns, 300))
        # faults: the raw row attended (K6); _kv_quant's rule (its scale
        # of 1 on the all-zero row)
        raw = K.decode_attn_quant_plain(q1, kn8, vn, *cache, posd)
        fault(f"k16w int8 pos={p_} raw row attended", out, raw)
        kvq_scale = kq.kv_quant(kn8[:, :, None], "int8")[1][0, 1, 0]
        fault(f"k16w int8 pos={p_} _kv_quant's rule (all-zero row's scale "
              f"{float(kvq_scale)}, the kernel's "
              f"{float(c_k[1][0, 1, p_]):.3e})", out, ref,
              extra_flag=not torch.equal(kvq_scale, c_k[1][0, 1, p_]))
        del copies, deq, cache, c_k, c_p

    # K16's write on the split: the new row at a part's first key carries
    # the softmax (q is 8x it); the plain version without that key (at
    # pos - 1 over the written cache) must disagree with the kernel
    pk = port_module("decode_attention").decode_plan(
        1, H, Hkv, T, D, "bf16", True).part_keys
    for pb in (pk, 4 * pk):
        posd = torch.tensor([pb], dtype=torch.int32, device=dev)
        kn, vn = randn(1, Hkv, D), randn(1, Hkv, D)
        qb = (kn.float() * 8).to(bf16).repeat_interleave(H // Hkv, dim=1)
        k, v = randn(1, Hkv, T, D), randn(1, Hkv, T, D)
        out = K.decode_attn_write(qb, kn, vn, k, None, v, None, posd)
        fault(f"k16w bf16 pos={pb} a part's boundary key lost", out,
              K.decode_attn_plain(qb, k, v, posd - 1))
        cache = (*kq.kv_quant(k, "int8"), *kq.kv_quant(v, "int8"))
        out = K.decode_attn_write(qb, kn, vn, *cache, posd)
        fault(f"k16w int8 pos={pb} a part's boundary key lost", out,
              K.decode_attn_quant_plain(qb, None, None, *cache, posd - 1))

    # K17 and K18: llama2-7b's projections
    def hopper(K_, N_):
        w = randn(K_, N_, dtype=torch.float32) * K_ ** -0.5
        pw = to_hopper(pack_qtensor(quantize_tensor(w, bits=4, group_size=G)))
        return pw, dequantize_packed(pw, bf16)

    (pwo, wo), (pwg, wg), (pwd, wd) = (hopper(*SHAPES[n])
                                       for n in ("o", "gate_up", "down"))
    Kh, I = SHAPES["down"][1], SHAPES["down"][0]
    tn_i = port_module("omlp_matvec")._pick_tiles(Kh, I, True, Kh)[1]
    x = randn(Kh)
    res = randn(Kh)
    rms_w = 1.0 + 0.1 * randn(Kh, dtype=torch.float32)
    wbytes = sum(pw.packed.numel() + pw.scales.numel() * 4
                 for pw in (pwo, pwg, pwd))
    wcopies = [[(pw.packed.clone(), pw.scales.clone())
                for pw in (pwo, pwg, pwd)] for _ in range(n_copies(wbytes))]
    for has_o in (True, False):
        xin = x if has_o else res

        def call(ws, fn=K.omlp):
            (ow, osc), (gw, gsc), (dw_, dsc) = ws
            return fn(xin, res if has_o else None, rms_w,
                      ow if has_o else None, osc if has_o else None, gw, gsc,
                      dw_, dsc, eps=1e-5, tn_i=tn_i)

        out = call(wcopies[0])
        ref = call(wcopies[0], K.omlp_plain)
        ms = timed_ms(torch, [lambda c=c: call(c) for c in wcopies], 50)
        pms = timed_ms(torch, [lambda: call(wcopies[0], K.omlp_plain)], 3)
        x2 = xin.reshape(1, Kh)

        def lib():
            y = torch.matmul(x2, wo) if has_o else x2
            g = torch.matmul(y, wg)
            return torch.matmul(g[:, :I], wd)

        lms = timed_ms(torch, [lib], 50)
        nb = (wbytes - (0 if has_o else pwo.packed.numel()
                        + pwo.scales.numel() * 4) + Kh * 2 * 3 + Kh * 4)
        ops = 2 * ((Kh * Kh if has_o else 0) + Kh * 2 * I + I * Kh)
        record("k17", f"{'o+' if has_o else ''}gate_up+down Kh={Kh} I={I} "
               f"tn_i={tn_i}", out, ref, ms, pms, lms, nb, ops, has_o=has_o)
        # faults: one h scale a token; x1 through bf16
        fault(f"k17 has_o={has_o} one h scale a token", out,
              K.omlp_plain(xin, res if has_o else None, rms_w,
                           pwo.packed if has_o else None,
                           pwo.scales if has_o else None, pwg.packed,
                           pwg.scales, pwd.packed, pwd.scales, eps=1e-5,
                           tn_i=I))
        if has_o:
            x1 = port_module("fused_matvec").fused_gemv_plain(
                x, None, pwo.packed, pwo.scales, None, res, eps=0.0,
                silu=False, out_dtype=bf16)
            fault("k17 x1 through bf16", out, K.omlp_plain(
                x1, None, rms_w, None, None, pwg.packed, pwg.scales,
                pwd.packed, pwd.scales, eps=1e-5, tn_i=tn_i))
    del wcopies

    qh = randn(H, D)
    N = SHAPES["o"][1]
    for p_ in ATTN_POS:
        L1 = p_ + 1
        kv = [(randn(Hkv, T, D), randn(Hkv, T, D), pwo.packed.clone(),
               pwo.scales.clone())
              for _ in range(n_copies(2 * Hkv * T * D * 2
                                      + pwo.packed.numel()
                                      + pwo.scales.numel() * 4))]
        k, v = kv[0][:2]
        out = K.attn_o(qh, k, v, p_, pwo.packed, pwo.scales, res)
        ref = K.attn_o_plain(qh, k, v, p_, pwo.packed, pwo.scales, res)
        fns = [lambda c=c: K.attn_o(qh, *c[:2], p_, *c[2:], res) for c in kv]
        ms = timed_ms(torch, fns, 200)
        pms = timed_ms(torch, [lambda: K.attn_o_plain(
            qh, k, v, p_, pwo.packed, pwo.scales, res)], 5)

        def lib(a, b):
            o = sdpa(qh[None, :, None], a[None, :, :L1], b[None, :, :L1])
            return torch.matmul(o.reshape(1, H * D), wo)

        lfns = [lambda c=c: lib(*c[:2]) for c in kv]
        lms = timed_ms(torch, lfns, 200)
        nb = (pwo.packed.numel() + pwo.scales.numel() * 4
              + 2 * Hkv * L1 * D * 2 + H * D * 2 + N * 2 * 2)
        record("k18", f"pos={p_} H={H} D={D} T={T} N={N}", out, ref, ms, pms,
               lms, nb, 2 * H * D * N + 4 * H * L1 * D, pos=p_,
               b2b_ms=backlog_ms(torch, fns, 300),
               library_b2b_ms=backlog_ms(torch, lfns, 300))
        o32 = _attend_plain(qh[None], k[None], v[None], p_).reshape(-1)
        fm = port_module("fused_matvec")
        if p_:  # at pos 0 the output is V's row 0, already bf16
            fault(f"k18 pos={p_} bf16-rounded output quantized", out,
                  fm.fused_gemv_plain(o32.to(bf16), None, pwo.packed,
                                      pwo.scales, None, res, eps=0.0,
                                      silu=False, out_dtype=bf16))
        # one scale a head: each head's codes at its own amax; with
        # G == D each group is one head, so its scale multiplies the group's
        oh = o32.reshape(H, D)
        s_h = oh.abs().amax(dim=1) * (1.0 / 127)
        s_h = torch.where(s_h <= 0, torch.ones_like(s_h), s_h)
        codes = torch.clamp(torch.round(oh / s_h[:, None]), -128, 127)
        yh = fm.group_dot(codes.reshape(-1), pwo.packed, pwo.scales,
                          gmul=s_h)
        fault(f"k18 pos={p_} one scale a head", out,
              (yh + res.float()).to(bf16))
        # one amax a part: the rows one PV block emits (a KV head's query
        # group; the one whose rows reach the least), not every head's
        a_p = oh.reshape(Hkv, -1).abs().amax(dim=1).min()
        s_p = a_p * (1.0 / 127)
        codes = torch.clamp(torch.round(oh / s_p), -128, 127)
        yp = fm.group_dot(codes.reshape(-1), pwo.packed, pwo.scales)
        fault(f"k18 pos={p_} one amax a part (one KV head's rows, "
              f"{float(a_p):.4f} of {float(oh.abs().max()):.4f})", out,
              (yp * s_p + res.float()).to(bf16))
        del kv
    # K18's split: a part's first key carries the softmax; the plain
    # version without it (pos - 1) must disagree with the kernel
    for pb in (128, 512):
        k, v = randn(Hkv, T, D), randn(Hkv, T, D)
        qb = (k[:, pb].float() * 8).to(bf16)
        fault(f"k18 pos={pb} a part's boundary key lost",
              K.attn_o(qb, k, v, pb, pwo.packed, pwo.scales, res),
              K.attn_o_plain(qb, k, v, pb - 1, pwo.packed, pwo.scales, res))
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"a variant kernel disagrees with its plain version: {bad}")
    if missed:
        fail(f"planted faults not flagged: {missed}")
    return rows


def v1_split_emulated(torch, q, kp, ks, vp, vs, bt, lengths, fault=None):
    """K15's split (``v1_plan``: scores and each page's maximum, the running
    maximum up to each page, per-page partials, the fold replaying v1's
    recurrence in page order) in float64 on the card -> out [B, H, D] bf16,
    with a planted fault where ``fault`` is "restart" (the running maximum
    restarted at each part, the parts rescaled to the global maximum and
    added as flash decoding adds them)."""
    pa = port_module("paged_attention")
    f64, f32 = torch.float64, torch.float32
    B, H, D = q.shape
    Hkv, page = kp.shape[1], kp.shape[2]
    pmax = bt.shape[1]
    rep = H // Hkv
    kpp = pa.v1_plan(B, H, Hkv, D, page, pmax).part_keys // page
    btl = bt.long()
    k, v = pa._gather_rows(kp, btl), pa._gather_rows(vp, btl)
    T = k.shape[2]
    n = lengths.long().clamp(max=T)
    valid = (torch.arange(T, device=q.device)[None, :]
             < n[:, None])[:, None, None, :]
    qr = q.reshape(B, Hkv, rep, D).to(f64)
    s = torch.einsum("bgrd,bgtd->bgrt", qr, k).to(f32)
    scale = torch.tensor(1.0 / (D ** 0.5), dtype=f32, device=q.device)
    s = s * ((pa._gather_pages(ks, btl) * scale)[:, :, None, :]
             if ks is not None else scale)
    pages = (B, Hkv, rep, pmax, page)
    page_max = torch.where(valid, s, torch.tensor(-float("inf"),
                                                  device=q.device)
                           ).reshape(pages).amax(dim=-1)
    run, prev = torch.empty_like(page_max), torch.empty_like(page_max)
    m = torch.full(page_max.shape[:-1], -1e30, dtype=f32, device=q.device)
    for pg in range(pmax):
        if fault == "restart" and pg % kpp == 0:
            m = torch.full_like(m, -1e30)
        prev[..., pg] = m
        m = torch.fmax(m, page_max[..., pg])
        run[..., pg] = m
    alpha = torch.exp(prev.to(f64) - run.to(f64))
    e = torch.exp(s.to(f64).reshape(pages) - run.to(f64)[..., None]).to(f32)
    e = torch.where(valid.reshape(B, 1, 1, pmax, page), e,
                    torch.zeros((), dtype=f32, device=q.device))
    l_p = e.to(f64).sum(dim=-1)
    pe = e if vs is None else e * pa._gather_pages(vs, btl).reshape(
        B, Hkv, 1, pmax, page)
    S_p = torch.einsum("bgrjt,bgjtd->bgrjd", pe.to(torch.bfloat16).to(f64),
                       v.reshape(B, Hkv, pmax, page, D))
    on_page = (torch.arange(pmax, device=q.device)[None, :]
               < ((n + page - 1) // page)[:, None])[:, None, None, :]
    l = torch.zeros(qr.shape[:-1], dtype=f64, device=q.device)
    acc = torch.zeros(qr.shape, dtype=f64, device=q.device)
    span = kpp if fault == "restart" else pmax   # pages folded together
    for p0 in range(0, pmax, span):
        lp, ap = torch.zeros_like(l), torch.zeros_like(acc)
        for pg in range(p0, min(p0 + span, pmax)):
            on = on_page[..., pg]
            lp = torch.where(on, lp * alpha[..., pg] + l_p[..., pg], lp)
            ap = torch.where(on[..., None], ap * alpha[..., pg, None]
                             + S_p[..., pg, :], ap)
        if fault == "restart":   # each part rescaled to the global maximum
            w = torch.exp(run[..., min(p0 + span, pmax) - 1].to(f64)
                          - run.amax(dim=-1).to(f64))
            lp, ap = lp * w, ap * w[..., None]
        l, acc = l + lp, acc + ap
    out = acc.to(f32) / l.to(f32).clamp_min(1e-30)[..., None]
    out = torch.where((lengths > 0).reshape(B, 1, 1, 1), out,
                      torch.zeros((), dtype=f32, device=q.device))
    return out.reshape(B, H, D).to(torch.bfloat16)


def v1_scale_after_cast(torch, q, kp, ks, vp, vs, bt, lengths):
    """K15 with the planted fault "v scale after the bf16 cast": p =
    bf16(e) times v_scale, where v1 casts bf16(e * v_scale). v1's plain
    version over V rows that carry their scale exactly (float64) and
    scales of 1, so the probabilities are cast before the scale multiplies
    them."""
    pa = port_module("paged_attention")
    vrows = vp.to(torch.bfloat16).to(torch.float64) \
        * vs[..., None].to(torch.float64)
    saved = pa._as_rows
    pa._as_rows = lambda pages, fmt: (pages if pages.dtype == torch.float64
                                      else saved(pages, fmt))
    try:
        return pa.paged_attn_v1_plain(q, kp, ks, vrows, torch.ones_like(vs),
                                      bt, lengths)
    finally:
        pa._as_rows = saved


def phase_variant_envelope(torch, nct) -> None:
    """K15-K18 and the repaired K5 at shapes llama2-7b does not give them,
    each within ``ulp_check`` of its plain version (bit for bit where the
    kernel is K5's function):
      * K15 and K16 (write bf16 and int8, bulk copies) at rep 1, 4 and 8 and
        D 64 and 80; K15 with zero-length and idle slots (every entry on
        trash page 0) and a PMAX not a multiple of 4;
      * K16's write at rep 16 over a 1,500-row cache (12 key parts: the
        split's third launch), on the parts' boundaries and past T: bf16
        equal to K5 plus the outside write, int8's codes and scales bit for
        bit; K18 over 1,500 rows at rep 4, at D 256, rep 8, and at H*D
        81,920 (its o-projection reading the weights from global memory),
        within ``ulp_check`` of ``attn_o_plain``;
      * K17 at I with tn_i 128, 256 and 512, and declining where tn_i is
        not a multiple of the down projection's group (counted in
        ``omlp_fused.declined``);
      * K18 declining at G != D and over an int8 cache (counted in
        ``attn_o_fused.declined``);
      * the repaired K5: per-slot positions in one launch, and pos >= T."""
    from neural_compressor_tpu_torch import kernels as K
    from neural_compressor_tpu_torch.models.llama import KVCache, QuantKVCache
    from neural_compressor_tpu_torch.ops import (pack_qtensor,
                                                 quantize_tensor, to_hopper)
    from neural_compressor_tpu_torch.ops import kv_quant as kq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(71)
    bf16 = torch.bfloat16
    bad, n = [], 0

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(label, out, ref, exact=False):
        nonlocal n
        n += 1
        torch.cuda.synchronize()
        ok = torch.equal(out, ref) if exact else ulp_check(torch, out, ref)[2]
        if not ok:
            bad.append(label)

    # K15 and K16 at rep 1, 4, 8 and D 64, 80
    for rep in (1, 4, 8):
        for D in (64, 80):
            Hkv = 4
            H, T, page = Hkv * rep, 300, 16
            tag = f"rep={rep} D={D}"
            q1 = randn(1, H, D)
            k, v = randn(1, Hkv, T, D), randn(1, Hkv, T, D)
            for p_ in (0, 77, T - 1):
                posd = torch.tensor([p_], dtype=torch.int32, device=dev)
                kn, vn = randn(1, Hkv, D), randn(1, Hkv, D)
                kn[0, 1] = 0
                a = [t.clone() for t in (k, v)]
                b = [t.clone() for t in (k, v)]
                check(f"k16w bf16 {tag} pos={p_}",
                      K.decode_attn_write(q1, kn, vn, a[0], None, a[1], None,
                                          posd),
                      K.decode_attn_write_plain(q1, kn, vn, b[0], None, b[1],
                                                None, posd))
                check(f"k16w bf16 cache {tag} pos={p_}", a[0], b[0],
                      exact=True)
                check(f"k16h {tag} pos={p_}", K.decode_attn_hbm(
                    q1, a[0], a[1], posd), K.decode_attn(q1, a[0], a[1], posd),
                      exact=True)
                c8 = (*kq.kv_quant(k, "int8"), *kq.kv_quant(v, "int8"))
                a8 = [t.clone() for t in c8]
                b8 = [t.clone() for t in c8]
                check(f"k16w int8 {tag} pos={p_}",
                      K.decode_attn_write(q1, kn, vn, *a8, posd),
                      K.decode_attn_write_plain(q1, kn, vn, *b8, posd))
                for x, y, what in zip(a8, b8, ("kc", "ks", "vc", "vs")):
                    check(f"k16w int8 {what} {tag} pos={p_}", x, y,
                          exact=True)
            # K15: slots of length 0, 1, a page, a page and one, the table;
            # an idle slot on trash page 0; PMAX 19 (not a multiple of 4)
            pmax = -(-T // page)
            lengths = torch.tensor([0, 1, page, page + 1, T, T], device=dev,
                                   dtype=torch.int32)
            B = lengths.numel()
            P = (B - 1) * pmax + 1
            bt = (torch.randperm(P - 1, generator=torch.Generator()
                                 .manual_seed(72)) + 1).reshape(B - 1, pmax)
            bt = torch.cat([bt, torch.zeros((1, pmax), dtype=bt.dtype)])
            bt = bt.to(torch.int32).to(dev)
            qb = randn(B, H, D)
            for fmt in ("bf16", "int8", "fp8_e4m3"):
                kr, vr = randn(P, Hkv, page, D), randn(P, Hkv, page, D)
                pool = ((kr, None, vr, None) if fmt == "bf16" else
                        (*kq.kv_quant(kr, fmt), *kq.kv_quant(vr, fmt)))
                out = K.paged_attn_v1(qb, *pool, bt, lengths)
                check(f"k15 {fmt} {tag} pmax={pmax}", out,
                      K.paged_attn_v1_plain(qb, *pool, bt, lengths))
                check(f"k15 {fmt} {tag} zero-length slot", out[0],
                      torch.zeros_like(out[0]), exact=True)

    # K16's write at rep 16 past eight parts, and K18 off llama2-7b's shapes
    H, Hkv, D, T = 16, 1, 128, 1500
    q1 = randn(1, H, D)
    k, v = randn(1, Hkv, T, D), randn(1, Hkv, T, D)
    c8 = (*kq.kv_quant(k, "int8"), *kq.kv_quant(v, "int8"))
    for p_ in (0, 127, 128, 129, 1023, T - 1, T + 3):
        posd = torch.tensor([p_], dtype=torch.int32, device=dev)
        kn, vn = randn(1, Hkv, D), randn(1, Hkv, D)
        a = [t.clone() for t in (k, v)]
        b = [t.clone() for t in (k, v)]
        out = K.decode_attn_write(q1, kn, vn, a[0], None, a[1], None, posd)
        if p_ < T:
            b[0][:, :, p_], b[1][:, :, p_] = kn, vn
        check(f"k16w bf16 rep=16 T={T} pos={p_} == K5 + write", out,
              K.decode_attn(q1, b[0], b[1], posd), exact=True)
        check(f"k16w bf16 rep=16 T={T} pos={p_} caches", torch.cat(a),
              torch.cat(b), exact=True)
        a8 = [t.clone() for t in c8]
        b8 = [t.clone() for t in c8]
        check(f"k16w int8 rep=16 T={T} pos={p_}",
              K.decode_attn_write(q1, kn, vn, *a8, posd),
              K.decode_attn_write_plain(q1, kn, vn, *b8, posd))
        for x, y, what in zip(a8, b8, ("kc", "ks", "vc", "vs")):
            check(f"k16w int8 rep=16 {what} pos={p_}", x, y, exact=True)
    fm_ = port_module("fused_matvec")
    for H, Hkv, D, T, N in ((32, 8, 128, 1500, 1024), (16, 2, 256, 300, 512),
                            (640, 80, 128, 64, 256)):
        w = randn(H * D, N, dtype=torch.float32) * (H * D) ** -0.5
        pw = to_hopper(pack_qtensor(quantize_tensor(w, bits=4,
                                                    group_size=D)))
        res = randn(N)
        for p_ in (0, 127, 128, 129, T - 1, T + 2):
            qh = randn(H, D)
            k, v = randn(Hkv, T, D), randn(Hkv, T, D)
            check(f"k18 H={H} Hkv={Hkv} D={D} T={T} N={N} pos={p_}",
                  K.attn_o(qh, k, v, p_, pw.packed, pw.scales, res),
                  fm_.attn_o_plain(qh, k, v, p_, pw.packed, pw.scales, res))

    # the repaired K5: per-slot positions in one launch, and pos >= T
    H, Hkv, D, T = 8, 2, 128, 200
    qb = randn(4, H, D)
    k, v = randn(4, Hkv, T, D), randn(4, Hkv, T, D)
    for posv in ((0, 57, 199, 260), (199, 199, 3, 0)):
        posd = torch.tensor(posv, dtype=torch.int32, device=dev)
        check(f"k5 per-slot positions {posv}", K.decode_attn(qb, k, v, posd),
              K.decode_attn_plain(qb, k, v, posd), exact=True)
        check(f"k16h per-slot positions {posv}",
              K.decode_attn_hbm(qb, k, v, posd),
              K.decode_attn(qb, k, v, posd), exact=True)

    # K17 at tn_i 128, 256, 512, and its decline
    om, fm = port_module("omlp_matvec"), port_module("fused_matvec")

    def hopper(K_, N_, g=G):
        w = randn(K_, N_, dtype=torch.float32) * K_ ** -0.5
        return to_hopper(pack_qtensor(quantize_tensor(w, bits=4,
                                                      group_size=g)))

    Kh = 1024
    pwo = hopper(Kh, Kh)
    for I, want_tn in ((384, 128), (768, 256), (2048, 512)):
        pwg, pwd = hopper(Kh, 2 * I), hopper(I, Kh)
        tn_i = om._pick_tiles(Kh, I, True, Kh)[1]
        if tn_i != want_tn:
            bad.append(f"k17 I={I}: tn_i {tn_i}, expected {want_tn}")
        x, res = randn(Kh), randn(Kh)
        rw = 1 + 0.1 * randn(Kh, dtype=torch.float32)
        for has_o in (True, False):
            args = ((x if has_o else res), res if has_o else None, rw,
                    pwo.packed if has_o else None,
                    pwo.scales if has_o else None, pwg.packed, pwg.scales,
                    pwd.packed, pwd.scales)
            check(f"k17 I={I} tn_i={tn_i} has_o={has_o}",
                  K.omlp(*args, eps=1e-5, tn_i=tn_i),
                  K.omlp_plain(*args, eps=1e-5, tn_i=tn_i))
    om.omlp_fused.declined = 0
    I = 640                  # tn_i 128, the down projection's group 640
    pwg, pwd = hopper(Kh, 2 * I), hopper(I, Kh, g=I)
    r = om.omlp_fused(randn(1, 1, Kh), pwo, pwg, pwd, residual=randn(1, 1, Kh),
                      rms_w=torch.ones(Kh, device=dev), eps=1e-5)
    if r is not None or om.omlp_fused.declined != 1:
        bad.append(f"k17 took tn_i % Gd != 0 (declined "
                   f"{om.omlp_fused.declined})")
    print(f"variant envelope: omlp_fused declined "
          f"{om.omlp_fused.declined} time(s) at I={I}, down group {I}",
          flush=True)

    # K18 declines: G != D, and an int8 cache
    fm.attn_o_fused.declined = 0
    H, Hkv, D, T = 8, 8, 128, 64
    q, kn, vn = randn(1, H, 1, D), randn(1, Hkv, 1, D), randn(1, Hkv, 1, D)
    res = randn(1, 1, 512)
    cache = KVCache(randn(1, Hkv, T, D), randn(1, Hkv, T, D))
    r1 = fm.attn_o_fused(q, kn, vn, cache, 5, hopper(H * D, 512, g=256), res)
    qc = QuantKVCache(*kq.kv_quant(cache.k, "int8"),
                      *kq.kv_quant(cache.v, "int8"))
    r2 = fm.attn_o_fused(q, kn, vn, qc, 5, hopper(H * D, 512), res)
    r3 = fm.attn_o_fused(q, kn, vn, cache, 5, hopper(H * D, 512), res)
    if (r1, r2) != (None, None) or r3 is None \
            or fm.attn_o_fused.declined != 2:
        bad.append(f"k18 envelope: declined {fm.attn_o_fused.declined}")
    print(f"variant envelope: attn_o_fused declined "
          f"{fm.attn_o_fused.declined} time(s) (G 256 != D 128; an int8 "
          f"cache), took the bf16 cache", flush=True)
    print(f"variant envelope: {n} checks, {len(bad)} failed", flush=True)
    if bad:
        fail(f"variant envelope: {bad}")


def variant_launches(flag, L: int, steps: int, fmt=None) -> dict:
    """The exact launches of ``steps`` fused B=1 decode steps of an L-layer
    W4A8 llama under ``flag`` after one prefill (K1 for its 4L + 1
    projections), over a bf16 cache or (``fmt`` "int8") an int8 one: K4 for
    the projections the variant leaves (4L + 1 a step; L + 1 beside K17,
    3L + 1 beside K18), and the variant's kernel once a layer a step."""
    s = steps * L
    attn = {"write": {("decode_attn_write_int8" if fmt
                       else "decode_attn_write"): s},
            "hbm": {"decode_attn_hbm": s},
            "omlp": {"omlp": s, "decode_attn": s},
            "attn_o": {"attn_o": s}}[flag]
    gemv = {"omlp": L + 1, "attn_o": 3 * L + 1}.get(flag, 4 * L + 1)
    return expect(w4a8_gemm=4 * L + 1, fused_gemv=steps * gemv, **attn)


def phase_variant_model_check(torch, nct) -> None:
    """A full-width 2-layer llama2-7b W4A8 with fused decode, on the card
    (kernels) against the same weights on the CPU (plain versions), under
    each switch: ``two_layer_check`` (a 32-token prefill, 8 greedy steps,
    tokens equal but at near-ties under ``card_cpu_tie``'s rule, exact
    launches) under K17, K18 and K16's bulk copies over a bf16 cache and
    K16's write over bf16 and int8 caches; then the engine under
    ``set_paged_v2(False)`` over paged bf16, int8 and fp8 pools (K15),
    card against CPU, tokens equal."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                          LlamaConfig)

    torch.set_num_threads(8)
    cfg = LlamaConfig(**dict(LLAMA_PRESETS["llama2-7b"], num_hidden_layers=2))
    m_cpu, m_gpu = w4a8_pair(nct, cfg, nct.RTNConfig(
        dtype="int4", group_size=G, quant_lm_head=True), seed=7)
    gen = torch.Generator().manual_seed(8)
    ids = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen)
    held = {}  # the CPU's unpacked weights, shared by every check below
    for flag in VARIANT_FLAGS:
        formats = (None, "int8") if flag == "write" else (None,)
        with variant(flag):
            two_layer_check(torch, f"variant check {flag}", m_cpu, m_gpu, ids,
                            woq=False, formats=formats, tie_any=True,
                            want_fn=lambda fmt, f=flag: variant_launches(
                                f, 2, 8, fmt), held=held)
    lens = (12, 20, 5, 33)
    prompts = [torch.randint(0, cfg.vocab_size, (P,), generator=gen).numpy()
               for P in lens]
    kw = dict(n_slots=4, max_len=128, prefill_chunk=16, page_size=32)
    for mode in ("paged_bf16", "paged_int8", "paged_fp8"):
        t1 = time.perf_counter()
        with variant("v1"):
            kernels.reset_launch_counts()
            _e, got, _s = serve_engine(torch, nct, m_gpu, mode, prompts,
                                       (4, 3, 4, 2), chunk=2, **kw)
            launched = launch_counts()
            with unpack_once(held):
                _e, want, _s = serve_engine(torch, nct, m_cpu, mode, prompts,
                                            (4, 3, 4, 2), chunk=2, **kw)
        toks = [r.generated for r in got]
        ok = (toks == [r.generated for r in want]
              and launched["paged_attn_v1"] > 0
              and launched["paged_attn"] + launched["paged_attn_fp8"] == 0)
        print(f"variant engine check v1 {mode} (2 layers, full width): card "
              f"tokens {toks} cpu tokens {[r.generated for r in want]} "
              f"launches { {k: v for k, v in launched.items() if v} } "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
        if not ok:
            fail(f"v1 engine {mode}: card and CPU differ or K15 did not run")
    held.clear()
    del m_cpu, m_gpu


def recording(model, sink):
    """A forward hook on ``model`` that keeps each call's logits in
    ``sink``; remove it after."""
    return model.register_forward_hook(lambda _m, _a, out: sink.append(
        out[0] if isinstance(out, tuple) else out))


def engine_decode_rows(eng, sink) -> dict:
    """Make ``eng`` record, while a ``recording`` hook fills ``sink``, the
    logits that chose each decode token of each request: {(request uid,
    new-token index): logits}. The first new token comes from the prefill,
    which no switch of this slice changes."""
    rows = {}
    decode = eng._decode_forward

    def observed(k):
        base = {s_: (eng.slot_req[s_].uid, len(eng.slot_req[s_].generated))
                for s_ in range(eng.n_slots)
                if eng.slot_state[s_] == "decode"}
        sink.clear()
        out = decode(k)
        for j, lg in enumerate(sink):
            for s_, (uid, n0) in base.items():
                rows[(uid, n0 + j)] = lg[s_, 0].clone()
        sink.clear()
        return out

    eng._decode_forward = observed
    return rows


def parting_rule(label, want, got, rows_want, rows_got) -> dict:
    """Tokens ``got`` of a variant path against the default path's ``want``:
    equal, or parted first at a new token n where the default path's top-2
    gap between the two tokens is at most the two paths' logit difference
    there, each path's logits the ones recorded in this run that chose
    token n (``rows_*(n)``). Returns the parting (or {})."""
    n = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if n is None:
        return {}
    a, b = rows_want(n), rows_got(n)
    if a is None or b is None:
        fail(f"{label}: parts at new token {n}, where no switch of this "
             "slice changes the path")
    a, b = a.float(), b.float()
    gap = float(a[want[n]] - a[got[n]])
    diff = float((a - b).abs().max())
    part = dict(step=n, default=want[n], variant=got[n], gap=gap, diff=diff)
    print(f"{label}: parts from the default path at new token {n}: {part}",
          flush=True)
    if gap > diff:
        fail(f"{label}: parts from the default path where its top-2 gap "
             f"{gap} exceeds the paths' difference {diff}")
    return part


def phase_variant_serve(torch, nct, model) -> dict:
    """The flag-selected variants on phase 5's llama2-7b W4A8 model
    (``W4A8_LAYERS`` of 32 layers, full width; not rebuilt):
      * B=1 greedy, prompts of 16 and 371 tokens, 48 new, under K17, K18,
        K16's bf16 write and K16's bulk copies, against the default path on
        the same prompts (measured before and after them);
      * K16's int8 write with the model's KV cache flagged int8 as
        ``KVCacheQuantConfig`` flags it, against the default int8 path (K6
        and K12);
      * the 8-slot engine under v1 (K15) over the paged bf16 and int8 pools,
        16 requests, against the default v2 engine on the same requests.
    Exact launch counts (``expect``), tok/s beside the default path's in
    this run, tokens under ``parting_rule`` (a forward hook records the
    logits that chose each token on both paths), one decode step (or
    dispatch) profiled a variant. Returns {path: launches}."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.models.llama import init_kv_cache

    nl = model.cfg.num_hidden_layers
    V = model.cfg.vocab_size
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, V, (1, P), generator=gen)
               for P in VARIANT_PROMPTS]
    steps = NEW_TOKENS - 1
    sink = []
    out = {}

    def greedy(flag, fmt):
        """Each prompt's new tokens, seconds, the logits that chose each
        token, and the launches, under ``flag`` over a cache of ``fmt``."""
        set_kv_format(model, fmt)
        hook = recording(model, sink)
        try:
            with variant(flag):
                toks, secs, rows = [], [], []
                kernels.reset_launch_counts()
                for ids in prompts:
                    sink.clear()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    toks.append(nct.greedy_search(
                        model, ids, max_new_tokens=NEW_TOKENS,
                        max_len=MAX_LEN)[0, ids.shape[1]:].tolist())
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t)
                    rows.append([lg[0, -1] for lg in sink])
                return toks, secs, rows, launch_counts()
        finally:
            hook.remove()
            sink.clear()
            set_kv_format(model, None)

    def tok_s(secs):
        return [round(steps / x, 2) for x in secs]

    nct.greedy_search(model, prompts[0], max_new_tokens=4, max_len=MAX_LEN)
    for fmt in (None, "int8"):
        flags = VARIANT_FLAGS if fmt is None else ("write",)
        base = greedy(None, fmt)
        runs = {flag: greedy(flag, fmt) for flag in flags}
        again = greedy(None, fmt)
        print(f"default path{' int8' if fmt else ''}: {tok_s(base[1])} tok/s "
              f"before the variants, {tok_s(again[1])} after", flush=True)
        for flag, (toks, secs, rows, launched) in runs.items():
            want = variant_launches(flag, nl, steps * len(prompts), fmt)
            want["w4a8_gemm"] *= len(prompts)
            key = f"variant_b1_{flag}" + (f"_{fmt}" if fmt else "")
            print(f"{key}: {nl} layers, prompts {VARIANT_PROMPTS}, "
                  f"{NEW_TOKENS} new: {tok_s(secs)} tok/s (request time, "
                  f"prefill included) launches "
                  f"{ {k: v for k, v in launched.items() if v} }",
                  flush=True)
            if launched != want:
                fail(f"{key}: launch counts {launched} != {want}")
            for i, ids in enumerate(prompts):
                parting_rule(f"{key} prompt {ids.shape[1]}", base[0][i],
                             toks[i], base[2][i].__getitem__,
                             rows[i].__getitem__)
            out[key] = launched
            # where the time goes: one decode step under the variant
            set_kv_format(model, fmt)
            try:
                with variant(flag), torch.no_grad():
                    ids = prompts[0].cuda()
                    P = ids.shape[1]
                    caches = init_kv_cache(model.cfg, 1, MAX_LEN,
                                           quantized=fmt or False)
                    model(ids, None, caches, 0)
                    tok = ids[:, -1:]

                    def step():
                        model(tok, torch.full((1, 1), P, device="cuda"),
                              caches, P)

                    step()
                    profile_window(torch, f"{key} decode step", step)
            finally:
                set_kv_format(model, None)
        del base, runs, again

    # the 8-slot engine under v1 against the default (v2) engine
    eprompts = [torch.randint(0, V, (PROMPTS[i % len(PROMPTS)],),
                              generator=gen).numpy()
                for i in range(ENGINE_REQUESTS)]
    new = [48 + (7 * i) % 17 for i in range(ENGINE_REQUESTS)]
    for mode in ("paged_bf16", "paged_int8"):
        res = {}
        for flag in (None, "v1"):
            with variant(flag):
                eng = engine_for(nct, model, mode, n_slots=SLOTS,
                                 max_len=MAX_LEN, page_size=PAGE)
                rows = engine_decode_rows(eng, sink)
                hook = recording(model, sink)
                reqs = [eng.submit(p, max_new_tokens=m)
                        for p, m in zip(eprompts, new)]
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                try:
                    done = eng.run(chunk=CHUNK)
                finally:
                    hook.remove()
                    sink.clear()
                torch.cuda.synchronize()
                if len(done) != len(reqs):
                    fail(f"engine {mode} ({flag}) finished {len(done)} of "
                         f"{len(reqs)} requests")
                res[flag] = (eng, reqs, time.perf_counter() - t,
                             launch_counts(), rows)
        eng, reqs, seconds, launched, rows = res["v1"]
        m = eng.metrics()
        dsteps = CHUNK * m["decode_dispatches"]
        chunks = m["prefill_chunk_dispatches"]
        want = expect(w4a8_gemm=(4 * nl + 1) * (dsteps + chunks),
                      paged_attn_v1=nl * dsteps, paged_write=nl * dsteps)
        base_m = res[None][0].metrics()
        key = f"variant_engine_v1_{mode}"
        print(f"{key}: {len(reqs)} requests in {seconds:.3f} s, generated "
              f"{m['generated_tok_s']:.2f} tok/s (default v2 engine "
              f"{base_m['generated_tok_s']:.2f} tok/s), launches "
              f"{ {k: v for k, v in launched.items() if v} }", flush=True)
        if launched != want:
            fail(f"{key}: launch counts {launched} != {want}")
        parted = []
        for r2, r1, p in zip(res[None][1], reqs, eprompts):
            part = parting_rule(
                f"{key} prompt {len(p)}", r2.generated, r1.generated,
                lambda n, u=r2.uid: res[None][4].get((u, n)),
                lambda n, u=r1.uid: rows.get((u, n)))
            parted += [part] if part else []
        print(f"{key}: {len(reqs) - len(parted)} of {len(reqs)} requests "
              "equal to the default engine's", flush=True)
        out[key] = launched
        with variant("v1"):
            eng = engine_for(nct, model, mode, n_slots=SLOTS,
                             max_len=MAX_LEN, page_size=PAGE)
            for p in eprompts[:SLOTS]:
                eng.submit(p, max_new_tokens=64)
            while eng.queue or "prefill" in eng.slot_state:
                eng.run(max_steps=1, chunk=1)
            profile_window(torch, f"{key} decode dispatch, 8 slots x "
                           f"{CHUNK} steps", lambda: eng.step_many(CHUNK))
        del eng, res, rows
    return out


# ------------------------------------------------------------- hybrid GPTQ
HYB_LAYERS = 2                # depth of the served hybrid-GPTQ llama2-7b
HYB_CALIB = (8, 512)          # calibration: 8 sequences of 512 random ids
HYB_PROMPTS = (16, 371)
S4_MS = (1, 8, 128)           # K2: the B=1 step, the engine's M = 8, a prefill
K1S_MS = (4, 8, 128)          # K1 on tpu_strided words (the repair)
# the share of a 4096x4096 matrix's GPTQ codes that must agree between the
# card and the CPU: the CPU tests hold the port to JAX at this share
# (tests/test_torch_gptq.py, GPTQ_CODE_SHARE)
GPTQ_CODE_SHARE = 0.995
HYB_DEV = "cuda"              # (a CPU rehearsal of these phases sets "cpu")


def hyb_weights(torch, gen, K, N, bits=4, scheme="sym", perm=False):
    """A random llama2-7b-scaled weight, quantized and packed
    "tpu_strided" on the card (with a random row permutation if asked)."""
    pk = {}
    if perm:
        pk["perm"] = torch.randperm(K, generator=gen, device=HYB_DEV)
    return woq_weight(torch, gen, K, N, G=G, scheme=scheme, bits=bits, **pk)


def phase_hybrid_kernels(torch, nct, peaks: dict) -> dict:
    """K2, K1's "tpu_strided" loader and K10 against their plain versions at
    llama2-7b's shapes, bit for bit (each keeps its plain version's order of
    float operations), with their times, the plain version's, one PyTorch
    yardstick's (``torch.matmul`` of the bf16 weights; never used by the
    port) and the bound:
      * K2 (``s4_gemm``) at M 1, 8 and 128 on qkv, o, gate_up, down and the
        lm_head, also equal to K1 on the same codes ("hopper_nk");
      * K1 on "tpu_strided" words (``w4a8_gemm_strided``) at M 4, 8, 128,
        equal to K1 on "hopper_nk";
      * K10 (``vpu_int8act``) at the B=1 step's five shapes, sym and asym
        int4, int2, and through ``vpu_matvec_int8act`` with a row
        permutation;
    and planted faults, each of which must be flagged: a flipped nibble and
    a wrong scale (K2, K1's loader, K10), a wrong zero (K10), the
    reference's xs one float32 ulp high or low (K10 with float32 outputs,
    also held bit-equal to its plain version), at the boundaries of K10's
    blocks (``split_faults``) and the reference's first two tiles folded in
    the other order. Every K10 launch is repeated and must give the same
    bits; K10's device ms (torch.profiler) stands beside its event ms."""
    from neural_compressor_tpu_torch.kernels import (
        s4_gemm, s4_gemm_plain, vpu_int8act, vpu_int8act_plain, w4a8_gemm,
        w4a8_gemm_strided, w4a8_gemm_strided_plain)
    from neural_compressor_tpu_torch.kernels.dequant_matmul import (
        _vpu_tiles, vpu_matvec_int8act)
    from neural_compressor_tpu_torch.ops import (dequantize_packed,
                                                 quantize_act_per_token,
                                                 to_hopper, to_s4_rowpack)

    gen = torch.Generator(device=HYB_DEV)
    gen.manual_seed(10)
    rows = {"k2": [], "k1s": [], "k10": []}
    faults = []

    def copies(*ts):
        n = n_copies(sum(t.numel() * t.element_size() for t in ts))
        return [tuple(t.clone() for t in ts) for _ in range(n)]

    def record(kind, name, M, yk, yp, ms, pms, lms, nbytes, ops, **extra):
        same = bool(torch.equal(yk, yp))
        err = float((yk.float() - yp.float()).abs().max())
        bms, by = bound(nbytes, ops, peaks["int8_s"], peaks)
        row = dict(shape=name, M=M, err=err, ok=same, ms=ms, plain_ms=pms,
                   library_ms=lms, bound_ms=bms, bound_by=by, **extra)
        rows[kind].append(row)
        print(f"{kind} {name:8s} M={M:4d} bit-equal={same} "
              f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={pms:.4f} "
              f"library_ms={lms:.4f} bound_ms={bms:.4f} ({by}) "
              f"{' '.join(f'{k}={v}' for k, v in extra.items())}",
              flush=True)

    def fault(label, yk, yp, want_flagged=True):
        flagged = not bool(torch.equal(yk, yp))
        faults.append((label, flagged == want_flagged))
        print(f"{'planted fault' if want_flagged else 'check'} {label}: "
              f"flagged={flagged}", flush=True)

    for name, (K, N) in SHAPES.items():
        pw = hyb_weights(torch, gen, K, N)
        s4, hop = to_s4_rowpack(pw), to_hopper(pw)
        wbf = dequantize_packed(pw, torch.bfloat16)
        sc = pw.scales
        wbytes = K * N // 2 + (K // G) * N * 4
        for M in sorted(set(S4_MS) | set(K1S_MS)):
            x = (torch.randn((M, K), generator=gen, device=HYB_DEV)
                 ).to(torch.bfloat16)
            xq, xs = quantize_act_per_token(x)
            xs = xs.reshape(-1).contiguous()
            y1 = w4a8_gemm(xq, hop.packed, sc, xs)
            lms = timed_ms(torch, [lambda: torch.matmul(x, wbf)], 50)
            io = M * K + M * 4 + M * N * 4
            for kind, Ms, fn, plain, words in (
                    ("k2", S4_MS, s4_gemm, s4_gemm_plain, s4.packed),
                    ("k1s", K1S_MS, w4a8_gemm_strided,
                     w4a8_gemm_strided_plain, pw.packed)):
                if M not in Ms:
                    continue
                yk = fn(xq, words, sc, xs)
                yp = plain(xq, words, sc, xs)
                torch.cuda.synchronize()
                cps = copies(words, sc)
                ms = timed_ms(torch, [lambda w_=w_, s_=s_: fn(xq, w_, s_, xs)
                                      for w_, s_ in cps], 50)
                del cps
                pms = timed_ms(torch, [lambda: plain(xq, words, sc, xs)], 3)
                record(kind, name, M, yk, yp, ms, pms, lms, wbytes + io,
                       2 * M * N * K, equal_to_k1_hopper=bool(
                           torch.equal(yk, y1)))
                if name == "o" and M == 8:
                    fault(f"{kind} flipped nibble",
                          fn(xq, flip_nibbles(torch, words), sc, xs), yp)
                    fault(f"{kind} wrong scale",
                          fn(xq, words, bad_scale(sc), xs), yp)
        # K10: the B=1 step's shape, sym int4 timed; asym, int2 and a row
        # permutation checked
        tk, _tn = _vpu_tiles(K, N, G)
        x = torch.randn((K,), generator=gen, device=HYB_DEV).to(torch.bfloat16)
        args = dict(bits=4, group_size=G, tk=tk, out_dtype=torch.bfloat16)
        yk = vpu_int8act(x, pw.packed, sc, None, **args)
        yp = vpu_int8act_plain(x, pw.packed, sc, None, **args)
        again = vpu_int8act(x, pw.packed, sc, None, **args)
        torch.cuda.synchronize()
        fault(f"k10 {name} a repeated launch giving other bits",
              again, yk, want_flagged=False)
        cps = copies(pw.packed, sc)
        run = [lambda w_=w_, s_=s_: vpu_int8act(x, w_, s_, None, **args)
               for w_, s_ in cps]
        ms = timed_ms(torch, run, 200)
        # the profiler can lose launches late in a long process (it saw a
        # sixth of K10's in one full run): then the back-to-back time
        seen = {}
        dms = sum(profiled(torch, run, names=K10_KERNELS,
                           counts=seen).values())
        if sum(seen.values()) < 40:
            dms = backlog_ms(torch, run, 200)
            print(f"k10 {name}: torch.profiler saw {sum(seen.values())} of "
                  f"40 launches; device_ms is the back-to-back time",
                  flush=True)
        del cps, run
        pms = timed_ms(torch, [lambda: vpu_int8act_plain(
            x, pw.packed, sc, None, **args)], 3)
        x2 = x.reshape(1, K)
        lms = timed_ms(torch, [lambda: torch.matmul(x2, wbf)], 200)
        record("k10", name, 1, yk, yp, ms, pms, lms,
               wbytes + K * 2 + N * 2, 2 * K * N, fmt="sym_int4", tk=tk,
               device_ms=dms)
        if name == "o":
            dm = port_module("dequant_matmul")
            plan = dm.gemv_plan(N, K, G, 4, tk)
            for label, bad in (split_faults(torch, pw, plan)
                               if plan.splits > 1 else ()):
                fault(f"k10 {label}",
                      vpu_int8act(x, pw.packed, bad, None, **args), yp)
            # the reference's tiles 0 and 1 folded in the other order, float32
            # outputs: its operands with those tiles swapped (the same
            # parts, chained swapped; max|x| and so xs unchanged)
            nt = K // tk

            def swap01(n):   # 0..n-1 in nt blocks, the first two swapped
                i = torch.arange(n, device=HYB_DEV).reshape(nt, -1)
                return i[[1, 0] + list(range(2, nt))].reshape(-1)
            a32 = dict(args, out_dtype=torch.float32)
            fault("k10 the reference's tiles 0 and 1 folded swapped",
                  vpu_int8act(x, pw.packed, sc, None, **a32),
                  vpu_int8act_plain(x[swap01(K)], pw.packed[swap01(K // 8)],
                                    sc[swap01(K // G)], None, **a32))
            fault("k10 flipped nibble",
                  vpu_int8act(x, flip_nibbles(torch, pw.packed), sc, None,
                              **args), yp)
            fault("k10 wrong scale",
                  vpu_int8act(x, pw.packed, bad_scale(sc), None, **args), yp)
            # xs one float32 ulp off on the reference's side, float32
            # outputs (a bf16 output hides a one-ulp xs): the bit
            # comparison must resolve an xs error as small as a kernel bug
            # would make, e.g. a multiply in place of a division
            a32 = dict(args, out_dtype=torch.float32)
            yk32 = vpu_int8act(x, pw.packed, sc, None, **a32)
            yp32 = vpu_int8act_plain(x, pw.packed, sc, None, **a32)
            torch.cuda.synchronize()
            same = bool(torch.equal(yk32, yp32))
            rows["k10"].append(dict(shape=name, M=1, fmt="sym_int4_f32_out",
                                    ok=same, err=float((yk32 - yp32).abs()
                                                       .max()), timed=False))
            print(f"k10 {name:8s} sym_int4_f32_out: bit-equal={same}",
                  flush=True)
            dm = port_module("dequant_matmul")
            quant = dm.act_quant_per_tensor
            for label, to in (("high", math.inf), ("low", -math.inf)):
                def quant_off(x_, to=to):
                    xq_, xs_ = quant(x_)
                    return xq_, torch.nextafter(xs_, torch.full_like(xs_, to))
                dm.act_quant_per_tensor = quant_off
                try:
                    y_off = vpu_int8act_plain(x, pw.packed, sc, None, **a32)
                finally:
                    dm.act_quant_per_tensor = quant
                fault(f"k10 xs one ulp {label} (reference)", yk32, y_off)
        for fmt, bits, scheme in (("asym_int4", 4, "asym"),
                                  ("sym_int2", 2, "sym")):
            pa = hyb_weights(torch, gen, K, N, bits=bits, scheme=scheme)
            a2 = dict(args, bits=bits)
            zk = vpu_int8act(x, pa.packed, pa.scales, pa.zeros, **a2)
            zp = vpu_int8act_plain(x, pa.packed, pa.scales, pa.zeros, **a2)
            torch.cuda.synchronize()
            same = bool(torch.equal(zk, zp))
            rows["k10"].append(dict(shape=name, M=1, fmt=fmt, ok=same,
                                    err=float((zk.float() - zp.float())
                                              .abs().max()), timed=False))
            print(f"k10 {name:8s} {fmt}: bit-equal={same}", flush=True)
            if name == "o" and fmt == "asym_int4":
                fault("k10 wrong zero",
                      vpu_int8act(x, pa.packed, pa.scales,
                                  bad_scale(pa.zeros, by=1.0), **a2), zp)
            del pa
        pp = hyb_weights(torch, gen, K, N, perm=True)
        m = port_module("dequant_matmul")
        yk = vpu_matvec_int8act(x.reshape(1, K), pp)
        plain_fn = m.vpu_int8act
        m.vpu_int8act = vpu_int8act_plain
        try:
            yp = vpu_matvec_int8act(x.reshape(1, K), pp)
        finally:
            m.vpu_int8act = plain_fn
        torch.cuda.synchronize()
        same = bool(torch.equal(yk, yp))
        rows["k10"].append(dict(shape=name, M=1, fmt="perm", ok=same,
                                err=float((yk.float() - yp.float())
                                          .abs().max()), timed=False))
        print(f"k10 {name:8s} perm: bit-equal={same}", flush=True)
        del pw, s4, hop, wbf, pp
    bad = [r for rs in rows.values() for r in rs if not r["ok"]
           or not r.get("equal_to_k1_hopper", True)]
    if bad:
        fail(f"a hybrid kernel disagrees with its plain version: {bad}")
    missed = [label for label, flagged in faults if not flagged]
    if missed:
        fail(f"planted faults not flagged (or repeats unequal): {missed}")
    print(f"hybrid kernels: {sum(len(r) for r in rows.values())} checks "
          f"bit-equal, {len(faults)} planted faults flagged and repeats "
          f"equal", flush=True)
    return rows


def phase_hybrid_envelope(torch, nct) -> None:
    """The hybrid kernels at shapes llama2-7b does not give them, bit for
    bit against their plain versions: K2 and K1's "tpu_strided" loader at
    ragged M (1, 17, 130), at group sizes 32, 64, 256, 384 (the loaders'
    other branches) and 8, 16, 24 (the general path), K10 at group 32 and
    64, int2, f32 x and out, N 384 and 640, K past 1024 in one tile
    (group = K); and the declines of the JAX package's envelope, counted:
    ``s4_matmul`` and ``w4a8_matmul`` take the dequant-and-dot at N % 256
    and on asymmetric words, ``vpu_matvec_int8act`` returns None at M 2,
    N % 128, 8-bit codes and nf4."""
    from neural_compressor_tpu_torch.kernels import (
        dequant_dot, s4_gemm, s4_gemm_plain, vpu_int8act, vpu_int8act_plain,
        w4a8_gemm_strided, w4a8_gemm_strided_plain)
    from neural_compressor_tpu_torch.kernels.dequant_matmul import (
        _vpu_tiles, vpu_matvec_int8act)
    from neural_compressor_tpu_torch.ops import (quantize_act_per_token,
                                                 to_s4_rowpack)

    s4m, w4m = port_module("s4_matmul"), port_module("w4a8_matmul")
    gen = torch.Generator(device=HYB_DEV)
    gen.manual_seed(11)
    n, bad = 0, []
    for (K, N, Gs) in ((768, 512, 32), (768, 256, 64), (1024, 256, 256),
                       (768, 256, 384), (264, 256, 8), (256, 256, 16),
                       (264, 512, 24), (2048, 256, 2048)):
        pw = woq_weight(torch, gen, K, N, G=Gs, scheme="sym")
        s4 = to_s4_rowpack(pw)
        for M in (1, 17, 130):
            xq, xs = quantize_act_per_token(torch.randn(
                (M, K), generator=gen, device=HYB_DEV).to(torch.bfloat16))
            xs = xs.reshape(-1).contiguous()
            for label, fn, plain, words in (
                    ("k2", s4_gemm, s4_gemm_plain, s4.packed),
                    ("k1s", w4a8_gemm_strided, w4a8_gemm_strided_plain,
                     pw.packed)):
                yk, yp = fn(xq, words, pw.scales, xs), plain(
                    xq, words, pw.scales, xs)
                n += 1
                if not bool(torch.equal(yk, yp)):
                    bad.append((label, K, N, Gs, M))
    for (K, N, Gs, bits, scheme, xd, od) in (
            (1024, 384, 32, 4, "sym", torch.float32, torch.float32),
            (2048, 640, 64, 2, "asym", torch.bfloat16, torch.float32),
            (1536, 256, 1536, 4, "sym", torch.bfloat16, torch.bfloat16),
            (11008, 128, 128, 2, "sym", torch.float32, torch.bfloat16)):
        pw = woq_weight(torch, gen, K, N, G=Gs, scheme=scheme, bits=bits)
        tk, _tn = _vpu_tiles(K, N, Gs)
        x = torch.randn((K,), generator=gen, device=HYB_DEV).to(xd)
        args = dict(bits=bits, group_size=Gs, tk=tk, out_dtype=od)
        yk = vpu_int8act(x, pw.packed, pw.scales, pw.zeros, **args)
        yp = vpu_int8act_plain(x, pw.packed, pw.scales, pw.zeros, **args)
        n += 1
        if not bool(torch.equal(yk, yp)):
            bad.append(("k10", K, N, Gs, bits, scheme))
    torch.cuda.synchronize()
    # the envelope's declines
    declines = 0
    x5 = torch.randn((5, 256), generator=gen, device=HYB_DEV).to(
        torch.bfloat16)
    for pw in (woq_weight(torch, gen, 256, 384, scheme="sym"),
               woq_weight(torch, gen, 256, 256, scheme="asym")):
        before = dequant_dot.calls
        w4m.w4a8_matmul(x5, pw)
        if pw.zeros is None:
            s4m.s4_matmul(x5, to_s4_rowpack(pw))
        declines += dequant_dot.calls - before
    for pw, M in ((woq_weight(torch, gen, 256, 256, scheme="sym"), 2),
                  (woq_weight(torch, gen, 256, 96, scheme="sym"), 1),
                  (woq_weight(torch, gen, 256, 256, scheme="sym", bits=8), 1),
                  (woq_weight(torch, gen, 256, 256, scheme="sym",
                              dtype="nf4"), 1)):
        if vpu_matvec_int8act(x5[:M], pw) is None:
            declines += 1
    print(f"hybrid envelope: {n - len(bad)} of {n} shapes bit-equal, "
          f"{declines} of 7 declines where the JAX package declines",
          flush=True)
    if bad or declines != 7:
        fail(f"hybrid envelope: unequal {bad}, declines {declines} != 7")


# ------------------------------------------------------ the W4A8 core
CORE_MS = (1, 8, 17, 32, 64, 128, 512)
CORE_KERNELS = ("small_kernel", "wgmma_kernel", "any_group_kernel")
CORE_SHAPES = ("o", "qkv", "gate_up", "down", "lm_head")


def core_layouts(torch, gen, K, N, Gs=G):
    """One random sym int4 weight on K1's and K2's three layouts: name ->
    (wrapper, plain version, words), and its scales."""
    from neural_compressor_tpu_torch.kernels import (
        s4_gemm, s4_gemm_plain, w4a8_gemm, w4a8_gemm_plain, w4a8_gemm_strided,
        w4a8_gemm_strided_plain)
    from neural_compressor_tpu_torch.ops import (pack_qtensor,
                                                 quantize_tensor, to_hopper,
                                                 to_s4_rowpack)

    w = torch.randn((K, N), generator=gen, device=HYB_DEV) * K ** -0.5
    pw = pack_qtensor(quantize_tensor(w, bits=4, group_size=Gs))
    return ({"hopper_nk": (w4a8_gemm, w4a8_gemm_plain,
                           to_hopper(pw).packed),
             "tpu_strided": (w4a8_gemm_strided, w4a8_gemm_strided_plain,
                             pw.packed),
             "s4_rowpack": (s4_gemm, s4_gemm_plain,
                            to_s4_rowpack(pw).packed)}, pw.scales)


def phase_w4a8_core(torch, nct, peaks: dict) -> None:
    """K1 (both loaders) and K2 on the shared core's plans at llama2-7b's
    five projections, M in ``CORE_MS``: each launch bit-equal to its plain
    version, its plan, event and device ms printed (weights rotated through
    >200 MB of copies); short grids and gathered stages at small shapes."""
    from neural_compressor_tpu_torch.ops import quantize_act_per_token

    wm = port_module("w4a8_matmul")
    gen = torch.Generator(device=HYB_DEV)
    gen.manual_seed(12)
    bad = []
    for name in CORE_SHAPES:
        K, N = SHAPES[name]
        lays, sc = core_layouts(torch, gen, K, N)
        wbytes = K * N // 2 + (K // G) * N * 4
        for M in CORE_MS:
            xq, xs = quantize_act_per_token(torch.randn(
                (M, K), generator=gen, device=HYB_DEV).to(torch.bfloat16))
            xs = xs.reshape(-1).contiguous()
            bms, by = bound(wbytes + M * K + M * 4 + M * N * 4,
                            2 * M * N * K, peaks["int8_s"], peaks)
            for lay, (fn, plain, words) in lays.items():
                yk, yp = fn(xq, words, sc, xs), plain(xq, words, sc, xs)
                torch.cuda.synchronize()
                same = bool(torch.equal(yk, yp))
                if not same:
                    bad.append((name, M, lay))
                cps = [(words.clone(), sc.clone())
                       for _ in range(n_copies(wbytes))]
                fns = [lambda w_=w_, s_=s_: fn(xq, w_, s_, xs)
                       for w_, s_ in cps]
                ms = timed_ms(torch, fns, 50)
                dms = sum(profiled(torch, fns, names=CORE_KERNELS).values())
                plan = wm.gemm_plan(M, N, K, G, lay)
                print(f"core {name:5s} M={M:4d} {lay:11s} bit-equal={same} "
                      f"ms={ms:.4f} device_ms={dms:.4f} "
                      f"bound_ms={bms:.4f} ({by}) "
                      f"{plan.path} mt={plan.mt} bn={plan.bn} ku={plan.ku} "
                      f"stages={plan.stages} grid={plan.grid}", flush=True)
                del cps
    # short grids and the gathered "tpu_strided" stages
    for (M, K, N, Gs) in ((1, 256, 256, 128), (8, 768, 512, 32),
                          (5, 1536, 256, 384), (3, 4096, 256, 2048),
                          (17, 768, 512, 64), (40, 768, 256, 384),
                          (130, 2048, 256, 2048), (70, 768, 320, 32)):
        lays, sc = core_layouts(torch, gen, K, N, Gs)
        xq, xs = quantize_act_per_token(torch.randn(
            (M, K), generator=gen, device=HYB_DEV).to(torch.bfloat16))
        xs = xs.reshape(-1).contiguous()
        for lay, (fn, plain, words) in lays.items():
            same = bool(torch.equal(fn(xq, words, sc, xs),
                                    plain(xq, words, sc, xs)))
            plan = wm.gemm_plan(M, N, K, Gs, lay)
            print(f"core M={M} K={K} N={N} G={Gs} {lay}: bit-equal={same} "
                  f"{plan.path} grid={plan.grid} ku={plan.ku}",
                  flush=True)
            if not same:
                bad.append((M, K, N, Gs, lay))
    if bad:
        fail(f"the W4A8 core disagrees with its plain versions: {bad}")


# ------------------------------------------------------------- K8's plans
K8_CORE_MS = tuple(range(1, 33)) + (100, 128, 256)


def phase_k8_core(torch, nct, peaks: dict) -> None:
    """K8 on ``dequant_plan``'s plans at llama2-7b's five projections and
    DeepSeek-V3's expert shapes, M 1-32, 100, 128 and 256: each launch
    within ``woq_tol`` of its plain version, its plan, event and device ms
    and bound printed (weights rotated through >200 MB of copies). Other
    plans: ``tools/k8_sweep.py``."""
    from neural_compressor_tpu_torch.kernels import dequant_matmul as dm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    bad = []
    for name, (K, N) in dict(SHAPES, **EXPERT_SHAPES).items():
        pw = woq_weight(torch, gen, K, N)
        wbytes = K * N // 2 + 2 * (K // G) * N * 4
        cps = [tuple(t.clone() for t in woq_operands(pw))
               for _ in range(n_copies(wbytes))]
        kw = dict(bits=4, group_size=G, layout="tpu_strided",
                  out_dtype=torch.bfloat16)
        for M in K8_CORE_MS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            yk = dm.dequant_gemm(x, *woq_operands(pw), None, **kw)
            yp = dm.dequant_gemm_plain(x, *woq_operands(pw), None, **kw)
            torch.cuda.synchronize()
            ok = bool(((yk.float() - yp.float()).abs()
                       <= woq_tol(torch, x, pw, yp, k9=False)).all())
            if not ok:
                bad.append((name, M))
            run = [lambda c=c: dm.dequant_gemm(x, *c, None, **kw)
                   for c in cps]
            ms = timed_ms(torch, run, 30)
            dms = sum(profiled(torch, run, names=K8_KERNELS).values())
            bms, by = bound(M * K * 2 + wbytes + M * N * 2, 2 * M * N * K,
                            peaks["bf16_s"], peaks)
            print(f"k8 {name:11s} M={M:3d} ok={ok} ms={ms:.4f} "
                  f"device_ms={dms:.4f} bound_ms={bms:.4f} ({by}) "
                  f"{dm.dequant_plan(M, N, K, G, 4, 'tpu_strided')}",
                  flush=True)
        del cps
    if bad:
        fail(f"K8 disagrees with its plain version: {bad}")


@contextlib.contextmanager
def plain_path():
    """Every kernel wrapper of the port replaced, where it is called from,
    by its plain PyTorch version (``<wrapper>_plain``), which runs on the
    card as well: the same weights' plain path, launching no kernel."""
    from neural_compressor_tpu_torch import kernels

    saved = []
    for fn in kernels.KERNEL_WRAPPERS:
        mod = sys.modules[fn.__module__]
        plain = getattr(mod, fn.__name__ + "_plain", None)
        if plain is not None:
            saved.append((mod, fn.__name__, fn))
            setattr(mod, fn.__name__, plain)
    try:
        with unpack_once():
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def gptq_objective(torch, W, Q, H) -> float:
    """GPTQ's objective tr((W - Q)ᵀ H (W - Q)) in float64."""
    D = (W.double() - Q.double())
    return float((D * (H.double() @ D)).sum())


def phase_hybrid_serve(torch, nct) -> dict:
    """Hybrid GPTQ on llama2-7b at full width, cut to ``HYB_LAYERS`` of its
    32 layers, random bf16 weights from a seed, on the card:
      * calibration: ``quantize(model, HybridGPTQConfig(dtype="int4",
        group_size=128, block_size=128, quant_lm_head=True),
        run_fn=calibration_forward)`` over 8 sequences of 512 random ids;
        for every matrix GPTQ's objective tr((W-Q)ᵀH(W-Q)) no larger than
        RTN's on the same H; layer 0's q_proj (4096x4096) quantized again on
        the CPU from the same W and H, its codes equal to the card's in at
        least ``GPTQ_CODE_SHARE``; seconds per layer;
      * served three ways, each against the same weights' plain path (every
        wrapper's plain version on the card, ``plain_path``), tokens equal
        but at a near-tie (``parting_rule`` on the logits both paths
        recorded), exact launch counts:
        1. ``to_w4a8_serving(s4="s4")``: B=1 greedy (prompts 16 and 371, 48
           new) and the 8-slot engine over contiguous bf16 caches (16
           requests): K2 at every M, K5, K7, no K4;
        2. ``W4A8Linear.M_INT8_THRESHOLD = 2`` on the "tpu_strided" words:
           B=1 greedy, K1's strided loader for every prefill projection and
           K10 for every decode projection;
        3. ``to_w4a8_serving()`` ("hopper_nk") with fused decode: B=1 greedy
           (K1, K4, K5), the yardstick.
    Returns {path: launches}."""
    from neural_compressor_tpu_torch import kernels
    from neural_compressor_tpu_torch.algorithms import gptq as tg
    from neural_compressor_tpu_torch.algorithms.calib_capture import \
        calibration_forward
    from neural_compressor_tpu_torch.kernels import dequant_dot
    from neural_compressor_tpu_torch.layers import W4A8Linear
    from neural_compressor_tpu_torch.models.llama import (LLAMA_PRESETS,
                                                          LlamaConfig,
                                                          LlamaForCausalLM)
    from neural_compressor_tpu_torch.ops import qdq_tensor, unpack_to_codes

    t0 = time.perf_counter()
    cfg = LlamaConfig(**dict(LLAMA_PRESETS["llama2-7b"],
                             num_hidden_layers=HYB_LAYERS))
    model = LlamaForCausalLM(cfg, seed=10, device=HYB_DEV)
    nl, V = HYB_LAYERS, cfg.vocab_size
    gen = torch.Generator(device=HYB_DEV)
    gen.manual_seed(10)
    calib = torch.randint(0, V, HYB_CALIB, generator=gen, device=HYB_DEV)
    batches = [calib[i:i + 1] for i in range(HYB_CALIB[0])]
    torch.cuda.synchronize()
    print(f"hybrid: llama2-7b ({nl} of {LAYERS} layers, bf16) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # record each matrix's objective against RTN's on the same H, and keep
    # the first 4096x4096 matrix (layer 0's q_proj) for the CPU
    seen = []
    keep = {}
    inner = tg.gptq_layer_to_woq

    def observed(kernel, H, cfg_, bias=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lin = inner(kernel, H, cfg_, bias=bias)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        W = kernel.float()
        og = gptq_objective(torch, W, lin.dequantized_kernel(torch.float32),
                            H)
        orr = gptq_objective(torch, W, qdq_tensor(
            W, bits=4, group_size=G, scheme="sym", out_dtype=torch.float32),
            H)
        seen.append(dict(K=W.shape[0], N=W.shape[1], gptq=og, rtn=orr,
                         s=secs))
        if not keep and tuple(W.shape) == (cfg.hidden_size,) * 2:
            keep.update(W=kernel.cpu(), H=H.cpu(), cfg=cfg_,
                        codes=unpack_to_codes(lin.packed_weight()).cpu())
        return lin

    tg.gptq_layer_to_woq = observed
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        nct.quantize(model, nct.HybridGPTQConfig(
            dtype="int4", group_size=G, block_size=128, quant_lm_head=True),
            run_fn=lambda m: calibration_forward(m, batches))
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t
    finally:
        tg.gptq_layer_to_woq = inner
    worse = [r for r in seen if not r["gptq"] <= r["rtn"]]
    ratio = [r["gptq"] / r["rtn"] for r in seen]
    print(f"hybrid calibration: {calib_s:.1f} s for {nl} layers and the "
          f"lm_head ({calib_s / nl:.2f} s a layer with the head's share; "
          f"GPTQ sweeps {sum(r['s'] for r in seen):.1f} s), {len(seen)} "
          f"matrices, GPTQ/RTN objective {min(ratio):.4f}-{max(ratio):.4f}",
          flush=True)
    for r in seen[:8] + seen[-1:]:
        print(f"  gptq {r['K']}x{r['N']}: objective {r['gptq']:.6e} vs RTN "
              f"{r['rtn']:.6e} ({r['s']:.2f} s)", flush=True)
    if len(seen) != 7 * nl + 1 or worse:
        fail(f"GPTQ: {len(seen)} matrices, objective above RTN's: {worse}")
    w4a8 = [m for m in model.modules() if type(m) is W4A8Linear]
    if len(w4a8) != 7 * nl + 1 or {m.layout for m in w4a8} != {
            "tpu_strided"}:
        fail("hybrid GPTQ did not leave W4A8Linear modules on tpu_strided "
             "words")
    # one matrix again on the CPU from the same W and H
    t = time.perf_counter()
    torch.set_num_threads(8)
    lin = inner(keep["W"], keep["H"], keep["cfg"])
    share = float((unpack_to_codes(lin.packed_weight()) == keep["codes"])
                  .float().mean())
    print(f"hybrid GPTQ card vs CPU, 4096x4096 q_proj: {share:.6f} of codes "
          f"equal (at least {GPTQ_CODE_SHARE}; CPU "
          f"{time.perf_counter() - t:.1f} s)", flush=True)
    if share < GPTQ_CODE_SHARE:
        fail(f"GPTQ card vs CPU codes agree in {share} < {GPTQ_CODE_SHARE}")
    del keep, lin

    nct.fuse_for_serving(model)
    ways = {"s4": copy.deepcopy(model), "strided": model,
            "hopper": copy.deepcopy(model)}
    if nct.to_w4a8_serving(ways["s4"], s4="s4") != 4 * nl + 1:
        fail("to_w4a8_serving(s4='s4') did not upgrade every module")
    if nct.to_w4a8_serving(ways["hopper"]) != 4 * nl + 1:
        fail("to_w4a8_serving() did not upgrade every module")
    if nct.enable_fused_decode(ways["hopper"]) != nl:
        fail("fused decode not enabled on every layer")
    prompts = [torch.randint(0, V, (1, P), generator=gen, device=HYB_DEV)
               for P in HYB_PROMPTS]
    steps = NEW_TOKENS - 1
    sink = []
    out = {}

    def greedy(m):
        hook = recording(m, sink)
        toks, secs, rows = [], [], []
        try:
            for ids in prompts:
                sink.clear()
                torch.cuda.synchronize()
                tt = time.perf_counter()
                toks.append(nct.greedy_search(
                    m, ids, max_new_tokens=NEW_TOKENS,
                    max_len=MAX_LEN)[0, ids.shape[1]:].tolist())
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - tt)
                rows.append([lg[0, -1] for lg in sink])
        finally:
            hook.remove()
            sink.clear()
        return toks, secs, rows

    proj = 4 * nl + 1
    n_req = len(prompts)
    want_b1 = {"s4": dict(s4_gemm=n_req * (1 + steps) * proj,
                          decode_attn=n_req * steps * nl),
               "strided": dict(w4a8_gemm_strided=n_req * proj,
                               vpu_int8act=n_req * steps * proj,
                               decode_attn=n_req * steps * nl),
               "hopper": dict(w4a8_gemm=n_req * proj,
                              fused_gemv=n_req * steps * proj,
                              decode_attn=n_req * steps * nl)}
    for way, m in ways.items():
        threshold = W4A8Linear.M_INT8_THRESHOLD
        W4A8Linear.M_INT8_THRESHOLD = 2 if way == "strided" else 1
        try:
            nct.greedy_search(m, prompts[0], max_new_tokens=2,
                              max_len=MAX_LEN)        # warm
            with plain_path():
                ptoks, psecs, prows = greedy(m)
            kernels.reset_launch_counts()
            dequant_dot.calls = 0
            ktoks, ksecs, krows = greedy(m)
            launched = launch_counts()
            fallbacks = dequant_dot.calls
        finally:
            W4A8Linear.M_INT8_THRESHOLD = threshold
        want = expect(**want_b1[way])
        key = f"hybrid_{way}_greedy_b1"
        print(f"{key}: {nl} layers, prompts {HYB_PROMPTS}, {NEW_TOKENS} new: "
              f"{[round(steps / s, 2) for s in ksecs]} tok/s (request time, "
              f"prefill included; plain path "
              f"{[round(steps / s, 2) for s in psecs]}), launches "
              f"{ {k: v for k, v in launched.items() if v} }, "
              f"dequant-and-dot {fallbacks}", flush=True)
        if launched != want or fallbacks:
            fail(f"{key}: launch counts {launched} != {want}, "
                 f"{fallbacks} dequant-and-dot")
        for i, ids in enumerate(prompts):
            if not all(0 <= tok < V for tok in ktoks[i]):
                fail(f"{key}: bad tokens {ktoks[i]}")
            parting_rule(f"{key} prompt {ids.shape[1]}", ptoks[i], ktoks[i],
                         prows[i].__getitem__, krows[i].__getitem__)
        print(f"{key}: first new tokens {ktoks[0][:8]} (plain {ptoks[0][:8]})",
              flush=True)
        out[key] = launched

    # the 8-slot engine over contiguous bf16 caches on the s4 words: K2 at
    # the engine's M = 8 and its prefill chunks, against the plain path
    m = ways["s4"]
    eprompts = [torch.randint(0, V, (PROMPTS[i % len(PROMPTS)],),
                              generator=gen, device=HYB_DEV).cpu().numpy()
                for i in range(ENGINE_REQUESTS)]
    new = [48 + (7 * i) % 17 for i in range(ENGINE_REQUESTS)]
    res = {}
    for label in ("plain", "kernels"):
        ctx = plain_path() if label == "plain" else contextlib.nullcontext()
        with ctx:
            eng = engine_for(nct, m, "contiguous", n_slots=SLOTS,
                             max_len=MAX_LEN)
            rows = engine_decode_rows(eng, sink)
            hook = recording(m, sink)
            reqs = [eng.submit(p, max_new_tokens=k)
                    for p, k in zip(eprompts, new)]
            kernels.reset_launch_counts()
            dequant_dot.calls = 0
            torch.cuda.synchronize()
            tt = time.perf_counter()
            try:
                done = eng.run(chunk=CHUNK)
            finally:
                hook.remove()
                sink.clear()
            torch.cuda.synchronize()
            if len(done) != len(reqs):
                fail(f"hybrid s4 engine ({label}) finished {len(done)} of "
                     f"{len(reqs)} requests")
            res[label] = (eng, reqs, time.perf_counter() - tt,
                          launch_counts(), rows, dequant_dot.calls)
    eng, reqs, seconds, launched, rows, fallbacks = res["kernels"]
    mt = eng.metrics()
    dsteps = CHUNK * mt["decode_dispatches"]
    chunks = mt["prefill_chunk_dispatches"]
    want = expect(s4_gemm=proj * (dsteps + chunks),
                  batched_decode_attn=nl * dsteps)
    key = "hybrid_s4_engine_contiguous"
    print(f"{key}: {len(reqs)} requests in {seconds:.3f} s, generated "
          f"{mt['generated_tok_s']:.2f} tok/s (plain path "
          f"{res['plain'][0].metrics()['generated_tok_s']:.2f}), launches "
          f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    if launched != want or fallbacks:
        fail(f"{key}: launch counts {launched} != {want}, {fallbacks} "
             "dequant-and-dot")
    parted = []
    for r2, r1, p in zip(res["plain"][1], reqs, eprompts):
        part = parting_rule(
            f"{key} prompt {len(p)}", r2.generated, r1.generated,
            lambda n, u=r2.uid: res["plain"][4].get((u, n)),
            lambda n, u=r1.uid: rows.get((u, n)))
        parted += [part] if part else []
    print(f"{key}: {len(reqs) - len(parted)} of {len(reqs)} requests equal "
          "to the plain path's", flush=True)
    out[key] = launched
    del ways, m, model, eng, res
    return out


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

    checks = {"kernels": lambda: phase_kernels(torch, nct, peaks),
              "engine_kernels": lambda: phase_engine_kernels(torch, nct,
                                                             peaks),
              "woq_kernels": lambda: phase_woq_kernels(torch, nct, peaks),
              "kv_kernels": lambda: phase_kv_kernels(torch, nct, peaks),
              "envelope": lambda: phase_envelope(torch, nct),
              "engine_envelope": lambda: phase_engine_envelope(torch),
              "woq_envelope": lambda: phase_woq_envelope(torch, nct),
              "kv_envelope": lambda: phase_kv_envelope(torch),
              "model_check": lambda: phase_model_check(torch, nct),
              "engine_check": lambda: phase_engine_check(torch, nct),
              "woq_model_check": lambda: phase_woq_model_check(torch, nct),
              "spec_kernels": lambda: phase_spec_kernels(torch, nct, peaks),
              "spec_envelope": lambda: phase_spec_envelope(torch),
              "spec_model_check": lambda: phase_spec_model_check(torch,
                                                                 nct),
              "gemma_kernels": lambda: phase_gemma_kernels(torch, nct, peaks),
              "k11_profile": lambda: phase_k11_profile(torch),
              "gemma_envelope": lambda: phase_gemma_envelope(torch, nct),
              "gemma_model_check": lambda: phase_gemma_model_check(torch,
                                                                   nct),
              "deepseek_kernels": lambda: phase_deepseek_kernels(torch, nct,
                                                                 peaks),
              "deepseek_envelope": lambda: phase_deepseek_envelope(torch,
                                                                   nct),
              "deepseek_model_check": lambda: phase_deepseek_model_check(
                  torch, nct),
              "variant_kernels": lambda: phase_variant_kernels(torch, nct,
                                                               peaks),
              "variant_envelope": lambda: phase_variant_envelope(torch, nct),
              "variant_model_check": lambda: phase_variant_model_check(
                  torch, nct),
              "hybrid_kernels": lambda: phase_hybrid_kernels(torch, nct,
                                                             peaks),
              "hybrid_envelope": lambda: phase_hybrid_envelope(torch, nct)}
    # the serving phases a development run may name as well (there
    # variant_serve builds phase 5's model itself), and K11's profile at
    # parts of 256, 512 and 1024 keys
    serves = {"k11_part_sweep": lambda: phase_k11_profile(
                  torch, (256, 512, 1024)),
              "deepseek_serve": lambda: phase_deepseek_serve(torch, nct),
              "variant_serve": lambda: phase_variant_serve(
                  torch, nct, w4a8_model(torch, nct)),
              "hybrid_serve": lambda: phase_hybrid_serve(torch, nct),
              "w4a8_core": lambda: phase_w4a8_core(torch, nct, peaks),
              "k8_core": lambda: phase_k8_core(torch, nct, peaks)}
    if len(sys.argv) > 1:
        # a development run: only the named checks, no serving, no result
        unknown = [a for a in sys.argv[1:] if a not in {**checks, **serves}]
        if unknown:
            fail(f"unknown checks {unknown}; choose from "
                 f"{sorted({**checks, **serves})}")
        for a in sys.argv[1:]:
            timed_phase(a, {**checks, **serves}[a])
        print(f"checks {sys.argv[1:]} passed", flush=True)
        return
    results = {k: timed_phase(k, fn) for k, fn in checks.items()}
    rows, erows = results["kernels"], results["engine_kernels"]
    wrows, kvrows = results["woq_kernels"], results["kv_kernels"]
    srows, grows = results["spec_kernels"], results["gemma_kernels"]
    drows, vrows = results["deepseek_kernels"], results["variant_kernels"]
    hrows = results["hybrid_kernels"]
    launches, model, prompts = timed_phase(
        "serve", lambda: phase_serve(torch, nct))
    timed_phase("profile", lambda: phase_profile(torch, model, prompts[1]))
    by_path = {"greedy_b1": launches}
    for mode, counts in timed_phase(
            "engine_serve",
            lambda: phase_engine_serve(torch, nct, model)).items():
        by_path[f"engine_{mode}"] = counts
    by_path.update(timed_phase("spec_serve",
                               lambda: phase_spec_serve(torch, nct, model)))
    by_path.update(timed_phase("variant_serve",
                               lambda: phase_variant_serve(torch, nct,
                                                           model)))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    by_path["woq_greedy_b1"], model = timed_phase(
        "woq_serve", lambda: phase_woq_serve(torch, nct))
    by_path["woq_engine_contiguous"] = timed_phase(
        "woq_engine", lambda: phase_woq_engine(torch, nct, model))
    for fmt, counts in timed_phase(
            "kv_serve", lambda: phase_kv_serve(torch, nct, model)).items():
        by_path[f"kv_greedy_b1_{fmt}"] = counts
    for mode, counts in timed_phase(
            "kv_engine", lambda: phase_kv_engine(torch, nct, model)).items():
        by_path[f"kv_engine_{mode}"] = counts
    del model
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(timed_phase("gemma_serve",
                               lambda: phase_gemma_serve(torch, nct)))
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(timed_phase("deepseek_serve", serves["deepseek_serve"]))
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(timed_phase("hybrid_serve", serves["hybrid_serve"]))
    print(f"all phases done in {time.perf_counter() - T_START:.1f} s",
          flush=True)
    print(f"launches by main path: {json.dumps(by_path)}", flush=True)

    proj = ("qkv", "o", "gate_up", "down")

    def per_layer(rs):
        return [(r, LAYERS if r["shape"] in proj else 1) for r in rs]

    gemm_u = unit([r for r in rows["gemm"] if r["M"] == UNIT_M], per_layer,
                  lambda rs: "operations" if all(
                      r["bound_by"] == "operations" for r in rs) else "bytes")
    gemm_u["max_abs_err"] = max(r["err"] for r in rows["gemm"])
    # K1's second unit: one step of the 8-slot engine (M = 8)
    gemm_step_u = unit([r for r in rows["gemm"] if r["M"] == STEP_M],
                       per_layer, lambda rs: "bytes")

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
    # K8's second unit: one 128-token W4A16 prefill chunk
    k8_prefill_u = unit([r for r in wrows["k8"] if r["M"] == WOQ_PREFILL_M],
                        per_layer, mixed)
    k9_u = unit(wrows["k9"], per_layer, mixed)

    def kv_unit(kind, pick=lambda r: True):
        u = unit([r for r in kvrows[kind] if pick(r)], layers, bytes_)
        u["max_abs_err"] = max(r["err"] for r in kvrows[kind])
        return u

    def spec_unit(kind):
        u = unit([r for r in srows[kind] if r["fmt"] == "int8"], layers,
                 bytes_)
        u["max_abs_err"] = max(r["err"] for r in srows[kind])
        return u

    int8_at_unit = lambda r: (r["fmt"] == "int8"  # noqa: E731
                              and r["label"].endswith(f"pos={UNIT_POS}"))
    k6_u = kv_unit("k6", int8_at_unit)
    gemma_u = unit([r for r in grows if r["fmt"] == "int8"],
                   lambda rs: [(r, 21) for r in rs], bytes_)
    gemma_u["max_abs_err"] = max(r["err"] for r in grows)
    k7q_u = kv_unit("k7q", lambda r: r["fmt"] == "int8")
    ds_layers = lambda rs: [(r, 61) for r in rs]  # noqa: E731
    k14w_u = unit([drows["write"]], ds_layers, bytes_)
    k14a_u = unit([drows["attn"]], ds_layers,
                  lambda rs: rs[0]["bound_by"])

    def variant_unit(kind, pick=lambda r: True):
        u = unit([r for r in vrows[kind] if pick(r)], layers, bytes_)
        u["max_abs_err"] = max(r["err"] for r in vrows[kind])
        return u

    at_unit = lambda r: r.get("pos") == UNIT_POS  # noqa: E731

    def hybrid_unit(kind, M):
        u = unit([r for r in hrows[kind] if r["M"] == M and "ms" in r],
                 per_layer, mixed)
        u["max_abs_err"] = max(r["err"] for r in hrows[kind])
        return u

    entries = [
        ("w4a8_gemm", "neural_compressor_tpu_torch/csrc/w4a8_gemm.cu",
         "neural_compressor_tpu/kernels/w4a8_matmul.py:88 (_w4a8_impl, K1); "
         "neural_compressor_tpu/kernels/fused_matvec.py:324 (_u4k_impl, K3)",
         gemm_u),
        ("fused_gemv", "neural_compressor_tpu_torch/csrc/fused_gemv.cu",
         "neural_compressor_tpu/kernels/fused_matvec.py:195 (_fused_impl, K4)",
         gemv_u),
        ("decode_attn", "neural_compressor_tpu_torch/csrc/decode_split.cu",
         "neural_compressor_tpu/kernels/decode_attention.py:282 "
         "(_decode_attn_ro_impl, K5)", attn_u),
        ("batched_decode_attn",
         "neural_compressor_tpu_torch/csrc/decode_split.cu",
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
        ("vpu_gemv", "neural_compressor_tpu_torch/csrc/vpu_gemv.cu",
         "neural_compressor_tpu/kernels/dequant_matmul.py:286 "
         "(_vpu_matvec_impl, K9)", k9_u),
        ("decode_attn_quant",
         "neural_compressor_tpu_torch/csrc/decode_split.cu",
         "neural_compressor_tpu/kernels/decode_attention.py:482 "
         "(_decode_attn_quant_ro_impl, K6)", k6_u),
        ("batched_decode_attn_quant",
         "neural_compressor_tpu_torch/csrc/decode_split.cu",
         "neural_compressor_tpu/kernels/decode_attention.py:666 "
         "(_batched_attn_impl, K7, int8/fp8 branch)", k7q_u),
        ("paged_attn_fp8",
         "neural_compressor_tpu_torch/csrc/paged_attention.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:489 "
         "(_paged_attn_impl_v2, K11, fp8 pools)", kv_unit("k11_fp8")),
        ("paged_attn_int4",
         "neural_compressor_tpu_torch/csrc/paged_attention.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:489 "
         "(_paged_attn_impl_v2, K11, int4 pools)", kv_unit("k11_int4")),
        ("paged_write_fp8", "neural_compressor_tpu_torch/csrc/paged_write.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:641 "
         "(_paged_write_impl, _write_kernel_quant, K12, fp8)",
         kv_unit("k12_fp8")),
        ("paged_write_int4",
         "neural_compressor_tpu_torch/csrc/paged_write.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:615 "
         "(_paged_write_impl, _write_kernel_int4, K12, int4)",
         kv_unit("k12_int4")),
        ("paged_write_window",
         "neural_compressor_tpu_torch/csrc/paged_write.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:855, :882, :904 "
         "(_paged_write_window_impl, K13)", spec_unit("k13")),
        ("paged_window_attn",
         "neural_compressor_tpu_torch/csrc/paged_attention.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:489 "
         "(_paged_attn_impl_v2, K11, the W-query window wq > 1)",
         spec_unit("k11w")),
        ("paged_attn_gemma",
         "neural_compressor_tpu_torch/csrc/paged_attention.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:489 "
         "(_paged_attn_impl_v2, K11, the window and softcap branches of "
         "_paged_kernel_v2, :302-305, :352-355)", gemma_u),
        ("paged_latent_write",
         "neural_compressor_tpu_torch/csrc/paged_latent.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:1051 "
         "(_paged_latent_write_impl, K14's write)", k14w_u),
        ("paged_latent_attn",
         "neural_compressor_tpu_torch/csrc/paged_latent.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:1187 "
         "(_paged_latent_attn_impl, K14's attention)", k14a_u),
        ("paged_attn_v1",
         "neural_compressor_tpu_torch/csrc/paged_attention_v1.cu",
         "neural_compressor_tpu/kernels/paged_attention.py:166, :231 "
         "(_paged_attn_impl, _paged_attn_quant_impl, K15)",
         variant_unit("k15", lambda r: r["fmt"] == "int8")),
        ("decode_attn_write",
         "neural_compressor_tpu_torch/csrc/decode_attention.cu",
         "neural_compressor_tpu/kernels/decode_attention.py:77 "
         "(_decode_attn_impl, K16's in-kernel write, bf16)",
         variant_unit("k16w", lambda r: at_unit(r) and r["fmt"] == "bf16")),
        ("decode_attn_write_int8",
         "neural_compressor_tpu_torch/csrc/decode_attention.cu",
         "neural_compressor_tpu/kernels/decode_attention.py:170 "
         "(_decode_attn_quant_impl, K16's in-kernel write, int8)",
         variant_unit("k16w", lambda r: at_unit(r) and r["fmt"] == "int8")),
        ("decode_attn_hbm",
         "neural_compressor_tpu_torch/csrc/decode_attention_hbm.cu",
         "neural_compressor_tpu/kernels/decode_attention.py:364 "
         "(_decode_attn_ro_hbm_impl, K16's bulk-copied caches)",
         variant_unit("k16h", at_unit)),
        ("omlp", "neural_compressor_tpu_torch/csrc/omlp.cu",
         "neural_compressor_tpu/kernels/omlp_matvec.py:250 "
         "(_omlp_impl, K17)", variant_unit("k17", lambda r: r["has_o"])),
        ("attn_o", "neural_compressor_tpu_torch/csrc/attn_o.cu",
         "neural_compressor_tpu/kernels/fused_matvec.py:489 "
         "(_attn_o_impl, K18)", variant_unit("k18", at_unit)),
        ("w4a8_gemm_strided",
         "neural_compressor_tpu_torch/csrc/w4a8_gemm_strided.cu",
         "neural_compressor_tpu/kernels/w4a8_matmul.py:88 (_w4a8_impl, K1, "
         "its own tpu_strided words)", hybrid_unit("k1s", UNIT_M)),
        ("s4_gemm", "neural_compressor_tpu_torch/csrc/s4_gemm.cu",
         "neural_compressor_tpu/kernels/s4_matmul.py:83 (_s4_impl, K2)",
         hybrid_unit("k2", UNIT_M)),
        ("vpu_int8act", "neural_compressor_tpu_torch/csrc/vpu_int8act.cu",
         "neural_compressor_tpu/kernels/dequant_matmul.py:547 "
         "(_vpu_matvec_int_impl, K10)", hybrid_unit("k10", 1)),
    ]
    print(smi, flush=True)
    print("unit of the kernels line: w4a8_gemm = one 128-token prefill "
          "(32 layers x 4 projections + lm_head), its engine_step_m8 one "
          "8-slot engine step (the same at M = 8); s4_gemm's b1_step_m1 one "
          "B=1 decode step (M = 1); fused_gemv = one decode "
          "step (32 x 4 + lm_head); decode_attn = one decode step at "
          "pos 517 (32 layers); batched_decode_attn = one 8-slot decode "
          f"step at positions {SLOT_POS} (32 layers; device_ms beside it, "
          "and beside decode_attn, decode_attn_quant, "
          "batched_decode_attn_quant and paged_attn_v1, from "
          "torch.profiler); paged_attn and "
          "paged_write = the same step over the int8 pool of 128-row pages "
          "(32 layers; paged_write has no single library call for int8); "
          "dequant_gemm = one 8-slot W4A16 decode step (32 x 4 + lm_head "
          "at M = 8), its prefill_m128 one 128-token W4A16 prefill chunk "
          "(the same at M = 128), device_ms beside them from "
          "torch.profiler; vpu_gemv = one B=1 W4A16 decode step (32 x 4 + "
          "lm_head); decode_attn_quant = one B=1 decode step at pos 517 "
          "over the int8 cache (32 layers; fp8 in the log); "
          "batched_decode_attn_quant = the 8-slot step over the int8 "
          "cache (32 layers); paged_attn_fp8/int4 and paged_write_fp8/int4 "
          "= the 8-slot step over the fp8/int4 pool (32 layers; no single "
          "library call writes a quantized row); paged_write and "
          "paged_write_fp8 also count the decode rows K12 writes into "
          "contiguous int8 and fp8 caches. launches: the sum over "
          "the main paths (W4A8: B=1 greedy, the engine contiguous, the "
          "engine paged int8; W4A16: B=1 greedy, the engine contiguous; "
          "W4A16 with quantized KV caches: B=1 greedy over int8 and fp8, "
          "the engine over contiguous int8, fp8 and int4 caches and paged "
          "fp8 and int4 pools; W4A8 speculation: B=1 prompt lookup, the "
          "engine contiguous and paged int8), each counted from 0; "
          "paged_write_window and paged_window_attn = one verify round of "
          f"the 8-slot engine ({SPEC_W}-token windows at {SPEC_POS}) over "
          "the int8 pool (32 layers; index assignment into a bf16 pool and "
          "SDPA over the gathered rows in the log); paged_attn_gemma = one "
          f"8-slot {GEMMA_PRESET} decode step (lengths {GEMMA_POS} + 1, "
          "Hkv 8, rep 2, D 256) over the int8 pool, 42 layers: 21 with the "
          "band and the softcap, 21 with the softcap alone (the library "
          "yardstick SDPA with the band mask and no softcap; every format "
          "in the log), its launches summed over the gemma paths (B=1 "
          "greedy, the engine over paged bf16 and int8 pools); "
          "paged_latent_write and paged_latent_attn = one 8-slot "
          f"{DS_PRESET} decode step (lengths {DS_LENGTHS}, H 128, C 576, "
          "r 512, pages of 128 rows) over the latent pool, 61 layers (the "
          "write's yardstick an index_put_, the attention's SDPA over the "
          "gathered rows), their launches from the deepseek engine path; "
          "paged_attn_v1 = the 8-slot step over the int8 pool under "
          "set_paged_v2(False) (32 layers; bf16 and fp8 in the log); "
          "decode_attn_write, decode_attn_write_int8 and decode_attn_hbm "
          f"= one B=1 decode step at pos {UNIT_POS} over the bf16 (int8) "
          "cache (32 layers); omlp = one decode step's o + gate_up + down "
          "(32 layers; without o in the log); attn_o = one decode step's "
          f"attention and o-projection at pos {UNIT_POS} (32 layers); "
          "their launches from the variant paths (B=1 greedy under each "
          "switch, the 8-slot engine under v1 over paged bf16 and int8); "
          "w4a8_gemm_strided and s4_gemm = one 128-token prefill (32 x 4 + "
          "lm_head) on tpu_strided / s4_rowpack words, vpu_int8act = one B=1 "
          "decode step (32 x 4 + lm_head), their launches from the "
          "hybrid-GPTQ paths (s4: B=1 greedy and the engine contiguous; "
          "tpu_strided under M_INT8_THRESHOLD 2: B=1 greedy)",
          flush=True)
    # second units beside the kernels-line unit: K1's 8-slot engine step
    # (M = 8), K2's B=1 decode step (M = 1)
    second = {"w4a8_gemm": ("engine_step_m8", gemm_step_u),
              "s4_gemm": ("b1_step_m1", hybrid_unit("k2", 1)),
              "dequant_gemm": ("prefill_m128", k8_prefill_u)}

    def fields(u):
        """The line's times; device ms beside them where measured."""
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {k: u[k] for k in keys + (("device_ms",) if u.get(
            "device_ms") is not None else ())}

    kernels_line = {"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[k] for c in by_path.values()
                         for k in LINE_SUMS.get(n, (n,))),
         "max_abs_err": u["max_abs_err"], **fields(u),
         **({second[n][0]: fields(second[n][1])} if n in second else {})}
        for n, src, rep, u in entries]}
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
