"""Fused W4A8 decode GEMV (M == 1) with its prologue and epilogues.

In this order, in one launch:
  * optional RMSNorm prologue by scale invariance: per-token symmetric
    int8 codes of ``z = x·w_rms`` equal those of ``x·w_rms/rms``, so the
    kernel quantizes z and multiplies the activation scale by
    ``rsqrt(mean(x²) + eps)``; the normalized activation never exists;
  * int8 activation quantization;
  * the grouped int4 dot (int32 per group, float64 across groups, rounded
    once to float32, where K4 sums groups in float32);
  * epilogues: ``silu(g)·u`` over a concatenated gate_up weight (u is
    column ``n + N/2``), bias, residual; one bf16 store.

Ports ``neural_compressor_tpu/kernels/fused_matvec.py`` ``_fused_impl``
(K4, kernel body ``_make_kernel``). The CUDA kernel is
``csrc/fused_gemv.cu``, on the column stream of ``csrc/w4a8_gemv.cuh``
with the plan of ``w4a8_gemv_plan``; eligibility (``fused_ok``,
``_pick_tn``) follows the JAX module exactly, minus its TPU check.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.packing import HOPPER_LAYOUT, PackedWeight
from . import _build
from .dequant_matmul import N_SM, SM_BLOCK_SMEM, SM_SMEM, SM_THREADS
from .w4a8_matmul import MAX_DYN_SMEM

# K4's plan: the column stream of csrc/w4a8_gemv.cuh (K17's phases share
# it, kernels/omlp_matvec.py omlp_plan). The C entry checks every plan it is
# given against the same rules (``k4_plan_ok``) and refuses the rest.
W4A8_COLS = 8                 # a tile's columns: one a consumer warp (16: two)
W4A8_RING = 96 * 1024         # bytes a block aims to keep in flight
W4A8_SLOT = 48 * 1024         # a ring slot's bytes, at most
W4A8_MAX_STAGES = 8
W4A8_BLOCKS_PER_SM = 1        # resident blocks an SM
W4A8_THREADS = 288            # eight consumer warps and the producer warp
_MIN_RING = 32 * 1024         # the least ring beside codes in shared memory
_RED_BYTES = 96               # the consumers' reductions

# the largest K whose activation codes (and their sums per 128 codes) a
# block keeps in shared memory beside a ring of _MIN_RING. Past it one first
# launch quantizes the activation into global memory, where every block
# reads the codes (from L2): K has no cap.
MAX_K = ((MAX_DYN_SMEM - _RED_BYTES - 16 * W4A8_MAX_STAGES - _MIN_RING)
         * 32 // 33 // 128 * 128)


def _up16(b: int) -> int:
    return -(-b // 16) * 16


def w4a8_slot_bytes(runs: int, cols: int, upc: int) -> int:
    """A ring slot of the column stream (``slot_bytes`` in
    csrc/w4a8_gemv.cuh): ``runs`` x ``cols`` columns of ``upc`` units of
    128 codes (64 bytes each), then a float32 scale a unit and column."""
    return _up16(runs * cols * upc * (64 + 4))


def k4_smem(K: int, stages: int, slot: int, codes_global: bool) -> int:
    """K4's dynamic shared memory (``k4_layout(...).total``): the ring and
    its two mbarriers a slot, the even and odd activation codes and their
    sums per 128 (none where they live in global memory), the reductions."""
    codes = 0 if codes_global else K
    return (_up16(stages * slot + 16 * stages + codes + codes // 32)
            + _RED_BYTES)


class W4A8Plan(NamedTuple):
    """How K4 runs one product: ``blocks`` resident blocks, each owning a
    contiguous share of the output columns, walked in tiles of ``cols``
    columns, each tile in ``chunks`` slots of ``upc`` units of 128 codes,
    streamed through a ring of ``stages`` slots of ``slot`` bytes; ``smem``
    the launch's dynamic shared memory. ``codes_bytes`` > 0 (K past
    ``MAX_K``): a first launch writes the activation codes to global
    scratch of that many bytes."""
    cols: int
    stages: int
    upc: int
    chunks: int
    blocks: int
    slot: int
    smem: int
    codes_bytes: int


def ring_plan(runs: int, nu: int, avail: int):
    """(upc, slot, stages) of a ring in ``avail`` bytes of shared memory for
    products of ``runs`` runs of ``nu`` units: the largest slot up to
    ``W4A8_SLOT`` of which two fit, of whole K where it can; as many slots
    as take ``W4A8_RING`` bytes (2 to ``W4A8_MAX_STAGES``), as fit."""
    per_unit = w4a8_slot_bytes(runs, W4A8_COLS, 1)
    upc = max(1, min(nu, min(W4A8_SLOT, avail // 2) // per_unit))
    slot = w4a8_slot_bytes(runs, W4A8_COLS, upc)
    stages = min(W4A8_MAX_STAGES, max(2, -(-W4A8_RING // slot)),
                 avail // slot)
    return upc, slot, stages


def resident_blocks(smem: int, n_sm: int) -> int:
    """The blocks of ``smem`` bytes the card holds at once, at most
    ``W4A8_BLOCKS_PER_SM`` an SM."""
    return n_sm * max(1, min(W4A8_BLOCKS_PER_SM,
                             SM_SMEM // (smem + SM_BLOCK_SMEM),
                             SM_THREADS // W4A8_THREADS))


@functools.lru_cache(maxsize=4096)
def w4a8_gemv_plan(K: int, N: int, G: int, n_out: int, silu: bool,
                   n_sm: int = N_SM) -> W4A8Plan:
    """K4's plan for x [K] against "hopper_nk" words [N, K/2] in groups of
    G, ``n_out`` outputs (N/2 with silu). Raises ValueError on a shape the
    kernel does not take (K % 128, G % 128, K % G).

    Tiles of ``W4A8_COLS`` columns; the ring of ``ring_plan`` in what the
    codes leave of the block's shared memory; the codes in global memory
    past ``MAX_K``; a block an SM (``W4A8_BLOCKS_PER_SM``), no more blocks
    than tiles."""
    if not (K >= 128 and K % 128 == 0 and G >= 128 and G % 128 == 0
            and K % G == 0 and n_out >= 1
            and N == (2 * n_out if silu else n_out)):
        raise ValueError(f"K4 needs K % 128 == 0, G % 128 == 0, K % G == 0 "
                         f"and N = n_out (2 n_out with silu) (K={K}, N={N}, "
                         f"G={G}, n_out={n_out}, silu={silu})")
    codes_global = K > MAX_K
    avail = (MAX_DYN_SMEM - k4_smem(K, 0, 0, codes_global)
             - 16 * W4A8_MAX_STAGES)
    nu = K // 128
    upc, slot, stages = ring_plan(2 if silu else 1, nu, avail)
    smem = k4_smem(K, stages, slot, codes_global)
    blocks = min(resident_blocks(smem, n_sm), -(-n_out // W4A8_COLS))
    return W4A8Plan(W4A8_COLS, stages, upc, -(-nu // upc), blocks, slot,
                    smem, K if codes_global else 0)


# device -> (codes bytes held, (codes, sums, scales), {plan: argument
# block}): the global scratch of K4 past MAX_K, replaced by a larger one
# (and the argument blocks dropped) when a plan needs more. Calls on one
# stream run in order, so one call's codes are free when the next starts.
_K4_SCRATCH: dict = {}


def w4a8_gemv_workspace(plan: W4A8Plan, device) -> int:
    """The address of ``nctt_fused_gemv``'s argument block for ``plan`` on
    ``device``: ten 64-bit words, the global scratch (codes, sums per 128,
    two scales; null where the codes stay in shared memory) and the plan
    (cols, stages, upc, blocks, slot, smem, global), in the order of
    ``K4Word`` in csrc/w4a8_gemv.cuh; cached per plan and device."""
    have = _K4_SCRATCH.get(device)
    if have is not None:
        block = have[2].get(plan)
        if block is not None:
            return block[1]
    if have is None or have[0] < plan.codes_bytes:
        _K4_BLOCKS.clear()
        n = max(plan.codes_bytes, 0 if have is None else have[0])
        bufs = ((torch.empty(n // 4, dtype=torch.int32, device=device),
                 torch.empty(n // 128, dtype=torch.int32, device=device),
                 torch.empty(2, dtype=torch.float32, device=device))
                if n else None)
        have = (n, bufs, {})
        _K4_SCRATCH[device] = have
    ptrs = ((0, 0, 0) if not plan.codes_bytes
            else tuple(b.data_ptr() for b in have[1]))
    words = (ctypes.c_int64 * 10)(
        *ptrs, plan.cols, plan.stages, plan.upc, plan.blocks, plan.slot,
        plan.smem, int(plan.codes_bytes > 0))
    have[2][plan] = (words, ctypes.addressof(words))
    return have[2][plan][1]


# (device, K, N, G, silu) -> the argument block's address: a call's plan
# and workspace in one lookup (the blocks live in _K4_SCRATCH; a plan that
# grows the scratch there drops the blocks, and this map with them)
_K4_BLOCKS: dict = {}


@functools.lru_cache(maxsize=64)
def _n_sm(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_ok(pw: PackedWeight, n_batch_tokens: int = 1) -> bool:
    """The fused kernel serves single-row decode on symmetric int4
    "hopper_nk" weights with 128-multiple groups and N."""
    K, N = pw.orig_shape
    G = pw.group_size if pw.group_size > 0 else K
    return (pw.layout == HOPPER_LAYOUT and pw.bits == 4
            and pw.dtype == "int" and pw.zeros is None
            and n_batch_tokens == 1 and K % 8 == 0 and K % G == 0
            and G % 128 == 0 and N % 128 == 0)


def _pick_tn(n_out: int, allow_ragged: bool = False) -> int:
    for tn in (512, 256, 128):
        if n_out % tn == 0:
            return tn
    if allow_ragged and n_out > 8192 and n_out % 128 == 0:
        return 512
    return 0


def act_codes(z: torch.Tensor):
    """Per-token symmetric int8 activation codes of float32 ``z``: scale
    ``f32(max |z| * f32(1/127))`` (1 where it is 0; XLA compiles
    ``amax / 127`` as that product) and ``clip(round(z / s), -128, 127)``,
    half to even. Returns (scale, float32 codes)."""
    s = torch.amax(torch.abs(z)) * (1.0 / 127)
    s = torch.where(s <= 0, torch.ones_like(s), s)
    return s, torch.clamp(torch.round(z / s), -128, 127)


def group_dot(codes: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
              gmul: torch.Tensor | None = None) -> torch.Tensor:
    """The grouped int4 dot of one activation row: float32 ``codes`` [K]
    against "hopper_nk" ``w`` [N, K/2] with float32 ``scales`` [K/G, N] ->
    float32 [N]. Each group's int32 dot is exact; times its scale (with
    ``gmul`` [K/G], first multiplied in float32 by ``gmul[g]``) it is summed
    over groups in float64 and rounded once, as ``csrc/gemv_dot.cuh``
    does."""
    from ..ops.packing import unpack_codes_hopper_f32

    f64 = torch.float64
    ng, N = scales.shape
    G = codes.numel() // ng
    wq = unpack_codes_hopper_f32(w).reshape(ng, G, N)
    d = torch.bmm(codes.reshape(ng, 1, G), wq)[:, 0]          # [ng, N] exact
    sc = scales if gmul is None else scales * gmul[:, None]
    return (d.to(f64) * sc.to(f64)).sum(dim=0).to(torch.float32)


def fused_gemv_plain(x, rms_w, w, scales, bias, residual, *, eps: float,
                     silu: bool, out_dtype) -> torch.Tensor:
    """Plain PyTorch version of the kernel. x [K]; rms_w f32 [K] or None;
    w uint8 "hopper_nk" [N, K/2]; scales f32 [K/G, N]; bias f32 [n_out] or
    None; residual [n_out] or None -> [n_out] in ``out_dtype``.

    The sum of squares, the sum over groups and the sigmoid run in float64
    and round once, so the summation order almost never shows and the
    kernel matches this bit for bit."""
    f64 = torch.float64
    xf = x.reshape(-1).to(torch.float32)
    K = xf.shape[0]
    if rms_w is not None:
        ss = torch.sum(xf.to(f64) * xf.to(f64))
        eps64 = torch.tensor(eps, dtype=torch.float32).to(f64)  # as passed
        inv = (1.0 / torch.sqrt(ss / K + eps64)).to(torch.float32)
        z = xf * rms_w
    else:
        inv = torch.ones((), dtype=torch.float32, device=x.device)
        z = xf
    s, codes = act_codes(z)
    ssc = s * inv
    acc = group_dot(codes, w, scales)
    N = scales.shape[1]
    if silu:
        n_out = N // 2
        gacc, uacc = acc[:n_out] * ssc, acc[n_out:] * ssc
        sig = (1.0 / (1.0 + torch.exp(-gacc.to(f64)))).to(torch.float32)
        y = gacc * sig * uacc
    else:
        y = acc * ssc
    if bias is not None:
        y = y + bias
    if residual is not None:
        y = y + residual.reshape(-1).to(torch.float32)
    return y.to(out_dtype)


def fused_gemv(x, rms_w, w, scales, bias, residual, *, eps: float,
               silu: bool, out_dtype) -> torch.Tensor:
    """The fused GEMV on the card (``csrc/fused_gemv.cu``, one launch on
    ``w4a8_gemv_plan``'s plan, two past ``MAX_K``); the plain version for
    CPU tensors. Arguments as in ``fused_gemv_plain``."""
    if x.device.type == "cpu":
        return fused_gemv_plain(x, rms_w, w, scales, bias, residual, eps=eps,
                                silu=silu, out_dtype=out_dtype)
    dev = x.device
    K = x.numel()
    ng, N = scales.shape
    G = K // ng if ng else 0
    n_out = N // 2 if silu else N
    if not (K % 128 == 0 and G % 128 == 0 and ng * G == K
            and (not silu or N % 2 == 0)):
        raise ValueError(f"fused_gemv needs K % 128 == 0 and G % 128 == 0 "
                         f"(K={K}, G={G}, N={N})")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"fused_gemv stores bf16, not {out_dtype}")
    if x.dim() != 1:
        x = x.reshape(K)
    req = _build.require
    req(x, "x", torch.bfloat16, dev, (K,))
    req(w, "w", torch.uint8, dev, (N, K // 2))
    req(scales, "scales", torch.float32, dev, (ng, N))
    ptrs = [None, None, None]
    for i, (t, name, dtype, n) in enumerate((
            (rms_w, "rms_w", torch.float32, K),
            (bias, "bias", torch.float32, n_out),
            (residual, "residual", torch.bfloat16, n_out))):
        if t is not None:
            if t.dim() != 1:
                t = t.reshape(n)
            req(t, name, dtype, dev, (n,))
            ptrs[i] = t.data_ptr()
    lib = _build.library()
    key = (dev, K, N, G, silu)
    block = _K4_BLOCKS.get(key)
    if block is None:
        block = _K4_BLOCKS[key] = w4a8_gemv_workspace(
            w4a8_gemv_plan(K, N, G, n_out, bool(silu), _n_sm(dev)), dev)
    y = torch.empty(n_out, dtype=torch.bfloat16, device=dev)
    err = lib.nctt_fused_gemv(
        x.data_ptr(), ptrs[0], w.data_ptr(), scales.data_ptr(), ptrs[1],
        ptrs[2], y.data_ptr(), block, K, N, G, n_out, int(silu), float(eps),
        _build.stream_handle(dev))
    _build.check(err, "nctt_fused_gemv")
    fused_gemv.launches += 1
    return y


fused_gemv.launches = 0


def fused_matvec(x: torch.Tensor, pw: PackedWeight, *, rms_w=None,
                 eps: float = 0.0, bias=None, residual=None,
                 silu_gate: bool = False, out_dtype=None):
    """y = [rms-norm ->] act-quant -> x @ dequant(Wq) [-> silu(g)*u]
    [+ bias] [+ residual], in one launch (M == 1 only).

    Returns None when the weight or shape is outside the fused envelope;
    callers then take the modular path."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    K, N = pw.orig_shape
    M = 1
    for d in lead:
        M *= d
    if not fused_ok(pw, M):
        return None
    if silu_gate and bias is not None:
        # the epilogue adds the bias after silu(g)*u, which is not the
        # gate_up bias semantics silu(g+b_g)*(u+b_u)
        return None
    n_out = (N // 2) if silu_gate else N
    allow_ragged = (not silu_gate and bias is None and residual is None)
    if not _pick_tn(n_out, allow_ragged=allow_ragged):
        return None
    y = fused_gemv(
        x.reshape(K),
        None if rms_w is None else rms_w.to(torch.float32),
        pw.packed, pw.scales,
        None if bias is None else bias.to(torch.float32),
        None if residual is None else residual.reshape(n_out),
        eps=float(eps), silu=silu_gate, out_dtype=out_dtype)
    return y.reshape(*lead, n_out)


# ---------------------------------------------------------------------------
# K18: B=1 decode attention fused into the o-projection
# ---------------------------------------------------------------------------

# JAX's switch (neural_compressor_tpu/kernels/fused_matvec.py ATTN_O_FUSED),
# read at call time by LlamaDecoderLayer._fused_call
ATTN_O_FUSED = False

# output columns a block of K18's o-projection stage (csrc/attn_o.cu
# oproj_kernel): 256 blocks at llama2-7b's N = 4096
ATTN_O_COLS = 16
# 0: K18's o-projection stage is an ordinary launch after the attention's
# PV launch. 1, a design the sweep measures (tools/decode_attn_sweep.py
# --sweep): a programmatic dependent launch, its weight copies issued while
# the attention runs; they contend with PV's reads, and at llama2-7b's shapes
# the call measured slower than with the ordinary launch (PERF.md)
ATTN_O_DEPENDENT = 0



def attn_o_plain(q, k_cache, v_cache, pos, w, scales, residual,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K18: q [H, D] bf16 (rope applied); bf16
    caches [Hkv, T, D] already holding row ``pos`` (an int or an int32 [1]
    tensor); ``w`` "hopper_nk" [N, H*D/2] with float32 ``scales``
    [H*D/D, N]; ``residual`` [N] -> y [N] bf16.

    The TPU kernel's order (``_make_attn_o_kernel``): each head's attention
    as K5 computes it up to its FLOAT32 output (not rounded to bf16), one
    activation scale over the outputs of all heads, their int8 codes, the
    grouped int4 dot, ``acc * s + residual``. That second half is K4's
    function on the float32 row (``fused_gemv_plain`` without a norm)."""
    from .decode_attention import _attend_plain

    H, D = q.shape
    o = _attend_plain(q[None], k_cache[None], v_cache[None], pos)
    return fused_gemv_plain(o.reshape(H * D), None, w, scales, None,
                            residual, eps=0.0, silu=False,
                            out_dtype=out_dtype)


def attn_o(q, k_cache, v_cache, pos, w, scales, residual) -> torch.Tensor:
    """K18 on the card (``csrc/attn_o.cu``): K5's launches over the bf16
    caches (``decode_attention.decode_plan(1, H, Hkv, T, D, "bf16",
    k6=True)``) with float32 rows and one amax, then the o-projection stage,
    ``ATTN_O_COLS`` columns a block; scratch, the
    rows and the amax word from ``decode_attention.decode_workspace``. The
    plain version for CPU tensors. Arguments as in ``attn_o_plain``; the
    position stays on the device."""
    if q.device.type == "cpu":
        return attn_o_plain(q, k_cache, v_cache, pos, w, scales, residual,
                            q.dtype)
    from .decode_attention import decode_plan, decode_workspace, pos_vector

    dev = q.device
    H, D = q.shape
    Hkv, T, _d = k_cache.shape
    K, N = H * D, w.shape[0]
    rep = H // Hkv if Hkv else 0
    if not (D in (128, 256) and Hkv * rep == H and rep >= 1 and T >= 1
            and N % 128 == 0):
        raise ValueError(f"attn_o needs D 128 or 256 (the group size), H a "
                         f"multiple of Hkv and N % 128 == 0 (H={H}, "
                         f"Hkv={Hkv}, D={D}, N={N})")
    pos = pos_vector(pos, 1, dev)
    _build.require(q, "q", torch.bfloat16, dev, (H, D))
    _build.require(k_cache, "k_cache", torch.bfloat16, dev, (Hkv, T, D))
    _build.require(v_cache, "v_cache", torch.bfloat16, dev, (Hkv, T, D))
    _build.require(w, "w", torch.uint8, dev, (N, K // 2))
    _build.require(scales, "scales", torch.float32, dev, (K // D, N))
    residual = residual.reshape(N)
    _build.require(residual, "residual", torch.bfloat16, dev, (N,))
    plan = decode_plan(1, H, Hkv, T, D, "bf16", True)
    y = torch.empty(N, dtype=torch.bfloat16, device=dev)
    err = _build.library().nctt_attn_o(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        w.data_ptr(), scales.data_ptr(), residual.data_ptr(), y.data_ptr(),
        decode_workspace(plan, dev), H, Hkv, T, D, N, ATTN_O_COLS,
        ATTN_O_DEPENDENT, 1.0 / (D ** 0.5), _build.stream_handle(dev))
    _build.check(err, "nctt_attn_o")
    attn_o.launches += 1
    return y


attn_o.launches = 0


def attn_o_fused(q, k_new, v_new, cache, pos, pw_o: PackedWeight, residual,
                 out_dtype=None):
    """B=1 decode attention and the o-projection in one call of K18.

    q [1, H, 1, D] (rope applied); ``k_new``/``v_new`` [1, Hkv, 1, D];
    ``cache`` a ``KVCache`` ([1, Hkv, T, D] tensors); ``pos`` an int or a
    [1] tensor; ``pw_o`` the o-projection's symmetric int4 "hopper_nk"
    weight; ``residual`` [1, 1, N]. Writes the new row into the cache IN
    PLACE before the launch (JAX writes it after, outside the kernel), then
    returns (y [1, 1, N], cache). Returns None outside JAX's envelope, and
    counts it in ``attn_o_fused.declined``: a cache of two tensors of bf16
    or float32, q's dtype; the weight in ``fused_ok``'s envelope with
    G == D, K == H*D and ``_pick_tn(N)``; B = S = 1. The caller then takes
    the split attention-then-o path (and checks the o bias, as JAX's
    caller does)."""
    from ..models.llama import KVCache, _update_rows

    B, H, S, D = q.shape
    ok = isinstance(cache, tuple) and len(cache) == 2 and B == 1 and S == 1
    if ok:
        k_cache, v_cache = cache
        K, N = pw_o.orig_shape
        G = pw_o.group_size if pw_o.group_size > 0 else K
        ok = (fused_ok(pw_o, 1) and G == D and K == H * D
              and k_cache.dtype in (torch.bfloat16, torch.float32)
              and k_cache.dtype == q.dtype and bool(_pick_tn(N)))
    if not ok:
        attn_o_fused.declined += 1
        return None
    k_cache = _update_rows(k_cache, k_new, pos)
    v_cache = _update_rows(v_cache, v_new, pos)
    y = attn_o(q[0, :, 0].contiguous(), k_cache[0], v_cache[0], pos,
               pw_o.packed, pw_o.scales, residual.reshape(N))
    return y.to(out_dtype or q.dtype).reshape(1, 1, N), KVCache(k_cache, v_cache)


attn_o_fused.declined = 0
