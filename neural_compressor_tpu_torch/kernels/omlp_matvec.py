"""The decoder-block megakernel (K17): o-projection, RMSNorm, gate_up with
silu(g)*u and the down-projection of one B=1 W4A8 decode step in one
launch.

Ports ``neural_compressor_tpu/kernels/omlp_matvec.py`` (``_omlp_impl`` /
``_make_kernel``; the switch ``OMLP_FUSED``, ``set_omlp_fused``,
``omlp_fused``, ``mlp_fused`` and the envelope ``_eligible`` /
``_pick_tiles``). The CUDA kernel is ``csrc/omlp.cu``, one cooperative
launch whose phases are split by grid-wide barriers, each phase's weights
streamed through the column stream of ``csrc/w4a8_gemv.cuh`` (K4's) with the
plan of ``omlp_plan``; its workspace (x1, h, the blocks' reductions, the
tile maxima) from ``omlp_workspace``.

Numerics differ from the split K4 path (``kernels/fused_matvec.py``) at
bf16-rounding level, as in JAX: x1 stays float32, h = g * sigmoid(g) * u in
float32, and h is int8-quantized per ``tn_i``-wide tile, one scale a tile
(the split path has one a token). ``tn_i`` comes from the TPU kernel's
``_pick_tiles`` (a VMEM budget there); here it is numerics, so the rule and
the envelope it implies are kept as they are. Group sums run in float64
and round once, as K4's do.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.packing import HOPPER_LAYOUT, PackedWeight
from . import _build
from .dequant_matmul import N_SM
from .fused_matvec import (W4A8_COLS, W4A8_MAX_STAGES, W4A8_SLOT, _n_sm,
                           _pick_tn, _up16, act_codes, group_dot,
                           resident_blocks, w4a8_slot_bytes)
from .w4a8_matmul import MAX_DYN_SMEM

# bytes of weights the ring aims to hold: with every block resident, what
# the producer can issue of the next phase before a grid barrier
OMLP_RING = 192 * 1024

# JAX's switch, read at call time by LlamaDecoderLayer._fused_call
OMLP_FUSED = False


def set_omlp_fused(on: bool) -> None:
    global OMLP_FUSED
    OMLP_FUSED = bool(on)


def omlp_plain(x, residual, rms_w, ow, osc, guw, gusc, dw, dsc, *,
               eps: float, tn_i: int) -> torch.Tensor:
    """Plain PyTorch version of K17. With ``ow`` (the o-projection): x [Ko]
    the attention output, ``residual`` [Kh]; without (``ow`` None): x [Kh]
    is x1 itself. ``rms_w`` float32 [Kh]; "hopper_nk" weights [N, K/2]
    with float32 scales [K/G, N]: ``ow`` [Kh, Ko/2], ``guw`` [2I, Kh/2]
    (gate columns, then up), ``dw`` [Kh, I/2] -> y [Kh] bf16.

    The TPU kernel's order of operations (``_make_kernel``), each group sum
    in float64 rounded once: x1 = f32(acc_o * s) + residual in float32;
    z = x1 * w_rms and its codes, ``ssc = s2 * f32(rsqrt(mean(x1^2) +
    eps))`` (the sum of squares in float64); g, u = acc * ssc; h = g *
    f32(sigmoid(g)) * u; h's codes with one scale a ``tn_i`` tile; y =
    bf16(sum_r dot_r * f32(dsc[r] * hs[tile]) + x1)."""
    f64, f32 = torch.float64, torch.float32
    if ow is not None:
        s, codes = act_codes(x.reshape(-1).to(f32))
        x1 = group_dot(codes, ow, osc) * s + residual.reshape(-1).to(f32)
    else:
        x1 = x.reshape(-1).to(f32)
    Kh = x1.numel()
    ss = torch.sum(x1.to(f64) * x1.to(f64))
    eps64 = torch.tensor(eps, dtype=f32).to(f64)
    inv = (1.0 / torch.sqrt(ss / Kh + eps64)).to(f32)
    s2, codes2 = act_codes(x1 * rms_w)
    acc = group_dot(codes2, guw, gusc) * (s2 * inv)
    I = acc.numel() // 2
    g, u = acc[:I], acc[I:]
    sig = (1.0 / (1.0 + torch.exp(-g.to(f64)))).to(f32)
    h = g * sig * u
    hs = h.reshape(I // tn_i, tn_i).abs().amax(dim=1) * (1.0 / 127)
    hs = torch.where(hs <= 0, torch.ones_like(hs), hs)
    hq = torch.clamp(torch.round(h / hs.repeat_interleave(tn_i)), -128, 127)
    ngd = dsc.shape[0]
    y = group_dot(hq, dw, dsc, gmul=hs.repeat_interleave(ngd // hs.numel()))
    return (y + x1).to(torch.bfloat16)


class OmlpPlan(NamedTuple):
    """How K17 runs one call: ``blocks`` resident blocks (every one, for
    the grid barriers), each owning a contiguous share of each phase's
    columns, walked in tiles of ``cols`` columns, each tile in slots of
    ``upc`` units of 128 codes (o, gate_up, down), through one ring of
    ``stages`` slots of ``slot`` bytes; ``smem`` the launch's dynamic
    shared memory; ``Kh``, ``I`` and ``n_i`` (h's tiles) size the
    workspace."""
    cols: int
    stages: int
    upc_o: int
    upc_g: int
    upc_d: int
    blocks: int
    slot: int
    smem: int
    Kh: int
    I: int
    n_i: int


def omlp_smem(kmax: int, n_i: int, stages: int, slot: int) -> int:
    """``layout(...).total`` of csrc/omlp.cu: the ring and its mbarriers,
    the even and odd codes of the widest activation and their sums per
    128, h's tile scales, the block's tile maxima and h's scale a unit of
    128 codes, the reductions."""
    return (stages * (slot + 16)
            + _up16(_up16(kmax + kmax // 32) + 8 * n_i + kmax // 32) + 96)


@functools.lru_cache(maxsize=1024)
def omlp_plan(Ko: int, Kh: int, I: int, Go: int, Gg: int, Gd: int,
              tn_i: int, has_o: bool, n_sm: int = N_SM) -> OmlpPlan:
    """K17's plan. Raises ValueError on a shape the kernel does not take
    (K and groups multiples of 128, I % tn_i, tn_i % Gd) or whose
    activation codes leave no room for a ring of two slots.

    Tiles of ``W4A8_COLS`` columns; each phase's slot of whole K where it
    fits ``W4A8_SLOT`` (and two fit), the ring of the largest of them, as
    many as take ``OMLP_RING`` bytes and fit; a block an SM."""
    if not (all(k >= 128 and k % 128 == 0 for k in (Ko, Kh, I, Go, Gg, Gd))
            and Ko % Go == 0 and Kh % Gg == 0 and I % Gd == 0
            and tn_i > 0 and I % tn_i == 0 and tn_i % Gd == 0):
        raise ValueError(f"omlp needs K and groups that are multiples of 128 "
                         f"and I % tn_i == tn_i % Gd == 0 (Ko={Ko}, Kh={Kh}, "
                         f"I={I}, groups {Go}/{Gg}/{Gd}, tn_i={tn_i})")
    kmax = max(Ko if has_o else 0, Kh, I)
    n_i = I // tn_i
    avail = MAX_DYN_SMEM - omlp_smem(kmax, n_i, 0, 0) - 16 * W4A8_MAX_STAGES
    upc = []
    for runs, K in ((1, Ko), (2, Kh), (1, I)):
        per_unit = w4a8_slot_bytes(runs, W4A8_COLS, 1)
        upc.append(max(1, min(K // 128,
                              min(W4A8_SLOT, avail // 2) // per_unit)))
    phases = ((1, upc[0]),) * has_o + ((2, upc[1]), (1, upc[2]))
    slot = max(w4a8_slot_bytes(r, W4A8_COLS, u) for r, u in phases)
    stages = min(W4A8_MAX_STAGES, max(2, -(-OMLP_RING // slot)),
                 avail // slot)
    if stages < 2:
        raise ValueError(f"omlp: the activation codes (K {kmax}) leave no "
                         f"room for a ring of two slots")
    smem = omlp_smem(kmax, n_i, stages, slot)
    return OmlpPlan(W4A8_COLS, stages, *upc, resident_blocks(smem, n_sm),
                    slot, smem, Kh, I, n_i)


# (plan, device) -> (buffers, argument block): K17's workspace, float32 x1
# and h, the blocks' float64 sums of x1^2 and max |x1 w_rms|, two sets of
# tile words and the generation word (zeroed: each launch zeroes the set
# the next one takes), the grid barrier's counter (zeroed, only grows).
# Calls on one stream run in order.
_OMLP_SCRATCH: dict = {}


# (device, Ko, Kh, I, Go, Gg, Gd, tn_i, has_o) -> the argument block's
# address: a call's plan and workspace in one lookup
_OMLP_BLOCKS: dict = {}


def omlp_workspace(plan: OmlpPlan, device) -> int:
    """The address of ``nctt_omlp``'s argument block for ``plan`` on
    ``device``: fifteen 64-bit words, the workspace's addresses (x1s, hs,
    ss, am, tiles, gen, bar) and the plan (cols, stages, upc_o, upc_g,
    upc_d, blocks, slot, smem), in the order of ``PlanWord`` in
    csrc/omlp.cu;
    workspace and block are kept per plan and device."""
    have = _OMLP_SCRATCH.get((plan, device))
    if have is not None:
        return have[1][1]
    f32 = torch.float32
    bufs = (torch.empty(plan.Kh, dtype=f32, device=device),
            torch.empty(plan.I, dtype=f32, device=device),
            torch.empty(plan.blocks, dtype=torch.float64, device=device),
            torch.empty(plan.blocks, dtype=f32, device=device),
            torch.zeros(2 * plan.n_i, dtype=torch.int32, device=device),
            torch.zeros(4, dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.int64, device=device))
    words = (ctypes.c_int64 * 15)(
        *(b.data_ptr() for b in bufs), plan.cols, plan.stages, plan.upc_o,
        plan.upc_g, plan.upc_d, plan.blocks, plan.slot, plan.smem)
    _OMLP_SCRATCH[(plan, device)] = (bufs, (words, ctypes.addressof(words)))
    return _OMLP_SCRATCH[(plan, device)][1][1]


def omlp(x, residual, rms_w, ow, osc, guw, gusc, dw, dsc, *, eps: float,
         tn_i: int) -> torch.Tensor:
    """K17 on the card (``csrc/omlp.cu``, one cooperative launch on
    ``omlp_plan``'s plan, its workspace from ``omlp_workspace``); the plain
    version for CPU tensors. Arguments as in ``omlp_plain``."""
    if x.device.type == "cpu":
        return omlp_plain(x, residual, rms_w, ow, osc, guw, gusc, dw, dsc,
                          eps=eps, tn_i=tn_i)
    dev = x.device
    has_o = ow is not None
    Kh = dw.shape[0]
    I = guw.shape[0] // 2
    Ko = x.numel() if has_o else Kh
    Gg, Gd = Kh // gusc.shape[0], I // dsc.shape[0]
    Go = Ko // osc.shape[0] if has_o else Gg
    if not (all(k % 128 == 0 for k in (Ko, Kh, I, Go, Gg, Gd))
            and tn_i > 0 and I % tn_i == 0 and tn_i % Gd == 0):
        raise ValueError(f"omlp needs K and groups that are multiples of 128 "
                         f"and I % tn_i == tn_i % Gd == 0 (Ko={Ko}, Kh={Kh}, "
                         f"I={I}, groups {Go}/{Gg}/{Gd}, tn_i={tn_i})")
    if x.dim() != 1:
        x = x.reshape(-1)
    _build.require(x, "x", torch.bfloat16, dev, (Ko,))
    _build.require(rms_w, "rms_w", torch.float32, dev, (Kh,))
    _build.require(guw, "guw", torch.uint8, dev, (2 * I, Kh // 2))
    _build.require(gusc, "gusc", torch.float32, dev, (Kh // Gg, 2 * I))
    _build.require(dw, "dw", torch.uint8, dev, (Kh, I // 2))
    _build.require(dsc, "dsc", torch.float32, dev, (I // Gd, Kh))
    if has_o:
        if residual.dim() != 1:
            residual = residual.reshape(-1)
        _build.require(residual, "residual", torch.bfloat16, dev, (Kh,))
        _build.require(ow, "ow", torch.uint8, dev, (Kh, Ko // 2))
        _build.require(osc, "osc", torch.float32, dev, (Ko // Go, Kh))
    lib = _build.library()
    key = (dev, Ko, Kh, I, Go, Gg, Gd, tn_i, has_o)
    block = _OMLP_BLOCKS.get(key)
    if block is None:
        block = _OMLP_BLOCKS[key] = omlp_workspace(
            omlp_plan(Ko, Kh, I, Go, Gg, Gd, tn_i, has_o, _n_sm(dev)), dev)
    y = torch.empty(Kh, dtype=torch.bfloat16, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = lib.nctt_omlp(
        x.data_ptr(), ptr(residual if has_o else None), rms_w.data_ptr(),
        ptr(ow), ptr(osc), guw.data_ptr(), gusc.data_ptr(), dw.data_ptr(),
        dsc.data_ptr(), y.data_ptr(), block, Ko, Kh, I,
        Go, Gg, Gd, tn_i, float(eps), int(has_o), _build.stream_handle(dev))
    _build.check(err, "nctt_omlp")
    omlp.launches += 1
    return y


omlp.launches = 0


def _eligible(pw: PackedWeight) -> bool:
    K, N = pw.orig_shape
    G = pw.group_size if pw.group_size > 0 else K
    return (pw.layout == HOPPER_LAYOUT and pw.bits == 4 and pw.dtype == "int"
            and pw.zeros is None and pw.perm is None
            and pw.sq_scales is None
            and K % 8 == 0 and K % G == 0 and G % 128 == 0)


def _pick_tiles(Kh: int, I: int, has_o: bool, Ko: int):
    """Largest hidden/intermediate tiles whose double-buffered blocks fit
    a conservative VMEM budget (the 16 MB scoped-vmem limit minus
    scratches and slack): the TPU kernel's rule, kept as it is because
    ``tn_i`` sets where h's scales change."""
    tn_i = _pick_tn(I)
    if not tn_i:
        return 0, 0
    for tn in (512, 256, 128):
        if Kh % tn:
            continue
        blocks = 2 * (I // 8) * tn * 4            # down u32, double-buffered
        blocks += 4 * (Kh // 8) * tn_i * 4        # gate+up u32
        if has_o:
            blocks += 2 * (Ko // 8) * tn * 4      # o u32
        # f32 scales (same tiling, /8 of the u32 rows at G=128)
        blocks += blocks // 8
        scratch = (I // tn_i) * 8 * tn_i + 2 * 8 * max(Kh, Ko) \
            + (Kh // tn) * 8 * tn * 4
        if blocks + scratch < 11 * 1024 * 1024:
            return tn, tn_i
    return 0, 0


def mlp_fused(x1, pw_gu: PackedWeight, pw_down: PackedWeight, *, rms_w,
              eps: float, out_dtype=None):
    """x2 = x1 + down(silu(g)*u of rmsnorm-fold(x1)) in one launch
    (M == 1). Returns None outside the fused envelope."""
    return _omlp(None, None, None, pw_gu, pw_down, x1=x1, rms_w=rms_w,
                 eps=eps, out_dtype=out_dtype)


def omlp_fused(attn_out, pw_o: PackedWeight, pw_gu: PackedWeight,
               pw_down: PackedWeight, *, residual, rms_w, eps: float,
               out_dtype=None):
    """x2 = x1 + down(silu(g)*u of rmsnorm-fold(x1)), x1 = residual +
    o(attn_out): the post-attention half of a decoder layer in one launch
    (M == 1). Returns None outside the fused envelope."""
    return _omlp(attn_out, pw_o, residual, pw_gu, pw_down, x1=None,
                 rms_w=rms_w, eps=eps, out_dtype=out_dtype)


def _omlp(attn_out, pw_o, residual, pw_gu, pw_down, *, x1, rms_w, eps,
          out_dtype):
    """JAX's envelope (``_omlp``, minus its TPU check); each None it
    returns adds one to ``omlp_fused.declined``."""
    has_o = attn_out is not None
    x = attn_out if has_o else x1
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    Kh, N2 = pw_gu.orig_shape
    I, Nd = pw_down.orig_shape
    Ko = Kh
    ok = (all(d == 1 for d in lead) and N2 == 2 * I and Nd == Kh
          and _eligible(pw_gu) and _eligible(pw_down))
    if ok and has_o:
        Ko, No = pw_o.orig_shape
        ok = No == Kh and _eligible(pw_o)
    tn = tn_i = 0
    if ok:
        tn, tn_i = _pick_tiles(Kh, I, has_o, Ko)
        Gd = pw_down.group_size if pw_down.group_size > 0 else I
        ok = bool(tn) and tn_i % Gd == 0
    if not ok:
        omlp_fused.declined += 1
        return None
    y = omlp(x.reshape(-1), residual, rms_w.to(torch.float32),
             pw_o.packed if has_o else None,
             pw_o.scales if has_o else None, pw_gu.packed, pw_gu.scales,
             pw_down.packed, pw_down.scales, eps=float(eps), tn_i=tn_i)
    return y.to(out_dtype).reshape(*lead, Kh)


omlp_fused.declined = 0
