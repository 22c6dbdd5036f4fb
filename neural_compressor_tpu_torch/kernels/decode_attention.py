"""Single-token decode attention over a head-major KV cache: B=1 over bf16
(K5, or K16 with the cache write or the bulk copies inside the kernel) and
over int8/fp8 codes (K6, or K16's int8 write), and batched with per-slot
positions over bf16 or int8/fp8 codes (K7).

q [B, H, D] against caches [B, Hkv, T, D]; the ``rep = H / Hkv`` query
heads of a KV head share its rows (GQA). Scores are float32 times
``1/sqrt(D)``, keys after ``pos`` are masked out, the softmax
probabilities are cast to bf16 before the PV product. The TPU kernels sum
in float32; the port sums in float64 over the exact products and rounds
once, so the summation order almost never shows (the two differ by less
than float32's rounding).

Ports ``neural_compressor_tpu/kernels/decode_attention.py``:
  * K5, ``_decode_attn_ro_impl`` / ``_kernel_ro`` (``decode_attn``,
    ``csrc/decode_split.cu``: K6's split of the keys over bf16 rows, its
    plan ``decode_plan(..., "bf16", k6=True)``). The TPU kernel reads the
    cache read-only and folds the new K/V row in by a select at ``pos``; JAX
    writes that row into the cache right after the kernel. The port writes
    the row into the cache first, in place, and then attends: the kernel
    sees the same values (the select uses the row cast to the cache
    dtype), and the cache is updated without a copy. It visits only the
    rows ``t <= pos``, which is what the -1e30 mask leaves of the softmax.
    Per-slot positions are an int32 [B] tensor read on the device, as the
    TPU kernel's grid (B, Hkv) reads ``pos_ref[b]``: a one-slot engine's
    decode runs here, as JAX's dispatch sends every B=1 call to K5. At
    ``pos >= T`` it attends all T rows.
  * K6, ``_decode_attn_quant_ro_impl`` / ``_kernel_q_ro``
    (``decode_attn_quant``, ``csrc/decode_split.cu``, its keys split across
    blocks by ``decode_plan``): K5 over int8 or fp8-e4m3 codes with
    per-(token, head) float32 scales.
    The scores are ``f32(q . code) * f32(k_scale * D^-1/2)``, the
    normalised probabilities times ``v_scale`` are cast to bf16 for PV.
    The new row is folded in RAW (bf16, scale 1) at ``pos``: the kernel
    never reads the cache there, so its codes may be written before or
    after (``decode_attention_quant`` writes them after, as JAX does).
    Per-slot positions are read on the device; at ``pos >= T`` (a slot
    running on past its end inside a multi-step dispatch) it attends all
    T code rows and no raw row, as the TPU kernel's mask leaves them.
  * K7, ``_batched_attn_impl`` / ``_kernel_batched``
    (``batched_decode_attn``, bf16 caches or int8/fp8 codes, its launches
    counted per format; ``csrc/decode_split.cu``, split as K6): per-slot
    ``pos`` [B] read on the device, and K7's order of operations, which
    normalises after PV (K5 normalises before the bf16 cast); scales
    multiply the scores before ``D^-1/2`` and the probabilities before
    the bf16 cast.

  * K16, the flag-selected B=1 variants (``set_cache_write_mode``,
    ``set_ro_cache_space``):
      - ``"kernel"`` write mode: ``_decode_attn_impl`` / ``_kernel``
        (bf16) and ``_decode_attn_quant_impl`` / ``_kernel_q`` (int8),
        ``decode_attn_write`` (``csrc/decode_attention.cu``): K5's launches
        (bf16) or K6's (int8) on ``decode_plan(..., k6=True)``. The kernel
        stores the new row at ``pos`` and attends it from its inputs. bf16
        stages the new row in place of the cache's and equals K5 plus the
        outside write bit for bit. int8 quantizes the row by the TPU
        kernel's own rule, ``scale = max(amax, 1e-6) / 127`` and codes
        clipped to +-127 (``_kv_quant`` takes ``amax <= 0 -> 1`` and
        clips to -128), and attends the QUANTIZED row (codes times the new
        scale) where K6 attends the raw one. fp8 caches stay on K6 plus
        the outside write, as in JAX;
      - ``"hbm"`` cache space: ``_decode_attn_ro_hbm_impl`` /
        ``_kernel_ro_hbm``, ``decode_attn_hbm``
        (``csrc/decode_attention_hbm.cu``): K5's math with the rows brought
        into shared memory by bulk copies the kernel issues itself, equal
        to K5 bit for bit. ``"pin"`` is a TPU placement with no kernel of
        its own: on Hopper it takes K5, as does ``"vmem"``.
    The port reads the switches at call time (JAX at trace time).

The CUDA kernels keep each query row's float32 scores over the visited rows
in a workspace in device memory (the split's scratch, or
``score_workspace`` for K16's bulk copies), not in a block's shared
memory, so they take contexts of any length, as the TPU kernels do (their
chunked online softmax has no such limit either). K5, K6, K7, K16's write
and K18's attention (``kernels/fused_matvec.py`` ``attn_o``) cut each
slot's keys into parts of a fixed size (``decode_plan``) that blocks take
in parallel: scores and part maxima, then p against the row's global
maximum, float64 PV partials and their fold in ascending part order, so
the split moves no bit (``tests/test_torch_decode_split.py`` and
``tests/test_torch_variant_split.py`` emulate it). Their scratch and the
C entries' argument block come from ``decode_workspace``, cached per plan
and device: a call allocates its output and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build


# head widths the attention kernels take: any D up to 256 (K5's lanes hold
# DPL = ceil(D / 32) elements of a row, DPL 1-8; K6, K7 and K11 stage whole
# rows, D 128 and 256 with copies of their own)
KERNEL_D = range(1, 257)
# K7 also takes the widths around 384 and 512, the D % 128 == 0 widths that
# JAX's K7 dispatch runs (four columns a PV thread)
BATCHED_KERNEL_D = (*KERNEL_D, *range(353, 385), *range(481, 513))


def score_workspace(B: int, rows: int, T: int, device) -> torch.Tensor:
    """The float32 score rows [B, rows, T] that K16's bulk-copy kernel and
    K11 keep in device memory instead of shared memory, so that no context
    length is too long for a block."""
    return torch.empty((B, rows, T), dtype=torch.float32, device=device)


def _attend_plain(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos) -> torch.Tensor:
    """K5's attention up to its float32 output [B, H, D] (K18 quantizes it
    unrounded). ``pos`` an int or int32 [B]; a slot at ``pos >= T``
    attends every row."""
    B, H, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    f64 = torch.float64
    dev = q.device
    last = pos_vector(pos, B, dev).to(torch.int64).clamp(0, T - 1)
    valid = (torch.arange(T, device=dev)[None, :]
             <= last[:, None])[:, None, None, :]               # [B,1,1,T]
    qr = q.reshape(B, Hkv, rep, D).to(f64)
    s = torch.einsum("bgrd,bgtd->bgrt", qr, k_cache.to(f64)).to(
        torch.float32) * (1.0 / (D ** 0.5))
    s = torch.where(valid, s, torch.tensor(-1e30, device=dev))
    e = torch.exp(s.to(f64) - s.amax(dim=-1, keepdim=True).to(f64))
    e = torch.where(valid, e, torch.zeros((), dtype=f64, device=dev))
    p = (e / e.sum(dim=-1, keepdim=True)).to(torch.float32).to(v_cache.dtype)
    o = torch.einsum("bgrt,bgtd->bgrd", p.to(f64), v_cache.to(f64))
    return o.to(torch.float32).reshape(B, H, D)


def decode_attn_plain(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos) -> torch.Tensor:
    """Plain PyTorch version of K5: q [B, H, D]; caches [B, Hkv, T, D]
    already holding row ``pos``; ``pos`` an int or an int32 [B] tensor of
    per-slot positions (a slot at ``pos >= T`` attends all T rows) ->
    [B, H, D] in q's dtype.

    Sums run in float64 over exact bf16 products and round once, so the
    summation order almost never shows and the kernel matches it bit for
    bit."""
    return _attend_plain(q, k_cache, v_cache, pos).to(q.dtype)


def _check_b1(name: str, q, k_cache, D_ok) -> tuple:
    B, H, D = q.shape
    _b, Hkv, T, _d = k_cache.shape
    rep = H // Hkv if Hkv else 0
    if not (D_ok(D) and Hkv * rep == H and rep >= 1 and T >= 1):
        raise ValueError(f"{name} needs 1 <= D <= 256 and H a multiple of "
                         f"Hkv (H={H}, Hkv={Hkv}, D={D}, T={T})")
    return B, H, Hkv, T, D


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos) -> torch.Tensor:
    """K5 on the card (``csrc/decode_split.cu``, ``nctt_decode_attention``:
    K6's two or three CUDA launches a call over bf16 rows, as
    ``decode_plan(..., "bf16", k6=True)`` says); the plain version for CPU
    tensors. Arguments as in ``decode_attn_plain``; the positions go to the
    kernel as an int32 [B] tensor on the device (an int is made one; a
    tensor is not read back)."""
    if q.device.type == "cpu":
        return decode_attn_plain(q, k_cache, v_cache, pos)
    dev = q.device
    B, H, Hkv, T, D = _check_b1("decode_attn", q, k_cache,
                                lambda d: d in KERNEL_D)
    pos = pos_vector(pos, B, dev)
    _build.require(q, "q", torch.bfloat16, dev, (B, H, D))
    _build.require(k_cache, "k_cache", torch.bfloat16, dev, (B, Hkv, T, D))
    _build.require(v_cache, "v_cache", torch.bfloat16, dev, (B, Hkv, T, D))
    plan = decode_plan(B, H, Hkv, T, D, "bf16", True)
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    err = _build.library().nctt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), decode_workspace(plan, dev), B, H, Hkv, T, D,
        1.0 / (D ** 0.5), _build.stream_handle(dev))
    _build.check(err, "nctt_decode_attention")
    decode_attn.launches += 1
    return out


decode_attn.launches = 0


# K16's switches, JAX's names and values; read at call time
_WRITE_MODE = "outside"  # "kernel" (write inside the kernel) | "outside"
_RO_CACHE_SPACE = "vmem"  # "vmem" | "hbm" (bulk copies) | "pin"


def set_cache_write_mode(mode: str) -> None:
    """"outside" (default): the port writes the new row into the cache and
    K5/K6 attend; "kernel": K16 writes it inside the kernel (bf16 and int8
    caches at B=1; fp8 stays on K6 and the outside write)."""
    global _WRITE_MODE
    if mode not in ("kernel", "outside"):
        raise ValueError(f"cache write mode {mode!r}")
    _WRITE_MODE = mode


def set_ro_cache_space(space: str) -> None:
    """Where JAX's read-only B=1 kernel keeps its cache operands. On
    Hopper: "hbm" takes K16's kernel, which copies the caches into shared
    memory itself by bulk copies; "vmem" and "pin" (a TPU placement with no
    kernel of its own) take K5."""
    global _RO_CACHE_SPACE
    if space not in ("vmem", "hbm", "pin"):
        raise ValueError(f"read-only cache space {space!r}")
    _RO_CACHE_SPACE = space


def decode_attn_hbm_plain(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos) -> torch.Tensor:
    """Plain PyTorch version of K16's bulk-copy kernel: K5's function
    (``decode_attn_plain``), which the kernel computes in K5's order."""
    return decode_attn_plain(q, k_cache, v_cache, pos)


def decode_attn_hbm(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos) -> torch.Tensor:
    """K16's bulk-copy kernel on the card (``csrc/decode_attention_hbm.cu``);
    the plain version for CPU tensors. Arguments as in ``decode_attn``;
    rows must be 16-byte multiples (D % 8 == 0) for the bulk copy."""
    if q.device.type == "cpu":
        return decode_attn_hbm_plain(q, k_cache, v_cache, pos)
    dev = q.device
    B, H, Hkv, T, D = _check_b1("decode_attn_hbm", q, k_cache,
                                lambda d: d in KERNEL_D and d % 8 == 0)
    pos = pos_vector(pos, B, dev)
    _build.require(q, "q", torch.bfloat16, dev, (B, H, D))
    _build.require(k_cache, "k_cache", torch.bfloat16, dev, (B, Hkv, T, D))
    _build.require(v_cache, "v_cache", torch.bfloat16, dev, (B, Hkv, T, D))
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    ws = score_workspace(B, H, T, dev)
    err = _build.library().nctt_decode_attention_hbm(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        ws.data_ptr(), B, H, Hkv, T, D, pos.data_ptr(), 1.0 / (D ** 0.5),
        _build.stream_handle(dev))
    _build.check(err, "nctt_decode_attention_hbm")
    decode_attn_hbm.launches += 1
    return out


decode_attn_hbm.launches = 0


def k16_quant_row(x: torch.Tensor):
    """The TPU write kernel's int8 rule for new rows x [..., D]: scale =
    f32(max(amax, 1e-6) * f32(1/127)) (XLA multiplies by the reciprocal),
    codes = clip(round(x / scale), -127, 127). Not ``_kv_quant``'s rule,
    which takes scale 1 at amax 0 and clips to -128. Returns (int8 codes,
    float32 scales [...])."""
    xf = x.to(torch.float32)
    s = torch.clamp_min(xf.abs().amax(dim=-1), 1e-6) * (1.0 / 127)
    codes = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return codes.to(torch.int8), s


def _write_rows_at(pos: torch.Tensor, T: int, pairs) -> None:
    """Store each slot's row at ``pos[b] < T`` in place: ``pairs`` of
    (cache [B, Hkv, T, ...], rows [B, Hkv, ...]); a slot at or past T
    stores nothing, as the TPU kernel's select finds no row."""
    for b in range(pos.shape[0]):
        p = int(pos[b])
        if 0 <= p < T:
            for cache, rows in pairs:
                cache[b, :, p] = rows[b].to(cache.dtype)


def decode_attn_write_plain(q, k_new, v_new, k_cache, k_scale, v_cache,
                            v_scale, pos) -> torch.Tensor:
    """Plain PyTorch version of K16's in-kernel write: q [B, H, D] bf16;
    ``k_new``/``v_new`` [B, Hkv, D] bf16; bf16 caches [B, Hkv, T, D]
    (scales None) or int8 codes with float32 scales [B, Hkv, T]; ``pos``
    an int or int32 [B]. Stores each slot's new row at ``pos < T`` IN PLACE
    (int8: ``k16_quant_row``'s codes and scale) and returns the attention
    over the cache so written -> [B, H, D] bf16: bf16 is K5's function,
    int8 K6's with the quantized row at pos (codes times the new scale)
    where K6 has the raw one."""
    B, T = q.shape[0], k_cache.shape[2]
    p = pos_vector(pos, B, q.device)
    if k_scale is None:
        _write_rows_at(p, T, ((k_cache, k_new), (v_cache, v_new)))
        return decode_attn_plain(q, k_cache, v_cache, p)
    kc, ks = k16_quant_row(k_new)
    vc, vs = k16_quant_row(v_new)
    _write_rows_at(p, T, ((k_cache, kc), (k_scale, ks), (v_cache, vc),
                          (v_scale, vs)))
    return decode_attn_quant_plain(q, None, None, k_cache, k_scale, v_cache,
                                   v_scale, p)


# cache format -> (name, csrc/decode_attention.cu's code) of K16's write
_K16_FORMATS = {torch.bfloat16: ("bf16", 0), torch.int8: ("int8", 1)}


def decode_attn_write(q, k_new, v_new, k_cache, k_scale, v_cache, v_scale,
                      pos) -> torch.Tensor:
    """K16's in-kernel write on the card (``csrc/decode_attention.cu``,
    ``nctt_decode_attention_write``: K5's two or three CUDA launches a call
    for bf16, K6's for int8, as ``decode_plan(..., k6=True)`` says, the
    new rows stored by the launches; scratch from ``decode_workspace``);
    the plain version for CPU tensors. Arguments as in
    ``decode_attn_write_plain``; the positions stay on the device. Launches
    are counted per cache format in ``decode_attn_write.launches``."""
    if q.device.type == "cpu":
        return decode_attn_write_plain(q, k_new, v_new, k_cache, k_scale,
                                       v_cache, v_scale, pos)
    dev = q.device
    B, H, Hkv, T, D = _check_b1("decode_attn_write", q, k_cache,
                                lambda d: d in KERNEL_D)
    cdt = k_cache.dtype
    fmt, code = _K16_FORMATS.get(cdt, (None, None))
    if fmt is None or (code == 0) != (k_scale is None):
        raise ValueError(f"decode_attn_write takes bf16 caches, or int8 "
                         f"codes with scales, not {cdt}")
    pos = pos_vector(pos, B, dev)
    _build.require(q, "q", torch.bfloat16, dev, (B, H, D))
    _build.require(k_new, "k_new", torch.bfloat16, dev, (B, Hkv, D))
    _build.require(v_new, "v_new", torch.bfloat16, dev, (B, Hkv, D))
    _build.require(k_cache, "k_cache", cdt, dev, (B, Hkv, T, D))
    _build.require(v_cache, "v_cache", cdt, dev, (B, Hkv, T, D))
    if code:
        _build.require(k_scale, "k_scale", torch.float32, dev, (B, Hkv, T))
        _build.require(v_scale, "v_scale", torch.float32, dev, (B, Hkv, T))
    plan = decode_plan(B, H, Hkv, T, D, fmt, True)
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    err = _build.library().nctt_decode_attention_write(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        k_scale.data_ptr() if code else None, v_cache.data_ptr(),
        v_scale.data_ptr() if code else None, pos.data_ptr(), out.data_ptr(),
        decode_workspace(plan, dev), B, H, Hkv, T, D, code, 1.0 / (D ** 0.5),
        _build.stream_handle(dev))
    _build.check(err, "nctt_decode_attention_write")
    decode_attn_write.launches[fmt] += 1
    return out


decode_attn_write.launches = dict.fromkeys(("bf16", "int8"), 0)


def decode_attention(q, k_new, v_new, k_cache, v_cache, pos):
    """Single-token attention with cache update.

    q [B, H, 1, D]; k_new/v_new [B, Hkv, 1, D] (rope applied); caches
    [B, Hkv, T, D]; ``pos`` an int, or a [B] tensor of per-slot positions.
    B == 1 goes to the B=1 kernels, whatever the type of ``pos``, as JAX's
    dispatch sends it (``use_fused_decode_attention(1)``): under
    ``set_cache_write_mode("kernel")`` K16 writes the row and attends;
    otherwise the new rows are written into the caches IN PLACE and K5
    attends (K16's bulk-copy kernel under ``set_ro_cache_space("hbm")``).
    B > 1 writes the rows and takes K7 (``batched_decode_attention``).
    Returns (out [B, H, 1, D], k_cache, v_cache); out is None where
    ``batched_decode_attention`` declines, and the caller attends the
    updated caches itself."""
    from ..models.llama import _update_rows

    B, H, S, D = q.shape
    if S != 1:
        raise ValueError("decode attention is single-token")
    if B == 1 and _WRITE_MODE == "kernel":
        out = decode_attn_write(q[:, :, 0].contiguous(),
                                k_new[:, :, 0].contiguous(),
                                v_new[:, :, 0].contiguous(), k_cache, None,
                                v_cache, None, pos)
        return out[:, :, None], k_cache, v_cache
    k_cache = _update_rows(k_cache, k_new, pos)
    v_cache = _update_rows(v_cache, v_new, pos)
    if B != 1:
        return (batched_decode_attention(q, k_cache, v_cache, pos),
                k_cache, v_cache)
    attend = decode_attn_hbm if _RO_CACHE_SPACE == "hbm" else decode_attn
    out = attend(q[:, :, 0].contiguous(), k_cache, v_cache, pos)
    return out[:, :, None], k_cache, v_cache


# ---------------------------------------------------------------------------
# K5's, K6's and K7's split of the keys (csrc/decode_split.cu)
# ---------------------------------------------------------------------------


class DecodePlan(NamedTuple):
    """How K5, K6, K7, K16's write and K18's attention cut one call
    (``decode_plan``): query-row groups, key parts, the blocks' ring and
    threads, and the scratch's sizes."""
    groups: int          # ng: groups of query rows a (slot, KV head)
    group_rows: int      # gs: rows a group, at most 8 (6 past D 384)
    part_keys: int       # keys a part: whole 64-row tiles from key 0 on
    parts: int           # parts over the cache's T rows
    stages: int          # tiles of a block's cp.async ring
    threads: int         # threads a block
    lsum: int            # K5, K6: 1 = a third launch sums each part's exp
    grid: tuple          # (parts, Hkv * groups, B), every launch
    scores: int          # float32 score rows, B * H * T
    maxima: int          # float32 part maxima (K6's part sums: float64)
    partials: int        # float64 partials: acc, then l
    tickets: int         # int32 tickets, one a (slot, KV head, group)
    outputs: int         # K18's float32 attention rows, B * H * D


# keys a part holds where T <= MAX_PARTS * PART_KEYS (whole 64-row tiles);
# longer caches take longer parts, so a slot has at most MAX_PARTS
PART_KEYS = 128
MAX_PARTS = 64
RING_STAGES = 4        # tiles a block's ring holds at most
THREADS_D128 = 128     # threads a block at D 128 with single-row groups
LSUM_PARTS = 8         # K5, K6: past this many parts, l's sums launch apart
_TILE = 64
_MAX_DYN = 232448 - 8192   # csrc/decode_split.cuh MAX_DYN
_ESIZE = {"bf16": 2, "int8": 1, "fp8_e4m3": 1}


def _smem(D: int, esize: int, rows: int, stages: int, threads: int,
          cpt: int) -> int:
    """The larger of the two launches' dynamic shared memory
    (``scores_smem`` and ``pv_smem`` in csrc/decode_split.cuh)."""
    nc = -(-D * esize // 16)
    ring = stages * _TILE * (nc | 1) * 16
    if D in (128, 256):                 # the compile-time copies
        ct = -(-D // cpt)               # columns, in whole warps
        nsg = min(4, max(2, threads // (-(-ct // 32) * 32)))
    else:
        nsg = 2
    scores = ring + 8 * (rows * nc * (16 // esize)
                         + threads // 32 * rows * _TILE)
    pv = max(ring, 8 * (nsg - 1) * rows * D) + 8 * rows * _TILE
    return max(scores, pv)


@functools.lru_cache(maxsize=256)
def decode_plan(B: int, H: int, Hkv: int, T: int, D: int, fmt: str,
                k6: bool = False) -> DecodePlan:
    """K6's (``k6``; K5's at "bf16") or K7's plan for q [B, H, D] over a
    [B, Hkv, T, D] cache of ``fmt`` ("bf16", "int8" or "fp8_e4m3"). A
    (slot, KV head)'s H/Hkv query rows split into the fewest groups of at
    most 8 rows (6 past D 384), as even as they go; a slot's keys into
    parts of ``part_keys`` keys. Part boundaries are absolute key positions that depend on T
    alone, never on B, rep, the positions or the other slots, so a row's
    terms are summed in the same order whatever else shares the launch."""
    rep = H // Hkv
    ng = -(-rep // (6 if D > 384 else 8))
    gs = -(-rep // ng)
    part_keys = max(PART_KEYS, -(-T // (MAX_PARTS * _TILE)) * _TILE)
    parts = -(-T // part_keys)
    threads = (THREADS_D128 if gs == 1 else 128) if D == 128 else 256
    cpt = 4 if D > 256 else 2
    stages = min(RING_STAGES, part_keys // _TILE)
    while stages > 1 and _smem(D, _ESIZE[fmt], gs, stages, threads,
                               cpt) > _MAX_DYN:
        stages -= 1
    return DecodePlan(ng, gs, part_keys, parts, stages, threads,
                      int(k6 and parts > LSUM_PARTS), (parts, Hkv * ng, B),
                      B * H * T, B * H * parts, B * H * parts * (D + 1),
                      B * Hkv * ng, B * H * D)


# device -> (sizes held, buffers, {plan: argument block}): the split's own
# scratch, flat: score rows and part maxima (float32), partials and K6's
# part sums (float64, the latter of the maxima's size), tickets (int32,
# kept zeroed), K18's float32 attention rows and its amax word (zeroed by
# each call's first launch), replaced by larger ones (and the argument
# blocks dropped) when a call needs more. Calls on one stream run in order,
# so one call's scratch is free when the next starts; the folding blocks
# reset their tickets to 0.
_SCRATCH: dict = {}


def decode_workspace(plan: DecodePlan, device) -> int:
    """The address of the argument block of the split's C entries (K5, K6,
    K7, K16's write, K18) for ``plan`` on ``device``: thirteen 64-bit
    words, the scratch's addresses (score rows, part maxima, partials, K6's
    part sums, tickets, K18's attention rows and amax word) and the plan
    (groups, part keys, parts, stages, threads, lsum), in the order of
    ``PlanWord`` in csrc/decode_split.cuh. The scratch is flat buffers of
    at least the plan's sizes kept per device between calls; the blocks
    are cached per plan."""
    have = _SCRATCH.get(device)
    if have is not None:
        block = have[2].get(plan)
        if block is not None:
            return block[1]
    need = (plan.scores, plan.maxima, plan.partials, max(plan.tickets, 1024),
            plan.outputs)
    if have is None or any(h < n for h, n in zip(have[0], need)):
        n = need if have is None else tuple(map(max, have[0], need))
        bufs = (torch.empty(n[0], dtype=torch.float32, device=device),
                torch.empty(n[1], dtype=torch.float32, device=device),
                torch.empty(n[2], dtype=torch.float64, device=device),
                torch.empty(n[1], dtype=torch.float64, device=device),
                torch.zeros(n[3], dtype=torch.int32, device=device),
                torch.empty(n[4], dtype=torch.float32, device=device),
                torch.zeros(4, dtype=torch.int32, device=device))
        have = (n, bufs, {})
        _SCRATCH[device] = have
    words = (ctypes.c_int64 * 13)(
        *(b.data_ptr() for b in have[1]), plan.groups, plan.part_keys,
        plan.parts, plan.stages, plan.threads, plan.lsum)
    have[2][plan] = (words, ctypes.addressof(words))
    return have[2][plan][1]


# ---------------------------------------------------------------------------
# K6: B=1 attention over int8/fp8 codes, the raw new row folded in at pos
# ---------------------------------------------------------------------------

_CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)


def _as_f64(codes: torch.Tensor) -> torch.Tensor:
    """Cache rows (bf16, int8 or fp8 codes) as float64, exactly."""
    if codes.dtype == torch.float8_e4m3fn:
        codes = codes.to(torch.bfloat16)
    return codes.to(torch.float64)


def pos_vector(pos, B: int, device) -> torch.Tensor:
    """``pos`` (an int, or a tensor of one or B positions) as a contiguous
    int32 [B] tensor on ``device``; a tensor is not read back."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((B,), int(pos), dtype=torch.int32, device=device)
    if (pos.dtype == torch.int32 and pos.shape == (B,)
            and pos.device == device and pos.is_contiguous()):
        return pos                     # already what the kernels read
    return pos.reshape(-1).to(device=device,
                              dtype=torch.int32).expand(B).contiguous()


def decode_attn_quant_plain(q, k_new, v_new, k_codes, k_scale, v_codes,
                            v_scale, pos) -> torch.Tensor:
    """Plain PyTorch version of K6: q [B, H, D] bf16; ``k_new``/``v_new``
    [B, Hkv, D] bf16, the raw new rows (None: the codes at ``pos`` are
    attended as written, K16's int8 write); codes [B, Hkv, T, D] int8 or fp8;
    scales [B, Hkv, T] float32; ``pos`` an int or int32 [B] -> [B, H, D]
    bf16. Row ``pos[b]`` is the raw new row with scale 1, whatever the
    cache holds there; a slot at ``pos >= T`` attends all T code rows and
    no raw row, as the TPU kernel's mask leaves them.

    ``_kernel_q_ro``'s order of operations: ``s = f32(q . k) *
    f32(k_scale * D^-1/2)``, keys after ``pos`` masked, ``p =
    f32(exp(s - m) / l) * v_scale`` rounded to bf16 for PV. Sums in float64
    over exact products, rounded once, as the CUDA kernel does."""
    B, H, D = q.shape
    Hkv, T = k_codes.shape[1], k_codes.shape[2]
    rep = H // Hkv
    f64, f32 = torch.float64, torch.float32
    dev = q.device
    p = pos_vector(pos, B, dev).to(torch.int64)
    t = torch.arange(T, device=dev)[None, :]
    valid = (t <= p.clamp(0, T - 1)[:, None])[:, None, None]  # [B,1,1,T]
    k, v, ks, vs = _as_f64(k_codes), _as_f64(v_codes), k_scale, v_scale
    if k_new is not None:
        raw = (t == p[:, None])[:, None, :]                   # [B, 1, T]
        k = torch.where(raw[..., None], k_new.to(f64)[:, :, None], k)
        v = torch.where(raw[..., None], v_new.to(f64)[:, :, None], v)
        one = torch.ones((), dtype=f32, device=dev)
        ks = torch.where(raw, one, k_scale)
        vs = torch.where(raw, one, v_scale)
    scale = torch.tensor(1.0 / (D ** 0.5), dtype=f32)
    qr = q.reshape(B, Hkv, rep, D).to(f64)
    s = torch.einsum("bgrd,bgtd->bgrt", qr, k).to(f32) \
        * (ks * scale)[:, :, None, :]
    s = torch.where(valid, s, torch.tensor(-1e30, device=dev))
    e = torch.exp(s.to(f64) - s.amax(dim=-1, keepdim=True).to(f64))
    e = torch.where(valid, e, torch.zeros((), dtype=f64, device=dev))
    pr = (e / e.sum(dim=-1, keepdim=True)).to(f32) * vs[:, :, None, :]
    o = torch.einsum("bgrt,bgtd->bgrd", pr.to(torch.bfloat16).to(f64), v)
    return o.to(f32).reshape(B, H, D).to(q.dtype)


def decode_attn_quant(q, k_new, v_new, k_codes, k_scale, v_codes, v_scale,
                      pos) -> torch.Tensor:
    """K6 on the card (``csrc/decode_split.cu``,
    ``nctt_decode_attention_quant``: two or three CUDA launches a call, as
    ``decode_plan`` says); the plain version for CPU tensors. Arguments as
    in ``decode_attn_quant_plain``; ``pos`` stays on the device (the kernel
    reads it, no host sync)."""
    if q.device.type == "cpu":
        return decode_attn_quant_plain(q, k_new, v_new, k_codes, k_scale,
                                       v_codes, v_scale, pos)
    dev = q.device
    B, H, D = q.shape
    _b, Hkv, T, _d = k_codes.shape
    rep = H // Hkv if Hkv else 0
    if not (D in KERNEL_D and Hkv * rep == H and rep >= 1 and T >= 1):
        raise ValueError(f"decode_attn_quant needs 1 <= D <= 256 and H a "
                         f"multiple of Hkv (H={H}, Hkv={Hkv}, D={D}, T={T})")
    if k_codes.dtype not in _CODE_DTYPES:
        raise ValueError(f"decode_attn_quant takes int8 or fp8 codes, not "
                         f"{k_codes.dtype}")
    cdt = k_codes.dtype
    pos = pos_vector(pos, B, dev)
    _build.require(q, "q", torch.bfloat16, dev, (B, H, D))
    _build.require(k_new, "k_new", torch.bfloat16, dev, (B, Hkv, D))
    _build.require(v_new, "v_new", torch.bfloat16, dev, (B, Hkv, D))
    _build.require(k_codes, "k_codes", cdt, dev, (B, Hkv, T, D))
    _build.require(v_codes, "v_codes", cdt, dev, (B, Hkv, T, D))
    _build.require(k_scale, "k_scale", torch.float32, dev, (B, Hkv, T))
    _build.require(v_scale, "v_scale", torch.float32, dev, (B, Hkv, T))
    fp8 = cdt == torch.float8_e4m3fn
    plan = decode_plan(B, H, Hkv, T, D, "fp8_e4m3" if fp8 else "int8", True)
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    err = _build.library().nctt_decode_attention_quant(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_codes.data_ptr(),
        k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        pos.data_ptr(), out.data_ptr(), decode_workspace(plan, dev), B, H,
        Hkv, T, D, int(fp8), 1.0 / (D ** 0.5), _build.stream_handle(dev))
    _build.check(err, "nctt_decode_attention_quant")
    decode_attn_quant.launches += 1
    return out


decode_attn_quant.launches = 0


def decode_attention_quant(q, k_new, v_new, cache, pos):
    """Single-token attention over an int8/fp8 ``QuantKVCache``
    (``neural_compressor_tpu``'s ``decode_attention_quant``): K6 attends
    the raw new row at ``pos``, then the row's codes and scales are written
    into the cache IN PLACE (K12, ``models.llama._write_quant_row``).
    q [B, H, 1, D]; ``k_new``/``v_new`` [B, Hkv, 1, D]; ``pos`` an int or
    a tensor of per-slot positions, never read back. Under
    ``set_cache_write_mode("kernel")`` an int8 cache takes K16's write,
    which quantizes the row by its own rule and attends it (fp8 stays
    here, as in JAX). Returns (out [B, H, 1, D], cache)."""
    from ..models.llama import _write_quant_row

    B = q.shape[0]
    if q.shape[2] != 1:
        raise ValueError("decode attention is single-token")
    if cache.fmt == "int4":
        raise ValueError("int4 caches take the grouped code-domain "
                         "attention (models.llama._grouped_attention_int4)")
    pos = pos_vector(pos, B, q.device)
    if _WRITE_MODE == "kernel" and cache.fmt == "int8":
        out = decode_attn_write(q[:, :, 0].contiguous(),
                                k_new[:, :, 0].contiguous(),
                                v_new[:, :, 0].contiguous(), cache.k_codes,
                                cache.k_scale, cache.v_codes, cache.v_scale,
                                pos)
        return out[:, :, None], cache
    out = decode_attn_quant(q[:, :, 0].contiguous(),
                            k_new[:, :, 0].contiguous(),
                            v_new[:, :, 0].contiguous(), cache.k_codes,
                            cache.k_scale, cache.v_codes, cache.v_scale, pos)
    return out[:, :, None], _write_quant_row(cache, k_new, v_new, pos)


# ---------------------------------------------------------------------------
# K7: batched single-token attention over an already-updated cache
# ---------------------------------------------------------------------------


def batched_decode_attn_plain(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos: torch.Tensor,
                              k_scale: torch.Tensor | None = None,
                              v_scale: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of K7: q [B, H, D] bf16; caches [B, Hkv, T, D]
    (bf16, or int8/fp8 codes with per-(token, head) float32 ``k_scale``/
    ``v_scale`` [B, Hkv, T]) already holding each slot's row ``pos[b]``;
    ``pos`` int32 [B] (a slot at or past T - 1 attends every row) ->
    [B, H, D] bf16.

    K7's order of operations: float32 scores [times ``k_scale``] times
    ``1/sqrt(D)``, keys after ``pos[b]`` masked, ``exp(s - m)`` [times
    ``v_scale``] rounded to bf16 for the PV product, ``l = sum exp(s - m)``
    unrounded, and ``acc / l`` at the end (``decode_attention.py:570-614``).
    Sums run in float64 over exact products and round once, as the CUDA
    kernel does. The TPU kernel takes its running max over T-chunks; one
    pass over the visited rows gives the final max, which is what it
    computes whenever one chunk covers them (T <= 1024 at D = 128)."""
    B, H, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    f64 = torch.float64
    last = pos.to(torch.int64).clamp(0, T - 1)
    valid = (torch.arange(T, device=q.device)[None, :]
             <= last[:, None])[:, None, None, :]              # [B,1,1,T]
    qr = q.reshape(B, Hkv, rep, D).to(f64)
    s = torch.einsum("bgrd,bgtd->bgrt", qr, _as_f64(k_cache)).to(
        torch.float32)
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    s = s * (1.0 / (D ** 0.5))
    s = torch.where(valid, s, torch.tensor(-1e30, device=q.device))
    e = torch.exp(s.to(f64) - s.amax(dim=-1, keepdim=True).to(f64))
    e = torch.where(valid, e, torch.zeros((), dtype=f64, device=q.device))
    l = e.sum(dim=-1, keepdim=True).to(torch.float32)
    pe = e.to(torch.float32)
    if v_scale is not None:
        pe = pe * v_scale[:, :, None, :]
    p = pe.to(torch.bfloat16)
    acc = torch.einsum("bgrt,bgtd->bgrd", p.to(f64), _as_f64(v_cache))
    out = acc.to(torch.float32) / l
    return out.reshape(B, H, D).to(q.dtype)


# cache dtype -> (format name, csrc/decode_split.cu's code)
_K7_FORMATS = {torch.bfloat16: ("bf16", 0), torch.int8: ("int8", 1),
               torch.float8_e4m3fn: ("fp8_e4m3", 2)}


def batched_decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, pos: torch.Tensor,
                        k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """K7 on the card (``csrc/decode_split.cu``, two CUDA launches a call)
    over bf16 caches, or int8/fp8-e4m3 codes with their scales; the plain
    version for CPU tensors. Arguments as in
    ``batched_decode_attn_plain``; ``pos`` stays on the device (the kernel
    reads it, no host sync). Launches are counted per cache format in
    ``batched_decode_attn.launches``."""
    if q.device.type == "cpu":
        return batched_decode_attn_plain(q, k_cache, v_cache, pos, k_scale,
                                         v_scale)
    name = "batched_decode_attn"
    dev = q.device
    B, H, D = q.shape
    _b, Hkv, T, _d = k_cache.shape
    rep = H // Hkv if Hkv else 0
    if not (D in BATCHED_KERNEL_D and Hkv * rep == H and rep >= 1
            and T >= 1):
        raise ValueError(f"{name} needs D <= 256, 353-384 or 481-512 and H "
                         f"a multiple of Hkv (H={H}, Hkv={Hkv}, D={D}, "
                         f"T={T})")
    cdt = k_cache.dtype
    fmt, code = _K7_FORMATS.get(cdt, (None, None))
    if fmt is None or (code == 0) != (k_scale is None):
        raise ValueError(f"{name}: {cdt} caches "
                         f"{'with' if k_scale is not None else 'without'} "
                         "scales")
    _build.require(q, "q", torch.bfloat16, dev, (B, H, D))
    _build.require(k_cache, "k_cache", cdt, dev, (B, Hkv, T, D))
    _build.require(v_cache, "v_cache", cdt, dev, (B, Hkv, T, D))
    if code:
        _build.require(k_scale, "k_scale", torch.float32, dev, (B, Hkv, T))
        _build.require(v_scale, "v_scale", torch.float32, dev, (B, Hkv, T))
    _build.require(pos, "pos", torch.int32, dev, (B,))
    plan = decode_plan(B, H, Hkv, T, D, fmt)
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    err = _build.library().nctt_batched_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if code else None,
        v_scale.data_ptr() if code else None, pos.data_ptr(),
        out.data_ptr(), decode_workspace(plan, dev), B, H, Hkv, T, D, code,
        1.0 / (D ** 0.5), _build.stream_handle(dev))
    _build.check(err, "nctt_batched_decode_attention")
    batched_decode_attn.launches[fmt] += 1
    return out


batched_decode_attn.launches = dict.fromkeys(("bf16", "int8", "fp8_e4m3"), 0)


def batched_decode_attention(q, k_cache, v_cache, pos, k_scale=None,
                             v_scale=None):
    """Single-token attention over an ALREADY-UPDATED cache, per-slot
    positions (``neural_compressor_tpu``'s ``batched_decode_attention``).

    q [B, H, 1, D]; caches [B, Hkv, T, D] bf16, or int8/fp8 codes with
    ``k_scale``/``v_scale`` [B, Hkv, T]; ``pos`` an int or a [B] tensor.
    Returns out [B, H, 1, D] in q's dtype, or None where the JAX
    package's dispatcher declines its kernel (B == 1, B*Hkv < 16, D or T
    not a multiple of 128: ``neural_compressor_tpu/kernels/
    decode_attention.py:722``) and the port's kernel cannot take the
    shape either (D outside ``BATCHED_KERNEL_D``); the caller then attends
    with the plain grouped attention, as JAX's caller falls back to XLA,
    and each such None adds one to
    ``batched_decode_attention.plain_calls``. Where JAX declines and the
    port's kernel takes the shape (D in ``BATCHED_KERNEL_D``, any B, T),
    the kernel runs."""
    B, H, S, D = q.shape
    if S != 1:
        raise ValueError("batched decode attention is single-token")
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    jax_declines = B == 1 or B * Hkv < 16 or D % 128 or T % 128
    if D not in BATCHED_KERNEL_D and jax_declines:
        batched_decode_attention.plain_calls += 1
        return None
    pos = pos_vector(pos, B, q.device)
    out = batched_decode_attn(q[:, :, 0].contiguous(), k_cache, v_cache,
                              pos, k_scale, v_scale)
    return out[:, :, None]


batched_decode_attention.plain_calls = 0
