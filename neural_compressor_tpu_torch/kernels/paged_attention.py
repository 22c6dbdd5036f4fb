"""Paged decode attention and paged row writes over a shared page pool.

A pool holds pages of bf16 rows, int8 or fp8-e4m3 codes with per-(token,
head) float32 scales [P, Hkv, page], or int4 token-half-split bytes
[P, Hkv, page/2, D] (token r in the low nibble of byte row r, token
r + page/2 in the high), asymmetric per (token, head): ``x ~= scale *
(nibble - 8) + off`` with scales and offsets [P, Hkv, page]. Each slot's
block table [B, PMAX] int32 maps its logical page j (tokens j*page ..
j*page+page-1) to a pool page. Page 0 is the trash page: the engine points
every free block-table entry at it, and idle slots write and read it.

Ports ``neural_compressor_tpu/kernels/paged_attention.py``:
  * K11, ``paged_decode_attention`` and ``paged_window_attention``
    (``_paged_attn_impl_v2`` / ``_paged_kernel_v2``, ``wq == 1`` and the
    W-query window ``wq > 1``, with gemma's sliding band ``window`` and
    logit ``softcap``): attention over a slot's pages, one query
    at ``lengths - 1`` or a causal window of W queries whose row w sits at
    ``lengths - W + w`` (a speculative verify window; rows packed (w, rep)
    as the TPU kernel packs them); online softmax in the TPU kernel,
    scales folded into the scores (``s * k_scale``, int4 ``+ off *
    sum(q)``, then ``* D^-1/2``) and the probabilities (``exp(s - m) *
    v_scale``, then bf16 for PV; int4 adds ``sum_t exp(s - m) * v_off``
    to the output), ``acc / max(l, 1e-30)`` at the end, and zeros for a
    zero-length slot. A softcap maps the scaled score to ``cap *
    tanh(s / cap)`` before the mask; a band keeps only the keys with
    ``q_pos - k_pos < window``. Wrappers ``paged_attn``,
    ``paged_window_attn`` and ``paged_attn_gemma`` (a single query with a
    band and/or a softcap), their calls counted apart per pool format in
    ``.launches``; ``csrc/paged_attention.cu``, two CUDA launches a call
    over a fixed plan of key parts (``split_plan``: scores and part maxima,
    then probabilities, per-part PV partials and the ordered fold), with
    its scratch from ``split_workspace``.
  * K12, ``paged_write_rows`` (``_paged_write_impl`` with
    ``_write_kernel_bf16``, ``_write_kernel_quant`` and
    ``_write_kernel_int4``): each slot's new K/V row into page
    ``block_tables[b, pos // page]`` at row ``pos % page``, in place,
    quantized per (token, head) as ``models.llama._kv_quant`` (int8, fp8)
    and ``_kv_quant4_asym_codes`` (int4) quantize it under ``jax.jit``; an
    int4 row patches one nibble of byte row ``pos % (page/2)`` and keeps
    its partner token's. The TPU kernel stages and rewrites the slot's
    whole page block; the port writes only the row. Wrapper
    ``paged_write``, its launches counted per pool format; CUDA kernel
    ``csrc/paged_write.cu``. The contiguous int8/fp8 caches of
    ``models.llama`` take it too, as pools of one T-row page a slot.
  * K15, ``paged_decode_attention`` under ``set_paged_v2(False)``
    (``_paged_attn_impl`` / ``_paged_kernel`` over bf16 pools and
    ``_paged_attn_quant_impl`` / ``_paged_quant_kernel`` over int8 and fp8
    pools, the v1 kernels): one page a step with an online softmax whose
    running max moves page by page; ``exp(s - m_cur)`` [times ``v_scale``]
    is cast to bf16 for PV unnormalised, and divided by ``l`` only at the
    end, so it rounds in its own places, not K11's. Wrapper
    ``paged_attn_v1``, its launches counted per pool format; CUDA kernels
    ``csrc/paged_attention_v1.cu``, two launches a call over K11's parts
    of whole pages (``v1_plan``: K11's scores launch with each page's
    maximum, then p against the running maximum up to its page, per-page
    partials and their fold replaying v1's recurrence in page order), with
    its scratch from ``v1_workspace``. int4 pools stay on K11 (v1 has no
    int4 branch), and gemma's ``window``/``softcap`` raise
    ``NotImplementedError`` under v1, as in JAX.
  * K13, ``paged_write_window`` (``_paged_write_window_impl`` with
    ``_write_kernel_bf16_w``, ``_write_kernel_quant_w`` and
    ``_write_kernel_int4_w``): W consecutive rows a slot, which may cross
    one page boundary (``window_targets``), each quantized as K12
    quantizes it. Wrapper ``paged_write_window_kernel``, its launches
    counted per pool format; a second entry of ``csrc/paged_write.cu``.

fp8 scales: JAX's TPU write kernel computes ``(amax / 127) * (127 / 448)``,
an ulp off ``amax * f32(1/448)`` in most rows; off the TPU JAX writes fp8
rows with ``_kv_quant``'s scale, which the engine's prefill staging also
uses. The port follows ``_kv_quant``, so prefill and decode write the same
codes, in K12 and in K13 (off the TPU JAX writes fp8 windows row by row).

A position whose page index ``pos // page`` is past the block table (an
idle or finished slot running on inside a multi-step dispatch) writes
nothing in K12, as JAX's scatter drops it, and attention visits at most
``PMAX * page`` rows.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .decode_attention import KERNEL_D, pos_vector, score_workspace
from ..ops.activations import softcap as _softcap
from ..ops.kv_quant import kv_quant, kv_quant4_asym_codes

_F64 = torch.float64
_F32 = torch.float32
# pool format -> the C entries' format code
_FMT_CODE = {"bf16": 0, "int8": 1, "fp8_e4m3": 2, "int4": 3}


def pool_format(k_pages: torch.Tensor, k_scales, k_offs=None) -> str:
    """"bf16", "int8", "fp8_e4m3" or "int4" for a consistent pool, or
    "f32" for the float32 rows of a float32 model (plain versions only:
    the CUDA kernels take the other four); raise for a pool whose codes,
    scales and offsets do not go together."""
    fmt = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8",
           torch.float8_e4m3fn: "fp8_e4m3",
           torch.uint8: "int4"}.get(k_pages.dtype)
    if fmt is None or (fmt in ("bf16", "f32")) != (k_scales is None) \
            or (fmt == "int4") != (k_offs is not None):
        raise ValueError(
            f"a page pool of {k_pages.dtype} codes with"
            f"{'' if k_scales is not None else 'out'} scales and "
            f"with{'' if k_offs is not None else 'out'} offsets")
    return fmt


def _gather_pages(pages: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """[P, Hkv, page, ...] through [B, PMAX] -> [B, Hkv, PMAX*page, ...]."""
    g = pages[bt]                                   # [B, PMAX, Hkv, page, ...]
    B, PMAX, Hkv, page = g.shape[:4]
    return g.transpose(1, 2).reshape(B, Hkv, PMAX * page, *g.shape[4:])


def _gather_rows(pages: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """A slot's rows [B, Hkv, PMAX*page, D] as float64, exactly: bf16 rows,
    int8/fp8 codes, or the centered int4 nibbles of token-half-split
    pages; float32 rows rounded to bf16 first, as the TPU kernel casts
    every page to bf16 for its dots (``_codes_bf16``)."""
    if pages.dtype == torch.uint8:
        pages = torch.cat([(pages & 15), (pages >> 4)], dim=2)
        pages = pages.to(torch.int8) - 8             # [P, Hkv, page, D]
    elif pages.dtype in (torch.float8_e4m3fn, torch.float32):
        pages = pages.to(torch.bfloat16)
    return _gather_pages(pages, bt).to(_F64)


def paged_window_attn_plain(q, k_pages, k_scales, v_pages, v_scales,
                            block_tables, lengths, k_offs=None,
                            v_offs=None, window=None,
                            softcap=None) -> torch.Tensor:
    """Plain PyTorch version of K11 over a window of W queries a slot: q
    [B, H, W, D] bf16; pools as in the module docstring (``k_offs``/
    ``v_offs`` for int4 pools); ``block_tables`` [B, PMAX] int32;
    ``lengths`` [B] int32, the slot's rows with the whole window -> [B, H,
    W, D] bf16. Window row w sits at position ``lengths - W + w`` and
    attends keys up to it (W = 1: the single query, ``paged_attn_plain``);
    a slot of length 0, and a row with no key, give zeros. ``softcap``
    maps each scaled score s to ``cap * tanh(s * f32(1/cap))`` before the
    mask (``ops.activations.softcap``); ``window`` keeps only the keys
    with ``q_pos - k_pos < window`` (gemma's sliding band).

    The output takes q's dtype (bf16 on the card; float32 for a float32
    model's pool on the CPU).

    Sums run in float64 over exact products (bf16 times bf16, int8, fp8 or
    an int4 nibble) and round once, as the CUDA kernel does, so row w
    equals the single query at length ``lengths - W + w + 1``. The TPU
    kernel's online softmax over groups of 4 pages equals this one pass
    whenever one group covers the visited pages (PMAX <= 4) or the running
    max does not move."""
    fmt = pool_format(k_pages, k_scales, k_offs)
    B, H, Wq, D = q.shape
    Hkv = k_pages.shape[1]
    rep = H // Hkv
    rows = Wq * rep
    bt = block_tables.to(torch.int64)
    k = _gather_rows(k_pages, bt)                   # [B, Hkv, T, D]
    v = _gather_rows(v_pages, bt)
    T = k.shape[2]
    dev = q.device
    # query rows pack (w, rep), as K11 packs them
    qr = (q.reshape(B, Hkv, rep, Wq, D).transpose(2, 3)
          .reshape(B, Hkv, rows, D).to(_F64))
    w_of = torch.div(torch.arange(rows, device=dev), rep,
                     rounding_mode="floor")
    n = lengths.to(torch.int64).reshape(B, 1)
    qpos = n - Wq + w_of[None, :]                   # [B, rows]
    L = (qpos + 1).clamp(0, T)
    t_idx = torch.arange(T, device=dev)[None, None, :]
    valid = t_idx < L[:, :, None]
    if window is not None:
        valid = valid & (qpos[:, :, None] - t_idx < window)
    valid = valid[:, None]                          # [B, 1, rows, T]
    s = torch.einsum("bgrd,bgtd->bgrt", qr, k).to(_F32)
    if k_scales is not None:
        s = s * _gather_pages(k_scales, bt)[:, :, None, :]
    if fmt == "int4":
        qsum = qr.sum(dim=-1).to(_F32)[..., None]   # [B, Hkv, rows, 1]
        s = s + qsum * _gather_pages(k_offs, bt)[:, :, None, :]
    s = s * (1.0 / (D ** 0.5))
    if softcap is not None:
        s = _softcap(s, softcap)
    s = torch.where(valid, s, torch.tensor(-1e30, device=dev))
    e = torch.exp(s.to(_F64) - s.amax(dim=-1, keepdim=True).to(_F64))
    e = torch.where(valid, e, torch.zeros((), dtype=_F64, device=dev))
    l = e.sum(dim=-1, keepdim=True).to(_F32)
    pe = e.to(_F32)
    if k_scales is not None:
        pe = pe * _gather_pages(v_scales, bt)[:, :, None, :]
    acc = torch.einsum("bgrt,bgtd->bgrd", pe.to(torch.bfloat16).to(_F64),
                       v).to(_F32)
    if fmt == "int4":
        voff = _gather_pages(v_offs, bt).to(_F64)[:, :, None, :]
        corr = (e.to(_F32).to(_F64) * voff).sum(dim=-1, keepdim=True)
        acc = acc + corr.to(_F32)
    out = acc / l.clamp_min(1e-30)
    out = torch.where((lengths > 0).reshape(B, 1, 1, 1), out,
                      torch.zeros((), device=dev))
    return (out.reshape(B, Hkv, Wq, rep, D).transpose(2, 3)
            .reshape(B, H, Wq, D).to(q.dtype))


def paged_attn_plain(q, k_pages, k_scales, v_pages, v_scales, block_tables,
                     lengths, k_offs=None, v_offs=None, window=None,
                     softcap=None) -> torch.Tensor:
    """Plain PyTorch version of single-query K11: q [B, H, D] bf16; pools,
    ``block_tables``, ``lengths`` (the new row included), ``window`` and
    ``softcap`` as in ``paged_window_attn_plain``, of which it is the W = 1
    case -> [B, H, D] bf16."""
    return paged_window_attn_plain(q[:, :, None], k_pages, k_scales, v_pages,
                                   v_scales, block_tables, lengths, k_offs,
                                   v_offs, window, softcap)[:, :, 0]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _require_pools(name: str, fmt: str, dev, k_pages, k_scales, v_pages,
                   v_scales, k_offs, v_offs) -> None:
    """Check a pool's K and V codes, scales and offsets on ``dev``."""
    if fmt not in _FMT_CODE:
        raise ValueError(f"{name}: the CUDA kernels take {tuple(_FMT_CODE)} "
                         f"pools, not {fmt}")
    P, Hkv, rows, D = k_pages.shape
    page = 2 * rows if fmt == "int4" else rows
    _build.require(k_pages, "k_pages", k_pages.dtype, dev, (P, Hkv, rows, D))
    _build.require(v_pages, "v_pages", k_pages.dtype, dev, (P, Hkv, rows, D))
    for t, label in ((k_scales, "k_scales"), (v_scales, "v_scales"),
                     (k_offs, "k_offs"), (v_offs, "v_offs")):
        if t is not None:
            _build.require(t, label, torch.float32, dev, (P, Hkv, page))
    if (k_offs is None) != (v_offs is None) \
            or (k_scales is None) != (v_scales is None):
        raise ValueError(f"{name}: K and V pools of different formats")


class SplitPlan(NamedTuple):
    """How K11 cuts one launch (``split_plan``): query-row groups, key
    parts, the grid of both of its launches and its workspaces' shapes."""
    groups: int          # ng: groups of query rows a (slot, KV head)
    group_rows: int      # gs: rows a group, at most 8
    part_keys: int       # keys a part: whole pages from key 0 on
    parts: int           # parts over the block table's PMAX pages
    grid: tuple          # (parts, Hkv * groups, B), both launches
    scores: tuple        # float32 score rows [B * Hkv, ng * gs, PMAX*page]
    maxima: tuple        # float32 part maxima [B, Hkv, ng * gs, parts]
    partials: tuple      # float64 [B, Hkv, ng * gs, parts, D + 2]: acc, l, corr
    tickets: int         # int32 tickets, one a (slot, KV head, group)


# keys a part of K11's split holds: whole pages, 512 keys at the engine's
# 128-row pages (4 pages, the page group JAX's kernel stages, its _KPP)
PART_KEYS = 512


@functools.lru_cache(maxsize=256)
def split_plan(B: int, H: int, Hkv: int, W: int, D: int, page: int,
               PMAX: int) -> SplitPlan:
    """K11's plan for q [B, H, W, D] over pages of ``page`` tokens, PMAX a
    slot. A (slot, KV head)'s W*H/Hkv query rows, packed (w, rep), split
    into the fewest groups of at most 8 rows, as even as they go; a slot's
    keys into parts of ``max(1, PART_KEYS // page)`` whole pages. Part
    boundaries are absolute key positions that depend on the page size
    alone (never on W, rep, B, the lengths or a band), so a row's terms
    are summed in the same order whatever else shares its launch."""
    rows = W * (H // Hkv)
    ng = -(-rows // 8)
    gs = -(-rows // ng)
    part_keys = max(1, PART_KEYS // page) * page
    parts = -(-(PMAX * page) // part_keys)
    return SplitPlan(ng, gs, part_keys, parts, (parts, Hkv * ng, B),
                     (B * Hkv, ng * gs, PMAX * page),
                     (B, Hkv, ng * gs, parts), (B, Hkv, ng * gs, parts, D + 2),
                     B * Hkv * ng)


# device -> K11's own scratch, flat: part maxima (float32), partials
# (float64) and tickets (int32, kept zeroed), each replaced by a larger one
# when a launch needs more. Launches on one stream run in order, so one
# launch's scratch is free when the next starts; the folding blocks of each
# launch reset their tickets to 0.
_SCRATCH: dict = {}


def split_workspace(plan: SplitPlan, device) -> tuple:
    """K11's workspaces for ``plan`` on ``device``: (scores, maxima,
    partials, tickets). The score rows [B * Hkv, ng * gs, PMAX*page] come
    from ``decode_attention.score_workspace``, which K5 and K16 share;
    the part maxima, the float64 partials and the tickets are K11's own,
    flat buffers of at least ``plan``'s sizes kept per device between
    launches."""
    need = (math.prod(plan.maxima), math.prod(plan.partials), plan.tickets)
    have = _SCRATCH.get(device)
    if have is None or any(t.numel() < n for t, n in zip(have, need)):
        old = have or (None, None, None)
        grow = [n if t is None else max(n, t.numel())
                for t, n in zip(old, need)]
        have = (torch.empty(grow[0], dtype=_F32, device=device),
                torch.empty(grow[1], dtype=_F64, device=device),
                torch.zeros(max(grow[2], 1024), dtype=torch.int32,
                            device=device))
        _SCRATCH[device] = have
    return (score_workspace(*plan.scores, device), *have)


def _launch_paged_attn(name, q, k_pages, k_scales, v_pages, v_scales,
                       block_tables, lengths, k_offs, v_offs, window=None,
                       softcap=None):
    """Check the operands of K11 (q [B, H, W, D] on the card) and launch
    ``csrc/paged_attention.cu`` (two CUDA launches: scores, then PV and
    the fold); returns (out [B, H, W, D], pool format)."""
    fmt = pool_format(k_pages, k_scales, k_offs)
    dev = q.device
    B, H, Wq, D = q.shape
    P, Hkv, rows, _d = k_pages.shape
    page = 2 * rows if fmt == "int4" else rows
    PMAX = block_tables.shape[1]
    rep = H // Hkv if Hkv else 0
    if not (D in KERNEL_D and Hkv * rep == H and rep >= 1
            and Wq >= 1 and page >= 1 and PMAX >= 1):
        raise ValueError(f"{name} needs 1 <= D <= 256 and H a multiple of "
                         f"Hkv (H={H}, Hkv={Hkv}, D={D})")
    if (window is not None and window < 1) or (softcap is not None
                                               and not softcap > 0):
        raise ValueError(f"{name}: window {window} and softcap {softcap} "
                         "must be positive")
    _build.require(q, "q", torch.bfloat16, dev, (B, H, Wq, D))
    _require_pools(name, fmt, dev, k_pages, k_scales, v_pages, v_scales,
                   k_offs, v_offs)
    _build.require(block_tables, "block_tables", torch.int32, dev, (B, PMAX))
    _build.require(lengths, "lengths", torch.int32, dev, (B,))
    out = torch.empty((B, H, Wq, D), dtype=torch.bfloat16, device=dev)
    plan = split_plan(B, H, Hkv, Wq, D, page, PMAX)
    ws, pmax, part, tickets = split_workspace(plan, dev)
    err = _build.library().nctt_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), _ptr(k_scales), _ptr(k_offs),
        v_pages.data_ptr(), _ptr(v_scales), _ptr(v_offs),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        ws.data_ptr(), pmax.data_ptr(), part.data_ptr(), tickets.data_ptr(),
        B, H, Hkv, Wq, P, page, PMAX, D, _FMT_CODE[fmt], plan.groups,
        plan.part_keys, plan.parts, 1.0 / (D ** 0.5), window or 0,
        softcap or 0.0, 1.0 / softcap if softcap else 0.0,
        _build.stream_handle(dev))
    _build.check(err, "nctt_paged_decode_attention")
    return out, fmt


def paged_attn(q, k_pages, k_scales, v_pages, v_scales, block_tables,
               lengths, k_offs=None, v_offs=None) -> torch.Tensor:
    """K11 on the card (``csrc/paged_attention.cu``) over bf16, int8,
    fp8-e4m3 and int4 pools; the plain version for CPU tensors. Arguments
    as in ``paged_attn_plain``. Launches are counted per pool format in
    ``paged_attn.launches``."""
    if q.device.type == "cpu":
        return paged_attn_plain(q, k_pages, k_scales, v_pages, v_scales,
                                block_tables, lengths, k_offs, v_offs)
    out, fmt = _launch_paged_attn("paged_attn", q[:, :, None], k_pages,
                                  k_scales, v_pages, v_scales, block_tables,
                                  lengths, k_offs, v_offs)
    paged_attn.launches[fmt] += 1
    return out[:, :, 0]


paged_attn.launches = dict.fromkeys(_FMT_CODE, 0)


def paged_attn_gemma(q, k_pages, k_scales, v_pages, v_scales, block_tables,
                     lengths, k_offs=None, v_offs=None, window=None,
                     softcap=None) -> torch.Tensor:
    """Single-query K11 with gemma's branches on the card
    (``csrc/paged_attention.cu``): the sliding band ``window`` and/or the
    logit ``softcap``, over bf16, int8, fp8-e4m3 and int4 pools; the plain
    version for CPU tensors. Arguments as in ``paged_attn_plain``; one of
    ``window`` and ``softcap`` is set. Launches are counted in
    ``paged_attn_gemma.launches`` by branch and pool format: ``"band_<fmt>"``
    with a window (a sliding layer, with or without a softcap),
    ``"softcap_<fmt>"`` with a softcap alone (a global gemma-2 layer)."""
    if window is None and softcap is None:
        raise ValueError("paged_attn_gemma: neither a window nor a softcap; "
                         "that is paged_attn")
    if q.device.type == "cpu":
        return paged_attn_plain(q, k_pages, k_scales, v_pages, v_scales,
                                block_tables, lengths, k_offs, v_offs,
                                window, softcap)
    out, fmt = _launch_paged_attn("paged_attn_gemma", q[:, :, None], k_pages,
                                  k_scales, v_pages, v_scales, block_tables,
                                  lengths, k_offs, v_offs, window, softcap)
    branch = "band" if window is not None else "softcap"
    paged_attn_gemma.launches[f"{branch}_{fmt}"] += 1
    return out[:, :, 0]


paged_attn_gemma.launches = {f"{b}_{f}": 0 for b in ("band", "softcap")
                             for f in _FMT_CODE}


def _write_targets(k_rows, v_rows, pid, r, fmt, page, k_pages, k_scales,
                   v_pages, v_scales, k_offs, v_offs) -> None:
    """Write rows ``k_rows``/``v_rows`` [n, Hkv, D] at pool page ``pid``
    [n], row ``r`` [n], quantized in the pool's format, in place. One
    writer a target row: an index assignment with duplicate targets may mix
    their elements across threads, so the last of them stands."""
    key = pid * page + r
    uniq, inv = torch.unique(key, return_inverse=True)
    last = torch.full_like(uniq, -1).scatter_reduce(
        0, inv, torch.arange(key.numel(), device=key.device), reduce="amax")
    k_rows, v_rows, pid, r = k_rows[last], v_rows[last], pid[last], r[last]
    if fmt == "int4":
        half = page // 2
        brow, hi = r % half, (r >= half)[:, None, None]
        for new, pages, scales, offs in ((k_rows, k_pages, k_scales, k_offs),
                                         (v_rows, v_pages, v_scales, v_offs)):
            c, sc, off = kv_quant4_asym_codes(new)
            old = pages[pid, :, brow]                  # [n, Hkv, D]
            pages[pid, :, brow] = torch.where(hi, (old & 0x0F) | (c << 4),
                                              (old & 0xF0) | c)
            scales[pid, :, r] = sc
            offs[pid, :, r] = off
    elif fmt in ("int8", "fp8_e4m3"):
        for new, pages, scales in ((k_rows, k_pages, k_scales),
                                   (v_rows, v_pages, v_scales)):
            c, sc = kv_quant(new, fmt)
            pages[pid, :, r] = c
            scales[pid, :, r] = sc
    else:
        k_pages[pid, :, r] = k_rows.to(k_pages.dtype)
        v_pages[pid, :, r] = v_rows.to(v_pages.dtype)


def paged_write_plain(k_new, v_new, k_pages, k_scales, v_pages, v_scales,
                      block_tables, pos, k_offs=None, v_offs=None) -> None:
    """Plain PyTorch version of K12, in place: ``k_new``/``v_new``
    [B, Hkv, D] bf16; pools and block tables as in the module docstring;
    ``pos`` [B] int32. Rows whose page index is past the block table are
    dropped. Several slots writing one page row (idle slots on the trash
    page) leave the last slot's row there (the kernel leaves one of them,
    unspecified which)."""
    fmt = pool_format(k_pages, k_scales, k_offs)
    page = 2 * k_pages.shape[2] if fmt == "int4" else k_pages.shape[2]
    PMAX = block_tables.shape[1]
    p = pos.to(torch.int64)
    j = torch.div(p, page, rounding_mode="floor")
    rows = torch.nonzero((p >= 0) & (j < PMAX)).reshape(-1)
    pid = block_tables.to(torch.int64)[rows, j[rows]]
    _write_targets(k_new[rows], v_new[rows], pid, p[rows] % page, fmt, page,
                   k_pages, k_scales, v_pages, v_scales, k_offs, v_offs)


def paged_write(k_new, v_new, k_pages, k_scales, v_pages, v_scales,
                block_tables, pos, k_offs=None, v_offs=None) -> None:
    """K12 on the card (``csrc/paged_write.cu``) for bf16, int8, fp8-e4m3
    and int4 pools; the plain version for CPU tensors. Arguments as in
    ``paged_write_plain``; ``pos`` stays on the device. Launches are
    counted per pool format in ``paged_write.launches``."""
    if k_new.device.type == "cpu":
        return paged_write_plain(k_new, v_new, k_pages, k_scales, v_pages,
                                 v_scales, block_tables, pos, k_offs, v_offs)
    name = "paged_write"
    fmt = pool_format(k_pages, k_scales, k_offs)
    dev = k_new.device
    B, Hkv, D = k_new.shape
    P, _h, rows, _d = k_pages.shape
    page = 2 * rows if fmt == "int4" else rows
    if fmt == "int4" and page % 16:
        raise ValueError(f"{name}: int4 pages need page % 16 == 0")
    PMAX = block_tables.shape[1]
    _build.require(k_new, "k_new", torch.bfloat16, dev, (B, Hkv, D))
    _build.require(v_new, "v_new", torch.bfloat16, dev, (B, Hkv, D))
    _require_pools(name, fmt, dev, k_pages, k_scales, v_pages, v_scales,
                   k_offs, v_offs)
    _build.require(block_tables, "block_tables", torch.int32, dev, (B, PMAX))
    _build.require(pos, "pos", torch.int32, dev, (B,))
    err = _build.library().nctt_paged_write_rows(
        k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
        _ptr(k_scales), _ptr(k_offs), v_pages.data_ptr(), _ptr(v_scales),
        _ptr(v_offs), block_tables.data_ptr(), pos.data_ptr(), B, Hkv, P,
        page, PMAX, D, _FMT_CODE[fmt], _build.stream_handle(dev))
    _build.check(err, "nctt_paged_write_rows")
    paged_write.launches[fmt] += 1


paged_write.launches = dict.fromkeys(_FMT_CODE, 0)


def window_targets(block_tables, pos, page: int, W: int):
    """Where K13 puts each slot's W window rows, as JAX's
    ``paged_write_window`` maps them: (pool page [B, W], row [B, W]), int64.
    The window's first page is ``clip(pos // page, 0, PMAX - 1)``; rows
    past the end of that page go to its successor when the window crosses
    into a page of the table, else to the trash page 0."""
    PMAX = block_tables.shape[1]
    p = pos.to(torch.int64).reshape(-1)
    bt = block_tables.to(torch.int64)
    p0 = torch.div(p, page, rounding_mode="floor").clamp(0, PMAX - 1)
    off = p % page
    ar = torch.arange(bt.shape[0], device=bt.device)
    pid0 = bt[ar, p0]
    crosses = (off + W > page) & (p0 + 1 <= PMAX - 1)
    pid1 = torch.where(crosses, bt[ar, (p0 + 1).clamp(max=PMAX - 1)],
                       torch.zeros_like(p0))
    t = off[:, None] + torch.arange(W, device=bt.device)[None, :]
    first = t < page
    return (torch.where(first, pid0[:, None], pid1[:, None]),
            torch.where(first, t, t - page))


def paged_write_window_plain(k_new, v_new, k_pages, k_scales, v_pages,
                             v_scales, block_tables, pos, k_offs=None,
                             v_offs=None) -> None:
    """Plain PyTorch version of K13, in place: ``k_new``/``v_new``
    [B, Hkv, W, D] bf16 (W <= page), the window rows of each slot from
    ``pos`` [B] int32 on, into the pages ``window_targets`` gives, each row
    quantized as K12 quantizes it. Rows go in window order, each one
    written for all slots at once (one writer a target row, the last slot
    on the shared trash page)."""
    fmt = pool_format(k_pages, k_scales, k_offs)
    page = 2 * k_pages.shape[2] if fmt == "int4" else k_pages.shape[2]
    W = k_new.shape[2]
    pid, r = window_targets(block_tables, pos, page, W)
    for w in range(W):
        _write_targets(k_new[:, :, w], v_new[:, :, w], pid[:, w], r[:, w],
                       fmt, page, k_pages, k_scales, v_pages, v_scales,
                       k_offs, v_offs)


def paged_write_window_kernel(k_new, v_new, k_pages, k_scales, v_pages,
                              v_scales, block_tables, pos, k_offs=None,
                              v_offs=None) -> None:
    """K13 on the card (``csrc/paged_write.cu``,
    ``nctt_paged_write_window``) for bf16, int8, fp8-e4m3 and int4 pools;
    the plain version for CPU tensors. Arguments as in
    ``paged_write_window_plain``; ``pos`` stays on the device. Launches
    are counted per pool format in ``paged_write_window_kernel.launches``.
    """
    if k_new.device.type == "cpu":
        return paged_write_window_plain(k_new, v_new, k_pages, k_scales,
                                        v_pages, v_scales, block_tables, pos,
                                        k_offs, v_offs)
    name = "paged_write_window_kernel"
    fmt = pool_format(k_pages, k_scales, k_offs)
    dev = k_new.device
    B, Hkv, W, D = k_new.shape
    P, _h, rows, _d = k_pages.shape
    page = 2 * rows if fmt == "int4" else rows
    if fmt == "int4" and page % 16:
        raise ValueError(f"{name}: int4 pages need page % 16 == 0")
    if not 1 <= W <= page:
        raise ValueError(f"{name}: a window of {W} rows and pages of {page}")
    PMAX = block_tables.shape[1]
    _build.require(k_new, "k_new", torch.bfloat16, dev, (B, Hkv, W, D))
    _build.require(v_new, "v_new", torch.bfloat16, dev, (B, Hkv, W, D))
    _require_pools(name, fmt, dev, k_pages, k_scales, v_pages, v_scales,
                   k_offs, v_offs)
    _build.require(block_tables, "block_tables", torch.int32, dev, (B, PMAX))
    _build.require(pos, "pos", torch.int32, dev, (B,))
    err = _build.library().nctt_paged_write_window(
        k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
        _ptr(k_scales), _ptr(k_offs), v_pages.data_ptr(), _ptr(v_scales),
        _ptr(v_offs), block_tables.data_ptr(), pos.data_ptr(), B, Hkv, P,
        page, PMAX, D, W, _FMT_CODE[fmt], _build.stream_handle(dev))
    _build.check(err, "nctt_paged_write_window")
    paged_write_window_kernel.launches[fmt] += 1


paged_write_window_kernel.launches = dict.fromkeys(_FMT_CODE, 0)


def paged_window_attn(q, k_pages, k_scales, v_pages, v_scales, block_tables,
                      lengths, k_offs=None, v_offs=None) -> torch.Tensor:
    """K11's W-query window on the card (``csrc/paged_attention.cu``) over
    bf16, int8, fp8-e4m3 and int4 pools; the plain version for CPU tensors.
    Arguments as in ``paged_window_attn_plain``. Launches are counted per
    pool format in ``paged_window_attn.launches``, apart from the
    single-query ``paged_attn``'s."""
    if q.device.type == "cpu":
        return paged_window_attn_plain(q, k_pages, k_scales, v_pages,
                                       v_scales, block_tables, lengths,
                                       k_offs, v_offs)
    out, fmt = _launch_paged_attn("paged_window_attn", q, k_pages, k_scales,
                                  v_pages, v_scales, block_tables, lengths,
                                  k_offs, v_offs)
    paged_window_attn.launches[fmt] += 1
    return out


paged_window_attn.launches = dict.fromkeys(_FMT_CODE, 0)


def _pool_args(cache) -> tuple:
    return (cache.k_pages, cache.k_scales, cache.v_pages, cache.v_scales,
            cache.block_tables)


def paged_write_rows(cache, k_new, v_new, pos):
    """Write the new K/V rows [B, Hkv, 1, D] into their pages at per-slot
    ``pos`` (an int or [B]), IN PLACE (the TPU kernel aliases its outputs);
    returns ``cache``, a ``models.llama.PagedKVCache``."""
    B = k_new.shape[0]
    paged_write(k_new[:, :, 0].contiguous(), v_new[:, :, 0].contiguous(),
                *_pool_args(cache), pos_vector(pos, B, k_new.device),
                cache.k_offs, cache.v_offs)
    return cache


def paged_attn_v1_plain(q, k_pages, k_scales, v_pages, v_scales,
                        block_tables, lengths) -> torch.Tensor:
    """Plain PyTorch version of K15: q [B, H, D] bf16; bf16 pools (scales
    None) or int8/fp8 codes with float32 scales [P, Hkv, page];
    ``block_tables`` [B, PMAX] int32; ``lengths`` [B] int32 (the new row
    included) -> [B, H, D] in q's dtype, zeros for a slot of length 0.

    The v1 kernels' order of operations, page by page: ``s = f32(q . k) *
    scale`` (codes: ``* f32(k_scale * scale)``), keys past the length
    masked; ``m_cur = max(m_prev, max s)``, the running max up to this
    page; ``alpha = exp(m_prev - m_cur)``; ``e = f32(exp(s - m_cur))``;
    ``l = l * alpha + sum e``; ``acc = acc * alpha + sum bf16(e [*
    v_scale]) * v``; ``out = f32(acc) / max(f32(l), 1e-30)``. alpha, l and
    acc in float64 (the TPU carries float32), the dot products over exact
    terms in float64, as the CUDA kernel does; a float32 pool's rows and
    probabilities stay float32, as v1 casts p to the rows' dtype."""
    fmt = pool_format(k_pages, k_scales)
    B, H, D = q.shape
    P, Hkv, page, _d = k_pages.shape
    PMAX = block_tables.shape[1]
    rep = H // Hkv
    dev = q.device
    quant = k_scales is not None
    scale = 1.0 / (D ** 0.5)
    qr = q.reshape(B, Hkv, rep, D).to(_F64)
    n = lengths.to(torch.int64).reshape(B, 1)
    m = torch.full((B, Hkv, rep), -1e30, dtype=_F32, device=dev)
    l = torch.zeros((B, Hkv, rep), dtype=_F64, device=dev)
    acc = torch.zeros((B, Hkv, rep, D), dtype=_F64, device=dev)
    for p in range(PMAX):
        pid = block_tables[:, p].to(torch.int64)
        t = p * page + torch.arange(page, device=dev)[None, :]
        valid = (t < n)[:, None, None, :]                 # [B, 1, 1, page]
        k = _as_rows(k_pages[pid], fmt)                   # [B, Hkv, page, D]
        v = _as_rows(v_pages[pid], fmt)
        s = torch.einsum("bgrd,bgtd->bgrt", qr, k).to(_F32)
        if quant:
            s = s * (k_scales[pid] * scale)[:, :, None, :]
        else:
            s = s * scale
        s = torch.where(valid, s, torch.tensor(-1e30, device=dev))
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m.to(_F64) - m_cur.to(_F64))
        e = torch.exp(s.to(_F64) - m_cur.to(_F64)[..., None]).to(_F32)
        e = torch.where(valid, e, torch.zeros((), dtype=_F32, device=dev))
        l = l * alpha + e.to(_F64).sum(dim=-1)
        pe = e * v_scales[pid][:, :, None, :] if quant else e
        if fmt != "f32":
            pe = pe.to(torch.bfloat16)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrt,bgtd->bgrd", pe.to(_F64), v)
        m = m_cur
    out = acc.to(_F32) / l.to(_F32).clamp_min(1e-30)[..., None]
    out = torch.where((lengths > 0).reshape(B, 1, 1, 1), out,
                      torch.zeros((), device=dev))
    return out.reshape(B, H, D).to(q.dtype)


def _as_rows(pages: torch.Tensor, fmt: str) -> torch.Tensor:
    """Gathered pages (bf16 or float32 rows, int8 or fp8 codes) as float64,
    exactly."""
    if fmt == "fp8_e4m3":
        pages = pages.to(torch.bfloat16)
    return pages.to(_F64)


class V1Plan(NamedTuple):
    """How K15 cuts one call (``v1_plan``): query-row groups, parts of
    whole pages, the grid of both of its launches and its scratch's
    sizes."""
    groups: int          # ng: groups of query rows a (slot, KV head)
    group_rows: int      # gs: rows a group, at most 8
    part_keys: int       # keys a part: whole pages from key 0 on
    parts: int           # parts over the block table's PMAX pages
    grid: tuple          # (parts, Hkv * groups, B), both launches
    scores: int          # float32 score rows, B * Hkv * ng * gs * PMAX*page
    maxima: int          # float32 page maxima, B * Hkv * ng * gs * PMAX
    partials: int        # float64 page partials: S_p [D], l_p, alpha_p
    tickets: int         # int32 tickets, one a (slot, KV head, group)


@functools.lru_cache(maxsize=256)
def v1_plan(B: int, H: int, Hkv: int, D: int, page: int,
            PMAX: int) -> V1Plan:
    """K15's plan for q [B, H, D] over pages of ``page`` tokens, PMAX a
    slot: K11's cut (``split_plan`` at W = 1: groups of at most 8 query
    rows, parts of ``max(1, PART_KEYS // page)`` whole pages at absolute
    key positions set by the page size alone), with each page's maximum
    and each page's partials kept, so that the fold replays v1's page by
    page recurrence."""
    sp = split_plan(B, H, Hkv, 1, D, page, PMAX)
    rows = B * Hkv * sp.groups * sp.group_rows
    return V1Plan(sp.groups, sp.group_rows, sp.part_keys, sp.parts, sp.grid,
                  rows * PMAX * page, rows * PMAX, rows * PMAX * (D + 2),
                  sp.tickets)


# device -> (sizes held, buffers, {plan: argument block}): K15's scratch,
# flat: score rows and page maxima (float32), page partials (float64) and
# tickets (int32, kept zeroed), replaced by larger ones (and the argument
# blocks dropped) when a call needs more. Calls on one stream run in order,
# so one call's scratch is free when the next starts; the folding blocks
# reset their tickets to 0.
_V1_SCRATCH: dict = {}


def v1_workspace(plan: V1Plan, device) -> int:
    """The address of the argument block of K15's entry for ``plan`` on
    ``device``: seven 64-bit words, the scratch's addresses (score rows,
    page maxima, page partials, tickets) and the plan (groups, part keys,
    parts). The scratch is flat buffers of at least the plan's sizes kept
    per device between calls; the blocks are cached per plan."""
    have = _V1_SCRATCH.get(device)
    if have is not None:
        block = have[2].get(plan)
        if block is not None:
            return block[1]
    need = (plan.scores, plan.maxima, plan.partials, max(plan.tickets, 1024))
    if have is None or any(h < n for h, n in zip(have[0], need)):
        n = need if have is None else tuple(map(max, have[0], need))
        bufs = (torch.empty(n[0], dtype=_F32, device=device),
                torch.empty(n[1], dtype=_F32, device=device),
                torch.empty(n[2], dtype=_F64, device=device),
                torch.zeros(n[3], dtype=torch.int32, device=device))
        have = (n, bufs, {})
        _V1_SCRATCH[device] = have
    words = (ctypes.c_int64 * 7)(*(b.data_ptr() for b in have[1]),
                                 plan.groups, plan.part_keys, plan.parts)
    have[2][plan] = (words, ctypes.addressof(words))
    return have[2][plan][1]


def paged_attn_v1(q, k_pages, k_scales, v_pages, v_scales, block_tables,
                  lengths) -> torch.Tensor:
    """K15 on the card (``csrc/paged_attention_v1.cu``,
    ``nctt_paged_attention_v1``: two CUDA launches a call over
    ``v1_plan``'s parts of whole pages, scratch from ``v1_workspace``)
    over bf16, int8 and fp8-e4m3 pools; the plain version for CPU tensors.
    Arguments as in ``paged_attn_v1_plain``. Launches are counted per pool
    format in ``paged_attn_v1.launches``, one a call."""
    if q.device.type == "cpu":
        return paged_attn_v1_plain(q, k_pages, k_scales, v_pages, v_scales,
                                   block_tables, lengths)
    fmt = pool_format(k_pages, k_scales)
    if fmt not in paged_attn_v1.launches:
        raise ValueError(f"paged_attn_v1 takes bf16, int8 and fp8 pools, "
                         f"not {fmt}")
    dev = q.device
    B, H, D = q.shape
    P, Hkv, page, _d = k_pages.shape
    PMAX = block_tables.shape[1]
    rep = H // Hkv if Hkv else 0
    if not (D in KERNEL_D and Hkv * rep == H and rep >= 1 and page >= 1
            and PMAX >= 1):
        raise ValueError(f"paged_attn_v1 needs 1 <= D <= 256 and H a "
                         f"multiple of Hkv (H={H}, Hkv={Hkv}, D={D})")
    _build.require(q, "q", torch.bfloat16, dev, (B, H, D))
    _require_pools("paged_attn_v1", fmt, dev, k_pages, k_scales, v_pages,
                   v_scales, None, None)
    _build.require(block_tables, "block_tables", torch.int32, dev, (B, PMAX))
    _build.require(lengths, "lengths", torch.int32, dev, (B,))
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    plan = v1_plan(B, H, Hkv, D, page, PMAX)
    err = _build.library().nctt_paged_attention_v1(
        q.data_ptr(), k_pages.data_ptr(), _ptr(k_scales), v_pages.data_ptr(),
        _ptr(v_scales), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), v1_workspace(plan, dev), B, H, Hkv, P, page, PMAX, D,
        _FMT_CODE[fmt], 1.0 / (D ** 0.5), _build.stream_handle(dev))
    _build.check(err, "nctt_paged_attention_v1")
    paged_attn_v1.launches[fmt] += 1
    return out


paged_attn_v1.launches = dict.fromkeys(("bf16", "int8", "fp8_e4m3"), 0)

# JAX's switch (paged_attention.py _PAGED_V2): v2 (K11) is the default, v1
# (K15) the A/B comparator; read at call time
_PAGED_V2 = True


def set_paged_v2(on: bool) -> None:
    global _PAGED_V2
    _PAGED_V2 = bool(on)


def paged_decode_attention(q, cache, lengths, window=None, softcap=None):
    """Single-token attention over a ``PagedKVCache``: q [B, H, 1, D];
    ``lengths`` [B] = tokens in the cache INCLUDING the current one (its
    row written before the call). Slots with length 0 return zeros.
    ``window`` (gemma's sliding band: keys with q_pos - k_pos < window)
    and ``softcap`` (``cap * tanh(s / cap)`` on the scaled scores, before
    the mask) take ``paged_attn_gemma``; without them ``paged_attn``.
    Under ``set_paged_v2(False)`` bf16, int8 and fp8 pools take K15
    (``paged_attn_v1``), int4 pools stay on K11, and a window or softcap
    raises ``NotImplementedError``, as in JAX. Returns [B, H, 1, D]
    bf16."""
    B, _H, S, _D = q.shape
    if S != 1:
        raise ValueError("paged decode attention is single-token")
    lengths = pos_vector(lengths, B, q.device)
    if not _PAGED_V2 and cache.k_pages.dtype != torch.uint8:  # v1: no int4
        if window is not None or softcap is not None:
            raise NotImplementedError(
                "window/softcap need the v2 paged kernel (set_paged_v2)")
        return paged_attn_v1(q[:, :, 0].contiguous(), *_pool_args(cache),
                             lengths)[:, :, None]
    args = (q[:, :, 0].contiguous(), *_pool_args(cache), lengths,
            cache.k_offs, cache.v_offs)
    if window is None and softcap is None:
        out = paged_attn(*args)
    else:
        out = paged_attn_gemma(*args, window=window, softcap=softcap)
    return out[:, :, None]


def paged_write_window(cache, k_new, v_new, pos):
    """Write W consecutive rows a slot ([B, Hkv, W, D] from per-slot start
    ``pos``, an int or [B]) into the pages IN PLACE through K13, which may
    cross one page boundary; returns ``cache``. Returns None off the JAX
    kernel's envelope (``W > page``, ``D % 128``, ``page % 128``,
    ``Hkv % 8``), where the caller writes row by row (K12), as JAX does, so
    that both packages take the same write path on the same shapes."""
    B, Hkv, W, D = k_new.shape
    page = cache.page_size
    if W > page or D % 128 or page % 128 or Hkv % 8:
        return None
    paged_write_window_kernel(k_new.contiguous(), v_new.contiguous(),
                              *_pool_args(cache),
                              pos_vector(pos, B, k_new.device), cache.k_offs,
                              cache.v_offs)
    return cache


def paged_window_attention(q, cache, lengths):
    """W-query causal attention over a ``PagedKVCache`` (a speculative
    verify window): q [B, H, W, D]; ``lengths`` [B] = the slot's tokens
    INCLUDING the whole window (window row w sits at position
    ``lengths - W + w`` and attends keys up to it; its rows written
    before the call). Slots with length 0 return zeros. Returns
    [B, H, W, D] bf16."""
    B = q.shape[0]
    return paged_window_attn(q.contiguous(), *_pool_args(cache),
                             pos_vector(lengths, B, q.device), cache.k_offs,
                             cache.v_offs)


# ---------------------------------------------------------------------------
# K14: MLA latent paging (DeepSeek). A latent pool holds one C = r + dr row
# a token, [P, 1, page, C]: the post-norm latent and the rotated shared rope
# key, both key and value of every head (``models.deepseek``).
# ---------------------------------------------------------------------------


def _latent_targets(block_tables, pos, page: int):
    """(slot indices, pool pages, rows) of the latent rows K14's write puts
    down: a negative position writes nothing; a page index past the block
    table writes the trash page 0 at ``pos % page``, as JAX's
    ``paged_write_latent`` does (its ``take_along_axis`` fills and its
    page index clamps to 0); one writer a target row, the last slot."""
    PMAX = block_tables.shape[1]
    p = pos.to(torch.int64).reshape(-1)
    rows = torch.nonzero(p >= 0).reshape(-1)
    p = p[rows]
    j = torch.div(p, page, rounding_mode="floor")
    pid = torch.where(j < PMAX,
                      block_tables.to(torch.int64)[rows, j.clamp(max=PMAX - 1)],
                      torch.zeros_like(j))
    off = p % page
    key = pid * page + off
    uniq, inv = torch.unique(key, return_inverse=True)
    last = torch.full_like(uniq, -1).scatter_reduce(
        0, inv, torch.arange(key.numel(), device=key.device), reduce="amax")
    return rows[last], pid[last], off[last]


def paged_latent_write_plain(row, lat_pages, block_tables, pos) -> None:
    """Plain PyTorch version of K14's write, in place: ``row`` [B, C] (the
    slots' new latent rows), ``lat_pages`` [P, 1, page, C] (bf16, or
    float32 for a float32 model on the CPU), ``block_tables`` [B, PMAX]
    int32, ``pos`` [B] int32; targets as ``_latent_targets`` gives them
    (several slots on one row: the last slot's row stands, as in the
    kernel)."""
    rows, pid, off = _latent_targets(block_tables, pos, lat_pages.shape[2])
    lat_pages[pid, 0, off] = row[rows].to(lat_pages.dtype)


def paged_latent_write(row, lat_pages, block_tables, pos) -> None:
    """K14's write on the card (``csrc/paged_latent.cu``,
    ``nctt_paged_latent_write``) into a bf16 latent pool, in place; the
    plain version for CPU tensors. Arguments as in
    ``paged_latent_write_plain``; ``pos`` stays on the device. Launches are
    counted in ``paged_latent_write.launches``."""
    if row.device.type == "cpu":
        return paged_latent_write_plain(row, lat_pages, block_tables, pos)
    dev = row.device
    B, C = row.shape
    P, one, page, _c = lat_pages.shape
    PMAX = block_tables.shape[1]
    if one != 1:
        raise ValueError(f"paged_latent_write: pages [P, 1, page, C], got "
                         f"{tuple(lat_pages.shape)}")
    _build.require(row, "row", torch.bfloat16, dev, (B, C))
    _build.require(lat_pages, "lat_pages", torch.bfloat16, dev,
                   (P, 1, page, C))
    _build.require(block_tables, "block_tables", torch.int32, dev, (B, PMAX))
    _build.require(pos, "pos", torch.int32, dev, (B,))
    err = _build.library().nctt_paged_latent_write(
        row.data_ptr(), lat_pages.data_ptr(), block_tables.data_ptr(),
        pos.data_ptr(), B, P, page, PMAX, C, _build.stream_handle(dev))
    _build.check(err, "nctt_paged_latent_write")
    paged_latent_write.launches += 1


paged_latent_write.launches = 0


def paged_latent_attn_plain(q, lat_pages, block_tables, lengths, r: int,
                            scale: float) -> torch.Tensor:
    """Plain PyTorch version of K14's attention: q [B, H, C] (the absorbed
    query | the rotated rope query), ``lat_pages`` [P, 1, page, C] (bf16;
    float32 pages with a float32 q for a float32 model on the CPU),
    ``block_tables`` [B, PMAX] int32, ``lengths`` [B] int32 (the slot's
    rows, the new one included) -> float32 [B, H, r].

    s = f32(q . lat) * f32(scale) over the rows t < lengths (at most PMAX *
    page); e = exp(s - m), l = sum e; the probabilities rounded to the
    pages' dtype for PV against the rows' first r columns; acc / max(l,
    1e-30); zeros for a zero-length slot. Sums in float64 over exact
    products, one rounding each, as the CUDA kernel sums. The TPU kernel's
    online softmax over groups of min(4, PMAX) pages equals this one pass
    wherever one group covers the slot's pages or the running max does not
    move."""
    B, H, C = q.shape
    dev = q.device
    lat = _gather_pages(lat_pages, block_tables.to(torch.int64))[:, 0]
    T = lat.shape[1]                                  # [B, T, C]
    lat64 = lat.to(_F64)
    s = torch.einsum("bhc,btc->bht", q.to(_F64), lat64).to(_F32)
    s = s * torch.tensor(scale, dtype=_F32)
    n = lengths.to(torch.int64).reshape(B, 1, 1)
    valid = torch.arange(T, device=dev)[None, None, :] < n
    s = torch.where(valid, s, torch.tensor(-1e30, device=dev))
    e = torch.exp(s.to(_F64) - s.amax(dim=-1, keepdim=True).to(_F64))
    e = torch.where(valid, e, torch.zeros((), dtype=_F64, device=dev))
    l = e.sum(dim=-1, keepdim=True).to(_F32)
    p = e.to(_F32).to(lat_pages.dtype).to(_F64)
    acc = torch.einsum("bht,btc->bhc", p, lat64[..., :r]).to(_F32)
    out = acc / l.clamp_min(1e-30)
    return torch.where((lengths > 0).reshape(B, 1, 1), out,
                       torch.zeros((), device=dev))


class LatentPlan(NamedTuple):
    """How K14's attention cuts one call (``latent_plan``): parts of whole
    pages, the scores launch's row blocks, the PV launch's column passes
    and the scratch's sizes."""
    part_rows: int       # rows a part: whole pages from row 0 on
    parts: int           # parts over the block table's PMAX pages
    row_blocks: int      # the scores launch's blocks of 4096 / HEAD_GROUP rows
    passes: int          # the PV launch's blocks of 8192 / HEAD_GROUP columns
    scores: int          # float32 score rows, B * H * PMAX * page
    maxima: int          # float32 row-block maxima, B * H * row_blocks
    partials: int        # float64 partials, B * H * parts * (r + 1)


# rows a part of K14's split holds: whole pages, 4 pages of the engine's 128
# rows (a page past it is a part of its own, cut at PART_ROWS rows)
PART_ROWS = 512
# heads a block (csrc/paged_latent.cuh HG). The grids' block counts do not
# depend on it (a group twice as wide has half the rows a scores block and
# half the columns a PV block); 32 measured fastest of 16-128
# (tools/latent_attn_sweep.py)
HEAD_GROUP = 32
_LAT_STAGES = 3                # csrc/paged_latent.cuh NST
_LAT_MAX_PART_ROWS = 1024      # csrc/paged_latent.cuh MAX_PART_ROWS
_LAT_MAX_DYN = 232448 - 12288  # csrc/paged_latent.cuh MAX_DYN
_LAT_KR = 32
_LAT_NCC = 8192 // HEAD_GROUP  # columns of a PV pass (PvShape::NCC)


def _latent_pv_smem(part_rows: int) -> int:
    """The PV launch's dynamic shared memory, its ring and p's rows
    (``pv_smem`` in csrc/paged_latent.cuh)."""
    p_rows = HEAD_GROUP * (-(-part_rows // _LAT_KR) * _LAT_KR + 4) * 2
    return _LAT_STAGES * _LAT_KR * (2 * _LAT_NCC + 32) + p_rows


@functools.lru_cache(maxsize=256)
def latent_plan(B: int, H: int, C: int, r: int, page: int,
                PMAX: int) -> LatentPlan:
    """K14's plan for q [B, H, C] over pages of ``page`` rows, PMAX a slot,
    output width r. A slot's rows split into parts of ``max(1, PART_ROWS //
    page)`` whole pages (PART_ROWS rows where a page is longer): absolute
    row positions set by the page size alone, never by the lengths, B, H,
    C or r, so a row's terms are summed in the same order whatever else
    shares the launch. The heads split into groups of HEAD_GROUP; the
    scores launch takes blocks of 4096 / HEAD_GROUP rows, the PV launch
    passes of 8192 / HEAD_GROUP columns."""
    part_rows = (max(1, PART_ROWS // page) * page if page <= PART_ROWS
                 else PART_ROWS)
    if (part_rows > _LAT_MAX_PART_ROWS
            or _latent_pv_smem(part_rows) > _LAT_MAX_DYN):
        raise ValueError(f"latent_plan: parts of {part_rows} rows do not "
                         f"fit a block")
    Tv = PMAX * page
    parts = -(-Tv // part_rows)
    row_blocks = -(-Tv // (4096 // HEAD_GROUP))
    return LatentPlan(part_rows, parts, row_blocks, -(-r // _LAT_NCC),
                      B * H * Tv, B * H * row_blocks,
                      B * H * parts * (r + 1))


# device -> (sizes held, buffers, {plan: argument block}): K14's attention
# scratch, flat: score rows and row-block maxima (float32) and partials
# (float64), replaced by larger ones (and the argument blocks dropped) when
# a call needs more. Calls on one stream run in order, so one call's scratch
# is free when the next starts.
_LAT_SCRATCH: dict = {}


def latent_workspace(plan: LatentPlan, device) -> int:
    """The address of the argument block of K14's attention entry for
    ``plan`` on ``device``: five 64-bit words, the scratch's addresses
    (score rows, sized as ``decode_attention.score_workspace`` sizes them
    but kept here so that the block stays valid, row-block maxima,
    partials) and the plan (part rows, parts)."""
    have = _LAT_SCRATCH.get(device)
    if have is not None:
        block = have[2].get(plan)
        if block is not None:
            return block[1]
    need = (plan.scores, plan.maxima, plan.partials)
    if have is None or any(h < n for h, n in zip(have[0], need)):
        n = need if have is None else tuple(map(max, have[0], need))
        bufs = (torch.empty(n[0], dtype=_F32, device=device),
                torch.empty(n[1], dtype=_F32, device=device),
                torch.empty(n[2], dtype=_F64, device=device))
        have = (n, bufs, {})
        _LAT_SCRATCH[device] = have
    words = (ctypes.c_int64 * 5)(*(b.data_ptr() for b in have[1]),
                                 plan.part_rows, plan.parts)
    have[2][plan] = (words, ctypes.addressof(words))
    return have[2][plan][1]


def paged_latent_attn(q, lat_pages, block_tables, lengths, r: int,
                      scale: float) -> torch.Tensor:
    """K14's attention on the card (``csrc/paged_latent.cu``,
    ``nctt_paged_latent_attention``: three CUDA launches a call over
    ``latent_plan``'s row blocks, parts and head groups, scratch from
    ``latent_workspace``) over a bf16 latent pool; the plain version for
    CPU tensors. Arguments as in ``paged_latent_attn_plain``; ``lengths``
    stays on the device. Launches are counted in
    ``paged_latent_attn.launches``, one a call."""
    if q.device.type == "cpu":
        return paged_latent_attn_plain(q, lat_pages, block_tables, lengths,
                                       r, scale)
    dev = q.device
    B, H, C = q.shape
    P, one, page, _c = lat_pages.shape
    PMAX = block_tables.shape[1]
    if not (one == 1 and 1 <= r <= C <= 1024):
        raise ValueError(f"paged_latent_attn needs pages [P, 1, page, C] "
                         f"and 1 <= r <= C <= 1024 (C={C}, r={r})")
    _build.require(q, "q", torch.bfloat16, dev, (B, H, C))
    _build.require(lat_pages, "lat_pages", torch.bfloat16, dev,
                   (P, 1, page, C))
    _build.require(block_tables, "block_tables", torch.int32, dev, (B, PMAX))
    _build.require(lengths, "lengths", torch.int32, dev, (B,))
    out = torch.empty((B, H, r), dtype=_F32, device=dev)
    plan = latent_plan(B, H, C, r, page, PMAX)
    err = _build.library().nctt_paged_latent_attention(
        q.data_ptr(), lat_pages.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), latent_workspace(plan, dev), B,
        H, P, page, PMAX, C, r, float(scale), _build.stream_handle(dev))
    _build.check(err, "nctt_paged_latent_attention")
    paged_latent_attn.launches += 1
    return out


paged_latent_attn.launches = 0


def paged_write_latent(lat_pages, block_tables, row, pos):
    """Write one latent row a slot (``row`` [B, C]) at per-slot ``pos`` (an
    int or [B]) into the pool IN PLACE through K14's write (JAX's
    ``paged_write_latent``, whose TPU kernel aliases its output); returns
    the pages. JAX falls back to an XLA scatter for pages of a size that is
    not a multiple of 8 (the TPU's tile rule); the port's kernel takes
    every page size."""
    B = row.shape[0]
    paged_latent_write(row.to(lat_pages.dtype).contiguous(), lat_pages,
                       block_tables, pos_vector(pos, B, row.device))
    return lat_pages


def paged_latent_attention(qcat, lat_pages, block_tables, lengths, r: int,
                           scale: float) -> torch.Tensor:
    """Decode attention over a paged MLA latent pool (JAX's
    ``paged_latent_attention``): ``qcat`` [B, H, 1, C], ``lengths`` [B]
    including the current row (written first). Returns o_lat [B, H, 1, r]
    float32, the probabilities times the latent; the caller applies the
    value absorb factor. Zero-length slots give zeros."""
    B, H, S, C = qcat.shape
    if S != 1:
        raise ValueError("paged latent attention is single-token")
    out = paged_latent_attn(qcat[:, :, 0].contiguous(), lat_pages,
                            block_tables, pos_vector(lengths, B, qcat.device),
                            r, scale)
    return out[:, :, None]
