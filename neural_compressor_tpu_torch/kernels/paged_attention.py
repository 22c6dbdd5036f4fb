"""Paged decode attention and paged row writes over a shared page pool.

A pool holds pages [P, Hkv, page, D] (bf16 rows, or int8 codes with
per-(token, head) float32 scales [P, Hkv, page]); each slot's block table
[B, PMAX] int32 maps its logical page j (tokens j*page .. j*page+page-1) to
a pool page. Page 0 is the trash page: the engine points every free
block-table entry at it, and idle slots write and read it.

Ports ``neural_compressor_tpu/kernels/paged_attention.py``:
  * K11, ``paged_decode_attention`` (``_paged_attn_impl_v2`` /
    ``_paged_kernel_v2``): single-token attention over a slot's pages up to
    ``lengths[b]`` (the new row included), online softmax in the TPU
    kernel, int8 scales folded into the scores (``s * k_scale * D^-1/2``)
    and the probabilities (``exp(s - m) * v_scale``, then bf16 for PV),
    ``acc / max(l, 1e-30)`` at the end, and zeros for a zero-length slot.
    CUDA kernel: ``csrc/paged_attention.cu``.
  * K12, ``paged_write_rows`` (``_paged_write_impl`` / ``_write_kernel_bf16``
    / ``_write_kernel_quant``): each slot's new K/V row into page
    ``block_tables[b, pos // page]`` at row ``pos % page``, in place; int8
    pools quantize the row per (token, head): ``scale = amax * f32(1/127)``
    (1 where amax <= 0, XLA's reciprocal form of ``amax / 127``),
    ``code = clip(rint(x / scale), -128, 127)``. The TPU kernel stages and
    rewrites the slot's whole page block; the port writes only the row.
    CUDA kernel: ``csrc/paged_write.cu``.

A position whose page index ``pos // page`` is past the block table (an
idle or finished slot running on inside a multi-step dispatch) writes
nothing, as JAX's scatter drops it, and attention visits at most
``PMAX * page`` rows. fp8 and int4 pools, ``window`` and ``softcap`` raise.
"""

from __future__ import annotations

import torch

from . import _build

_F64 = torch.float64


def _check_pool(k_pages: torch.Tensor, k_scales) -> bool:
    """True for an int8 pool with scales, False for bf16; raise else."""
    if k_pages.dtype == torch.int8 and k_scales is not None:
        return True
    if k_pages.dtype == torch.bfloat16 and k_scales is None:
        return False
    raise NotImplementedError(
        f"{k_pages.dtype} page pools wait for the port of the fp8 and int4 "
        "branches of neural_compressor_tpu.kernels.paged_attention "
        "(_paged_kernel_v2, _write_kernel_int4)")


def _gather_pages(pages: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """[P, Hkv, page, ...] through [B, PMAX] -> [B, Hkv, PMAX*page, ...]."""
    g = pages[bt]                                   # [B, PMAX, Hkv, page, ...]
    B, PMAX, Hkv, page = g.shape[:4]
    return g.transpose(1, 2).reshape(B, Hkv, PMAX * page, *g.shape[4:])


def paged_attn_plain(q, k_pages, k_scales, v_pages, v_scales, block_tables,
                     lengths) -> torch.Tensor:
    """Plain PyTorch version of K11: q [B, H, D] bf16; pools as in the
    module docstring; ``block_tables`` [B, PMAX] int32; ``lengths`` [B]
    int32 -> [B, H, D] bf16.

    Sums run in float64 over exact products (bf16 times bf16 or int8) and
    round once, as the CUDA kernel does. The TPU kernel's online softmax
    over groups of 4 pages equals this one pass whenever one group covers
    the visited pages (PMAX <= 4) or the running max does not move."""
    quant = _check_pool(k_pages, k_scales)
    B, H, D = q.shape
    Hkv, page = k_pages.shape[1], k_pages.shape[2]
    PMAX = block_tables.shape[1]
    rep = H // Hkv
    W = PMAX * page
    dev = q.device
    bt = block_tables.to(torch.int64)
    k = _gather_pages(k_pages, bt)                  # [B, Hkv, W, D]
    v = _gather_pages(v_pages, bt)
    n = lengths.to(torch.int64).clamp(0, W)
    valid = (torch.arange(W, device=dev)[None, :] < n[:, None])[:, None, None]
    qr = q.reshape(B, Hkv, rep, D).to(_F64)
    s = torch.einsum("bgrd,bgtd->bgrt", qr, k.to(_F64)).to(torch.float32)
    if quant:
        s = s * _gather_pages(k_scales, bt)[:, :, None, :]
    s = s * (1.0 / (D ** 0.5))
    s = torch.where(valid, s, torch.tensor(-1e30, device=dev))
    e = torch.exp(s.to(_F64) - s.amax(dim=-1, keepdim=True).to(_F64))
    e = torch.where(valid, e, torch.zeros((), dtype=_F64, device=dev))
    l = e.sum(dim=-1, keepdim=True).to(torch.float32)
    pe = e.to(torch.float32)
    if quant:
        pe = pe * _gather_pages(v_scales, bt)[:, :, None, :]
    p = pe.to(torch.bfloat16)
    acc = torch.einsum("bgrt,bgtd->bgrd", p.to(_F64), v.to(_F64))
    out = acc.to(torch.float32) / l.clamp_min(1e-30)
    out = torch.where((lengths > 0)[:, None, None, None], out,
                      torch.zeros((), device=dev))
    return out.reshape(B, H, D).to(torch.bfloat16)


def _paged_attn_smem(rep: int, D: int, W: int) -> int:
    # csrc/paged_attention.cu: cross-warp float64 partials, per-row sums,
    # q rows, score rows over PMAX*page
    return 8 * 8 * rep * D + 8 * rep + 4 * (rep * D + rep * W)


def paged_attn(q, k_pages, k_scales, v_pages, v_scales, block_tables,
               lengths) -> torch.Tensor:
    """K11 on the card (``csrc/paged_attention.cu``); the plain version for
    CPU tensors. Arguments as in ``paged_attn_plain``."""
    if q.device.type == "cpu":
        return paged_attn_plain(q, k_pages, k_scales, v_pages, v_scales,
                                block_tables, lengths)
    quant = _check_pool(k_pages, k_scales)
    dev = q.device
    B, H, D = q.shape
    P, Hkv, page, _d = k_pages.shape
    PMAX = block_tables.shape[1]
    rep = H // Hkv if Hkv else 0
    if not (D in (32, 64, 128, 256) and Hkv * rep == H and 1 <= rep <= 8
            and page >= 1 and PMAX >= 1):
        raise ValueError(f"paged_attn needs D in (32, 64, 128, 256) and "
                         f"1 <= H/Hkv <= 8 (H={H}, Hkv={Hkv}, D={D})")
    if _paged_attn_smem(rep, D, PMAX * page) > 227 * 1024:
        raise ValueError(f"paged_attn: {PMAX} pages of {page} rows need more "
                         "shared memory than a block has")
    cdt = torch.int8 if quant else torch.bfloat16
    _build.require(q, "q", torch.bfloat16, dev, (B, H, D))
    _build.require(k_pages, "k_pages", cdt, dev, (P, Hkv, page, D))
    _build.require(v_pages, "v_pages", cdt, dev, (P, Hkv, page, D))
    if quant:
        _build.require(k_scales, "k_scales", torch.float32, dev,
                       (P, Hkv, page))
        _build.require(v_scales, "v_scales", torch.float32, dev,
                       (P, Hkv, page))
    _build.require(block_tables, "block_tables", torch.int32, dev, (B, PMAX))
    _build.require(lengths, "lengths", torch.int32, dev, (B,))
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    err = _build.library().nctt_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(),
        k_scales.data_ptr() if quant else None, v_pages.data_ptr(),
        v_scales.data_ptr() if quant else None, block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, Hkv, P, page, PMAX, D,
        int(quant), 1.0 / (D ** 0.5), _build.stream_handle(dev))
    _build.check(err, "nctt_paged_decode_attention")
    paged_attn.launches += 1
    return out


paged_attn.launches = 0


def kv_quant_int8(x: torch.Tensor):
    """Per-(token, head) int8 codes of ``x`` [..., D] and their float32
    scales [...], as ``neural_compressor_tpu.models.llama._kv_quant``
    (int8) computes them under XLA: ``amax * f32(1/127)``, a true division
    of x by the scale, half-to-even rounding."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax <= 0, torch.ones((), device=x.device),
                        amax * (1.0 / 127.0))
    codes = torch.clamp(torch.round(xf / scale[..., None]), -128, 127)
    return codes.to(torch.int8), scale


def paged_write_plain(k_new, v_new, k_pages, k_scales, v_pages, v_scales,
                      block_tables, pos) -> None:
    """Plain PyTorch version of K12, in place: ``k_new``/``v_new``
    [B, Hkv, D] bf16; pools and block tables as in the module docstring;
    ``pos`` [B] int32. Rows whose page index is past the block table are
    dropped. Several slots writing one page row (idle slots on the trash
    page) leave the last slot's row there (the kernel leaves one of them,
    unspecified which)."""
    quant = _check_pool(k_pages, k_scales)
    page = k_pages.shape[2]
    PMAX = block_tables.shape[1]
    p = pos.to(torch.int64)
    j = torch.div(p, page, rounding_mode="floor")
    rows = torch.nonzero((p >= 0) & (j < PMAX)).reshape(-1)
    pid = block_tables.to(torch.int64)[rows, j[rows]]
    off = p[rows] % page
    # one writer a target row: an index assignment with duplicate targets
    # may mix their elements across threads; the last slot's row stands
    key = pid * page + off
    uniq, inv = torch.unique(key, return_inverse=True)
    last = torch.full_like(uniq, -1).scatter_reduce(
        0, inv, torch.arange(key.numel(), device=key.device), reduce="amax")
    rows, pid, off = rows[last], pid[last], off[last]
    if quant:
        kc, ks = kv_quant_int8(k_new[rows])
        vc, vs = kv_quant_int8(v_new[rows])
        k_pages[pid, :, off] = kc
        v_pages[pid, :, off] = vc
        k_scales[pid, :, off] = ks
        v_scales[pid, :, off] = vs
    else:
        k_pages[pid, :, off] = k_new[rows].to(k_pages.dtype)
        v_pages[pid, :, off] = v_new[rows].to(v_pages.dtype)


def paged_write(k_new, v_new, k_pages, k_scales, v_pages, v_scales,
                block_tables, pos) -> None:
    """K12 on the card (``csrc/paged_write.cu``); the plain version for CPU
    tensors. Arguments as in ``paged_write_plain``; ``pos`` stays on the
    device."""
    if k_new.device.type == "cpu":
        return paged_write_plain(k_new, v_new, k_pages, k_scales, v_pages,
                                 v_scales, block_tables, pos)
    quant = _check_pool(k_pages, k_scales)
    dev = k_new.device
    B, Hkv, D = k_new.shape
    P, _h, page, _d = k_pages.shape
    PMAX = block_tables.shape[1]
    cdt = torch.int8 if quant else torch.bfloat16
    _build.require(k_new, "k_new", torch.bfloat16, dev, (B, Hkv, D))
    _build.require(v_new, "v_new", torch.bfloat16, dev, (B, Hkv, D))
    _build.require(k_pages, "k_pages", cdt, dev, (P, Hkv, page, D))
    _build.require(v_pages, "v_pages", cdt, dev, (P, Hkv, page, D))
    if quant:
        _build.require(k_scales, "k_scales", torch.float32, dev,
                       (P, Hkv, page))
        _build.require(v_scales, "v_scales", torch.float32, dev,
                       (P, Hkv, page))
    _build.require(block_tables, "block_tables", torch.int32, dev, (B, PMAX))
    _build.require(pos, "pos", torch.int32, dev, (B,))
    err = _build.library().nctt_paged_write_rows(
        k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
        k_scales.data_ptr() if quant else None, v_pages.data_ptr(),
        v_scales.data_ptr() if quant else None, block_tables.data_ptr(),
        pos.data_ptr(), B, Hkv, P, page, PMAX, D, int(quant),
        _build.stream_handle(dev))
    _build.check(err, "nctt_paged_write_rows")
    paged_write.launches += 1


paged_write.launches = 0


def _pos_vector(pos, B: int, device) -> torch.Tensor:
    if not isinstance(pos, torch.Tensor):
        return torch.full((B,), int(pos), dtype=torch.int32, device=device)
    return pos.reshape(-1).to(torch.int32).expand(B).contiguous()


def paged_write_rows(cache, k_new, v_new, pos):
    """Write the new K/V rows [B, Hkv, 1, D] into their pages at per-slot
    ``pos`` (an int or [B]), IN PLACE (the TPU kernel aliases its outputs);
    returns ``cache``, a ``models.llama.PagedKVCache``."""
    B = k_new.shape[0]
    paged_write(k_new[:, :, 0].contiguous(), v_new[:, :, 0].contiguous(),
                cache.k_pages, cache.k_scales, cache.v_pages, cache.v_scales,
                cache.block_tables, _pos_vector(pos, B, k_new.device))
    return cache


def paged_decode_attention(q, cache, lengths, window=None, softcap=None):
    """Single-token attention over a ``PagedKVCache``: q [B, H, 1, D];
    ``lengths`` [B] = tokens in the cache INCLUDING the current one (its
    row written before the call). Slots with length 0 return zeros.
    Returns [B, H, 1, D] bf16."""
    if window is not None or softcap is not None:
        raise NotImplementedError(
            "window and softcap wait for the port of gemma's paths through "
            "neural_compressor_tpu.kernels.paged_attention._paged_kernel_v2")
    B, _H, S, _D = q.shape
    if S != 1:
        raise ValueError("paged decode attention is single-token")
    out = paged_attn(q[:, :, 0].contiguous(), cache.k_pages, cache.k_scales,
                     cache.v_pages, cache.v_scales, cache.block_tables,
                     _pos_vector(lengths, B, q.device))
    return out[:, :, None]
