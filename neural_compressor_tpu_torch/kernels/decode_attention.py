"""B=1 single-token decode attention over a bf16 head-major KV cache.

q [B, H, D] against caches [B, Hkv, T, D]; the ``rep = H / Hkv`` query
heads of a KV head share its rows (GQA). Scores are float32 times
``1/sqrt(D)``, keys after ``pos`` are masked out, the softmax
probabilities are cast to the cache dtype (bf16) before the PV product.
K5 sums in float32; the port sums in float64 over the exact bf16 products
and rounds once, so the summation order almost never shows (the
two differ by less than float32's rounding).

Ports ``neural_compressor_tpu/kernels/decode_attention.py``
``_decode_attn_ro_impl`` / ``_kernel_ro`` (K5). The TPU kernel reads the
cache read-only and folds the new K/V row in by a select at ``pos``; JAX
writes that row into the cache right after the kernel. The port writes the
row into the cache first, in place, and then attends: the kernel sees the
same values (the select uses the row cast to the cache dtype), and the
cache is updated without a copy. The CUDA kernel is
``csrc/decode_attention.cu``; it visits only the rows ``t <= pos``, which
is what the -1e30 mask leaves of the softmax.
"""

from __future__ import annotations

import torch

from . import _build

# decode attention dispatch: the fused kernel serves single-row decode
_FUSED_ATTN_MAX_BATCH = 1


def use_fused_decode_attention(batch: int = 1) -> bool:
    return batch <= _FUSED_ATTN_MAX_BATCH


def decode_attn_plain(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: q [B, H, D]; caches
    [B, Hkv, T, D] already holding row ``pos`` -> [B, H, D] in q's dtype.

    Sums run in float64 over exact bf16 products and round once, so the
    summation order almost never shows and the kernel matches it bit for
    bit."""
    B, H, D = q.shape
    Hkv = k_cache.shape[1]
    rep = H // Hkv
    f64 = torch.float64
    qr = q.reshape(B, Hkv, rep, D).to(f64)
    k = k_cache[:, :, :pos + 1].to(f64)
    v = v_cache[:, :, :pos + 1]
    s = torch.einsum("bgrd,bgtd->bgrt", qr, k).to(torch.float32) \
        * (1.0 / (D ** 0.5))
    e = torch.exp(s.to(f64) - s.amax(dim=-1, keepdim=True).to(f64))
    p = (e / e.sum(dim=-1, keepdim=True)).to(torch.float32).to(v.dtype)
    o = torch.einsum("bgrt,bgtd->bgrd", p.to(f64), v.to(f64))
    return o.to(torch.float32).reshape(B, H, D).to(q.dtype)


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: int) -> torch.Tensor:
    """The decode attention kernel on the card (``csrc/decode_attention.cu``);
    the plain version for CPU tensors. Arguments as in
    ``decode_attn_plain``."""
    if q.device.type == "cpu":
        return decode_attn_plain(q, k_cache, v_cache, pos)
    dev = q.device
    B, H, D = q.shape
    _b, Hkv, T, _d = k_cache.shape
    rep = H // Hkv if Hkv else 0
    if not (D in (32, 64, 128, 256) and Hkv * rep == H and 1 <= rep <= 8
            and 0 <= pos < T):
        raise ValueError(f"decode_attn needs D in (32, 64, 128, 256), "
                         f"1 <= H/Hkv <= 8 and 0 <= pos < T "
                         f"(H={H}, Hkv={Hkv}, D={D}, pos={pos}, T={T})")
    smem = 8 * 8 * rep * D + 4 * (rep * D + rep * (pos + 1))
    if smem > 227 * 1024:
        raise ValueError(f"decode_attn: pos={pos} needs {smem} bytes of "
                         "shared memory, more than a block has")
    _build.require(q, "q", torch.bfloat16, dev, (B, H, D))
    _build.require(k_cache, "k_cache", torch.bfloat16, dev, (B, Hkv, T, D))
    _build.require(v_cache, "v_cache", torch.bfloat16, dev, (B, Hkv, T, D))
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    err = _build.library().nctt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        B, H, Hkv, T, D, int(pos), 1.0 / (D ** 0.5),
        _build.stream_handle(dev))
    _build.check(err, "nctt_decode_attention")
    decode_attn.launches += 1
    return out


decode_attn.launches = 0


def decode_attention(q, k_new, v_new, k_cache, v_cache, pos):
    """Single-token attention with cache update.

    q [B, H, 1, D]; k_new/v_new [B, Hkv, 1, D] (rope applied); caches
    [B, Hkv, T, D]; ``pos`` an int. Writes the new rows into the caches
    IN PLACE, then attends. Returns (out [B, H, 1, D], k_cache, v_cache)."""
    from ..models.llama import _update_rows

    B, H, S, D = q.shape
    if S != 1:
        raise ValueError("decode attention is single-token")
    if B != 1 or not isinstance(pos, int):
        raise NotImplementedError(
            "B > 1 decode attention waits for the port of "
            "neural_compressor_tpu.kernels.decode_attention."
            "batched_decode_attention (K7)")
    k_cache = _update_rows(k_cache, k_new, pos)
    v_cache = _update_rows(v_cache, v_new, pos)
    out = decode_attn(q[:, :, 0].contiguous(), k_cache, v_cache, pos)
    return out[:, :, None], k_cache, v_cache
