"""Single-token decode attention over a bf16 head-major KV cache: B=1
(K5) and batched with per-slot positions (K7).

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

K7 ports ``_batched_attn_impl`` / ``_kernel_batched`` for bf16 caches
(``csrc/batched_decode_attention.cu``): per-slot ``pos`` [B] read on the
device, and K7's order of operations, which normalises after PV (K5
normalises before the bf16 cast). Its int8/fp8 branch waits for
``QuantKVCache`` and K6.
"""

from __future__ import annotations

import torch

from . import _build


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
    [B, Hkv, T, D]; ``pos`` an int, or a [B] tensor of per-slot positions.
    Writes the new rows into the caches IN PLACE, then attends: B == 1 with
    an int ``pos`` on the B=1 kernel (K5), otherwise on K7
    (``batched_decode_attention``). Returns (out [B, H, 1, D], k_cache,
    v_cache)."""
    from ..models.llama import _update_rows

    B, H, S, D = q.shape
    if S != 1:
        raise ValueError("decode attention is single-token")
    k_cache = _update_rows(k_cache, k_new, pos)
    v_cache = _update_rows(v_cache, v_new, pos)
    if B != 1 or not isinstance(pos, int):
        return (batched_decode_attention(q, k_cache, v_cache, pos),
                k_cache, v_cache)
    out = decode_attn(q[:, :, 0].contiguous(), k_cache, v_cache, pos)
    return out[:, :, None], k_cache, v_cache


# ---------------------------------------------------------------------------
# K7: batched single-token attention over an already-updated cache
# ---------------------------------------------------------------------------


def batched_decode_attn_plain(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor,
                              pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: q [B, H, D] bf16; caches [B, Hkv, T, D]
    bf16 already holding each slot's row ``pos[b]``; ``pos`` int32 [B]
    (a slot at or past T - 1 attends every row) -> [B, H, D] bf16.

    K7's order of operations: float32 scores times ``1/sqrt(D)``, keys
    after ``pos[b]`` masked, ``exp(s - m)`` rounded to bf16 for the PV
    product, ``l = sum exp(s - m)`` unrounded, and ``acc / l`` at the end
    (``decode_attention.py:596-614``). Sums run in float64 over exact
    products and round once, as the CUDA kernel does. The TPU kernel takes
    its running max over T-chunks; one pass over the visited rows gives the
    final max, which is what it computes whenever one chunk covers them
    (T <= 1024 at D = 128)."""
    B, H, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    f64 = torch.float64
    last = pos.to(torch.int64).clamp(0, T - 1)
    valid = (torch.arange(T, device=q.device)[None, :]
             <= last[:, None])[:, None, None, :]              # [B,1,1,T]
    qr = q.reshape(B, Hkv, rep, D).to(f64)
    s = torch.einsum("bgrd,bgtd->bgrt", qr, k_cache.to(f64)).to(
        torch.float32) * (1.0 / (D ** 0.5))
    s = torch.where(valid, s, torch.tensor(-1e30, device=q.device))
    e = torch.exp(s.to(f64) - s.amax(dim=-1, keepdim=True).to(f64))
    e = torch.where(valid, e, torch.zeros((), dtype=f64, device=q.device))
    l = e.sum(dim=-1, keepdim=True).to(torch.float32)
    p = e.to(torch.float32).to(torch.bfloat16)
    acc = torch.einsum("bgrt,bgtd->bgrd", p.to(f64), v_cache.to(f64))
    out = acc.to(torch.float32) / l
    return out.reshape(B, H, D).to(q.dtype)


def _batched_smem(rep: int, D: int, T: int) -> int:
    # csrc/batched_decode_attention.cu: cross-warp float64 partials, q rows,
    # score rows over all T, per-row sums
    return 8 * 8 * rep * D + 4 * (rep * D + rep * T) + 8 * rep


def batched_decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
    """K7 on the card (``csrc/batched_decode_attention.cu``); the plain
    version for CPU tensors. Arguments as in ``batched_decode_attn_plain``;
    ``pos`` stays on the device (the kernel reads it, no host sync)."""
    if q.device.type == "cpu":
        return batched_decode_attn_plain(q, k_cache, v_cache, pos)
    dev = q.device
    B, H, D = q.shape
    _b, Hkv, T, _d = k_cache.shape
    rep = H // Hkv if Hkv else 0
    if not (D in (32, 64, 128, 256) and Hkv * rep == H and 1 <= rep <= 8
            and T >= 1):
        raise ValueError(f"batched_decode_attn needs D in (32, 64, 128, 256) "
                         f"and "
                         f"1 <= H/Hkv <= 8 (H={H}, Hkv={Hkv}, D={D}, T={T})")
    if _batched_smem(rep, D, T) > 227 * 1024:
        raise ValueError(f"batched_decode_attn: T={T} needs "
                         f"{_batched_smem(rep, D, T)} bytes of shared memory, "
                         "more than a block has")
    _build.require(q, "q", torch.bfloat16, dev, (B, H, D))
    _build.require(k_cache, "k_cache", torch.bfloat16, dev, (B, Hkv, T, D))
    _build.require(v_cache, "v_cache", torch.bfloat16, dev, (B, Hkv, T, D))
    _build.require(pos, "pos", torch.int32, dev, (B,))
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    err = _build.library().nctt_batched_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, H, Hkv, T, D, 1.0 / (D ** 0.5),
        _build.stream_handle(dev))
    _build.check(err, "nctt_batched_decode_attention")
    batched_decode_attn.launches += 1
    return out


batched_decode_attn.launches = 0


def batched_decode_attention(q, k_cache, v_cache, pos, k_scale=None,
                             v_scale=None):
    """Single-token attention over an ALREADY-UPDATED cache, per-slot
    positions (``neural_compressor_tpu``'s ``batched_decode_attention``).

    q [B, H, 1, D]; caches [B, Hkv, T, D] bf16; ``pos`` an int or a [B]
    tensor. Returns out [B, H, 1, D] in q's dtype. Unlike the TPU kernel,
    which returns None off its envelope (B == 1, B*Hkv < 16, D or T not a
    multiple of 128) for an XLA fallback, the port's kernel covers those
    shapes; off its own envelope it raises."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized caches in batched decode attention wait for the port "
            "of neural_compressor_tpu.models.llama.QuantKVCache and the "
            "int8/fp8 branch of batched_decode_attention (K6, K7 quant)")
    B, H, S, D = q.shape
    if S != 1:
        raise ValueError("batched decode attention is single-token")
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((B,), int(pos), dtype=torch.int32, device=q.device)
    pos = pos.reshape(-1).to(torch.int32).expand(B).contiguous()
    out = batched_decode_attn(q[:, :, 0].contiguous(), k_cache, v_cache, pos)
    return out[:, :, None]
