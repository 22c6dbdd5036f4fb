"""Llama-family causal LM in PyTorch: bf16 and quantized KV caches,
contiguous and paged.

The counterpart of ``neural_compressor_tpu.models.llama`` for rotary style
"half" (linear scaling or none), dense prefill attention and the chunked
long prefill over bf16 rows (``_ChunkedCausal``), decoding through the
port's kernels: over a bf16 head-major KV cache [B, Hkv, T, D] at B=1 (K5)
and at B > 1 with per-slot positions (K7); over a ``QuantKVCache`` of
int8 or fp8-e4m3 codes with per-(token, head) scales at B=1 (K6, which
folds the raw new row in at ``pos``) and at B > 1 (K7's quantized branch,
on the written codes), the new rows written by K12 as if the cache were a
pool of one page a slot, or of int4 D-half-split nibbles with affine
scale/offset per (token, head, D-half) (``_grouped_attention_int4``, plain
PyTorch on every device, as the JAX package runs it in XLA); and over a
paged pool of bf16 rows, int8 or fp8 codes, or int4 token-half-split
nibbles (``PagedKVCache``: K12 writes the row, K11 attends). Module and
parameter names follow the JAX model, so its flat state maps onto this
model's ``state_dict`` (``from_jax_params``).

Off this path the model raises ``NotImplementedError`` naming the JAX
function it waits for: the chunked long prefill over quantized caches,
calibrated per-channel int4 K scales, other rotary styles and scalings.
The pieces Gemma shares (``_rope``, ``apply_rope``, the chunked attention,
caches and pools, ``update_cache``, ``load_jax_state``) live here, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..common.device import resolve_device
from ..layers.linear import Embed, Linear
from ..ops.activations import softcap as _softcap
from ..ops.kv_quant import KV_CODE_DTYPES as _KV_CODE_DTYPES
from ..ops.kv_quant import kv_codes_int8 as _kv_codes_int8
from ..ops.kv_quant import kv_dequant as _kv_dequant
from ..ops.kv_quant import kv_dequant4_asym as _kv_dequant4_asym
from ..ops.kv_quant import kv_format
from ..ops.kv_quant import kv_pack_page_int4 as _kv_pack_page_int4
from ..ops.kv_quant import kv_quant as _kv_quant
from ..ops.kv_quant import kv_quant4_asym as _kv_quant4_asym
from ..ops.kv_quant import kv_quant4_asym_codes as _kv_quant4_asym_codes
from ..ops.kv_quant import kv_unpack_int4 as _kv_unpack_int4


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int | None = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    rope_style: str = "half"
    partial_rotary_factor: float = 1.0
    rope_scaling: dict | None = None
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads

    def check_supported(self) -> None:
        if (self.rope_style != "half" or self.partial_rotary_factor != 1.0
                or _rope_scaling_type(self.rope_scaling) not in (None,
                                                                 "linear")):
            raise NotImplementedError(
                "rotary styles other than full 'half' and rope scalings "
                "wait for the port of neural_compressor_tpu.models.llama."
                "_rope / apply_rope")
        if self.tie_word_embeddings:
            raise NotImplementedError(
                "tied embeddings wait for the port of nnx.Embed.attend in "
                "neural_compressor_tpu.models.llama.LlamaForCausalLM")


# the JAX package's presets; configurations with features off the ported
# path raise when a model is built from them (LlamaConfig.check_supported)
LLAMA_PRESETS = {
    "llama-test": dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=128),
    "llama2-7b": dict(hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=32, num_attention_heads=32,
                      num_key_value_heads=32),
    "llama2-13b": dict(hidden_size=5120, intermediate_size=13824,
                       num_hidden_layers=40, num_attention_heads=40,
                       num_key_value_heads=40),
    "llama3-8b": dict(vocab_size=128256, hidden_size=4096,
                      intermediate_size=14336, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=8,
                      rope_theta=500000.0, max_position_embeddings=8192),
    "mistral-7b": dict(hidden_size=4096, intermediate_size=14336,
                       num_hidden_layers=32, num_attention_heads=32,
                       num_key_value_heads=8, rope_theta=10000.0),
    "qwen2-7b": dict(vocab_size=152064, hidden_size=3584,
                     intermediate_size=18944, num_hidden_layers=28,
                     num_attention_heads=28, num_key_value_heads=4,
                     rope_theta=1e6, attention_bias=True),
    "qwen2-test": dict(vocab_size=256, hidden_size=128,
                       intermediate_size=256, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=128, attention_bias=True),
    "glm-4-9b": dict(vocab_size=151552, hidden_size=4096,
                     intermediate_size=13696, num_hidden_layers=40,
                     num_attention_heads=32, num_key_value_heads=2,
                     head_dim=128, rms_norm_eps=1.5625e-7,
                     rope_theta=10000.0, attention_bias=True,
                     rope_style="interleaved_partial",
                     partial_rotary_factor=0.5),
    "phi3-mini-4k": dict(vocab_size=32064, hidden_size=3072,
                         intermediate_size=8192, num_hidden_layers=32,
                         num_attention_heads=32, num_key_value_heads=32,
                         max_position_embeddings=4096, rope_theta=10000.0),
    "phi4-mini": dict(vocab_size=200064, hidden_size=3072,
                      intermediate_size=8192, num_hidden_layers=32,
                      num_attention_heads=24, num_key_value_heads=8,
                      max_position_embeddings=4096, rope_theta=10000.0,
                      partial_rotary_factor=0.75,
                      tie_word_embeddings=True),
}


class KVCache(NamedTuple):
    """Static-shape per-layer KV cache, head-major [B, Hkv, T, D]. The port
    writes new rows into it in place (``_update_rows``)."""

    k: torch.Tensor
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """Quantized per-layer KV cache with per-(token, head) scales. Codes are
    int8 or fp8-e4m3 [B, Hkv, T, D] with scales [B, Hkv, T]; or int4:
    offset-binary nibbles packed half-split along D, [B, Hkv, T, D/2]
    uint8, asymmetric per (token, head, D-half), ``x ~= scale *
    (nibble - 8) + off`` with scale/off [B, Hkv, T, 2] float32. The format
    is carried by the codes' dtype. The port writes rows in place."""

    k_codes: torch.Tensor
    k_scale: torch.Tensor
    v_codes: torch.Tensor
    v_scale: torch.Tensor
    k_off: torch.Tensor | None = None    # [B, Hkv, T, 2] (int4 only)
    v_off: torch.Tensor | None = None

    @property
    def fmt(self) -> str:
        return kv_format(self.k_codes)


def _kv_fmt(quantized: bool | str) -> str | None:
    """``quantized`` as a cache format: False -> None, True -> "int8"."""
    if not quantized:
        return None
    fmt = "int8" if quantized is True else str(quantized)
    if fmt not in _KV_CODE_DTYPES:
        raise ValueError(f"KV format {fmt!r}: expected one of "
                         f"{tuple(_KV_CODE_DTYPES)}")
    return fmt


def model_kv_format(model) -> str | None:
    """The KV cache format ``KVCacheQuantConfig`` flagged on ``model``
    ("int8", "fp8_e4m3" or "int4"), or None for bf16 caches: what JAX's
    ``_alloc_caches`` and engine allocate. Raises ``ValueError`` for an
    unknown format."""
    if not getattr(model, "kv_cache_quantized", False):
        return None
    return _kv_fmt(getattr(model, "kv_cache_format", "int8"))


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  quantized: bool | str = False, device=None):
    """One zero-filled cache per layer: a bf16 ``KVCache``, or with
    ``quantized`` (True / "int8", "fp8_e4m3", "int4") a ``QuantKVCache``
    with scales of 1 (and offsets of 0)."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    shape = (batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    fmt = _kv_fmt(quantized)
    L = cfg.num_hidden_layers

    def z(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    def one(shp):
        return torch.ones(shp, dtype=torch.float32, device=device)

    if fmt == "int4":
        cshape = shape[:-1] + (cfg.head_dim // 2,)
        sshape = shape[:-1] + (2,)
        return [QuantKVCache(z(cshape, torch.uint8), one(sshape),
                             z(cshape, torch.uint8), one(sshape),
                             z(sshape, torch.float32),
                             z(sshape, torch.float32)) for _ in range(L)]
    if fmt:
        cdt = _KV_CODE_DTYPES[fmt]
        return [QuantKVCache(z(shape, cdt), one(shape[:-1]), z(shape, cdt),
                             one(shape[:-1])) for _ in range(L)]
    return [KVCache(z(shape, dtype), z(shape, dtype)) for _ in range(L)]


class PagedKVCache(NamedTuple):
    """Paged KV cache: a shared page pool plus per-slot block tables. Pages
    are [page_size, D] rows per KV head: bf16; int8 or fp8-e4m3 codes with
    per-(token, head) float32 scales [P, Hkv, page]; or int4
    token-half-split bytes [P, Hkv, page/2, D] (token r in the low nibble
    of byte row r, token r + page/2 in the high), asymmetric per (token,
    head): ``x ~= scale * (nibble - 8) + off`` with scales and offsets
    [P, Hkv, page]. Pool page 0 is the engine's trash page. Consumed by
    ``kernels/paged_attention.py``; the port writes rows into the pool in
    place."""

    k_pages: torch.Tensor             # [P, Hkv, page, D] bf16|int8|fp8
    k_scales: torch.Tensor | None     # [P, Hkv, page] f32 (quantized pools)
    v_pages: torch.Tensor             # int4: [P, Hkv, page/2, D] uint8
    v_scales: torch.Tensor | None
    block_tables: torch.Tensor        # [B, PMAX] int32 page ids per slot
    k_offs: torch.Tensor | None = None   # [P, Hkv, page] f32 (int4 only)
    v_offs: torch.Tensor | None = None

    @property
    def page_size(self) -> int:
        s = self.k_pages.shape[2]
        # int4 pools hold two tokens a byte row
        return s * 2 if self.k_pages.dtype == torch.uint8 else s


def init_paged_pool(cfg: LlamaConfig, n_pages: int, batch: int, max_len: int,
                    page_size: int = 128, dtype=None,
                    quantized: bool | str = False, device=None):
    """Per-layer ``PagedKVCache`` pools with empty block tables: bf16 rows,
    or with ``quantized`` (True / "int8", "fp8_e4m3", "int4") codes with
    scales of 1 (int4: offsets of 0; pages of a multiple of 16 rows)."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    fmt = _kv_fmt(quantized)
    if fmt == "int4" and page_size % 16:
        raise ValueError(f"int4 pages need page_size % 16 == 0 "
                         f"(page_size={page_size})")
    pmax = (max_len + page_size - 1) // page_size
    shape = (n_pages, cfg.num_key_value_heads, page_size, cfg.head_dim)
    sshape = shape[:-1]

    def z(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    def one():
        return torch.ones(sshape, dtype=torch.float32, device=device)

    out = []
    for _ in range(cfg.num_hidden_layers):
        bt = torch.zeros((batch, pmax), dtype=torch.int32, device=device)
        if fmt == "int4":
            cshape = (n_pages, cfg.num_key_value_heads, page_size // 2,
                      cfg.head_dim)
            out.append(PagedKVCache(z(cshape, torch.uint8), one(),
                                    z(cshape, torch.uint8), one(), bt,
                                    z(sshape, torch.float32),
                                    z(sshape, torch.float32)))
        elif fmt:
            cdt = _KV_CODE_DTYPES[fmt]
            out.append(PagedKVCache(z(shape, cdt), one(), z(shape, cdt),
                                    one(), bt))
        else:
            out.append(PagedKVCache(z(shape, dtype), None, z(shape, dtype),
                                    None, bt))
    return out


def _paged_write_row(cache: PagedKVCache, k_new, v_new, pos):
    """Write the new K/V rows [B, Hkv, 1, D] into their pages at per-slot
    ``pos`` [B] (page id from the block table), in place, through the
    paged write kernel (K12). JAX falls back to an XLA scatter off its
    kernel's envelope; the port's kernel covers every shape."""
    from ..kernels.paged_attention import paged_write_rows

    return paged_write_rows(cache, k_new, v_new, pos)


def _update_rows(cache_arr: torch.Tensor, new: torch.Tensor, cache_pos):
    """Write ``new`` [B, H, S, D] into ``cache_arr`` [B, H, T, D] at token
    ``cache_pos``: an int, or a [B] tensor of per-row starts (continuous
    batching), IN PLACE (JAX returns an updated copy); returns it.

    Each start is clamped to [0, T - S], as ``jax.lax.dynamic_update_slice``
    clamps it (slicing past the end would silently write fewer rows). A
    tensor ``cache_pos`` stays on its device: no host sync."""
    S, T = new.shape[2], cache_arr.shape[2]
    new = new.to(cache_arr.dtype)
    if not isinstance(cache_pos, torch.Tensor):
        start = min(max(int(cache_pos), 0), T - S)
        cache_arr[:, :, start:start + S] = new
        return cache_arr
    B = cache_arr.shape[0]
    dev = cache_arr.device
    start = cache_pos.reshape(-1).to(device=dev, dtype=torch.int64).expand(B)
    rows = start.clamp(0, T - S)[:, None] + torch.arange(S, device=dev)
    cache_arr[torch.arange(B, device=dev)[:, None], :, rows] = \
        new.transpose(1, 2)
    return cache_arr


def _write_quant(cache: QuantKVCache, k, v, cache_pos) -> QuantKVCache:
    """Quantize the new K/V rows [B, Hkv, S, D] in the cache's format and
    write codes, scales (and int4 offsets) at ``cache_pos``, in place."""
    if cache.fmt == "int4":
        kc, ks, ko = _kv_quant4_asym(k)
        vc, vs, vo = _kv_quant4_asym(v)
        new = (kc, ks, vc, vs, ko, vo)
    else:
        kc, ks = _kv_quant(k, fmt=cache.fmt)
        vc, vs = _kv_quant(v, fmt=cache.fmt)
        new = (kc, ks, vc, vs, None, None)
    for arr, rows in zip(cache, new):
        if arr is not None:
            _update_rows(arr, rows, cache_pos)
    return cache


def _write_quant_row(cache: QuantKVCache, k, v, cache_pos) -> QuantKVCache:
    """Quantize and write each slot's one new K/V row [B, Hkv, 1, D] into
    an int8/fp8 cache at per-slot ``cache_pos`` (an int or a [B] tensor,
    never read back), in place, through the paged write kernel (K12): a
    contiguous [B, Hkv, T, D] cache is a pool of B pages of T rows with the
    block table ``arange(B)``. K12's codes and scales are ``_kv_quant``'s,
    bit for bit. A position at or past T writes nothing (JAX's
    ``dynamic_update_slice`` clamps it onto row T - 1): only a slot running
    on past its end inside a multi-step dispatch reaches it, and only that
    slot's discarded tokens could see the difference."""
    from ..kernels.decode_attention import pos_vector
    from ..kernels.paged_attention import paged_write

    B, dev = k.shape[0], k.device
    bt = torch.arange(B, dtype=torch.int32, device=dev).reshape(B, 1)
    paged_write(k[:, :, 0].contiguous(), v[:, :, 0].contiguous(),
                cache.k_codes, cache.k_scale, cache.v_codes, cache.v_scale,
                bt, pos_vector(cache_pos, B, dev))
    return cache


def update_cache(cache, k, v, cache_pos, dtype):
    """Write new K/V rows [B, H, S, D] into a ``KVCache`` or
    ``QuantKVCache`` (quantizing per token-head) and return ``(k_all,
    v_all, cache)`` with k_all/v_all dequantized to ``dtype``, as
    ``neural_compressor_tpu.models.llama.update_cache``; the cache is
    updated in place."""
    if isinstance(cache, QuantKVCache):
        c = _write_quant(cache, k, v, cache_pos)
        if c.fmt == "int4":
            return (_kv_dequant4_asym(c.k_codes, c.k_scale, c.k_off, dtype),
                    _kv_dequant4_asym(c.v_codes, c.v_scale, c.v_off, dtype),
                    c)
        return (_kv_dequant(c.k_codes, c.k_scale, dtype),
                _kv_dequant(c.v_codes, c.v_scale, dtype), c)
    k_all = _update_rows(cache.k, k, cache_pos)
    v_all = _update_rows(cache.v, v, cache_pos)
    return k_all.to(dtype), v_all.to(dtype), KVCache(k_all, v_all)


class _ChunkedCausal(NamedTuple):
    """Causal-mask sentinel for a long prefill: the query positions instead
    of a [B, 1, S, T] bool mask, so attention goes through
    ``_grouped_attention_chunked`` and never holds S x T scores. Made by
    the model's forward when S*T exceeds ``_DENSE_MASK_ELEMS``."""

    q_pos: torch.Tensor         # [B or 1, S] position of each query row
    window: int | None = None   # sliding band (gemma's local layers)


_DENSE_MASK_ELEMS = 16 * 1024 * 1024  # ~4096^2; S*T above this chunks
_F64 = torch.float64


def set_dense_mask_limit(n: int) -> None:
    """S*T above which a prefill takes the chunked attention."""
    global _DENSE_MASK_ELEMS
    _DENSE_MASK_ELEMS = int(n)


def _grouped_attention_chunked(q, k, v, q_pos, D, k_scale=None,
                               v_scale=None, q_chunk=512, softcap=None,
                               window=None):
    """``_grouped_attention`` without the [S, T] scores
    (``neural_compressor_tpu.models.llama._grouped_attention_chunked``
    over float K/V): query chunks of ``q_chunk`` rows, each against only
    the keys its rows can see (up to its last position; with a ``window``,
    from its first position - window + 1), so memory stays one chunk's
    scores whatever S and T. Key t is visible to a query at position p iff
    t <= p (and p - t < window). Scores are f32(q . k) [* k_scale] times
    f32(1/sqrt(D)) [softcapped before the mask]; p = exp(s - m), rounded
    to v's dtype unnormalised for the PV product [after * v_scale], l
    unrounded, out = acc / max(l, 1e-30): JAX's online softmax over KV
    chunks with its final max, which it equals wherever the running max
    does not move. Sums in float64, one rounding each, as
    ``_grouped_attention``."""
    B, H, S, _ = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = H // Hkv
    f32 = torch.float32
    dev = q.device
    qpos = torch.as_tensor(q_pos, device=dev).to(torch.int64).expand(B, S)
    qg = q.reshape(B, Hkv, rep, S, D)
    rsqrt_d = torch.tensor(1.0 / float(D) ** 0.5, dtype=f32)
    out = torch.empty((B, Hkv, rep, S, v.shape[-1]), dtype=q.dtype,
                      device=dev)
    for s0 in range(0, S, q_chunk):
        s1 = min(S, s0 + q_chunk)
        qp = qpos[:, s0:s1]                                   # [B, c]
        hi = min(T, int(qp.max()) + 1)
        lo = max(0, int(qp.min()) - window + 1) if window else 0
        if hi <= lo:
            out[:, :, :, s0:s1] = 0
            continue
        kpos = torch.arange(lo, hi, device=dev)
        s = torch.einsum("bgrsd,bgtd->bgrst", qg[:, :, :, s0:s1].to(_F64),
                         k[:, :, lo:hi].to(_F64)).to(f32)
        if k_scale is not None:
            s = s * k_scale[:, :, None, None, lo:hi]
        s = s * rsqrt_d
        if softcap is not None:
            s = _softcap(s, softcap)
        valid = kpos[None, None, :] <= qp[:, :, None]         # [B, c, t]
        if window is not None:
            valid = valid & (qp[:, :, None] - kpos[None, None, :] < window)
        valid = valid[:, None, None]
        s = torch.where(valid, s, torch.tensor(-1e30, device=dev))
        e = torch.exp(s.to(_F64) - s.amax(dim=-1, keepdim=True).to(_F64))
        e = torch.where(valid, e, torch.zeros((), dtype=_F64, device=dev))
        l = e.sum(dim=-1, keepdim=True).to(f32)
        pe = e.to(f32)
        if v_scale is not None:
            pe = pe * v_scale[:, :, None, None, lo:hi]
        acc = torch.einsum("bgrst,bgtd->bgrsd", pe.to(v.dtype).to(_F64),
                           v[:, :, lo:hi].to(_F64)).to(f32)
        out[:, :, :, s0:s1] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(B, H, S, v.shape[-1])


def _softmax_f32(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of float32 scores: exp and sum in float64,
    one rounding to float32."""
    e = torch.exp(s.to(_F64) - s.amax(dim=-1, keepdim=True).to(_F64))
    return (e / e.sum(dim=-1, keepdim=True)).to(torch.float32)


def _masked(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, :, None], s,
                       torch.tensor(-1e30, device=s.device))


def _grouped_attention(q, k, v, mask, D, k_scale=None, v_scale=None):
    """GQA-grouped SDPA: q [B, H, S, D] against k/v [B, Hkv, T, D] without
    repeating K/V; float32 scores, bf16 probabilities for PV. ``mask``
    [B or 1, 1, S, T] bool. ``k_scale``/``v_scale`` [B, Hkv, T]: per-(token,
    head) cache scales (``QuantKVCache``) folded into the scores and the
    probabilities, so k/v can be the raw codes. Returns [B, H, S, D].

    The sums run in float64 over exact bf16 products and round once (JAX
    sums in float32), so the summation order almost never shows: the card
    and the CPU compute the same bits, which the int8 activation
    quantization of the next projection would otherwise amplify. A
    ``_ChunkedCausal`` mask (a long prefill) takes
    ``_grouped_attention_chunked``."""
    if isinstance(mask, _ChunkedCausal):
        return _grouped_attention_chunked(q, k, v, mask.q_pos, D, k_scale,
                                          v_scale, window=mask.window)
    B, H, S, _ = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    qg = q.reshape(B, Hkv, rep, S, D).to(_F64)
    s = torch.einsum("bgrsd,bgtd->bgrst", qg, k.to(_F64)).to(torch.float32)
    if k_scale is not None:
        s = s * k_scale[:, :, None, None, :]
    s = s / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    p = _softmax_f32(_masked(s, mask))
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :]
    out = torch.einsum("bgrst,bgtd->bgrsd", p.to(v.dtype).to(_F64),
                       v.to(_F64))
    return out.to(torch.float32).reshape(B, H, S, D).to(q.dtype)


def _grouped_attention_int4(q, k_packed, v_packed, mask, D, k_scale, v_scale,
                            k_off=None, v_off=None):
    """``_grouped_attention`` on D-half-split int4 caches
    (``neural_compressor_tpu.models.llama._grouped_attention_int4``): the
    score is the sum of two half-D dots over the centered nibbles, each
    times its half's scale, plus the rank-1 offset terms ``off_h * sum(q
    over half h)``; the output is two half-D PV products over
    ``bf16(p * vscale_h)`` plus ``p @ voff_h`` broadcast over the half.
    Dense masks only. Sums in float64, one rounding each, as in
    ``_grouped_attention``."""
    B, H, S, _ = q.shape
    Hkv = k_packed.shape[1]
    rep = H // Hkv
    h = D // 2
    f32 = torch.float32
    qg = q.reshape(B, Hkv, rep, S, D).to(_F64)

    def nibbles(packed):
        return (((packed & 15).to(torch.int8) - 8).to(_F64),
                ((packed >> 4).to(torch.int8) - 8).to(_F64))

    def sc(a, i):
        return a[..., i][:, :, None, None, :]

    k_lo, k_hi = nibbles(k_packed)
    s_lo = torch.einsum("bgrsd,bgtd->bgrst", qg[..., :h], k_lo).to(f32)
    s_hi = torch.einsum("bgrsd,bgtd->bgrst", qg[..., h:], k_hi).to(f32)
    s = s_lo * sc(k_scale, 0) + s_hi * sc(k_scale, 1)
    if k_off is not None:
        qs_lo = qg[..., :h].sum(dim=-1).to(f32)[..., None]
        qs_hi = qg[..., h:].sum(dim=-1).to(f32)[..., None]
        s = s + qs_lo * sc(k_off, 0) + qs_hi * sc(k_off, 1)
    s = s / torch.sqrt(torch.tensor(float(D), dtype=f32))
    p = _softmax_f32(_masked(s, mask))
    v_lo, v_hi = nibbles(v_packed)
    dt = q.dtype

    def pv(i, v_half):
        pb = (p * sc(v_scale, i)).to(dt).to(_F64)
        return torch.einsum("bgrst,bgtd->bgrsd", pb, v_half).to(f32)

    o_lo, o_hi = pv(0, v_lo), pv(1, v_hi)
    if v_off is not None:
        p64 = p.to(_F64)
        o_lo = o_lo + torch.einsum("bgrst,bgt->bgrs", p64,
                                   v_off[..., 0].to(_F64)).to(f32)[..., None]
        o_hi = o_hi + torch.einsum("bgrst,bgt->bgrs", p64,
                                   v_off[..., 1].to(_F64)).to(f32)[..., None]
    out = torch.cat([o_lo, o_hi], dim=-1)
    return out.reshape(B, H, S, D).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                              device=device),
                                   requires_grad=False)
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the mean and rsqrt in float64, rounded once: the same bits on the
        # card and on the CPU, whatever the reduction order
        xf = x.to(torch.float32)
        x64 = xf.to(torch.float64)
        var = torch.mean(x64 * x64, dim=-1, keepdim=True)
        inv = (1.0 / torch.sqrt(var + self.eps)).to(torch.float32)
        return (xf * inv * self.weight).to(self.dtype)


def _rope_scaling_type(scaling: dict | None) -> str | None:
    return scaling.get("type") if scaling else None


def _rope(positions: torch.Tensor, head_dim: int, theta: float,
          partial_factor: float = 1.0, scaling: dict | None = None):
    """Rotary tables: cos/sin [B, S, D/2] float32 (full "half" rotary).
    ``inv_freq``, cos and sin are computed in float64 and rounded once, so
    the card and the CPU give the same bits (their float32 sin/cos differ
    in the last place). ``scaling={"type": "linear", "factor": f}``
    divides ``inv_freq`` by f in float32 (gemma-3's global layers)."""
    if partial_factor != 1.0 or _rope_scaling_type(scaling) not in (
            None, "linear"):
        raise NotImplementedError(
            "partial rotary and rope scalings other than linear wait for "
            "the port of neural_compressor_tpu.models.llama._rope")
    rd = head_dim
    f64 = torch.float64
    exps = torch.arange(0, rd, 2, dtype=f64, device=positions.device) / rd
    inv_freq = (1.0 / torch.pow(torch.tensor(theta, dtype=f64), exps)).to(
        torch.float32)
    if scaling:
        inv_freq = inv_freq / float(scaling["factor"])
    angles = (positions[..., None].to(torch.float32) * inv_freq).to(f64)
    return torch.cos(angles).to(torch.float32), torch.sin(angles).to(
        torch.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str = "half") -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D/2]: HF llama rotate-half."""
    if style != "half":
        raise NotImplementedError(
            f"rope style {style!r} waits for the port of "
            "neural_compressor_tpu.models.llama.apply_rope")
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    d2 = cos.shape[-1]
    x1, x2 = x[..., :d2].to(torch.float32), x[..., d2:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, generator=None):
        super().__init__()
        H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.cfg = cfg

        def lin(i, o, b=False):
            return Linear(i, o, bias=b, dtype=cfg.dtype, device=device,
                          generator=generator)

        qb = cfg.attention_bias
        self.q_proj = lin(cfg.hidden_size, H * D, qb)
        self.k_proj = lin(cfg.hidden_size, Hkv * D, qb)
        self.v_proj = lin(cfg.hidden_size, Hkv * D, qb)
        self.o_proj = lin(H * D, cfg.hidden_size)
        self.qkv_proj = None  # set by quantization.fuse.fuse_for_serving

    def forward(self, x, cos, sin, mask, cache: KVCache | None = None,
                cache_pos: int | None = None):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        if self.qkv_proj is not None:
            q, k, v = torch.split(self.qkv_proj(x), [H * D, Hkv * D, Hkv * D],
                                  dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = apply_rope(q.reshape(B, S, H, D), cos, sin, cfg.rope_style)
        k = apply_rope(k.reshape(B, S, Hkv, D), cos, sin, cfg.rope_style)
        v = v.reshape(B, S, Hkv, D)
        # head-major [B, H, S, D], the cache layout
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        out, new_cache = self._attend(x.dtype, q, k, v, mask, cache,
                                      cache_pos)
        return self.o_proj(out), new_cache

    def _attend(self, x_dtype, q, k, v, mask, cache, cache_pos):
        """Cache update + attention on head-major q/k/v; returns the
        flattened attention output [B, S, H*D] and the cache. Shared by the
        modular forward and the fused decode layer."""
        from ..kernels.decode_attention import decode_attention

        cfg = self.cfg
        B, S = q.shape[0], q.shape[2]
        H, D = cfg.num_attention_heads, cfg.head_dim
        new_cache = None
        if isinstance(cache, PagedKVCache):
            from ..kernels.paged_attention import (paged_decode_attention,
                                                   paged_window_attention,
                                                   paged_write_window)

            pos_b = (cache_pos if isinstance(cache_pos, torch.Tensor)
                     else torch.tensor(cache_pos, device=q.device))
            pos_b = pos_b.reshape(-1).to(device=q.device,
                                         dtype=torch.int32).expand(B)
            if S == 1:
                new_cache = _paged_write_row(cache, k, v, pos_b)
                out = paged_decode_attention(q, new_cache, pos_b + 1)
            else:
                # a W-token verify window (speculative serving over pages):
                # write the window rows (K13; they may cross one page
                # boundary), then the causal window attention (K11's
                # W-query branch)
                new_cache = paged_write_window(cache, k, v, pos_b)
                if new_cache is None:  # off K13's envelope: row by row
                    new_cache = cache
                    for w in range(S):
                        new_cache = _paged_write_row(
                            new_cache, k[:, :, w:w + 1], v[:, :, w:w + 1],
                            pos_b + w)
                out = paged_window_attention(q, new_cache, pos_b + S)
            out = out.to(x_dtype).transpose(1, 2)
            return out.reshape(B, S, H * D), new_cache
        if isinstance(cache, QuantKVCache):
            return self._attend_quant(x_dtype, q, k, v, mask, cache,
                                      cache_pos)
        if cache is not None:
            if S == 1:
                # B == 1 on the B=1 kernels (K5, or K16 under its
                # switches), B > 1 on the batched one (K7); None where
                # JAX's K7 dispatch declines and K7 cannot take D either:
                # the rows are written, attend them below
                out, k_all, v_all = decode_attention(
                    q, k, v, cache.k, cache.v, cache_pos)
                if out is not None:
                    out = out.to(x_dtype).transpose(1, 2)
                    return out.reshape(B, S, H * D), KVCache(k_all, v_all)
                new_cache = KVCache(k_all, v_all)
                out = _grouped_attention(q, k_all.to(x_dtype),
                                         v_all.to(x_dtype), mask, D)
                return out.transpose(1, 2).reshape(B, S, H * D), new_cache
            k_all = _update_rows(cache.k, k, cache_pos)
            v_all = _update_rows(cache.v, v, cache_pos)
            new_cache = KVCache(k_all, v_all)
            k, v = k_all.to(x_dtype), v_all.to(x_dtype)
        out = _grouped_attention(q, k, v, mask, D)
        return out.transpose(1, 2).reshape(B, S, H * D), new_cache

    def _attend_quant(self, x_dtype, q, k, v, mask, cache: QuantKVCache,
                      cache_pos):
        """``_attend`` over a ``QuantKVCache``, with the JAX package's two
        decode semantics. At B == 1 and S == 1, int8/fp8 caches take K6,
        which attends the RAW new row at ``pos`` (scale 1) and only then
        writes its codes. Otherwise the rows are quantized and written
        first and attention runs on the codes: K7's quantized branch at
        S == 1, ``_grouped_attention`` with scales folded for a prefill,
        and ``_grouped_attention_int4`` for int4 caches at every S.
        int8/fp8 decode rows are written by K12 (``_write_quant_row``);
        positions stay on the device."""
        from ..kernels.decode_attention import (batched_decode_attention,
                                                decode_attention_quant,
                                                pos_vector)

        cfg = self.cfg
        B, S = q.shape[0], q.shape[2]
        H, D = cfg.num_attention_heads, cfg.head_dim
        fmt = cache.fmt
        if S == 1 and fmt != "int4":
            pos = pos_vector(cache_pos, B, q.device)
            if B == 1:
                out, c = decode_attention_quant(q, k, v, cache, pos)
            else:
                c = _write_quant_row(cache, k, v, pos)
                out = batched_decode_attention(q, c.k_codes, c.v_codes, pos,
                                               c.k_scale, c.v_scale)
            if out is not None:
                out = out.to(x_dtype).transpose(1, 2)
                return out.reshape(B, S, H * D), c
            # JAX's K7 dispatch declines and K7 cannot take D: attend the
            # written codes with the scales folded, as JAX's XLA path does
            out = _grouped_attention(q, c.k_codes.to(x_dtype),
                                     c.v_codes.to(x_dtype), mask, D,
                                     c.k_scale, c.v_scale)
            return out.transpose(1, 2).reshape(B, S, H * D), c
        c = _write_quant(cache, k, v, cache_pos)
        if fmt == "int4":
            out = _grouped_attention_int4(q, c.k_codes, c.v_codes, mask, D,
                                          c.k_scale, c.v_scale, c.k_off,
                                          c.v_off)
        else:
            out = _grouped_attention(q, c.k_codes.to(x_dtype),
                                     c.v_codes.to(x_dtype), mask, D,
                                     c.k_scale, c.v_scale)
        return out.transpose(1, 2).reshape(B, S, H * D), c


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, generator=None):
        super().__init__()

        def lin(i, o):
            return Linear(i, o, dtype=cfg.dtype, device=device,
                          generator=generator)

        self.gate_proj = lin(cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = lin(cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = lin(cfg.intermediate_size, cfg.hidden_size)
        self.gate_up_proj = None  # set by quantization.fuse.fuse_for_serving

    def forward(self, x):
        if self.gate_up_proj is not None:
            g, u = torch.chunk(self.gate_up_proj(x), 2, dim=-1)
            return self.down_proj(_silu(g) * u)
        return self.down_proj(_silu(self.gate_proj(x)) * self.up_proj(x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it, rounding to x's dtype after
    every op: ``x * (1 / (1 + exp(-x)))``. In bf16 this differs from
    ``F.silu`` (one rounding) in ~40% of elements, and the next layer's
    int8 activation quantization turns such ulps into code flips. The exp
    runs in float64 so that the card and the CPU round it alike."""
    e = torch.exp(-x.to(torch.float64)).to(x.dtype)
    return x * (1 / (1 + e))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, generator=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       cfg.dtype, device)
        self.self_attn = LlamaAttention(cfg, device, generator)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, cfg.dtype,
                                                device)
        self.mlp = LlamaMLP(cfg, device, generator)
        # set by quantization.fuse.enable_fused_decode
        self.fused_decode = False
        self.fused_fold_norms = True

    def forward(self, x, cos, sin, mask, cache=None, cache_pos=None):
        if (self.fused_decode and x.shape[0] == 1 and x.shape[1] == 1
                and cache is not None):
            r = self._fused_call(x, cos, sin, mask, cache, cache_pos)
            if r is not None:
                return r
        h, new_cache = self.self_attn(self.input_layernorm(x), cos, sin, mask,
                                      cache, cache_pos)
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_cache

    def _fused_call(self, x, cos, sin, mask, cache, cache_pos):
        """Fused B=1 decode: each projection is one fused GEMV launch that
        also does the adjacent glue (RMSNorm by scale invariance, act
        quant, silu(g)*u, residual adds). JAX's switches, read at call
        time, select two variants: ``fused_matvec.ATTN_O_FUSED`` runs the
        attention inside the o-projection's launch (K18; it comes first),
        ``omlp_matvec.OMLP_FUSED`` the o-projection and the MLP in one
        launch (K17; it needs ``fused_fold_norms`` and no o/gate_up/down
        bias). A variant that declines falls back as in JAX. With
        ``fused_fold_norms`` False the layer applies its RMSNorms itself
        and the GEMVs take no norm weight. Returns None to fall back to the
        modular path (ineligible weights)."""
        from ..kernels import omlp_matvec as _om
        from ..kernels.fused_matvec import fused_matvec

        # the module (the package exports a function of its name)
        _fm = sys.modules[fused_matvec.__module__]

        attn, mlp = self.self_attn, self.mlp
        cfg = attn.cfg
        B, S, _ = x.shape
        H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        qkv_m, gu_m = attn.qkv_proj, mlp.gate_up_proj
        if qkv_m is None or gu_m is None:
            return None
        ln1, ln2 = self.input_layernorm, self.post_attention_layernorm
        fold = getattr(self, "fused_fold_norms", True)
        qkv = fused_matvec(x if fold else ln1(x), qkv_m.packed_weight(),
                           rms_w=ln1.weight if fold else None, eps=ln1.eps,
                           bias=qkv_m.bias, out_dtype=x.dtype)
        if qkv is None:
            return None
        q, k, v = torch.split(qkv, [H * D, Hkv * D, Hkv * D], dim=-1)
        q = apply_rope(q.reshape(B, S, H, D), cos, sin, cfg.rope_style)
        k = apply_rope(k.reshape(B, S, Hkv, D), cos, sin, cfg.rope_style)
        q, k = q.transpose(1, 2), k.transpose(1, 2)
        v = v.reshape(B, S, Hkv, D).transpose(1, 2)
        x1 = None
        if _fm.ATTN_O_FUSED and attn.o_proj.bias is None:
            r = _fm.attn_o_fused(q, k, v, cache, cache_pos,
                                 attn.o_proj.packed_weight(), residual=x,
                                 out_dtype=x.dtype)
            if r is not None:
                x1, new_cache = r
        if x1 is None:
            out, new_cache = attn._attend(x.dtype, q, k, v, mask, cache,
                                          cache_pos)
            if (_om.OMLP_FUSED and fold and attn.o_proj.bias is None
                    and gu_m.bias is None and mlp.down_proj.bias is None):
                x2 = _om.omlp_fused(
                    out, attn.o_proj.packed_weight(), gu_m.packed_weight(),
                    mlp.down_proj.packed_weight(), residual=x,
                    rms_w=ln2.weight, eps=ln2.eps, out_dtype=x.dtype)
                if x2 is not None:
                    return x2, new_cache
            x1 = fused_matvec(out, attn.o_proj.packed_weight(), residual=x,
                              bias=attn.o_proj.bias, out_dtype=x.dtype)
        if x1 is None:
            return None
        h = fused_matvec(x1 if fold else ln2(x1), gu_m.packed_weight(),
                         rms_w=ln2.weight if fold else None, eps=ln2.eps,
                         silu_gate=True, out_dtype=x.dtype)
        if h is None:
            return None
        x2 = fused_matvec(h, mlp.down_proj.packed_weight(), residual=x1,
                          out_dtype=x.dtype)
        if x2 is None:
            return None
        return x2, new_cache


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, generator=None,
                 n_layers: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size,
                                  dtype=cfg.dtype, device=device,
                                  generator=generator)
        n = cfg.num_hidden_layers if n_layers is None else n_layers
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(cfg, device, generator) for _ in range(n)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                            device)
        self.norm_in_head = False  # set by quantization.fuse.enable_fused_decode

    def forward(self, input_ids, positions=None, caches=None, cache_pos=None):
        cfg = self.cfg
        B, S = input_ids.shape
        dev = input_ids.device
        if positions is None:
            positions = torch.arange(S, device=dev)[None, :].expand(B, S)
        x = self.embed_tokens(input_ids)
        cos, sin = _rope(positions, cfg.head_dim, cfg.rope_theta,
                         cfg.partial_rotary_factor, cfg.rope_scaling)
        T = S if caches is None else caches[0][0].shape[2]
        if S * T > _DENSE_MASK_ELEMS and S > 1:
            # long prefill: chunked attention over bf16 rows; quantized
            # caches attend their codes, whose chunked form waits
            if caches is not None and not isinstance(caches[0], KVCache):
                raise NotImplementedError(
                    "the chunked long prefill over quantized caches waits "
                    "for the port of neural_compressor_tpu.models.llama."
                    "_grouped_attention_chunked with scales and int4 codes")
            mask = _ChunkedCausal(positions)
        elif caches is None:
            mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                         device=dev))[None, None]
        else:
            key_pos = torch.arange(T, device=dev)[None, None, None, :]
            mask = key_pos <= positions[:, None, :, None]
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            x, nc = layer(x, cos, sin, mask, cache, cache_pos)
            if new_caches is not None:
                new_caches.append(nc)
        if self.norm_in_head:
            # the fused decode folds the final norm into the lm_head GEMV;
            # the CausalLM applies it itself whenever it cannot fuse
            return x, new_caches
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0,
                 n_layers: int | None = None):
        """Random bf16 weights made from ``seed`` on ``device`` (None: the
        CUDA card). ``n_layers`` builds fewer decoder layers than
        ``cfg.num_hidden_layers`` (``build_quantized`` adds them one by
        one)."""
        super().__init__()
        cfg.check_supported()
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.model = LlamaModel(cfg, device, gen, n_layers=n_layers)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                              dtype=cfg.dtype, device=device, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.embedding.device

    def forward(self, input_ids, positions=None, caches=None, cache_pos=None):
        x, new_caches = self.model(input_ids, positions, caches, cache_pos)
        logits = None
        if self.model.norm_in_head:
            if (x.shape[0] == 1 and x.shape[1] == 1
                    and hasattr(self.lm_head, "packed_weight")):
                from ..kernels.fused_matvec import fused_matvec

                logits = fused_matvec(
                    x, self.lm_head.packed_weight(),
                    rms_w=self.model.norm.weight, eps=self.model.norm.eps,
                    out_dtype=x.dtype)
            if logits is None:
                x = self.model.norm(x)
        if logits is None:
            logits = self.lm_head(x)
        if caches is None:
            return logits
        return logits, new_caches


def build_quantized(preset_or_cfg, quant_config, seed: int = 0,
                    presets=None, device=None):
    """Build a llama on ``device`` and quantize it layer by layer, so the
    full float model never resides in device memory at once. Only
    calibration-free configs (RTN) apply here."""
    from ..quantization.quantize import quantize as _quantize

    if isinstance(preset_or_cfg, LlamaConfig):
        cfg = preset_or_cfg
    else:
        cfg = LlamaConfig(**dict((presets or LLAMA_PRESETS)[preset_or_cfg]))
    device = resolve_device(device)
    model = LlamaForCausalLM(cfg, device=device, seed=seed, n_layers=0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    for _ in range(cfg.num_hidden_layers):
        holder = _LayerHolder(LlamaDecoderLayer(cfg, device, gen))
        _quantize(holder, quant_config)
        model.model.layers.append(holder.layer)
        # model-level flags an entry set on the per-layer holder (the KV
        # cache format) belong to the model, or serving allocates bf16
        if getattr(holder, "kv_cache_quantized", False):
            model.kv_cache_quantized = True
            model.kv_cache_format = holder.kv_cache_format
    if _quant_lm_head(quant_config):
        holder = _LayerHolder(model.lm_head)
        _quantize(holder, quant_config)
        model.lm_head = holder.layer
    return model


def _quant_lm_head(quant_config) -> bool:
    """Whether any member of a (composable) config quantizes the lm_head."""
    members = getattr(quant_config, "config_list", [quant_config])
    return any(getattr(c, "quant_lm_head", False) for c in members)


class _LayerHolder(nn.Module):
    """Wraps one module so the quantize pass sees a walkable root."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer


def _tensor_from_numpy(arr) -> torch.Tensor:
    """numpy -> torch; JAX bf16 arrays (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses) go through a uint16 view."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    if arr.dtype == np.uint32:
        # tpu_strided words: the port holds them as int32 with the same bits
        return torch.from_numpy(arr.view(np.int32).copy())
    return torch.from_numpy(arr.copy())


def from_jax_params(flat: dict, cfg: LlamaConfig, device=None,
                    meta: dict | None = None,
                    kv_cache_format: str | None = None) -> LlamaForCausalLM:
    """Build the port's model from a JAX llama's flat state.

    ``flat`` maps dotted names ("model.layers.0.self_attn.q_proj.kernel",
    "model.embed_tokens.embedding", ...) to numpy arrays. A quantized
    projection ("<path>.packed", "<path>.scales" and, where the JAX module
    has them, ".zeros", ".perm", ".sq_scales", ".sq_zeros", ".bias",
    ".pre_scale") becomes a ``WOQLinear`` holding the same bytes (a
    ``W4A8Linear`` on JAX's layout, "tpu_strided" or "s4_rowpack", where
    the meta's "type" says the JAX module is one); fused
    "qkv_proj"/"gate_up_proj" entries replace their parts.

    ``meta`` maps each quantized module's path to its static attributes
    as the JAX package's ``save_load`` records them ("bits",
    "group_size", "wdtype", "layout", "impl"). Every quantized projection
    needs its entry: the arrays alone cannot tell symmetric int4 words
    from nf4/fp4 codebook indices. ``kv_cache_format``, the JAX model's
    ``kv_cache_format`` static attribute where its ``kv_cache_quantized``
    is set ("int8", "fp8_e4m3", "int4"), flags the port's model the same
    way. Serve the result like a model from ``build_quantized``."""
    device = resolve_device(device)
    model = LlamaForCausalLM(cfg, device=device)
    return load_jax_state(model, flat, cfg.hidden_size, device, meta,
                          kv_cache_format)


def load_jax_state(model, flat: dict, hidden_size: int, device,
                   meta: dict | None = None,
                   kv_cache_format: str | None = None):
    """Load a JAX model's flat state into the port's ``model`` of the same
    family, in place (``from_jax_params`` of each family): quantized
    projections become ``WOQLinear``s holding the same bytes (a JAX
    ``W4A8Linear``, meta "type", a ``W4A8Linear`` on its layout; fused
    "qkv_proj"/"gate_up_proj" entries, whose K is ``hidden_size``, replace
    their parts), every other array is copied by name, and
    ``kv_cache_format`` flags the KV format. Returns ``model``."""
    from ..layers.module_utils import get_module, replace_module
    from ..layers.woq_linear import W4A8Linear, WOQLinear
    from ..ops.packing import PackedWeight

    tensors = {k: _tensor_from_numpy(v) for k, v in flat.items()}
    quantized = sorted({k[:-len(".packed")] for k in tensors
                        if k.endswith(".packed")})
    for path in quantized:
        parent_path, _, name = path.rpartition(".")
        K = (hidden_size if name in ("qkv_proj", "gate_up_proj")
             else get_module(model, path).in_features)
        m = (meta or {}).get(path)
        if m is None:
            raise ValueError(f"from_jax_params: {path} is quantized and has "
                             "no meta (bits, group_size, wdtype, layout)")

        def opt(suffix):
            t = tensors.get(path + suffix)
            return None if t is None else t.to(device)

        packed, scales = opt(".packed"), opt(".scales")
        G = m["group_size"] if m["group_size"] > 0 else K
        if -(-K // G) != scales.shape[0]:
            raise ValueError(f"{path}: {scales.shape[0]} scale groups do not "
                             f"fit K={K} at group size {G}")
        pw = PackedWeight(packed, scales, opt(".zeros"), bits=m["bits"],
                          group_size=m["group_size"], dtype=m["wdtype"],
                          orig_shape=(K, scales.shape[-1]), layout=m["layout"],
                          perm=opt(".perm"), sq_scales=opt(".sq_scales"),
                          sq_zeros=opt(".sq_zeros"))
        if m.get("type") == "W4A8Linear":
            # JAX's layout kept ("tpu_strided" or "s4_rowpack")
            mod = W4A8Linear(pw, opt(".bias"), impl=m.get("impl", "auto"),
                             pre_scale=opt(".pre_scale"))
        else:
            mod = WOQLinear(pw, opt(".bias"), impl=m.get("impl", "auto"),
                            pre_scale=opt(".pre_scale"))
        if name in ("qkv_proj", "gate_up_proj"):
            parent = get_module(model, parent_path)
            setattr(parent, name, mod)
            parts = (("q_proj", "k_proj", "v_proj") if name == "qkv_proj"
                     else ("gate_proj", "up_proj"))
            for p in parts:
                setattr(parent, p, None)
        else:
            replace_module(model, path, mod)
    state = model.state_dict()
    missing = [k for k in state if k not in tensors]
    unknown = [k for k in tensors if k not in state]
    if missing or unknown:
        raise KeyError(f"from_jax_params: missing {missing[:5]}, "
                       f"unexpected {unknown[:5]}")
    with torch.no_grad():
        for k, t in tensors.items():
            state[k].copy_(t.to(state[k].dtype))
    if kv_cache_format:
        model.kv_cache_quantized = True
        model.kv_cache_format = _kv_fmt(kv_cache_format)
    return model
