"""Llama-family causal LM in PyTorch: bf16 contiguous and paged caches.

The counterpart of ``neural_compressor_tpu.models.llama`` for rotary style
"half" without scaling and dense prefill attention, decoding through the
port's kernels: over a bf16 head-major KV cache [B, Hkv, T, D] at B=1 (K5)
and at B > 1 with per-slot positions (K7), and over a paged pool of bf16
rows or int8 codes (``PagedKVCache``: K12 writes the row, K11 attends).
Module and parameter names follow the JAX model, so its flat state maps
onto this model's ``state_dict`` (``from_jax_params``).

Off this path the model raises ``NotImplementedError`` naming the JAX
function it waits for: quantized contiguous caches, fp8 and int4 pools,
multi-token windows over pages, the chunked long prefill, other rotary
styles and scalings.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..common.device import resolve_device
from ..layers.linear import Embed, Linear


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
                or self.rope_scaling):
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


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  quantized: bool | str = False, device=None):
    """One bf16 ``KVCache`` per layer, zero-filled."""
    if quantized:
        raise NotImplementedError(
            "quantized KV caches wait for the port of "
            "neural_compressor_tpu.models.llama.QuantKVCache and "
            "decode_attention_quant (K6)")
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    shape = (batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    return [KVCache(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_hidden_layers)]


class PagedKVCache(NamedTuple):
    """Paged KV cache: a shared page pool plus per-slot block tables. Pages
    are [page_size, D] rows per KV head, bf16, or int8 codes with
    per-(token, head) float32 scales. Pool page 0 is the engine's trash
    page. Consumed by ``kernels/paged_attention.py``; the port writes rows
    into the pool in place."""

    k_pages: torch.Tensor             # [P, Hkv, page, D] bf16 | int8
    k_scales: torch.Tensor | None     # [P, Hkv, page] f32 (int8 pools)
    v_pages: torch.Tensor
    v_scales: torch.Tensor | None
    block_tables: torch.Tensor        # [B, PMAX] int32 page ids per slot

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]


def init_paged_pool(cfg: LlamaConfig, n_pages: int, batch: int, max_len: int,
                    page_size: int = 128, dtype=None,
                    quantized: bool | str = False, device=None):
    """Per-layer ``PagedKVCache`` pools with empty block tables: bf16 rows,
    or int8 codes (``quantized=True`` or ``"int8"``) with scales of 1."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    fmt = ("int8" if quantized is True else str(quantized)) if quantized \
        else None
    if fmt not in (None, "int8"):
        raise NotImplementedError(
            f"{fmt} page pools wait for the port of "
            "neural_compressor_tpu.models.llama.init_paged_pool's "
            f"{fmt} branch with _kv_quant4_asym_codes (int4) or the fp8 "
            "branch of _kv_quant, and their paged kernels")
    pmax = (max_len + page_size - 1) // page_size
    shape = (n_pages, cfg.num_key_value_heads, page_size, cfg.head_dim)
    out = []
    for _ in range(cfg.num_hidden_layers):
        bt = torch.zeros((batch, pmax), dtype=torch.int32, device=device)
        if fmt:
            out.append(PagedKVCache(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(shape[:-1], dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(shape[:-1], dtype=torch.float32, device=device),
                bt))
        else:
            out.append(PagedKVCache(
                torch.zeros(shape, dtype=dtype, device=device), None,
                torch.zeros(shape, dtype=dtype, device=device), None, bt))
    return out


def _kv_quant(x: torch.Tensor, fmt: str = "int8"):
    """[B, H, S, D] -> int8 codes + per-(token, head) float32 scale, as
    ``neural_compressor_tpu.models.llama._kv_quant`` computes them."""
    if fmt != "int8":
        raise NotImplementedError(
            f"{fmt} KV codes wait for the port of the {fmt} branch of "
            "neural_compressor_tpu.models.llama._kv_quant")
    from ..kernels.paged_attention import kv_quant_int8

    return kv_quant_int8(x)


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


_DENSE_MASK_ELEMS = 16 * 1024 * 1024  # ~4096^2; S*T above this would chunk


def _grouped_attention(q, k, v, mask, D):
    """GQA-grouped SDPA: q [B, H, S, D] against k/v [B, Hkv, T, D] without
    repeating K/V; float32 scores, bf16 probabilities for PV. ``mask``
    [B or 1, 1, S, T] bool. Returns [B, H, S, D].

    The sums run in float64 over exact bf16 products and round once (JAX
    sums in float32), so the summation order almost never shows: the card
    and the CPU compute the same bits, which the int8 activation
    quantization of the next projection would otherwise amplify."""
    B, H, S, _ = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    f64 = torch.float64
    qg = q.reshape(B, Hkv, rep, S, D).to(f64)
    s = torch.einsum("bgrsd,bgtd->bgrst", qg, k.to(f64)).to(torch.float32)
    s = s / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    s = torch.where(mask[:, :, None], s, torch.tensor(-1e30, device=s.device))
    e = torch.exp(s.to(f64) - s.amax(dim=-1, keepdim=True).to(f64))
    p = (e / e.sum(dim=-1, keepdim=True)).to(torch.float32).to(v.dtype)
    out = torch.einsum("bgrst,bgtd->bgrsd", p.to(f64), v.to(f64))
    return out.to(torch.float32).reshape(B, H, S, D).to(q.dtype)


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


def _rope(positions: torch.Tensor, head_dim: int, theta: float,
          partial_factor: float = 1.0, scaling: dict | None = None):
    """Rotary tables: cos/sin [B, S, D/2] float32 (full "half" rotary).
    ``inv_freq``, cos and sin are computed in float64 and rounded once, so
    the card and the CPU give the same bits (their float32 sin/cos differ
    in the last place)."""
    if partial_factor != 1.0 or scaling:
        raise NotImplementedError(
            "partial rotary and rope scalings wait for the port of "
            "neural_compressor_tpu.models.llama._rope")
    rd = head_dim
    f64 = torch.float64
    exps = torch.arange(0, rd, 2, dtype=f64, device=positions.device) / rd
    inv_freq = (1.0 / torch.pow(torch.tensor(theta, dtype=f64), exps)).to(
        torch.float32)
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
            from ..kernels.paged_attention import paged_decode_attention

            if S != 1:
                raise NotImplementedError(
                    "multi-token windows over paged caches (speculative "
                    "serving) wait for the port of neural_compressor_tpu."
                    "kernels.paged_attention.paged_write_window (K13) and "
                    "paged_window_attention")
            pos_b = (cache_pos if isinstance(cache_pos, torch.Tensor)
                     else torch.tensor(cache_pos, device=q.device))
            pos_b = pos_b.reshape(-1).to(device=q.device,
                                         dtype=torch.int32).expand(B)
            new_cache = _paged_write_row(cache, k, v, pos_b)
            out = paged_decode_attention(q, new_cache, pos_b + 1)
            out = out.to(x_dtype).transpose(1, 2)
            return out.reshape(B, S, H * D), new_cache
        if cache is not None:
            if not isinstance(cache, KVCache):
                raise NotImplementedError(
                    "quantized caches wait for the port of "
                    "neural_compressor_tpu.models.llama.QuantKVCache "
                    "and decode_attention_quant (K6)")
            if S == 1:
                # B == 1 with an int position on the B=1 kernel (K5), B > 1
                # and per-slot positions on the batched one (K7)
                out, k_all, v_all = decode_attention(
                    q, k, v, cache.k, cache.v, cache_pos)
                out = out.to(x_dtype).transpose(1, 2)
                return out.reshape(B, S, H * D), KVCache(k_all, v_all)
            k_all = _update_rows(cache.k, k, cache_pos)
            v_all = _update_rows(cache.v, v, cache_pos)
            new_cache = KVCache(k_all, v_all)
            k, v = k_all.to(x_dtype), v_all.to(x_dtype)
        out = _grouped_attention(q, k, v, mask, D)
        return out.transpose(1, 2).reshape(B, S, H * D), new_cache


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
        self.fused_decode = False  # set by quantization.fuse.enable_fused_decode

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
        quant, silu(g)*u, residual adds). Returns None to fall back to the
        modular path (ineligible weights)."""
        from ..kernels.fused_matvec import fused_matvec

        attn, mlp = self.self_attn, self.mlp
        cfg = attn.cfg
        B, S, _ = x.shape
        H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        qkv_m, gu_m = attn.qkv_proj, mlp.gate_up_proj
        if qkv_m is None or gu_m is None:
            return None
        ln1, ln2 = self.input_layernorm, self.post_attention_layernorm
        qkv = fused_matvec(x, qkv_m.packed_weight(), rms_w=ln1.weight,
                           eps=ln1.eps, bias=qkv_m.bias, out_dtype=x.dtype)
        if qkv is None:
            return None
        q, k, v = torch.split(qkv, [H * D, Hkv * D, Hkv * D], dim=-1)
        q = apply_rope(q.reshape(B, S, H, D), cos, sin, cfg.rope_style)
        k = apply_rope(k.reshape(B, S, Hkv, D), cos, sin, cfg.rope_style)
        q, k = q.transpose(1, 2), k.transpose(1, 2)
        v = v.reshape(B, S, Hkv, D).transpose(1, 2)
        out, new_cache = attn._attend(x.dtype, q, k, v, mask, cache,
                                      cache_pos)
        x1 = fused_matvec(out, attn.o_proj.packed_weight(), residual=x,
                          bias=attn.o_proj.bias, out_dtype=x.dtype)
        if x1 is None:
            return None
        h = fused_matvec(x1, gu_m.packed_weight(), rms_w=ln2.weight,
                         eps=ln2.eps, silu_gate=True, out_dtype=x.dtype)
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
        if caches is None:
            T = S
            mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                         device=dev))[None, None]
        else:
            T = caches[0][0].shape[2]
            key_pos = torch.arange(T, device=dev)[None, None, None, :]
            mask = key_pos <= positions[:, None, :, None]
        if S * T > _DENSE_MASK_ELEMS and S > 1:
            raise NotImplementedError(
                "the chunked long prefill (S*T > _DENSE_MASK_ELEMS) waits for "
                "the port of neural_compressor_tpu.models.llama."
                "_grouped_attention_chunked")
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
    if getattr(quant_config, "quant_lm_head", False):
        holder = _LayerHolder(model.lm_head)
        _quantize(holder, quant_config)
        model.lm_head = holder.layer
    return model


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


def from_jax_params(flat: dict, cfg: LlamaConfig, device=None) -> LlamaForCausalLM:
    """Build the port's model from a JAX llama's flat state.

    ``flat`` maps dotted names ("model.layers.0.self_attn.q_proj.kernel",
    "model.embed_tokens.embedding", ...) to numpy arrays. A quantized
    projection ("<path>.packed" + "<path>.scales", symmetric int4
    "tpu_strided") becomes a ``WOQLinear`` holding the same bytes; fused
    "qkv_proj"/"gate_up_proj" entries replace their parts. Serve the result
    with ``fuse_for_serving`` / ``to_w4a8_serving`` /
    ``enable_fused_decode`` as a model from ``build_quantized``."""
    from ..layers.module_utils import get_module, replace_module
    from ..layers.woq_linear import WOQLinear
    from ..ops.packing import PackedWeight

    device = resolve_device(device)
    model = LlamaForCausalLM(cfg, device=device)
    tensors = {k: _tensor_from_numpy(v) for k, v in flat.items()}
    quantized = sorted({k[:-len(".packed")] for k in tensors
                        if k.endswith(".packed")})
    for path in quantized:
        if path + ".zeros" in tensors:
            raise NotImplementedError(
                "asymmetric JAX weights wait for the port of "
                "neural_compressor_tpu.ops.qtensor.quantize_int_asym")
        packed = tensors[path + ".packed"]
        scales = tensors[path + ".scales"].to(torch.float32)
        bias = tensors.get(path + ".bias")
        if packed.dtype != torch.int32:
            raise NotImplementedError(
                f"{path}: only int4 'tpu_strided' JAX weights carry across")
        K, N = packed.shape[0] * 8, packed.shape[1]
        pw = PackedWeight(packed.to(device), scales.to(device), None, bits=4,
                          group_size=K // scales.shape[0], dtype="int",
                          orig_shape=(K, N), layout="tpu_strided")
        parent_path, _, name = path.rpartition(".")
        mod = WOQLinear(pw, None if bias is None else bias.to(device))
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
    return model
