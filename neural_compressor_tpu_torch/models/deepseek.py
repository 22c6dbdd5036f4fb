"""DeepSeek-V3 family causal LM in PyTorch: multi-head latent attention
(MLA) and a sigmoid-routed MoE with shared experts.

The counterpart of ``neural_compressor_tpu.models.deepseek``; module and
parameter names follow the JAX model, so its flat state maps onto this
model's ``state_dict`` (``from_jax_params``). Every projection (the MLA
low-rank a/b factors and every expert's MLP included) is a ``Linear``, so
RTN quantizes the whole model to ``WOQLinear``s; the router is a raw
float32 parameter and stays float.

MLA: q through the optional low-rank ``q_b(q_a_norm(q_a(x)))``; one
down-projection ``kv_a_proj_with_mqa`` to [latent (kv_lora_rank) | shared
rope key (qk_rope_head_dim)], the latent RMS-normed and up-projected per
head by ``kv_b_proj`` to [k_nope | v]; the rope key shared by every head;
scores times ``attn_scale``. Caches:
  * expanded (the model's default): contiguous ``KVCache`` /
    ``QuantKVCache`` rows, K ``qk_head_dim`` and V ``v_head_dim`` wide,
    attended in plain PyTorch as JAX attends them in XLA;
  * latent (``enable_mla_latent_cache``): one [r + dr] row a token, the
    absorbed form (kv_b's key half folded into the query, its value half
    applied after the probabilities times the latent), in bf16
    (``LatentKVCache``), int8 or fp8-e4m3 with one scale a token
    (``QuantLatentKVCache``) or packed int4 with per-part affine pairs
    (``Quant4LatentKVCache``), attended in plain PyTorch as in XLA (a long
    prefill chunked, ``_grouped_attention_chunked``); and the paged
    latent pool of the engine (``PagedLatentKVCache``), where K14's write
    puts each slot's row into its page and K14's attention attends the
    slot's pages (``kernels.paged_attention.paged_write_latent`` and
    ``paged_latent_attention``).
The MoE dispatches densely, as JAX does: every expert runs on every token
and the outputs accumulate in float32 in ascending expert order.

Off this slice's path, the model raises ``NotImplementedError`` naming the
JAX function it waits for: YaRN rope scaling (the port's ``_rope``), and
speculation over a paged latent pool (the engine raises ``ValueError``, as
JAX's does).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from ..common.device import resolve_device
from ..layers.linear import Embed, Linear
from ..ops.kv_quant import KV_CODE_DTYPES as _KV_CODE_DTYPES
from ..ops.kv_quant import _asym
from ..ops.kv_quant import kv_quant as _kv_quant
from ..ops.kv_quant import kv_unpack_int4 as _lat4_unpack
from . import llama as _llama
from .llama import (_F64, KVCache, QuantKVCache, RMSNorm, _ChunkedCausal,
                    _grouped_attention_chunked, _kv_fmt, _LayerHolder, _rope,
                    _silu, _softmax_f32, _update_rows, apply_rope,
                    load_jax_state, update_cache)

_F32 = torch.float32


class LatentKVCache(NamedTuple):
    """MLA latent cache: one row a token of [kv_lora_rank (post-norm
    latent) | qk_rope_head_dim (rotated shared key)], [B, 1, T, r + dr],
    whatever the head count. The port writes rows in place."""

    lat: torch.Tensor


class QuantLatentKVCache(NamedTuple):
    """int8 / fp8-e4m3 latent cache: each [r + dr] row quantized with one
    scale a token (the latent is both K and V, so one code and scale pair
    serves the score and the output products)."""

    codes: torch.Tensor   # int8 | float8_e4m3fn [B, 1, T, r + dr]
    scale: torch.Tensor   # f32 [B, 1, T]

    @property
    def fmt(self) -> str:
        return "int8" if self.codes.dtype == torch.int8 else "fp8_e4m3"


class Quant4LatentKVCache(NamedTuple):
    """Packed int4 latent cache: the row's parts (latent halves [0, r/2),
    [r/2, r) and the rope key [r, C)) each with their own affine pair a
    token; the latent's two halves share one byte (low nibble: first
    half), the rope key packs half-split within dr."""

    codes_v: torch.Tensor    # uint8 [B, 1, T, r/2]
    codes_rot: torch.Tensor  # uint8 [B, 1, T, dr/2]
    scale_v: torch.Tensor    # f32 [B, 1, T, 2]
    off_v: torch.Tensor      # f32 [B, 1, T, 2]
    scale_r: torch.Tensor    # f32 [B, 1, T]
    off_r: torch.Tensor      # f32 [B, 1, T]


class PagedLatentKVCache(NamedTuple):
    """Paged latent cache (decode only): a page pool [P, 1, page, r + dr]
    and per-slot block tables [B, PMAX] int32; page 0 is the engine's trash
    page. Written and attended by K14."""

    lat_pages: torch.Tensor
    block_tables: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.lat_pages.shape[2]


def _lat4_quant_part(part: torch.Tensor):
    """One part of a latent row [..., W] -> half-split packed codes
    [..., W/2], scale and offset [...] (JAX's ``_lat4_quant_part`` under
    ``jit``: ``(mx - mn) / 15`` as a multiply by f32(1/15))."""
    c, scale, off = _asym(part.to(_F32))
    h = c.shape[-1] // 2
    return c[..., :h] | (c[..., h:] << 4), scale, off


def _lat4_quant(row: torch.Tensor, r: int):
    """[B, 1, S, C] latent rows -> (codes_v, codes_rot, scale_v, off_v,
    scale_r, off_r), ``Quant4LatentKVCache``'s fields for these rows: the
    latent's two r/2 halves quantized apart and re-packed into one byte
    (low nibble: first half), the rope part with one pair."""
    h = r // 2
    c0, s0, o0 = _lat4_quant_part(row[..., :h])
    c1, s1, o1 = _lat4_quant_part(row[..., h:r])

    def unpack_codes(c):
        return torch.cat([c & 15, c >> 4], dim=-1)

    cv = (unpack_codes(c0) | (unpack_codes(c1) << 4)).to(torch.uint8)
    sv = torch.stack([s0, s1], dim=-1)
    ov = torch.stack([o0, o1], dim=-1)
    cr, sr, orr = _lat4_quant_part(row[..., r:])
    return cv, cr, sv, ov, sr, orr


def init_paged_latent_pool(cfg: "DeepseekConfig", n_pages: int, batch: int,
                           max_len: int, page_size: int = 128, device=None):
    """Per-layer ``PagedLatentKVCache`` pools with empty block tables (the
    model in latent mode: ``enable_mla_latent_cache``). Any page size."""
    device = resolve_device(device)
    C = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    pmax = (max_len + page_size - 1) // page_size
    return [PagedLatentKVCache(
        torch.zeros((n_pages, 1, page_size, C), dtype=cfg.dtype,
                    device=device),
        torch.zeros((batch, pmax), dtype=torch.int32, device=device))
        for _ in range(cfg.num_hidden_layers)]


@dataclasses.dataclass
class DeepseekConfig:
    vocab_size: int = 129280
    hidden_size: int = 7168
    intermediate_size: int = 18432       # dense layers
    moe_intermediate_size: int = 2048    # a routed or shared expert
    num_hidden_layers: int = 61
    num_attention_heads: int = 128
    # MLA
    q_lora_rank: int | None = 1536       # None: a direct q_proj
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # MoE
    n_routed_experts: int = 256
    num_experts_per_tok: int = 8
    n_shared_experts: int = 1
    n_group: int = 8
    topk_group: int = 4
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.5
    first_k_dense_replace: int = 3       # leading layers: a dense MLP
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_interleave: bool = True
    # YaRN (deepseek-v3's published config sets factor 40); the port's
    # _rope raises for it
    rope_scaling: dict | None = None
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.n_routed_experts % self.n_group:
            raise ValueError("n_routed_experts must divide into n_group "
                             "groups")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def attn_scale(self) -> float:
        """qk_head_dim ** -0.5, times YaRN's mscale^2 when
        ``mscale_all_dim`` is set."""
        s = self.qk_head_dim ** -0.5
        rs = self.rope_scaling
        if rs and rs.get("mscale_all_dim"):
            f = float(rs["factor"])
            m = (0.1 * float(rs["mscale_all_dim"]) * math.log(f) + 1.0
                 if f > 1 else 1.0)
            s = s * m * m
        return s


# the JAX package's presets; "deepseek-v3" is the published config.json's
# widths without its YaRN scaling
DEEPSEEK_PRESETS = {
    "deepseek-test": dict(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=4, q_lora_rank=32, kv_lora_rank=16,
        qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=16,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
        n_group=4, topk_group=2, first_k_dense_replace=1,
        max_position_embeddings=128),
    "deepseek-v3": dict(),
}


def _einsum_f32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 results, summed in float64 over exact
    products (bf16 and float32 operands multiply exactly in float64) and
    rounded once, so the card and the CPU give the same bits."""
    return torch.einsum(eq, *(t.to(_F64) for t in ops)).to(_F32)


def _topk_desc(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first on ties, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order): a stable descending sort, its first k."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class DeepseekMLP(nn.Module):
    """SwiGLU MLP, ``down(silu(gate(x)) * up(x))``, silu rounded as XLA
    rounds it in bf16 (``models.llama._silu``)."""

    def __init__(self, cfg: "DeepseekConfig", intermediate: int, device=None,
                 generator=None):
        super().__init__()

        def lin(i, o):
            return Linear(i, o, dtype=cfg.dtype, device=device,
                          generator=generator)

        self.gate_proj = lin(cfg.hidden_size, intermediate)
        self.up_proj = lin(cfg.hidden_size, intermediate)
        self.down_proj = lin(intermediate, cfg.hidden_size)

    def forward(self, x):
        return self.down_proj(_silu(self.gate_proj(x)) * self.up_proj(x))


class DeepseekTopkRouter(nn.Module):
    """Raw-parameter router (not a Linear, so quantization leaves it
    float32): sigmoid scores; selection adds ``e_score_correction_bias``
    and is group-limited (the top ``topk_group`` of ``n_group`` groups by
    the sum of each group's top-2 scores); the combine weights are the
    unbiased sigmoid scores of the chosen experts, normalised, times
    ``routed_scaling_factor``."""

    def __init__(self, cfg: "DeepseekConfig", device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        w = torch.randn((cfg.n_routed_experts, cfg.hidden_size),
                        generator=generator, device=device) * 0.02
        self.weight = nn.Parameter(w, requires_grad=False)
        self.e_score_correction_bias = nn.Parameter(
            torch.zeros(cfg.n_routed_experts, dtype=_F32, device=device),
            requires_grad=False)

    def forward(self, xt: torch.Tensor):
        """xt [T, hidden] -> (topk indices [T, k] int64, topk weights
        [T, k] float32). The logits and the sigmoid in float64, rounded
        once to float32."""
        cfg = self.cfg
        E, G = cfg.n_routed_experts, cfg.n_group
        T = xt.shape[0]
        logits = xt.to(_F32).to(_F64) @ self.weight.to(_F64).t()
        scores = torch.sigmoid(logits.to(_F32).to(_F64)).to(_F32)  # [T, E]
        sc = scores + self.e_score_correction_bias[None, :]
        top2, _ = _topk_desc(sc.reshape(T, G, E // G), 2)
        group_scores = top2[..., 0] + top2[..., 1]                # [T, G]
        _, gidx = _topk_desc(group_scores, cfg.topk_group)
        gmask = torch.zeros((T, G), dtype=torch.bool, device=xt.device)
        gmask.scatter_(1, gidx, True)
        emask = gmask.repeat_interleave(E // G, dim=-1)             # [T, E]
        masked = torch.where(emask, sc, torch.zeros((), dtype=_F32,
                                                    device=xt.device))
        _, topi = _topk_desc(masked, cfg.num_experts_per_tok)
        topw = torch.gather(scores, 1, topi)
        if cfg.norm_topk_prob:
            den = topw.to(_F64).sum(dim=-1, keepdim=True).to(_F32) + 1e-20
            topw = topw / den
        return topi, topw * cfg.routed_scaling_factor


class DeepseekMoE(nn.Module):
    """Dense-dispatch MoE: every expert runs on every token, weighted by the
    sparse routing weights (zero for the experts a token did not choose),
    accumulated in float32 in ascending expert order, as the JAX package
    computes it; then the always-on shared experts. ``build_experts=False``
    leaves ``experts`` empty for ``build_quantized`` to fill one by one."""

    def __init__(self, cfg: "DeepseekConfig", device=None, generator=None,
                 build_experts: bool = True):
        super().__init__()
        self.cfg = cfg
        self.gate = DeepseekTopkRouter(cfg, device, generator)
        self.experts = nn.ModuleList(
            [DeepseekMLP(cfg, cfg.moe_intermediate_size, device, generator)
             for _ in range(cfg.n_routed_experts if build_experts else 0)])
        self.shared_experts = DeepseekMLP(
            cfg, cfg.moe_intermediate_size * cfg.n_shared_experts, device,
            generator)

    def forward(self, x):
        cfg = self.cfg
        B, S, Hd = x.shape
        xt = x.reshape(B * S, Hd)
        topi, topw = self.gate(xt)
        w_full = torch.zeros((B * S, cfg.n_routed_experts), dtype=_F32,
                             device=x.device).scatter_(1, topi, topw)
        out = torch.zeros((B * S, Hd), dtype=_F32, device=x.device)
        for e, expert in enumerate(self.experts):
            out = out + expert(xt).to(_F32) * w_full[:, e:e + 1]
        out = out.to(x.dtype).reshape(B, S, Hd)
        return out + self.shared_experts(x)


def _densify(mask, T: int):
    """A ``_ChunkedCausal`` sentinel as a dense bool mask [B, 1, S, T] (the
    expanded MLA path has no chunked form, as in the JAX package)."""
    if isinstance(mask, _ChunkedCausal):
        key_pos = torch.arange(T, device=mask.q_pos.device)[None, None, None]
        return key_pos <= mask.q_pos[:, None, :, None]
    return mask


class DeepseekAttention(nn.Module):
    """MLA (HF DeepseekV3Attention)."""

    def __init__(self, cfg: "DeepseekConfig", device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.num_attention_heads

        def lin(i, o, b=False):
            return Linear(i, o, bias=b, dtype=cfg.dtype, device=device,
                          generator=generator)

        if cfg.q_lora_rank is None:
            self.q_proj = lin(cfg.hidden_size, H * cfg.qk_head_dim)
            self.q_a_proj = self.q_a_layernorm = self.q_b_proj = None
        else:
            self.q_proj = None
            self.q_a_proj = lin(cfg.hidden_size, cfg.q_lora_rank,
                                cfg.attention_bias)
            self.q_a_layernorm = RMSNorm(cfg.q_lora_rank, cfg.rms_norm_eps,
                                         cfg.dtype, device)
            self.q_b_proj = lin(cfg.q_lora_rank, H * cfg.qk_head_dim)
        self.kv_a_proj_with_mqa = lin(
            cfg.hidden_size, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
            cfg.attention_bias)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps,
                                      cfg.dtype, device)
        self.kv_b_proj = lin(cfg.kv_lora_rank,
                             H * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        self.o_proj = lin(H * cfg.v_head_dim, cfg.hidden_size,
                          cfg.attention_bias)
        # absorbed kv_b factors of the latent path (enable_mla_latent_cache):
        # float32 [r, H, dn] and [r, H, dv]
        self.w_k_absorb = None
        self.w_v_absorb = None

    def _rot(self, x, cos, sin):
        """Rope over the qk_rope slice: ``rope_interleave`` checkpoints keep
        pairs interleaved, regrouped (even | odd) before the rotate-half."""
        if self.cfg.rope_interleave:
            x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
        return apply_rope(x, cos, sin, "half")

    def forward(self, x, cos, sin, mask, cache=None, cache_pos=None):
        cfg = self.cfg
        B, S, _ = x.shape
        H = cfg.num_attention_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        if self.q_proj is not None:
            q = self.q_proj(x)
        else:
            q = self.q_b_proj(self.q_a_layernorm(self.q_a_proj(x)))
        q = q.reshape(B, S, H, dn + dr)
        q_nope, q_rot = q[..., :dn], q[..., dn:]
        ckv = self.kv_a_proj_with_mqa(x)                        # [B, S, r+dr]
        r = cfg.kv_lora_rank
        latent, k_rot = ckv[..., :r], ckv[..., r:]
        if isinstance(cache, (LatentKVCache, PagedLatentKVCache,
                              QuantLatentKVCache, Quant4LatentKVCache)):
            return self._latent_attend(x, q_nope, q_rot, latent, k_rot, cos,
                                       sin, mask, cache, cache_pos)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent))
        kv = kv.reshape(B, S, H, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        q_rot = self._rot(q_rot, cos, sin)
        k_rot = self._rot(k_rot[:, :, None, :], cos, sin).expand(B, S, H, dr)
        q = torch.cat([q_nope, q_rot], dim=-1).transpose(1, 2)   # [B,H,S,dq]
        k = torch.cat([k_nope, k_rot], dim=-1).transpose(1, 2)
        v = v.transpose(1, 2)                                    # [B,H,S,dv]
        new_cache = None
        if cache is not None:
            k, v, new_cache = update_cache(cache, k, v, cache_pos, x.dtype)
        mask = _densify(mask, k.shape[2])
        s = _einsum_f32("bhsd,bhtd->bhst", q, k)
        s = s * torch.tensor(cfg.attn_scale, dtype=_F32)
        s = torch.where(mask, s, torch.tensor(-1e30, device=s.device))
        p = _softmax_f32(s)
        out = _einsum_f32("bhst,bhtd->bhsd", p.to(v.dtype), v)
        out = out.to(x.dtype).transpose(1, 2).reshape(B, S, H * dv)
        return self.o_proj(out), new_cache

    def _out(self, x, o_lat):
        """o_lat [B, H, S, r] float32 -> the value absorb, o_proj."""
        B, S = x.shape[0], x.shape[1]
        H, dv = self.cfg.num_attention_heads, self.cfg.v_head_dim
        out = _einsum_f32("bhsc,chd->bshd", o_lat, self.w_v_absorb)
        return self.o_proj(out.to(x.dtype).reshape(B, S, H * dv))

    def _chunked(self, x, qcat, k, v, mask, k_scale=None):
        """The chunked long prefill over the latent rows (as an Hkv = 1
        cache): q pre-scaled by ``attn_scale * sqrt(C)`` in q's dtype (the
        chunked form scales by f32(1/sqrt(C))), -> o_lat float32."""
        C = k.shape[-1]
        qs = (qcat * torch.tensor(self.cfg.attn_scale * float(C) ** 0.5,
                                  dtype=qcat.dtype, device=qcat.device)
              ).transpose(1, 2)                                  # [B,H,S,C]
        return _grouped_attention_chunked(
            qs, k, v, mask.q_pos, C, k_scale=k_scale,
            v_scale=k_scale).to(_F32)

    def _latent_attend(self, x, q_nope, q_rot, latent, k_rot, cos, sin,
                       mask, cache, cache_pos):
        """Absorbed MLA over the latent cache: scores q_nope . k_nope ==
        (q_nope @ W_k^T) . c, so the per-head key never exists; the output
        is probs . c, then the per-head value factor."""
        from ..kernels.paged_attention import (paged_latent_attention,
                                               paged_write_latent)

        cfg = self.cfg
        B, S, _ = x.shape
        r = cfg.kv_lora_rank
        scale = torch.tensor(cfg.attn_scale, dtype=_F32)
        if self.w_k_absorb is None:
            raise ValueError("a latent cache needs enable_mla_latent_cache("
                             "model) first")
        c = self.kv_a_layernorm(latent)                            # [B,S,r]
        q_rot = self._rot(q_rot, cos, sin)
        krot = self._rot(k_rot[:, :, None, :], cos, sin)[:, :, 0]
        row = torch.cat([c, krot.to(c.dtype)], dim=-1)[:, None]    # [B,1,S,C]
        q_abs = _einsum_f32("bshd,rhd->bshr", q_nope, self.w_k_absorb)
        qcat = torch.cat([q_abs.to(x.dtype), q_rot], dim=-1)       # [B,S,H,C]
        if isinstance(cache, PagedLatentKVCache):
            if S != 1:
                raise ValueError("a paged latent cache is decode-only (the "
                                 "engine prefills through staging rows)")
            pos_b = (cache_pos if isinstance(cache_pos, torch.Tensor)
                     else torch.tensor(cache_pos, device=x.device))
            pos_b = pos_b.reshape(-1).to(device=x.device,
                                         dtype=torch.int32).expand(B)
            pages = paged_write_latent(cache.lat_pages, cache.block_tables,
                                       row[:, 0, 0], pos_b)
            o_lat = paged_latent_attention(
                qcat.transpose(1, 2), pages, cache.block_tables, pos_b + 1,
                r, cfg.attn_scale)                               # [B,H,1,r]
            return self._out(x, o_lat), PagedLatentKVCache(
                pages, cache.block_tables)
        if isinstance(cache, Quant4LatentKVCache):
            fields = _lat4_quant(row, r)
            new_cache = Quant4LatentKVCache(*(
                _update_rows(arr, new, cache_pos)
                for arr, new in zip(cache, fields)))
            lat_v, lat_r, sv_a, ov_a, sr_a, or_a = new_cache
            cvu = _lat4_unpack(lat_v[:, 0]).to(x.dtype)           # [B,T,r]
            cru = _lat4_unpack(lat_r[:, 0]).to(x.dtype)           # [B,T,dr]
            sv0, sv1 = sv_a[:, 0, :, 0], sv_a[:, 0, :, 1]         # [B,T]
            ov0, ov1 = ov_a[:, 0, :, 0], ov_a[:, 0, :, 1]
            srt, ort = sr_a[:, 0], or_a[:, 0]
            h = r // 2
            if isinstance(mask, _ChunkedCausal):
                # dequantize once (one rounding of code * scale + off, as
                # XLA fuses it) and take the chunked attention
                def deq(cp, sp, op):
                    return (cp.to(_F64) * sp[..., None].to(_F64)
                            + op[..., None].to(_F64)).to(_F32)

                latf = torch.cat([deq(cvu[..., :h], sv0, ov0),
                                  deq(cvu[..., h:], sv1, ov1),
                                  deq(cru, srt, ort)], dim=-1).to(x.dtype)
                o_lat = self._chunked(x, qcat, latf[:, None],
                                      latf[:, None, :, :r], mask)
                return self._out(x, o_lat), new_cache
            parts = ((qcat[..., :h], cvu[..., :h], sv0, ov0),
                     (qcat[..., h:r], cvu[..., h:], sv1, ov1),
                     (qcat[..., r:], cru, srt, ort))
            # per part: s_p * (q_p . c'_p) + off_p * sum(q_p), in JAX's order
            sq = torch.zeros((), dtype=_F32, device=x.device)
            for qp, cp, sp, op in parts:
                d = _einsum_f32("bshc,btc->bhst", qp, cp)
                qs_ = qp.to(_F64).sum(dim=-1).to(_F32).transpose(1, 2)
                sq = (sq + d * sp[:, None, None, :]
                      + qs_[..., None] * op[:, None, None, :])
            sq = torch.where(mask, sq * scale,
                             torch.tensor(-1e30, device=sq.device))
            pq = _softmax_f32(sq)
            halves = []
            for cp, sp, op in ((cvu[..., :h], sv0, ov0),
                               (cvu[..., h:], sv1, ov1)):
                o_h = _einsum_f32("bhst,btc->bhsc",
                                  (pq * sp[:, None, None, :]).to(x.dtype), cp)
                halves.append(o_h + _einsum_f32("bhst,bt->bhs", pq,
                                                op)[..., None])
            return self._out(x, torch.cat(halves, dim=-1)), new_cache
        if isinstance(cache, QuantLatentKVCache):
            codes, scl = _kv_quant(row, cache.fmt)
            lat_c = _update_rows(cache.codes, codes, cache_pos)
            lat_s = _update_rows(cache.scale, scl, cache_pos)
            new_cache = QuantLatentKVCache(lat_c, lat_s)
            if isinstance(mask, _ChunkedCausal):
                o_lat = self._chunked(x, qcat, lat_c.to(x.dtype),
                                      lat_c[..., :r].to(x.dtype), mask,
                                      k_scale=lat_s)
                return self._out(x, o_lat), new_cache
            latf = lat_c[:, 0].to(x.dtype)                          # [B,T,C]
            st = lat_s[:, 0]                                        # [B,T]
            sq = _einsum_f32("bshc,btc->bhst", qcat, latf)
            sq = sq * st[:, None, None, :] * scale
            pq = _softmax_f32(torch.where(mask, sq, torch.tensor(
                -1e30, device=sq.device)))
            o_lat = _einsum_f32("bhst,btc->bhsc",
                                (pq * st[:, None, None, :]).to(latf.dtype),
                                latf[..., :r])
            return self._out(x, o_lat), new_cache
        lat = _update_rows(cache.lat, row, cache_pos)              # [B,1,T,C]
        latf = lat[:, 0].to(x.dtype)
        if isinstance(mask, _ChunkedCausal):
            o_lat = self._chunked(x, qcat, latf[:, None],
                                  latf[:, None, :, :r], mask)
            return self._out(x, o_lat), LatentKVCache(lat)
        s = _einsum_f32("bshc,btc->bhst", qcat, latf) * scale
        p = _softmax_f32(torch.where(mask, s, torch.tensor(-1e30,
                                                           device=s.device)))
        o_lat = _einsum_f32("bhst,btc->bhsc", p.to(latf.dtype), latf[..., :r])
        return self._out(x, o_lat), LatentKVCache(lat)


def enable_mla_latent_cache(model: "DeepseekForCausalLM") -> int:
    """Switch a DeepSeek model to the latent KV cache (absorbed MLA):
    build each attention's float32 absorbed kv_b factors ``w_k_absorb``
    [r, H, dn] and ``w_v_absorb`` [r, H, dv], from the dequantized kernel
    where a quantization pass made ``kv_b_proj`` a ``WOQLinear`` (so the
    latent path reproduces the quantized expanded numerics), and make
    ``init_caches`` allocate latent rows. A ``pre_scale`` on kv_b_proj
    (unabsorbed smoothing) raises: the absorption would drop it. Returns
    the number of attention modules converted."""
    n = 0
    for layer in model.model.layers:
        attn = layer.self_attn
        kvb = attn.kv_b_proj
        if getattr(kvb, "pre_scale", None) is not None:
            raise ValueError(
                "kv_b_proj carries a runtime pre_scale (unabsorbed AWQ "
                "smoothing); the latent absorption would drop it")
        if hasattr(kvb, "dequantized_kernel"):
            kernel = kvb.dequantized_kernel(_F32)
        else:
            kernel = kvb.kernel.to(_F32)
        cfg = attn.cfg
        dn = cfg.qk_nope_head_dim
        kbr = kernel.reshape(cfg.kv_lora_rank, cfg.num_attention_heads, -1)
        attn.w_k_absorb = nn.Parameter(kbr[..., :dn].contiguous(),
                                       requires_grad=False)
        attn.w_v_absorb = nn.Parameter(kbr[..., dn:].contiguous(),
                                       requires_grad=False)
        n += 1
    model.use_latent_cache = True
    return n


class DeepseekDecoderLayer(nn.Module):
    def __init__(self, cfg: "DeepseekConfig", layer_idx: int, device=None,
                 generator=None, build_experts: bool = True):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       cfg.dtype, device)
        self.self_attn = DeepseekAttention(cfg, device, generator)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, cfg.dtype,
                                                device)
        if layer_idx >= cfg.first_k_dense_replace:
            self.mlp = DeepseekMoE(cfg, device, generator, build_experts)
        else:
            self.mlp = DeepseekMLP(cfg, cfg.intermediate_size, device,
                                   generator)

    def forward(self, x, cos, sin, mask, cache=None, cache_pos=None):
        h, new_cache = self.self_attn(self.input_layernorm(x), cos, sin,
                                      mask, cache, cache_pos)
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_cache


class DeepseekModel(nn.Module):
    def __init__(self, cfg: "DeepseekConfig", device=None, generator=None,
                 n_layers: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size,
                                  dtype=cfg.dtype, device=device,
                                  generator=generator)
        n = cfg.num_hidden_layers if n_layers is None else n_layers
        self.layers = nn.ModuleList(
            [DeepseekDecoderLayer(cfg, i, device, generator)
             for i in range(n)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                            device)

    def forward(self, input_ids, positions=None, caches=None, cache_pos=None):
        cfg = self.cfg
        B, S = input_ids.shape
        dev = input_ids.device
        if positions is None:
            positions = torch.arange(S, device=dev)[None, :].expand(B, S)
        x = self.embed_tokens(input_ids)
        cos, sin = _rope(positions, cfg.qk_rope_head_dim, cfg.rope_theta, 1.0,
                         cfg.rope_scaling)
        if caches is None:
            if S * S > _llama._DENSE_MASK_ELEMS:  # long prefill: chunked
                mask = _ChunkedCausal(torch.arange(S, device=dev)[None])
            else:
                mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                             device=dev))[None, None]
        else:
            T = caches[0][0].shape[2]
            if S * T > _llama._DENSE_MASK_ELEMS and S > 1:
                mask = _ChunkedCausal(positions)
            else:
                key_pos = torch.arange(T, device=dev)[None, None, None, :]
                mask = key_pos <= positions[:, None, :, None]
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            x, nc = layer(x, cos, sin, mask, cache, cache_pos)
            if new_caches is not None:
                new_caches.append(nc)
        return self.norm(x), new_caches


class DeepseekForCausalLM(nn.Module):
    def __init__(self, cfg: "DeepseekConfig", device=None, seed: int = 0,
                 n_layers: int | None = None):
        """Random weights made from ``seed`` on ``device`` (None: the CUDA
        card); ``n_layers`` builds fewer decoder layers (``build_quantized``
        adds them one by one)."""
        super().__init__()
        if cfg.tie_word_embeddings:
            raise NotImplementedError(
                "tied embeddings wait for the port of nnx.Embed.attend in "
                "neural_compressor_tpu.models.deepseek.DeepseekForCausalLM")
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.model = DeepseekModel(cfg, device, gen, n_layers=n_layers)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                              dtype=cfg.dtype, device=device, generator=gen)
        self.use_latent_cache = False

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.embedding.device

    def forward(self, input_ids, positions=None, caches=None, cache_pos=None):
        x, new_caches = self.model(input_ids, positions, caches, cache_pos)
        logits = self.lm_head(x)
        if caches is None:
            return logits
        return logits, new_caches

    def init_caches(self, batch: int, max_len: int,
                    quantized: bool | str = False):
        """Zero-filled caches, one a layer, in the model's mode: latent rows
        (``enable_mla_latent_cache``; bf16, or with ``quantized`` int8 /
        fp8-e4m3 codes with a scale a token, or packed int4), else the
        expanded K (``qk_head_dim`` wide) and V (``v_head_dim``) rows, bf16
        or int8 / fp8 codes (packed int4 is the latent cache's only). The
        generation loops and the engine allocate through this."""
        cfg = self.cfg
        dev = self.device
        fmt = _kv_fmt(quantized)
        L = cfg.num_hidden_layers

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        def one(shape):
            return torch.ones(shape, dtype=_F32, device=dev)

        if self.use_latent_cache:
            r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
            lead = (batch, 1, max_len)
            if fmt == "int4":
                return [Quant4LatentKVCache(
                    z(lead + (r // 2,), torch.uint8),
                    z(lead + (dr // 2,), torch.uint8), one(lead + (2,)),
                    z(lead + (2,), _F32), one(lead), z(lead, _F32))
                    for _ in range(L)]
            if fmt:
                return [QuantLatentKVCache(
                    z(lead + (r + dr,), _KV_CODE_DTYPES[fmt]), one(lead))
                    for _ in range(L)]
            return [LatentKVCache(z(lead + (r + dr,), cfg.dtype))
                    for _ in range(L)]
        H = cfg.num_attention_heads
        kshape = (batch, H, max_len, cfg.qk_head_dim)
        vshape = (batch, H, max_len, cfg.v_head_dim)
        if fmt == "int4":
            raise ValueError("packed int4 KV is the latent cache's only "
                             "(enable_mla_latent_cache)")
        if fmt:
            cdt = _KV_CODE_DTYPES[fmt]
            return [QuantKVCache(z(kshape, cdt), one(kshape[:-1]),
                                 z(vshape, cdt), one(vshape[:-1]))
                    for _ in range(L)]
        return [KVCache(z(kshape, cfg.dtype), z(vshape, cfg.dtype))
                for _ in range(L)]

    @classmethod
    def from_preset(cls, name: str, seed: int = 0, device=None, **overrides):
        params = dict(DEEPSEEK_PRESETS[name])
        params.update(overrides)
        return cls(DeepseekConfig(**params), device=device, seed=seed)


def build_quantized(preset_or_cfg, quant_config, seed: int = 0, device=None,
                    **overrides) -> DeepseekForCausalLM:
    """Build a DeepSeek model on ``device`` and quantize it module by
    module, so the float model never resides in device memory at once: each
    decoder layer's attention, dense MLP or shared expert with the layer,
    then each routed expert on its own (a full-width MoE layer is 257 x 3
    projections of 7168 x 2048, 22.6 GB in bf16). The router stays float32
    (a raw parameter), the embedding and the lm_head stay in the model dtype
    unless the config quantizes the lm_head. Only calibration-free configs
    (RTN, ``KVCacheQuantConfig``) apply here."""
    from ..quantization.quantize import quantize as _quantize

    if isinstance(preset_or_cfg, DeepseekConfig):
        cfg = dataclasses.replace(preset_or_cfg, **overrides)
    else:
        cfg = DeepseekConfig(**dict(DEEPSEEK_PRESETS[preset_or_cfg],
                                    **overrides))
    device = resolve_device(device)
    model = DeepseekForCausalLM(cfg, device=device, seed=seed, n_layers=0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    for i in range(cfg.num_hidden_layers):
        layer = DeepseekDecoderLayer(cfg, i, device, gen, build_experts=False)
        holder = _LayerHolder(layer)
        _quantize(holder, quant_config)
        layer = holder.layer
        if isinstance(layer.mlp, DeepseekMoE):
            for _e in range(cfg.n_routed_experts):
                eh = _LayerHolder(DeepseekMLP(cfg, cfg.moe_intermediate_size,
                                              device, gen))
                _quantize(eh, quant_config)
                layer.mlp.experts.append(eh.layer)
        model.model.layers.append(layer)
        if getattr(holder, "kv_cache_quantized", False):
            model.kv_cache_quantized = True
            model.kv_cache_format = holder.kv_cache_format
    if _llama._quant_lm_head(quant_config):
        holder = _LayerHolder(model.lm_head)
        _quantize(holder, quant_config)
        model.lm_head = holder.layer
    return model


def from_jax_params(flat: dict, cfg: "DeepseekConfig", device=None,
                    meta: dict | None = None,
                    kv_cache_format: str | None = None) -> DeepseekForCausalLM:
    """Build the port's DeepSeek from a JAX DeepSeek's flat state (dotted
    names to numpy arrays: "model.layers.1.mlp.experts.3.gate_proj.kernel",
    "model.layers.1.mlp.gate.weight", ...), float or quantized, as
    ``models.llama.from_jax_params`` does for a Llama: ``meta`` gives each
    quantized projection's static attributes and ``kv_cache_format`` flags
    the KV format. A state with the absorbed factors (a JAX model after
    ``enable_mla_latent_cache``) puts the port's model in latent mode with
    those factors; without them, ``enable_mla_latent_cache`` recomputes
    them from the loaded kv_b_proj."""
    device = resolve_device(device)
    model = DeepseekForCausalLM(cfg, device=device)
    absorbed = any(k.endswith(".w_k_absorb") for k in flat)
    if absorbed:
        for layer in model.model.layers:
            attn = layer.self_attn
            r, H = cfg.kv_lora_rank, cfg.num_attention_heads
            attn.w_k_absorb = nn.Parameter(torch.zeros(
                (r, H, cfg.qk_nope_head_dim), device=device),
                requires_grad=False)
            attn.w_v_absorb = nn.Parameter(torch.zeros(
                (r, H, cfg.v_head_dim), device=device), requires_grad=False)
        model.use_latent_cache = True
    return load_jax_state(model, flat, cfg.hidden_size, device, meta,
                          kv_cache_format)
