"""Gemma family causal LM in PyTorch: gemma-1, gemma-2 and gemma-3 (text).

The counterpart of ``neural_compressor_tpu.models.gemma``; module and
parameter names follow the JAX model, so its flat state maps onto this
model's ``state_dict`` (``from_jax_params``). Deltas from the Llama stack:
  * RMSNorm scales by ``1 + w``, the whole norm in float32;
  * embeddings times ``sqrt(hidden_size)`` cast to the model dtype;
  * a GeGLU MLP, ``down(gelu_tanh(gate(x)) * up(x))``, rounded as XLA
    rounds it (``ops.activations.gelu_tanh``);
  * attention scaled by ``query_pre_attn_scalar ** -0.5``, with gemma-2's
    logit softcap (``cap * tanh(s / cap)`` before the mask) and a sliding
    band on the layers ``layer_types`` names "sliding_attention" (keys
    with q_pos - k_pos < ``sliding_window``);
  * gemma-2's post-norms around attention and MLP; gemma-3's q/k norms and
    a second, local-theta rope table for the sliding layers;
  * the lm_head tied to the embedding (``attend``), and gemma-2's final
    logit softcap.

Caches are Llama's: contiguous ``KVCache`` / ``QuantKVCache`` rows handed
to attention dequantized (``update_cache``), attended in plain PyTorch as
the JAX package attends them in XLA (a long prefill chunked,
``_grouped_attention_chunked``); and paged pools, where K12 writes the row
and K11 attends it with the band and the softcap (``paged_attn_gemma``;
gemma-3's global layers take plain ``paged_attn``). ``generate``,
``greedy_search`` and ``ContinuousBatchingEngine`` serve it as they serve
a Llama.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..common.device import resolve_device
from ..layers.linear import Embed, Linear
from ..ops.activations import gelu_tanh, softcap
from .llama import (_F64, PagedKVCache, _ChunkedCausal,
                    _grouped_attention_chunked, _LayerHolder,
                    _paged_write_row, _rope, _softmax_f32, apply_rope,
                    load_jax_state, update_cache)
from . import llama as _llama


@dataclasses.dataclass
class GemmaConfig:
    vocab_size: int = 256000
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    head_dim: int = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # gemma-3: the sliding layers rotate with this theta (HF
    # rope_local_base_freq); None: one table for every layer
    rope_local_theta: float | None = None
    # rope scaling of the GLOBAL layers only (gemma-3 4b+: linear x8)
    rope_scaling: dict | None = None
    # attention scale query_pre_attn_scalar ** -0.5; None: head_dim
    query_pre_attn_scalar: float | None = None
    attn_logit_softcapping: float | None = None
    final_logit_softcapping: float | None = None
    sliding_window: int | None = None
    # per layer "sliding_attention" | "full_attention"; None: all full
    layer_types: tuple | None = None
    use_post_norms: bool = True
    use_qk_norm: bool = False
    attention_bias: bool = False
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.query_pre_attn_scalar is None:
            self.query_pre_attn_scalar = float(self.head_dim)
        if self.layer_types is None:
            self.layer_types = ("full_attention",) * self.num_hidden_layers
        self.layer_types = tuple(self.layer_types)
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(
                f"layer_types has {len(self.layer_types)} entries for "
                f"{self.num_hidden_layers} layers")
        if any(t == "sliding_attention" for t in self.layer_types) and \
                not self.sliding_window:
            raise ValueError("sliding_attention layers need sliding_window")


# the JAX package's presets: three tiny test configs, one per generation's
# feature set, and two at published widths (HF config.json values)
GEMMA_PRESETS = {
    "gemma-test": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=1, head_dim=16,
                       max_position_embeddings=128, use_post_norms=False),
    "gemma2-test": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=4, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=16,
                        max_position_embeddings=128,
                        query_pre_attn_scalar=24.0,
                        attn_logit_softcapping=50.0,
                        final_logit_softcapping=30.0,
                        sliding_window=8,
                        layer_types=("sliding_attention",
                                     "full_attention") * 2),
    "gemma3-test": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=6, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=16,
                        max_position_embeddings=128,
                        rope_theta=1e6, rope_local_theta=10000.0,
                        use_qk_norm=True, sliding_window=8,
                        layer_types=("sliding_attention",) * 5
                        + ("full_attention",)),
    "gemma2-9b": dict(vocab_size=256000, hidden_size=3584,
                      intermediate_size=14336, num_hidden_layers=42,
                      num_attention_heads=16, num_key_value_heads=8,
                      head_dim=256, query_pre_attn_scalar=256.0,
                      attn_logit_softcapping=50.0,
                      final_logit_softcapping=30.0, sliding_window=4096,
                      layer_types=tuple(
                          "sliding_attention" if i % 2 == 0
                          else "full_attention" for i in range(42))),
    "gemma3-4b-text": dict(vocab_size=262208, hidden_size=2560,
                           intermediate_size=10240, num_hidden_layers=34,
                           num_attention_heads=8, num_key_value_heads=4,
                           head_dim=256, query_pre_attn_scalar=256.0,
                           rope_theta=1e6, rope_local_theta=10000.0,
                           rope_scaling=dict(type="linear", factor=8.0),
                           use_qk_norm=True, sliding_window=1024,
                           max_position_embeddings=131072,
                           layer_types=tuple(
                               "full_attention" if (i + 1) % 6 == 0
                               else "sliding_attention" for i in range(34))),
}


class GemmaRMSNorm(nn.Module):
    """HF Gemma2RMSNorm: float32 throughout, scale ``1 + w`` (w starts at
    0). The mean of squares and its rsqrt run in float64 and round once,
    as the Llama norm does, so the card and the CPU give the same bits."""

    weight_offset = 1.0

    def __init__(self, dim: int, eps: float, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                               device=device),
                                   requires_grad=False)
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        x64 = xf.to(_F64)
        var = torch.mean(x64 * x64, dim=-1, keepdim=True)
        inv = (1.0 / torch.sqrt(var + self.eps)).to(torch.float32)
        return (xf * inv * (1.0 + self.weight)).to(self.dtype)


def _gemma_grouped_attention(q, k, v, mask, scaling: float,
                             softcap_: float | None):
    """GQA attention with gemma's decoupled scale and optional logit
    softcap (before the mask), q [B, H, S, D] against k/v [B, Hkv, T, D]
    without repeating K/V. Scores f32(q . k) times f32(scaling), softmax
    normalised before the cast of p to v's dtype for PV; sums in float64,
    one rounding each (``models.llama._grouped_attention``). A
    ``_ChunkedCausal`` mask takes the chunked attention with
    ``scaling * sqrt(D)`` folded into q in q's dtype first, as JAX folds
    it (the chunked form scales by 1/sqrt(D))."""
    B, H, S, D = q.shape
    if isinstance(mask, _ChunkedCausal):
        qs = q * torch.tensor(scaling * float(D) ** 0.5, dtype=q.dtype,
                              device=q.device)
        return _grouped_attention_chunked(qs, k, v, mask.q_pos, D,
                                          softcap=softcap_,
                                          window=mask.window)
    Hkv = k.shape[1]
    rep = H // Hkv
    qg = q.reshape(B, Hkv, rep, S, D).to(_F64)
    s = torch.einsum("bgrsd,bgtd->bgrst", qg, k.to(_F64)).to(torch.float32)
    s = s * torch.tensor(scaling, dtype=torch.float32)
    if softcap_ is not None:
        s = softcap(s, softcap_)
    s = torch.where(mask[:, :, None], s, torch.tensor(-1e30,
                                                      device=s.device))
    p = _softmax_f32(s)
    out = torch.einsum("bgrst,bgtd->bgrsd", p.to(v.dtype).to(_F64),
                       v.to(_F64))
    return out.to(torch.float32).reshape(B, H, S, D).to(q.dtype)


class GemmaAttention(nn.Module):
    def __init__(self, cfg: GemmaConfig, layer_idx: int, device=None,
                 generator=None):
        super().__init__()
        H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        self.cfg = cfg
        self.is_sliding = cfg.layer_types[layer_idx] == "sliding_attention"

        def lin(i, o):
            return Linear(i, o, bias=cfg.attention_bias, dtype=cfg.dtype,
                          device=device, generator=generator)

        self.q_proj = lin(cfg.hidden_size, H * D)
        self.k_proj = lin(cfg.hidden_size, Hkv * D)
        self.v_proj = lin(cfg.hidden_size, Hkv * D)
        self.o_proj = lin(H * D, cfg.hidden_size)
        if cfg.use_qk_norm:
            self.q_norm = GemmaRMSNorm(D, cfg.rms_norm_eps, cfg.dtype, device)
            self.k_norm = GemmaRMSNorm(D, cfg.rms_norm_eps, cfg.dtype, device)
        else:
            self.q_norm = self.k_norm = None

    def forward(self, x, cos, sin, mask, cache=None, cache_pos=None):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        q = self.q_proj(x).reshape(B, S, H, D)
        k = self.k_proj(x).reshape(B, S, Hkv, D)
        v = self.v_proj(x).reshape(B, S, Hkv, D)
        if self.q_norm is not None:  # gemma-3 QK-norm, before rope
            q = self.q_norm(q)
            k = self.k_norm(k)
        q = apply_rope(q, cos, sin, "half")
        k = apply_rope(k, cos, sin, "half")
        # head-major [B, H, S, D], the cache layout
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        scaling = cfg.query_pre_attn_scalar ** -0.5
        if isinstance(cache, PagedKVCache):
            # paged decode (engine serving): K12 writes the row, K11 attends
            # with the band and the softcap; the decoupled scaling pre-folds
            # into q in q's dtype (the kernel scales by 1/sqrt(D))
            from ..kernels.paged_attention import paged_decode_attention

            if S != 1:
                raise ValueError("a paged gemma cache is decode-only (the "
                                 "engine prefills through staging rows)")
            pos_b = (cache_pos if isinstance(cache_pos, torch.Tensor)
                     else torch.tensor(cache_pos, device=q.device))
            pos_b = pos_b.reshape(-1).to(device=q.device,
                                         dtype=torch.int32).expand(B)
            new_cache = _paged_write_row(cache, k, v, pos_b)
            qs = q * torch.tensor(scaling * float(D) ** 0.5, dtype=q.dtype,
                                  device=q.device)
            out = paged_decode_attention(
                qs, new_cache, pos_b + 1,
                window=cfg.sliding_window if self.is_sliding else None,
                softcap=cfg.attn_logit_softcapping)
            out = out.to(x.dtype).transpose(1, 2)
            return self.o_proj(out.reshape(B, S, H * D)), new_cache
        new_cache = None
        if cache is not None:
            k, v, new_cache = update_cache(cache, k, v, cache_pos, x.dtype)
        out = _gemma_grouped_attention(q, k, v, mask, scaling,
                                       cfg.attn_logit_softcapping)
        out = out.transpose(1, 2).reshape(B, S, H * D)
        return self.o_proj(out), new_cache


class GemmaMLP(nn.Module):
    """GeGLU: ``down(gelu_tanh(gate(x)) * up(x))``."""

    def __init__(self, cfg: GemmaConfig, device=None, generator=None):
        super().__init__()

        def lin(i, o):
            return Linear(i, o, dtype=cfg.dtype, device=device,
                          generator=generator)

        self.gate_proj = lin(cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = lin(cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = lin(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.down_proj(gelu_tanh(self.gate_proj(x)) * self.up_proj(x))


class GemmaDecoderLayer(nn.Module):
    """gemma-2/3 norm sandwich: ``x + post_attn_norm(attn(input_norm(x)))``
    then ``x + post_ffw_norm(mlp(pre_ffw_norm(x)))``; gemma-1
    (``use_post_norms=False``) is the Llama two-norm form."""

    def __init__(self, cfg: GemmaConfig, layer_idx: int, device=None,
                 generator=None):
        super().__init__()

        def norm():
            return GemmaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                                device)

        self.cfg = cfg
        self.input_layernorm = norm()
        self.self_attn = GemmaAttention(cfg, layer_idx, device, generator)
        self.post_attention_layernorm = norm()
        if cfg.use_post_norms:
            self.pre_feedforward_layernorm = norm()
            self.post_feedforward_layernorm = norm()
        else:
            self.pre_feedforward_layernorm = None
            self.post_feedforward_layernorm = None
        self.mlp = GemmaMLP(cfg, device, generator)

    def forward(self, x, cos, sin, mask, cache=None, cache_pos=None):
        h, new_cache = self.self_attn(self.input_layernorm(x), cos, sin,
                                      mask, cache, cache_pos)
        if self.cfg.use_post_norms:
            x = x + self.post_attention_layernorm(h)
            x = x + self.post_feedforward_layernorm(
                self.mlp(self.pre_feedforward_layernorm(x)))
        else:  # gemma-1: post_attention_layernorm is the pre-MLP norm
            x = x + h
            x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_cache


class GemmaModel(nn.Module):
    def __init__(self, cfg: GemmaConfig, device=None, generator=None,
                 n_layers: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size,
                                  dtype=cfg.dtype, device=device,
                                  generator=generator)
        n = cfg.num_hidden_layers if n_layers is None else n_layers
        self.layers = nn.ModuleList([GemmaDecoderLayer(cfg, i, device,
                                                       generator)
                                     for i in range(n)])
        self.norm = GemmaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                 cfg.dtype, device)

    def forward(self, input_ids, positions=None, caches=None, cache_pos=None):
        cfg = self.cfg
        B, S = input_ids.shape
        dev = input_ids.device
        if positions is None:
            positions = torch.arange(S, device=dev)[None, :].expand(B, S)
        # HF scales the embedding by sqrt(hidden) cast to the model dtype
        x = self.embed_tokens(input_ids) * torch.tensor(
            cfg.hidden_size ** 0.5, dtype=cfg.dtype, device=dev)
        cos_g, sin_g = _rope(positions, cfg.head_dim, cfg.rope_theta, 1.0,
                             cfg.rope_scaling)
        if cfg.rope_local_theta is not None:
            cos_l, sin_l = _rope(positions, cfg.head_dim,
                                 cfg.rope_local_theta)
        else:
            cos_l, sin_l = cos_g, sin_g
        # masks [B, 1, S, T]: causal, and the sliding band q - k < window
        T = S if caches is None else caches[0][0].shape[2]
        if S * T > _llama._DENSE_MASK_ELEMS and S > 1:  # long prefill
            mask_full = _ChunkedCausal(positions)
            mask_sliding = (_ChunkedCausal(positions, cfg.sliding_window)
                            if cfg.sliding_window else mask_full)
        else:
            key_pos = torch.arange(T, device=dev)[None, None, None, :]
            q_pos = positions[:, None, :, None]
            mask_full = key_pos <= q_pos
            mask_sliding = mask_full
            if cfg.sliding_window:
                mask_sliding = mask_full & (q_pos - key_pos
                                            < cfg.sliding_window)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            sliding = cfg.layer_types[i] == "sliding_attention"
            x, nc = layer(x, cos_l if sliding else cos_g,
                          sin_l if sliding else sin_g,
                          mask_sliding if sliding else mask_full,
                          cache, cache_pos)
            if new_caches is not None:
                new_caches.append(nc)
        return self.norm(x), new_caches


class GemmaForCausalLM(nn.Module):
    def __init__(self, cfg: GemmaConfig, device=None, seed: int = 0,
                 n_layers: int | None = None):
        """Random weights made from ``seed`` on ``device`` (None: the CUDA
        card); ``n_layers`` builds fewer decoder layers (``build_quantized``
        adds them one by one). The lm_head is the embedding (tied)."""
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.model = GemmaModel(cfg, device, gen, n_layers=n_layers)
        self.lm_head = None

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.embedding.device

    def forward(self, input_ids, positions=None, caches=None, cache_pos=None):
        x, new_caches = self.model(input_ids, positions, caches, cache_pos)
        # nnx.Embed.attend: x @ embedding.T in the model dtype (float32
        # accumulation); JAX leaves it to XLA, the port to torch.matmul
        logits = torch.matmul(x, self.model.embed_tokens.embedding.t())
        cap = self.cfg.final_logit_softcapping
        if cap is not None:
            logits = softcap(logits, cap)
        if caches is None:
            return logits
        return logits, new_caches

    @classmethod
    def from_preset(cls, name: str, seed: int = 0, device=None,
                    **overrides):
        params = dict(GEMMA_PRESETS[name])
        params.update(overrides)
        return cls(GemmaConfig(**params), device=device, seed=seed)


def build_quantized(preset_or_cfg, quant_config, seed: int = 0,
                    device=None, **overrides) -> GemmaForCausalLM:
    """Build a gemma on ``device`` and quantize it layer by layer, so the
    full float model never resides in device memory at once. The tied
    embedding stays in the model dtype (a config's ``quant_lm_head`` finds
    no lm_head, as in the JAX package). Only calibration-free configs
    (RTN, ``KVCacheQuantConfig``) apply here."""
    from ..quantization.quantize import quantize as _quantize

    if isinstance(preset_or_cfg, GemmaConfig):
        cfg = preset_or_cfg
    else:
        params = dict(GEMMA_PRESETS[preset_or_cfg])
        params.update(overrides)
        cfg = GemmaConfig(**params)
    device = resolve_device(device)
    model = GemmaForCausalLM(cfg, device=device, seed=seed, n_layers=0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    for i in range(cfg.num_hidden_layers):
        holder = _LayerHolder(GemmaDecoderLayer(cfg, i, device, gen))
        _quantize(holder, quant_config)
        model.model.layers.append(holder.layer)
        if getattr(holder, "kv_cache_quantized", False):
            model.kv_cache_quantized = True
            model.kv_cache_format = holder.kv_cache_format
    return model


def from_jax_params(flat: dict, cfg: GemmaConfig, device=None,
                    meta: dict | None = None,
                    kv_cache_format: str | None = None) -> GemmaForCausalLM:
    """Build the port's gemma from a JAX gemma's flat state (dotted names
    to numpy arrays, "model.layers.0.self_attn.q_proj.kernel", ...), float
    or quantized, as ``models.llama.from_jax_params`` does for a Llama:
    ``meta`` gives each quantized projection's static attributes and
    ``kv_cache_format`` flags the KV format."""
    device = resolve_device(device)
    model = GemmaForCausalLM(cfg, device=device)
    return load_jax_state(model, flat, cfg.hidden_size, device, meta,
                          kv_cache_format)
