"""Post-quantization transforms for serving.

The counterpart of ``neural_compressor_tpu.quantization.fuse``:
  * ``fuse_for_serving``: group-wise quantization is exact under
    output-dim concatenation (scales are per (group, out-channel)), so
    q/k/v and gate/up fuse into one packed weight each, bit for bit;
  * ``to_w4a8_serving``: every eligible ``WOQLinear`` becomes a
    ``W4A8Linear``, on the "hopper_nk" layout by default, "s4_rowpack"
    with ``s4="s4"``, or on its "tpu_strided" words with ``s4=False``;
    "tpu_strided" ``W4A8Linear``s (hybrid GPTQ's) are upgraded in place;
  * ``enable_fused_decode``: flags decoder layers and the lm_head for the
    fused B=1 decode (RMSNorm, silu and residuals folded into the GEMVs).
"""

from __future__ import annotations

import torch

from ..common import logger
from ..layers.module_utils import named_modules, replace_module
from ..layers.woq_linear import W4A8Linear, WOQLinear
from ..ops.packing import (HOPPER_LAYOUT, PackedWeight, hopper_eligible,
                           s4_eligible, to_hopper, to_s4_rowpack)


def _fusible(mods) -> bool:
    """Same module type and quantization; no input scale, row permutation
    or double-quantized scales (their per-module meta would differ)."""
    ref = mods[0]
    if type(ref) not in (WOQLinear, W4A8Linear):
        return False
    if not all(type(m) is type(ref) for m in mods):
        return False
    for m in mods:
        if (m.bits != ref.bits or m.group_size != ref.group_size
                or m.wdtype != ref.wdtype or m.layout != ref.layout
                or m.in_features != ref.in_features
                or (m.zeros is None) != (ref.zeros is None)
                or (m.bias is None) != (ref.bias is None)
                or m.pre_scale is not None
                or m.perm is not None
                or m.sq_scales is not None):
            return False
    return True


def _concat_woq(mods):
    ref = mods[0]
    # hopper_nk is [N, K/2]: its output dim is the first
    axis = 0 if ref.layout == HOPPER_LAYOUT else 1
    pw = PackedWeight(
        packed=torch.cat([m.packed for m in mods], dim=axis),
        scales=torch.cat([m.scales for m in mods], dim=1),
        zeros=(torch.cat([m.zeros for m in mods], dim=1)
               if ref.zeros is not None else None),
        bits=ref.bits, group_size=ref.group_size, dtype=ref.wdtype,
        orig_shape=(ref.in_features, sum(m.out_features for m in mods)),
        layout=ref.layout)
    bias = (torch.cat([m.bias for m in mods])
            if ref.bias is not None else None)
    return type(ref)(pw, bias=bias, impl=ref.impl)


def fuse_for_serving(model) -> int:
    """Fuse q/k/v and gate/up quantized Linears in place. Returns #fusions."""
    n = 0
    for _path, mod in list(named_modules(model)):
        t = type(mod).__name__
        if t == "LlamaAttention" and mod.qkv_proj is None:
            mods = [mod.q_proj, mod.k_proj, mod.v_proj]
            if _fusible(mods):
                mod.qkv_proj = _concat_woq(mods)
                mod.q_proj = mod.k_proj = mod.v_proj = None
                n += 1
        elif t == "LlamaMLP" and mod.gate_up_proj is None:
            mods = [mod.gate_proj, mod.up_proj]
            if _fusible(mods):
                mod.gate_up_proj = _concat_woq(mods)
                mod.gate_proj = mod.up_proj = None
                n += 1
    logger.info("Fused %d projection groups for serving", n)
    return n


def to_w4a8_serving(model, s4: bool | str = "auto") -> int:
    """Swap every symmetric-int4 ``WOQLinear`` (fused included) for a
    ``W4A8Linear``, in place. Same int4 codes; activations are quantized to
    int8 per token at run time, so no calibration is needed. Other weights
    (asymmetric, other widths) keep their ``WOQLinear`` and its K8/K9
    kernels.

    ``s4`` selects the serving layout of eligible weights, under JAX's
    values (``quantization/fuse.py:96-138`` there):
      * "auto" (or "u4k", the JAX name): "hopper_nk", the port's
        counterpart of JAX's "u4_kpack" (K1, the fused decode's K4), while
        ``W4A8Linear.M_INT8_THRESHOLD`` is 1; where ``hopper_eligible``
        refuses (a row permutation, double-quantized scales) or the
        threshold is raised, the words stay "tpu_strided";
      * "s4" (or True): "s4_rowpack" where N % 256 == 0 (K2 at every M);
      * False: keep "tpu_strided" (K1 on those words, K10 at M == 1 under a
        raised ``M_INT8_THRESHOLD``).
    A ``W4A8Linear`` already on "tpu_strided" words (hybrid GPTQ's) is
    upgraded in place to the selected layout. Returns the number of modules
    converted."""
    if s4 is True:
        s4 = "s4"
    elif s4 == "u4k":
        s4 = "auto"
    if s4 not in ("auto", "s4", False):
        raise ValueError(f"s4 must be 'auto', 'u4k', 's4', True or False, "
                         f"got {s4!r}")

    def _layout(pw: PackedWeight) -> tuple[PackedWeight, int]:
        if (s4 == "auto" and hopper_eligible(pw)
                and W4A8Linear.M_INT8_THRESHOLD <= 1):
            return to_hopper(pw), 1
        if s4 == "s4" and s4_eligible(pw) and pw.orig_shape[1] % 256 == 0:
            return to_s4_rowpack(pw), 1
        return pw, 0

    n = n_up = n_skip = 0
    for path, mod in list(named_modules(model)):
        if type(mod) is WOQLinear:
            pw = mod.packed_weight()
            if not (pw.layout == "tpu_strided" and pw.bits == 4
                    and pw.dtype == "int" and pw.zeros is None):
                n_skip += 1
                continue
            pw, up = _layout(pw)
            n_up += up
            replace_module(model, path, W4A8Linear(
                pw, bias=mod.bias, impl=mod.impl, pre_scale=mod.pre_scale))
            n += 1
        elif type(mod) is W4A8Linear and mod.layout == "tpu_strided":
            # hybrid GPTQ's modules: upgrade the storage layout in place
            pw, up = _layout(mod.packed_weight())
            if up:
                mod.packed = pw.packed
                mod.layout = pw.layout
                n_up += 1
                n += 1
    if n_skip:
        logger.info("to_w4a8_serving: left %d non-sym-int4 module(s) as "
                    "WOQLinear", n_skip)
    logger.info("Converted %d modules to W4A8 serving (%d to %s)", n, n_up,
                "s4_rowpack" if s4 == "s4" else
                HOPPER_LAYOUT if s4 == "auto" else "no other layout")
    return n


def s4_prepare(model) -> int:
    """JAX's ``s4_prepare`` (``quantization/fuse.py:236`` there) takes the
    int4 view of every "s4_rowpack" weight once per jitted program, so that
    XLA does not re-materialize it inside the decode loop. PyTorch runs
    eagerly and K2 reads the 32-bit words where they lie, so there is
    nothing to prepare: it returns 0, and the port's paths do not call it.
    Kept under JAX's name for JAX's callers."""
    return 0


def enable_fused_decode(model, fold_norms: bool = True) -> int:
    """Flag llama decoder layers (and the lm_head) for the fused B=1 decode
    path (``LlamaDecoderLayer._fused_call``). Needs the fused qkv/gate_up
    projections on "hopper_nk" ``W4A8Linear`` modules: run after
    ``fuse_for_serving`` and ``to_w4a8_serving``. ``fold_norms`` (JAX's
    argument): the GEMVs fold the layer's RMSNorms into their activation
    quantization; False applies each norm first (and K17, which folds it,
    is not taken). Returns #layers flagged."""

    def _ok(m):
        return (type(m) is W4A8Linear and m.layout == HOPPER_LAYOUT
                and m.group_size % 128 == 0)

    inner = getattr(model, "model", None)
    layers = getattr(inner, "layers", None)
    if layers is None:
        return 0
    n = n_layers = 0
    for layer in layers:
        if type(layer).__name__ != "LlamaDecoderLayer":
            continue
        n_layers += 1
        attn, mlp = layer.self_attn, layer.mlp
        if (attn.qkv_proj is not None and mlp.gate_up_proj is not None
                and _ok(attn.qkv_proj) and _ok(attn.o_proj)
                and _ok(mlp.gate_up_proj) and _ok(mlp.down_proj)
                and type(layer.input_layernorm).__name__ == "RMSNorm"
                and type(layer.post_attention_layernorm).__name__
                == "RMSNorm"):
            layer.fused_decode = True
            layer.fused_fold_norms = fold_norms
            n += 1
    head = getattr(model, "lm_head", None)
    if (n and head is not None and _ok(head)
            and type(inner.norm).__name__ == "RMSNorm"):
        # fold the final norm into the quantized lm_head kernel; the
        # CausalLM forward applies the norm itself whenever it cannot fuse
        inner.norm_in_head = True
    logger.info("Fused decode enabled on %d/%d layer(s)%s", n, n_layers,
                " + lm_head" if getattr(inner, "norm_in_head", False) else "")
    return n
