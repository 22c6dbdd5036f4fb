"""KV-cache quantizers: the codes a quantized KV cache or page pool holds.

The counterparts of ``neural_compressor_tpu.models.llama``'s ``_kv_quant``,
``_kv_quant4_asym``, ``_kv_dequant4_asym``, ``_kv_quant4_asym_codes``,
``_kv_pack_page_int4``, ``_kv_unpack_int4``, ``_kv_codes_int8`` and
``_kv_dequant``, with the same layouts:

* int8 / fp8-e4m3: codes at element width, one float32 scale per
  (token, head): ``x ~= scale * code``;
* int4 (symmetric, ``_kv_quant``): offset-binary nibbles packed HALF-SPLIT
  along D (d < D/2 in the low nibble, d >= D/2 in the high);
* int4 asymmetric per (token, head, D-half) (``_kv_quant4_asym``, the
  contiguous ``QuantKVCache``): the same D-half-split bytes with
  ``x ~= scale * (nibble - 8) + off``, scale and off [..., 2];
* int4 asymmetric per (token, head) (``_kv_quant4_asym_codes``, paged
  pools): unpacked 0..15 codes, packed TOKEN-half-split into pages by
  ``_kv_pack_page_int4`` (token r in the low nibble of byte row r, token
  r + page/2 in the high).

Codes and scales are bit-equal to the JAX functions under ``jax.jit``, as
the JAX package's generation and serving programs run them: XLA compiles a
division by a constant (``amax / 127``, ``/ 448``, ``/ 7``, ``/ 15``) as a
multiplication by its float32 reciprocal, while a division by a tensor
(``x / scale``) stays a true division; rounding is half to even; the fp8
cast rounds to nearest even after the clip.
"""

from __future__ import annotations

import torch

KV_CODE_DTYPES = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn,
                  "int4": torch.uint8}

_F32 = torch.float32


def _recip(c: float) -> torch.Tensor:
    """``f32(1 / c)``, the constant XLA multiplies by for ``x / c``."""
    return torch.tensor(1.0 / c, dtype=_F32)


def kv_format(codes: torch.Tensor) -> str:
    """The cache format its codes' dtype carries."""
    if codes.dtype == torch.int8:
        return "int8"
    if codes.dtype == torch.uint8:
        return "int4"
    if codes.dtype == torch.float8_e4m3fn:
        return "fp8_e4m3"
    raise ValueError(f"{codes.dtype} is not a KV-cache code dtype")


def kv_quant(x: torch.Tensor, fmt: str = "int8"):
    """[..., D] -> codes + per-(token, head) float32 scale [...]
    (``_kv_quant``)."""
    xf = x.to(_F32)
    amax = xf.abs().amax(dim=-1)
    one = torch.ones((), dtype=_F32, device=x.device)
    div = {"int8": 127.0, "fp8_e4m3": 448.0, "int4": 7.0}.get(fmt)
    if div is None:
        raise ValueError(f"KV format {fmt!r}: expected one of "
                         f"{tuple(KV_CODE_DTYPES)}")
    scale = torch.where(amax <= 0, one, amax * _recip(div).to(x.device))
    y = xf / scale[..., None]
    if fmt == "fp8_e4m3":
        return y.clamp(-448.0, 448.0).to(torch.float8_e4m3fn), scale
    if fmt == "int4":
        c = (torch.round(y).clamp(-8, 7) + 8.0).to(torch.uint8)
        h = c.shape[-1] // 2
        return c[..., :h] | (c[..., h:] << 4), scale
    return torch.round(y).clamp(-128, 127).to(torch.int8), scale


def _asym(g: torch.Tensor):
    """Affine 0..15 codes of ``g`` along its last axis, with scale and
    ``off = mn + 8 * scale`` (``x ~= scale * (code - 8) + off``)."""
    mn = g.amin(dim=-1)
    mx = g.amax(dim=-1)
    one = torch.ones((), dtype=_F32, device=g.device)
    scale = torch.where(mx - mn <= 0, one,
                        (mx - mn) * _recip(15.0).to(g.device))
    c = torch.round((g - mn[..., None]) / scale[..., None]).clamp(0, 15)
    return c.to(torch.uint8), scale, mn + 8.0 * scale


def kv_quant4_asym(x: torch.Tensor):
    """[..., D] -> D-half-split bytes [..., D/2] + affine scale/off
    [..., 2] per (token, head, D-half) (``_kv_quant4_asym``)."""
    xf = x.to(_F32)
    D = xf.shape[-1]
    c, scale, off = _asym(xf.reshape(*xf.shape[:-1], 2, D // 2))
    return c[..., 0, :] | (c[..., 1, :] << 4), scale, off


def kv_dequant4_asym(codes: torch.Tensor, scale: torch.Tensor,
                     off: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of ``kv_quant4_asym``: [..., D/2] -> [..., D]
    (``_kv_dequant4_asym``). ``code * scale + off`` is one rounding to
    float32, as XLA fuses it into a multiply-add: the product of a 4-bit
    code and a float32 scale is exact in float64."""
    f64 = torch.float64
    c = kv_unpack_int4(codes).to(f64)
    s, o = scale.to(f64), off.to(f64)
    h = c.shape[-1] // 2
    lo = c[..., :h] * s[..., 0:1] + o[..., 0:1]
    hi = c[..., h:] * s[..., 1:2] + o[..., 1:2]
    return torch.cat([lo, hi], dim=-1).to(_F32).to(dtype)


def kv_quant4_asym_codes(x: torch.Tensor):
    """[..., D] -> UNPACKED 0..15 codes (uint8) [..., D] + affine scale/off
    [...] per (token, head), the paged-pool quantizer
    (``_kv_quant4_asym_codes``)."""
    return _asym(x.to(_F32))


def kv_pack_page_int4(c4: torch.Tensor) -> torch.Tensor:
    """Codes [..., page, D] -> token-half-split bytes [..., page/2, D]
    (``_kv_pack_page_int4``)."""
    half = c4.shape[-2] // 2
    return c4[..., :half, :] | (c4[..., half:, :] << 4)


def kv_unpack_int4(codes: torch.Tensor) -> torch.Tensor:
    """D-half-split bytes [..., D/2] -> centered int8 codes [..., D]
    (``_kv_unpack_int4``)."""
    lo = (codes & 15).to(torch.int8) - 8
    hi = (codes >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-1)


def kv_codes_int8(codes: torch.Tensor) -> torch.Tensor:
    """Cache codes -> dot-ready form: int4 unpacks, int8/fp8 pass
    through (``_kv_codes_int8``)."""
    return kv_unpack_int4(codes) if codes.dtype == torch.uint8 else codes


def kv_dequant(codes: torch.Tensor, scale: torch.Tensor,
               dtype) -> torch.Tensor:
    """``codes * scale`` per (token, head), in ``dtype`` (``_kv_dequant``)."""
    return (kv_codes_int8(codes).to(_F32) * scale[..., None]).to(dtype)
