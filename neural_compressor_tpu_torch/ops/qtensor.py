"""Group-wise quantization math — the numeric core of the port.

Plain tensor functions over weights of shape ``[K, N]`` (``in_features x
out_features``: ``y = x @ w``), the layout of ``neural_compressor_tpu``.
Quantization groups run along the reduction axis K: with group size G the
scales have shape ``[K/G, N]``.

Every rounding is ``torch.round``, which rounds half to even as
``jnp.round`` does, and a division by a constant is a multiplication by its
float32 reciprocal, as XLA compiles ``x / c``; so integer codes and scales
are bit-equal to the JAX package's on the same inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# NF4: normalized quantiles of N(0, 1) (QLoRA); FP4: the e2m1 value grid,
# 15 entries divided by 12 in float32
NF4_CODEBOOK = torch.tensor(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0], dtype=torch.float32)
FP4_CODEBOOK = torch.tensor(
    [-12.0, -8.0, -6.0, -4.0, -3.0, -2.0, -1.0, 0.0,
     1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0], dtype=torch.float32) / 12.0
CODEBOOKS = {"nf4": NF4_CODEBOOK, "fp4": FP4_CODEBOOK,
             "fp4_e2m1": FP4_CODEBOOK}

INT_DTYPES = ("int", "int8", "int4", "int2")
FLOAT_CODE_DTYPES = tuple(CODEBOOKS)
FP8_DTYPES = ("fp8_e4m3", "fp8_e5m2")


class QTensor(NamedTuple):
    """A group-quantized tensor (pre-packing).

    ``codes``: int8 [Kp, N] codes (Kp = K padded to a multiple of G):
        signed integers, centered asymmetric integers or codebook indices.
    ``scales``: float32 [K/G, N] per-(group, out-channel) scales.
    ``zeros``: optional centered zero points (asymmetric), else None.
    ``dtype``: logical quant dtype ("int", "nf4", "fp4").
    ``bits``: bit width. ``group_size``: group length along K.
    ``orig_shape``: original [K, N] before padding.
    """

    codes: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor | None
    dtype: str
    bits: int
    group_size: int
    orig_shape: tuple[int, int]


def _resolve_group(K: int, group_size: int) -> int:
    if group_size in (-1, 0) or group_size >= K:
        return K
    return group_size


def _grouped(w: torch.Tensor, G: int) -> torch.Tensor:
    """[K, N] -> [K/G, G, N] (pads K to a multiple of G with zeros)."""
    K, N = w.shape
    rem = K % G
    if rem:
        w = torch.nn.functional.pad(w, (0, 0, 0, G - rem))
    return w.reshape(-1, G, N)


def quantize_int_sym(w: torch.Tensor, bits: int = 4, group_size: int = 32,
                     full_range: bool = False) -> QTensor:
    """Symmetric signed-integer group quantization.

    ``full_range=False``: codes in [-(2^(b-1)-1), 2^(b-1)-1].
    ``full_range=True``: use the extra negative code -2^(b-1) when the
    group's largest magnitude is on the negative side.
    """
    if bits < 2:
        raise ValueError("bits must be >= 2 (1-bit sym has qmax=0)")
    K, N = w.shape
    G = _resolve_group(K, group_size)
    wg = _grouped(w.to(torch.float32), G)
    qmax = 2 ** (bits - 1) - 1
    qmin = -(2 ** (bits - 1))
    amax = wg.amax(dim=1)
    amin = wg.amin(dim=1)
    if full_range:
        scale = torch.maximum(amax * (1.0 / qmax), amin * (1.0 / qmin))
        lo = qmin
    else:
        scale = torch.maximum(amax.abs(), amin.abs()) * (1.0 / qmax)
        lo = -qmax
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), lo, qmax)
    codes = q.to(torch.int8).reshape(-1, N)
    return QTensor(codes, scale, None, "int", bits, G, (K, N))


def quantize_int_asym(w: torch.Tensor, bits: int = 4,
                      group_size: int = 32) -> QTensor:
    """Asymmetric group quantization with zero points.

    Codes and zero points are stored centered (shifted by -2^(b-1)) so
    codes fit signed int8 and pack as two's complement; ``(q - z) * s`` is
    unchanged by the common shift. ``(amax - amin) / qmax`` is a
    multiplication by the float32 reciprocal, as XLA compiles it under
    ``jit``; the other divisions are by tensors and stay divisions."""
    if bits < 2:
        raise ValueError("bits must be >= 2")
    K, N = w.shape
    G = _resolve_group(K, group_size)
    wg = _grouped(w.to(torch.float32), G)
    qmax = 2 ** bits - 1
    half = 2 ** (bits - 1)
    amax = wg.amax(dim=1)
    amin = wg.amin(dim=1)
    scale = (amax - amin) * (1.0 / qmax)
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    zero = torch.round(-amin / scale)
    q = torch.clamp(torch.round(wg / scale[:, None, :]) + zero[:, None, :],
                    0, qmax)
    codes = (q - half).to(torch.int8).reshape(-1, N)
    return QTensor(codes, scale, zero - half, "int", bits, G, (K, N))


def _codebook_nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Indices of the nearest codebook entries (codebook sorted ascending):
    ``searchsorted(mids, x, side="right")`` over the float32 midpoints."""
    mids = (codebook[1:] + codebook[:-1]) / 2.0
    return torch.searchsorted(mids, x.contiguous(), right=True).to(torch.int8)


def quantize_codebook(w: torch.Tensor, dtype: str = "nf4",
                      group_size: int = 32) -> QTensor:
    """NF4/FP4 group quantization: normalize by the group's absmax, snap to
    the codebook. Codes are unsigned codebook indices."""
    K, N = w.shape
    G = _resolve_group(K, group_size)
    codebook = CODEBOOKS[dtype].to(w.device)
    wg = _grouped(w.to(torch.float32), G)
    scale = wg.abs().amax(dim=1)
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    codes = _codebook_nearest(wg / scale[:, None, :], codebook).reshape(-1, N)
    return QTensor(codes, scale, None, dtype, 4, G, (K, N))


def quantize_tensor(w: torch.Tensor, bits: int = 4, group_size: int = 32,
                    scheme: str = "sym", dtype: str = "int",
                    full_range: bool = False) -> QTensor:
    """Dispatch on dtype/scheme. ``dtype`` in {"int", "int4", ..., "nf4",
    "fp4"}."""
    if dtype in FLOAT_CODE_DTYPES:
        return quantize_codebook(w, dtype=dtype, group_size=group_size)
    if dtype in FP8_DTYPES:
        raise ValueError(
            f"{dtype!r} weights go through the FP8 flow, not quantize_tensor")
    if dtype != "int":
        if not (dtype.startswith("int") and dtype[3:].isdigit()):
            raise ValueError(
                f"unknown quant dtype {dtype!r}; expected one of "
                f"{INT_DTYPES + FLOAT_CODE_DTYPES}")
        bits = int(dtype[3:])
    if scheme == "sym":
        return quantize_int_sym(w, bits=bits, group_size=group_size,
                                full_range=full_range)
    return quantize_int_asym(w, bits=bits, group_size=group_size)


def dequantize(qt: QTensor, out_dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the (fake-quantized) weight [K, N] from a QTensor."""
    K, N = qt.orig_shape
    G = qt.group_size
    codes = qt.codes.reshape(-1, G, N)
    if qt.dtype in FLOAT_CODE_DTYPES:
        vals = CODEBOOKS[qt.dtype].to(codes.device)[codes.to(torch.int64)]
    else:
        vals = codes.to(torch.float32)
        if qt.zeros is not None:
            vals = vals - qt.zeros[:, None, :]
    w = vals * qt.scales[:, None, :]
    return w.reshape(-1, N)[:K].to(out_dtype)


def qdq_tensor(w: torch.Tensor, bits: int = 4, group_size: int = 32,
               scheme: str = "sym", dtype: str = "int",
               full_range: bool = False, out_dtype=None) -> torch.Tensor:
    """Fake-quantize: quantize then dequantize, keeping w's dtype unless
    ``out_dtype`` is given."""
    qt = quantize_tensor(w, bits=bits, group_size=group_size, scheme=scheme,
                         dtype=dtype, full_range=full_range)
    return dequantize(qt, out_dtype=out_dtype or w.dtype)


def quantize_with_scale(w: torch.Tensor, scales: torch.Tensor,
                        zeros: torch.Tensor | None, bits: int,
                        group_size: int, scheme: str = "sym") -> torch.Tensor:
    """Quantize ``w`` [K, N] with given group scales (and centered zero
    points) [K/G, N], as GPTQ and AWQ do after their sweep; int8 codes
    [K, N]. The divisions are by tensors: true divisions in both
    packages."""
    K, N = w.shape
    G = _resolve_group(K, group_size)
    wg = _grouped(w.to(torch.float32), G)
    if scheme == "sym":
        qmax = 2 ** (bits - 1) - 1
        q = torch.clamp(torch.round(wg / scales[:, None, :]), -qmax - 1, qmax)
    else:
        qmax = 2 ** bits - 1
        half = 2 ** (bits - 1)
        z = zeros if zeros is not None else torch.zeros_like(scales)
        q = torch.clamp(torch.round(wg / scales[:, None, :])
                        + (z[:, None, :] + half), 0, qmax) - half
    return q.to(torch.int8).reshape(-1, N)[:K]


def search_clip(w: torch.Tensor, bits: int = 4, group_size: int = 32,
                scheme: str = "sym", dtype: str = "int", n_grid: int = 20,
                max_shrink: float = 0.8) -> torch.Tensor:
    """Per-(group, channel) clip ratio in (max_shrink, 1] that minimizes the
    QDQ squared error: every ratio r of the grid clips the group to
    ±r·absmax, fake-quantizes it and keeps the first ratio of least error.
    Returns float32 [K/G, N]."""
    K, N = w.shape
    G = _resolve_group(K, group_size)
    wg = _grouped(w.to(torch.float32), G)                  # [ng, G, N]
    absmax = wg.abs().amax(dim=1, keepdim=True)
    step = torch.tensor((1.0 - max_shrink) / n_grid, dtype=torch.float32)
    ratios = 1.0 - torch.arange(n_grid, dtype=torch.float32) * step
    ratios = ratios.to(w.device)
    errs = []
    for r in ratios:
        clipped = torch.clamp(wg, -absmax * r, absmax * r)
        out = qdq_tensor(clipped.reshape(-1, N), bits=bits, group_size=G,
                         scheme=scheme, dtype=dtype)
        errs.append(((out.reshape(wg.shape) - wg) ** 2).sum(dim=1))
    best = torch.argmin(torch.stack(errs), dim=0)          # first minimum
    return ratios[best]


def quantize_act_per_token(x: torch.Tensor, bits: int = 8):
    """Per-token (row-wise) symmetric dynamic activation quantization.
    Returns (int8 codes, float32 scales [..., 1])."""
    qmax = 2 ** (bits - 1) - 1
    x = x.to(torch.float32)
    scale = x.abs().amax(dim=-1, keepdim=True) * (1.0 / qmax)
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale
