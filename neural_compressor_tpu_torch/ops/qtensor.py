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

INT_DTYPES = ("int", "int8", "int4", "int2")
FLOAT_CODE_DTYPES = ("nf4", "fp4", "fp4_e2m1")
FP8_DTYPES = ("fp8_e4m3", "fp8_e5m2")


class QTensor(NamedTuple):
    """A group-quantized tensor (pre-packing).

    ``codes``: int8 [Kp, N] integer codes (Kp = K padded to a multiple of G).
    ``scales``: float32 [K/G, N] per-(group, out-channel) scales.
    ``zeros``: optional zero points (asymmetric), else None.
    ``dtype``: logical quant dtype ("int").
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


def quantize_tensor(w: torch.Tensor, bits: int = 4, group_size: int = 32,
                    scheme: str = "sym", dtype: str = "int",
                    full_range: bool = False) -> QTensor:
    """Dispatch on dtype/scheme. The port carries the symmetric integer
    path; the others raise until their JAX counterparts are ported."""
    if dtype in FLOAT_CODE_DTYPES:
        raise NotImplementedError(
            f"{dtype!r} codebook quantization waits for the port of "
            "neural_compressor_tpu.ops.qtensor.quantize_codebook")
    if dtype in FP8_DTYPES:
        raise ValueError(
            f"{dtype!r} weights go through the FP8 flow, not quantize_tensor")
    if dtype != "int":
        if not (dtype.startswith("int") and dtype[3:].isdigit()):
            raise ValueError(
                f"unknown quant dtype {dtype!r}; expected one of "
                f"{INT_DTYPES + FLOAT_CODE_DTYPES}")
        bits = int(dtype[3:])
    if scheme != "sym":
        raise NotImplementedError(
            "asymmetric quantization waits for the port of "
            "neural_compressor_tpu.ops.qtensor.quantize_int_asym")
    return quantize_int_sym(w, bits=bits, group_size=group_size,
                            full_range=full_range)


def dequantize(qt: QTensor, out_dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the (fake-quantized) weight [K, N] from a QTensor."""
    K, N = qt.orig_shape
    G = qt.group_size
    vals = qt.codes.reshape(-1, G, N).to(torch.float32)
    if qt.zeros is not None:
        vals = vals - qt.zeros[:, None, :]
    w = vals * qt.scales[:, None, :]
    return w.reshape(-1, N)[:K].to(out_dtype)


def quantize_act_per_token(x: torch.Tensor, bits: int = 8):
    """Per-token (row-wise) symmetric dynamic activation quantization.
    Returns (int8 codes, float32 scales [..., 1])."""
    qmax = 2 ** (bits - 1) - 1
    x = x.to(torch.float32)
    scale = x.abs().amax(dim=-1, keepdim=True) * (1.0 / qmax)
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale
