"""Bit packing for quantized weights: the JAX package's layout and the
Hopper serving layout, with exact converters between them.

"tpu_strided" (the JAX package's canonical layout, kept so that packed
weights cross between the packages byte for byte): int4/int2 codes [K, N]
packed into 32-bit words along K, strided within each group:

    packed[g*G/P + i, n] field s  ==  codes[g*G + s*(G/P) + i, n]

with P = 32/bits fields per word, each field offset-binary (signed + 2^(b-1)).
PyTorch has no usable uint32 arithmetic, so the words are held as int32
with the same bits.

"s4_rowpack" (the JAX package's native-int4 serving layout, read where it
lies by K2, ``csrc/s4_gemm.cu``): int32 [K, N/8]; word (k, j) holds the 8
consecutive output columns 8j..8j+7 of input row k, nibble s = column
8j+s, two's complement. The JAX package views these words as an int4
[K, N] array (``s4_view``); the port has no such view and needs none: the
kernel sign-extends the nibbles itself.

"hopper_nk" (the port's serving layout, read by the CUDA kernels):
uint8 [N, K/2]; byte (n, j) holds code[2j, n] in its low nibble and
code[2j+1, n] in its high nibble, both two's complement. One output
column's K codes are contiguous, so a thread streams them as 16-byte
vectors, and a 16-byte vector (32 codes) never straddles a group of a
multiple of 32. Scales stay float32 [K/G, N].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .qtensor import CODEBOOKS, FLOAT_CODE_DTYPES, QTensor

LANE_BITS = 32
HOPPER_LAYOUT = "hopper_nk"
S4_LAYOUT = "s4_rowpack"


class PackedWeight(NamedTuple):
    """A packed, serving-ready quantized weight.

    ``packed``: int32 [K/P, N] ("tpu_strided"), int32 [K, N/8]
        ("s4_rowpack"), uint8 [N, K/2] ("hopper_nk") or int8 [K, N]
        ("int8").
    ``scales``: float32 [K/G, N]. ``zeros``: optional float32 [K/G, N].
    ``bits`` / ``group_size`` / ``dtype`` / ``orig_shape``: as in QTensor.
    ``layout``: "tpu_strided" | "s4_rowpack" | "hopper_nk" | "int8".
    ``perm``: optional int32 [K] input-row permutation: stored row i holds
        original input row ``perm[i]``; the matmul gathers ``x[..., perm]``
        and dequantization scatters the rows back.
    ``sq_scales`` / ``sq_zeros``: double quantization. When set, ``scales``
        holds int8 codes of the group scales and these hold their float32
        scale (and zero point) per super-group, [ng2, N].
    """

    packed: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor | None
    bits: int
    group_size: int
    dtype: str
    orig_shape: tuple[int, int]
    layout: str
    perm: torch.Tensor | None = None
    sq_scales: torch.Tensor | None = None
    sq_zeros: torch.Tensor | None = None


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 holding the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_codes(codes: torch.Tensor, bits: int, group_size: int,
               offset_binary: bool = True) -> torch.Tensor:
    """Pack int codes [K, N] -> int32 [K/P, N] in the tpu_strided layout
    (bit-identical to ``neural_compressor_tpu.ops.packing.pack_codes``)."""
    P = LANE_BITS // bits
    K, N = codes.shape
    G = group_size if group_size > 0 else K
    if K % G or G % P:
        raise ValueError(f"tpu_strided needs K % G == 0 and G % {P} == 0 "
                         f"(K={K}, G={G})")
    mask = (1 << bits) - 1
    c = codes.to(torch.int64) & mask
    if offset_binary:
        c = c ^ (1 << (bits - 1))
    c = c.reshape(K // G, P, G // P, N)
    words = torch.zeros((K // G, G // P, N), dtype=torch.int64,
                        device=codes.device)
    for s in range(P):
        words = words | (c[:, s] << (bits * s))
    return _to_int32_bits(words.reshape(K // P, N))


def unpack_codes(packed: torch.Tensor, bits: int, group_size: int, K: int,
                 signed: bool) -> torch.Tensor:
    """Inverse of ``pack_codes``: int32 [K/P, N] -> int8 codes [K, N]
    (``signed=False`` keeps the raw unsigned fields)."""
    P = LANE_BITS // bits
    G = group_size if group_size > 0 else K
    N = packed.shape[-1]
    p = packed.reshape(K // G, G // P, N)
    mask = (1 << bits) - 1
    # an arithmetic shift of the int32 words, then the mask: the field bits
    planes = [(p >> (bits * s)) & mask for s in range(P)]
    codes = torch.cat(planes, dim=1).reshape(K, N)
    if signed:
        codes = codes - (1 << (bits - 1))
    return codes.to(torch.int8)


def pack_codes_hopper(codes: torch.Tensor) -> torch.Tensor:
    """Signed int4 codes [K, N] -> uint8 [N, K/2] ("hopper_nk")."""
    K, N = codes.shape
    if K % 2:
        raise ValueError(f"hopper_nk needs an even K, got {K}")
    c = (codes.to(torch.int16) & 0xF).t()
    return (c[:, 0::2] | (c[:, 1::2] << 4)).to(torch.uint8).contiguous()


def unpack_codes_hopper(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_codes_hopper``: uint8 [N, K/2] -> int8 codes [K, N]."""
    N = packed.shape[0]
    p = packed.to(torch.int16)
    c = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(N, -1)
    c = torch.where(c >= 8, c - 16, c)
    return c.t().contiguous().to(torch.int8)


def unpack_codes_hopper_f32(packed: torch.Tensor) -> torch.Tensor:
    """``unpack_codes_hopper``'s codes [K, N] as float32 (exact), the operand
    of the plain W4A8 products."""
    return unpack_codes_hopper(packed).to(torch.float32)


def pack_codes_s4(codes: torch.Tensor) -> torch.Tensor:
    """Signed int4 codes [K, N] -> int32 [K, N/8] ("s4_rowpack"), the bits
    of ``neural_compressor_tpu.ops.packing.pack_codes_s4``'s uint32 words."""
    K, N = codes.shape
    if N % 8:
        raise ValueError(f"s4_rowpack needs N % 8 == 0, got N={N}")
    c = (codes.to(torch.int64) & 0xF).reshape(K, N // 8, 8)
    words = torch.zeros((K, N // 8), dtype=torch.int64, device=codes.device)
    for s in range(8):
        words = words | (c[..., s] << (4 * s))
    return _to_int32_bits(words)


def unpack_codes_s4(packed: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """Inverse of ``pack_codes_s4``: int32 [K, N/8] -> int8 codes [K, N]."""
    planes = [(packed >> (4 * s)) & 0xF for s in range(8)]
    c = torch.stack(planes, dim=-1).reshape(K, N)
    return torch.where(c >= 8, c - 16, c).to(torch.int8)


def s4_eligible(pw: PackedWeight) -> bool:
    """What ``to_s4_rowpack`` converts: symmetric int4 integer words in the
    tpu_strided layout with N % 8 == 0 (a row permutation and
    double-quantized scales ride along unchanged)."""
    return (pw.bits == 4 and pw.dtype == "int" and pw.zeros is None
            and pw.orig_shape[1] % 8 == 0 and pw.layout == "tpu_strided")


def to_s4_rowpack(pw: PackedWeight) -> PackedWeight:
    """tpu_strided -> "s4_rowpack", exact (the codes are unchanged), as
    ``neural_compressor_tpu.ops.packing.to_s4_rowpack``."""
    if not s4_eligible(pw):
        K, N = pw.orig_shape
        raise ValueError(f"not s4_rowpack-convertible: bits={pw.bits} "
                         f"dtype={pw.dtype} layout={pw.layout} N={N}")
    return pw._replace(packed=pack_codes_s4(unpack_to_codes(pw)),
                       layout=S4_LAYOUT)


def unpack_to_codes(pw: PackedWeight) -> torch.Tensor:
    """PackedWeight -> int8 codes [K, N]."""
    K, N = pw.orig_shape
    if pw.layout == "tpu_strided":
        signed = pw.dtype not in FLOAT_CODE_DTYPES
        return unpack_codes(pw.packed, pw.bits, pw.group_size, K,
                            signed=signed)
    if pw.layout == S4_LAYOUT:
        return unpack_codes_s4(pw.packed, K, N)
    if pw.layout == HOPPER_LAYOUT:
        return unpack_codes_hopper(pw.packed)
    return pw.packed.to(torch.int8)


def hopper_eligible(pw: PackedWeight) -> bool:
    """Symmetric int4 integer weights in the tpu_strided layout, without a
    row permutation or double-quantized scales: exactly the weights
    ``to_w4a8_serving`` serves on the integer path."""
    return (pw.layout == "tpu_strided" and pw.bits == 4
            and pw.dtype == "int" and pw.zeros is None
            and pw.perm is None and pw.sq_scales is None)


def to_hopper(pw: PackedWeight) -> PackedWeight:
    """tpu_strided -> hopper_nk, exact (the codes are unchanged)."""
    if not hopper_eligible(pw):
        raise ValueError(f"not hopper_nk-convertible: bits={pw.bits} "
                         f"dtype={pw.dtype} layout={pw.layout} "
                         f"zeros={pw.zeros is not None}")
    return pw._replace(packed=pack_codes_hopper(unpack_to_codes(pw)),
                       layout=HOPPER_LAYOUT)


def to_tpu_strided(pw: PackedWeight) -> PackedWeight:
    """hopper_nk -> tpu_strided, exact: the inverse of ``to_hopper``."""
    if pw.layout != HOPPER_LAYOUT:
        raise ValueError(f"expected a {HOPPER_LAYOUT} weight, got {pw.layout}")
    packed = pack_codes(unpack_codes_hopper(pw.packed), pw.bits,
                        pw.group_size)
    return pw._replace(packed=packed, layout="tpu_strided")


def pack_qtensor(qt: QTensor, force_int8: bool = False,
                 perm: torch.Tensor | None = None) -> PackedWeight:
    """QTensor -> PackedWeight in the tpu_strided layout where it applies
    (else unpacked "int8"), as ``neural_compressor_tpu`` packs it.
    ``perm``: the QTensor's rows are already in permuted (group-contiguous)
    order; it is recorded for the matmul."""
    K, N = qt.orig_shape
    G = qt.group_size
    P = LANE_BITS // qt.bits if qt.bits in (2, 4) else 0
    if (not force_int8 and qt.bits in (2, 4) and K % G == 0
            and G % P == 0):
        packed = pack_codes(qt.codes[:K], qt.bits, G,
                            offset_binary=qt.dtype not in FLOAT_CODE_DTYPES)
        layout = "tpu_strided"
    else:
        packed = qt.codes[:K].to(torch.int8)
        layout = "int8"
    return PackedWeight(
        packed=packed,
        scales=qt.scales.to(torch.float32),
        zeros=None if qt.zeros is None else qt.zeros.to(torch.float32),
        bits=qt.bits, group_size=G, dtype=qt.dtype, orig_shape=(K, N),
        layout=layout,
        perm=(None if perm is None
              else torch.as_tensor(perm, dtype=torch.int32,
                                   device=packed.device)))


def effective_scales(pw: PackedWeight) -> torch.Tensor:
    """float32 group scales, dequantizing double-quantized (int8) ones."""
    if pw.sq_scales is None:
        return pw.scales.to(torch.float32)
    ng, N = pw.scales.shape
    ng2 = pw.sq_scales.shape[0]
    c = pw.scales.to(torch.float32).reshape(ng2, ng // ng2, N)
    if pw.sq_zeros is not None:
        c = c - pw.sq_zeros[:, None, :]
    return (c * pw.sq_scales[:, None, :]).reshape(ng, N)


def resolve_double_quant(pw: PackedWeight) -> PackedWeight:
    """float32 scales from a double-quantized weight (no-op otherwise), as
    every consumer resolves them before its kernel."""
    if pw.sq_scales is None:
        return pw
    return pw._replace(scales=effective_scales(pw), sq_scales=None,
                       sq_zeros=None)


def apply_double_quant(pw: PackedWeight, bits: int = 8, group_size: int = 256,
                       sym: bool = False) -> PackedWeight:
    """Quantize the scale tensor itself: the [ng, N] scales are grouped
    along the group axis in super-groups of ``group_size`` (the largest
    divisor of ng not above it) and stored as int8 codes with a float32
    scale (and zero point) per super-group. The JAX package runs this
    eagerly, so its divisions are true divisions, as here."""
    if not 2 <= bits <= 8:
        raise ValueError("double-quant codes are stored int8: 2 <= bits <= 8")
    half = float(1 << (bits - 1))
    scales = pw.scales.to(torch.float32)
    ng, N = scales.shape
    G2 = min(group_size, ng)
    while ng % G2:
        G2 -= 1
    s = scales.reshape(ng // G2, G2, N)
    if sym:
        qmax = half - 1
        s2 = s.abs().amax(dim=1) / qmax
        s2 = torch.where(s2 <= 0, torch.ones_like(s2), s2)
        codes = torch.clamp(torch.round(s / s2[:, None, :]), -half, qmax)
        z2 = None
    else:
        mx, mn = s.amax(dim=1), s.amin(dim=1)
        s2 = (mx - mn) / (2.0 * half - 1.0)
        s2 = torch.where(s2 <= 0, torch.ones_like(s2), s2)
        z2 = torch.round(-mn / s2) - half
        codes = torch.clamp(torch.round(s / s2[:, None, :])
                            + (z2[:, None, :] + half),
                            0, 2.0 * half - 1.0) - half
    return pw._replace(scales=codes.reshape(ng, N).to(torch.int8),
                       sq_scales=s2, sq_zeros=z2)


def dequantize_packed(pw: PackedWeight, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Full dequantization to [K, N] in the original row order (the
    reference the kernels are held to)."""
    pw = resolve_double_quant(pw)
    K, N = pw.orig_shape
    G = pw.group_size if pw.group_size > 0 else K
    codes = unpack_to_codes(pw)
    rem = codes.shape[0] % G
    if rem:
        # "int8" layout stores K unpadded rows; scales cover ceil(K/G) groups
        codes = torch.nn.functional.pad(codes, (0, 0, 0, G - rem))
    codes = codes.reshape(-1, G, N)
    if pw.dtype in FLOAT_CODE_DTYPES:
        vals = CODEBOOKS[pw.dtype].to(codes.device)[codes.to(torch.int64)]
    else:
        vals = codes.to(torch.float32)
        if pw.zeros is not None:
            vals = vals - pw.zeros[:, None, :]
    w = (vals * pw.scales[:, None, :]).reshape(-1, N)[:K].to(out_dtype)
    if pw.perm is not None:
        # stored row i is original row perm[i]
        w = torch.zeros_like(w).index_copy_(0, pw.perm.to(torch.int64), w)
    return w
