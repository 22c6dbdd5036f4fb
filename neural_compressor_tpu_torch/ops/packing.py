"""Bit packing for quantized weights: the JAX package's layout and the
Hopper serving layout, with exact converters between them.

"tpu_strided" (the JAX package's canonical layout, kept so that packed
weights cross between the packages byte for byte): int4/int2 codes [K, N]
packed into 32-bit words along K, strided within each group:

    packed[g*G/P + i, n] field s  ==  codes[g*G + s*(G/P) + i, n]

with P = 32/bits fields per word, each field offset-binary (signed + 2^(b-1)).
PyTorch has no usable uint32 arithmetic, so the words are held as int32
with the same bits.

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

from .qtensor import FLOAT_CODE_DTYPES, QTensor

LANE_BITS = 32
HOPPER_LAYOUT = "hopper_nk"


class PackedWeight(NamedTuple):
    """A packed, serving-ready quantized weight.

    ``packed``: int32 [K/P, N] ("tpu_strided"), uint8 [N, K/2]
        ("hopper_nk") or int8 [K, N] ("int8").
    ``scales``: float32 [K/G, N]. ``zeros``: optional float32 [K/G, N].
    ``bits`` / ``group_size`` / ``dtype`` / ``orig_shape``: as in QTensor.
    ``layout``: "tpu_strided" | "hopper_nk" | "int8".
    """

    packed: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor | None
    bits: int
    group_size: int
    dtype: str
    orig_shape: tuple[int, int]
    layout: str


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
    """Inverse of ``pack_codes``: int32 [K/P, N] -> int8 codes [K, N]."""
    P = LANE_BITS // bits
    G = group_size if group_size > 0 else K
    N = packed.shape[-1]
    p = (packed.to(torch.int64) & 0xFFFFFFFF).reshape(K // G, G // P, N)
    mask = (1 << bits) - 1
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


def unpack_to_codes(pw: PackedWeight) -> torch.Tensor:
    """PackedWeight -> int8 codes [K, N]."""
    K, _N = pw.orig_shape
    if pw.layout == "tpu_strided":
        signed = pw.dtype not in FLOAT_CODE_DTYPES
        return unpack_codes(pw.packed, pw.bits, pw.group_size, K,
                            signed=signed)
    if pw.layout == HOPPER_LAYOUT:
        return unpack_codes_hopper(pw.packed)
    return pw.packed.to(torch.int8)


def hopper_eligible(pw: PackedWeight) -> bool:
    """Symmetric int4 integer weights in the tpu_strided layout: exactly
    the weights ``to_w4a8_serving`` serves on the integer path."""
    return (pw.layout == "tpu_strided" and pw.bits == 4
            and pw.dtype == "int" and pw.zeros is None)


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


def pack_qtensor(qt: QTensor) -> PackedWeight:
    """QTensor -> PackedWeight in the tpu_strided layout where it applies
    (else unpacked "int8"), as ``neural_compressor_tpu`` packs it."""
    K, N = qt.orig_shape
    G = qt.group_size
    P = LANE_BITS // qt.bits if qt.bits in (2, 4) else 0
    if qt.bits in (2, 4) and K % G == 0 and G % P == 0:
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
        layout=layout)


def dequantize_packed(pw: PackedWeight, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Full dequantization to [K, N] (the reference the kernels are held to)."""
    if pw.dtype in FLOAT_CODE_DTYPES:
        raise NotImplementedError(
            "codebook weights wait for the port of "
            "neural_compressor_tpu.ops.packing._dequantize_packed_arrays")
    K, N = pw.orig_shape
    G = pw.group_size if pw.group_size > 0 else K
    codes = unpack_to_codes(pw)
    rem = codes.shape[0] % G
    if rem:
        # "int8" layout stores K unpadded rows; scales cover ceil(K/G) groups
        codes = torch.nn.functional.pad(codes, (0, 0, 0, G - rem))
    vals = codes.reshape(-1, G, N).to(torch.float32)
    if pw.zeros is not None:
        vals = vals - pw.zeros[:, None, :]
    w = vals * pw.scales[:, None, :]
    return w.reshape(-1, N)[:K].to(out_dtype)
