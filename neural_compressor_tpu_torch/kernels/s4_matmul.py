"""W4A8 matmul on "s4_rowpack" weights (K2).

The counterpart of ``neural_compressor_tpu/kernels/s4_matmul.py``: the
contract and numerics of ``w4a8_matmul`` (int8 per-token activations x
grouped symmetric int4 weights, int32 group partials folded into float32
in group order) on the JAX package's native-int4 layout, 32-bit words
[K, N/8] with 8 consecutive output columns a word (``ops/packing.py``).
The TPU kernel reads an int4 view of the words (``s4_view``, taken once
per jitted program by ``s4_prepare``); the CUDA kernel
(``csrc/s4_gemm.cu``) reads the words where they lie and sign-extends the
nibbles itself, so the port has no view and nothing to prepare. It shares
K1's MMA core, so the same codes give K1's bits at every M.
"""

from __future__ import annotations

import torch

from ..ops.packing import (S4_LAYOUT, PackedWeight, resolve_double_quant,
                           unpack_codes_s4)
from ..ops.qtensor import quantize_act_per_token
from .w4a8_matmul import (_gather_perm, _launch, grouped_gemm_plain,
                          select_w4a8_tiles)


def s4_usable(pw: PackedWeight) -> bool:
    """``neural_compressor_tpu``'s ``s4_usable`` without its TPU check:
    symmetric int4 integer "s4_rowpack" words, K % G == 0 and N % 256 ==
    0. On the CPU the wrapper runs K2's plain version instead of the
    kernel, as every wrapper of the port does."""
    K, N = pw.orig_shape
    G = pw.group_size if pw.group_size > 0 else K
    return (pw.layout == S4_LAYOUT and pw.bits == 4 and pw.zeros is None
            and pw.dtype == "int" and K % G == 0 and N % 256 == 0)


def s4_gemm_plain(xq: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
                  x_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: xq int8 [M, K], w int32 "s4_rowpack"
    [K, N/8], scales f32 [K/G, N], x_scale f32 [M] -> f32 [M, N], the
    arithmetic of K1 (``grouped_gemm_plain``)."""
    K = xq.shape[1]
    N = scales.shape[1]
    return grouped_gemm_plain(xq, unpack_codes_s4(w, K, N), scales, x_scale)


def s4_gemm(xq: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
            x_scale: torch.Tensor) -> torch.Tensor:
    """K2 on the card (``csrc/s4_gemm.cu``); the plain version for CPU
    tensors. Shapes as in ``s4_gemm_plain``; any M (M = 1 and 8 run the
    same kernel). The tiled kernel where K and G are multiples of 32, the
    general path elsewhere."""
    if xq.device.type == "cpu":
        return s4_gemm_plain(xq, w, scales, x_scale)
    return _launch(s4_gemm, "nctt_s4_gemm", xq, w, scales, x_scale)


s4_gemm.launches = 0


def s4_matmul(x: torch.Tensor, pw: PackedWeight,
              out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(Wq) with int8 per-token activation quantization on
    "s4_rowpack" words, as ``neural_compressor_tpu``'s ``s4_matmul``:
    double-quantized scales resolved and ``perm`` gathered outside the
    kernel; the tiles of ``select_w4a8_tiles``, with the N tile 512 at
    M <= 32 where N % 512 == 0, else 256, decide which shapes the kernel
    takes; outside that envelope the bf16 dequant-and-dot, with no int8
    activations (``s4_matmul.py:149-153``)."""
    from .dequant_matmul import dequant_dot

    out_dtype = out_dtype or x.dtype
    pw = resolve_double_quant(pw)
    K, N = pw.orig_shape
    lead = x.shape[:-1]
    x2, pw = _gather_perm(x.reshape(-1, K), pw)
    M = x2.shape[0]
    G = pw.group_size if pw.group_size > 0 else K
    _tm, tk = select_w4a8_tiles(M, K, G)
    tn = 512 if (M <= 32 and N % 512 == 0) else 256
    if not s4_usable(pw) or K % tk or N % tn:
        return dequant_dot(x2, pw, torch.bfloat16, out_dtype).reshape(*lead, N)
    xq, x_scale = quantize_act_per_token(x2, bits=8)
    y = s4_gemm(xq, pw.packed, pw.scales.to(torch.float32),
                x_scale.reshape(-1))
    return y.to(out_dtype).reshape(*lead, N)
