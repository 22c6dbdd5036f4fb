"""Weight-only-quantized Linear modules.

``WOQLinear`` holds a packed weight as RTN leaves it ("tpu_strided"); its
forward waits for the bf16-activation WOQ kernels.
``W4A8Linear`` serves symmetric int4 weights with int8 per-token
activations on the "hopper_nk" layout and the port's kernels; its dispatch
mirrors ``neural_compressor_tpu/layers/woq_linear.py:150-184`` and
``kernels/fused_matvec.py:359-396``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.packing import (PackedWeight, dequantize_packed, hopper_eligible,
                           to_hopper)


class WOQLinear(nn.Module):
    """Packed weight-only-quantized Linear: ``y = x @ dequant(Wq) + b``."""

    def __init__(self, pw: PackedWeight, bias: torch.Tensor | None = None):
        super().__init__()
        K, N = pw.orig_shape
        self.in_features = K
        self.out_features = N
        self.bits = pw.bits
        self.group_size = pw.group_size
        self.wdtype = pw.dtype
        self.layout = pw.layout
        self.register_buffer("packed", pw.packed)
        self.register_buffer("scales", pw.scales)
        self.register_buffer("zeros", pw.zeros)
        self.register_buffer("bias", bias)

    def packed_weight(self) -> PackedWeight:
        return PackedWeight(
            packed=self.packed, scales=self.scales, zeros=self.zeros,
            bits=self.bits, group_size=self.group_size, dtype=self.wdtype,
            orig_shape=(self.in_features, self.out_features),
            layout=self.layout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "WOQLinear's bf16-activation forward waits for the port of "
            "neural_compressor_tpu.kernels.dequant_matmul.woq_matmul "
            "(K8/K9); serve the model through to_w4a8_serving")


def _dequant_dot(x: torch.Tensor, pw: PackedWeight, out_dtype) -> torch.Tensor:
    """bf16 dequant and a float32 dot, as ``w4a8_matmul.py:178-182``. Not a
    kernel: each call adds one to ``_dequant_dot.calls``, so a run can show
    that its shapes never took it."""
    _dequant_dot.calls += 1
    K, N = pw.orig_shape
    w = dequantize_packed(pw, out_dtype=torch.bfloat16)
    x2 = x.reshape(-1, K).to(torch.bfloat16)
    y = torch.matmul(x2.to(torch.float32), w.to(torch.float32))
    return y.to(out_dtype).reshape(*x.shape[:-1], N)


_dequant_dot.calls = 0


class W4A8Linear(WOQLinear):
    """INT4-weight x INT8-activation serving Linear.

    Symmetric int4 weights move to the "hopper_nk" layout when the module
    is built (exact: the codes are unchanged). Forward, by shape:
      * outside the envelope of the JAX package's integer kernel
        (``w4a8_tiles_ok``: asymmetric weights, N % 256, K % tk): the bf16
        dequant-and-dot that ``w4a8_matmul`` falls back to;
      * M == 1 inside ``fused_ok``: the fused GEMV with no prologue or
        epilogue;
      * otherwise: int8 per-token activations and the W4A8 GEMM.
    """

    def __init__(self, pw: PackedWeight, bias: torch.Tensor | None = None):
        if hopper_eligible(pw):
            pw = to_hopper(pw)
        super().__init__(pw, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..kernels.fused_matvec import fused_matvec
        from ..kernels.w4a8_matmul import w4a8_matmul, w4a8_tiles_ok

        M = x.numel() // self.in_features
        pw = self.packed_weight()
        if not w4a8_tiles_ok(pw, M):
            y = _dequant_dot(x, pw, x.dtype)
        else:
            y = fused_matvec(x, pw) if M == 1 else None
            if y is None:
                y = w4a8_matmul(x, pw)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
