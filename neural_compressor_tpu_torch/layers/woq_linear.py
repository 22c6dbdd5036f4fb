"""Weight-only-quantized Linear modules.

``WOQLinear`` holds a packed weight as RTN leaves it ("tpu_strided", or
"int8" codes) and serves it with bf16 activations through ``woq_matmul``
(K8/K9 on the card); ``neural_compressor_tpu/layers/woq_linear.py:23-105``.
``W4A8Linear`` serves symmetric int4 weights with int8 per-token
activations on the "hopper_nk" layout and the port's integer kernels; its
dispatch mirrors ``neural_compressor_tpu/layers/woq_linear.py:150-184`` and
``kernels/fused_matvec.py:359-396``.
``QDQLinear`` keeps the fake-quantized kernel in bf16 (the numeric
reference of quantization at full memory cost).
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.dequant_matmul import dequant_dot, woq_matmul
from ..ops.packing import (HOPPER_LAYOUT, PackedWeight, dequantize_packed,
                           hopper_eligible, pack_qtensor, to_hopper)
from ..ops.qtensor import QTensor, quantize_tensor


class WOQLinear(nn.Module):
    """Packed weight-only-quantized Linear: ``y = x @ dequant(Wq) + b``.

    ``impl`` selects ``woq_matmul``'s path ("auto" by default).
    ``pre_scale``: a per-input-channel scale that could not be folded into
    a parent op; the forward computes ``(x / pre_scale) @ dequant(Wq)``."""

    def __init__(self, pw: PackedWeight, bias: torch.Tensor | None = None,
                 impl: str = "auto", pre_scale: torch.Tensor | None = None):
        super().__init__()
        K, N = pw.orig_shape
        self.in_features = K
        self.out_features = N
        self.bits = pw.bits
        self.group_size = pw.group_size
        self.wdtype = pw.dtype
        self.layout = pw.layout
        self.impl = impl
        self.register_buffer("packed", pw.packed)
        self.register_buffer("scales", pw.scales)
        self.register_buffer("zeros", pw.zeros)
        # act-order input-row permutation (rows stored permuted)
        self.register_buffer("perm", pw.perm)
        # double quant: ``scales`` holds int8 codes, these their meta
        self.register_buffer("sq_scales", pw.sq_scales)
        self.register_buffer("sq_zeros", pw.sq_zeros)
        self.register_buffer("bias", bias)
        self.register_buffer("pre_scale", None if pre_scale is None
                             else pre_scale.to(torch.float32))

    def packed_weight(self) -> PackedWeight:
        return PackedWeight(
            packed=self.packed, scales=self.scales, zeros=self.zeros,
            bits=self.bits, group_size=self.group_size, dtype=self.wdtype,
            orig_shape=(self.in_features, self.out_features),
            layout=self.layout, perm=self.perm, sq_scales=self.sq_scales,
            sq_zeros=self.sq_zeros)

    def _scale_input(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_scale is None:
            return x
        return x / self.pre_scale.to(x.dtype)

    def _add_bias(self, y: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._scale_input(x)
        return self._add_bias(woq_matmul(x, self.packed_weight(),
                                         impl=self.impl))

    def dequantized_kernel(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize_packed(self.packed_weight(), out_dtype=dtype)

    @classmethod
    def from_qtensor(cls, qt: QTensor, bias=None, impl: str = "auto",
                     pre_scale=None, perm=None) -> "WOQLinear":
        return cls(pack_qtensor(qt, perm=perm), bias=bias, impl=impl,
                   pre_scale=pre_scale)

    @classmethod
    def from_kernel(cls, kernel: torch.Tensor, bias=None, *, bits=4,
                    group_size=32, scheme="sym", dtype="int",
                    impl: str = "auto") -> "WOQLinear":
        qt = quantize_tensor(kernel, bits=bits, group_size=group_size,
                             scheme=scheme, dtype=dtype)
        return cls.from_qtensor(qt, bias=bias, impl=impl)


class W4A8Linear(WOQLinear):
    """INT4-weight x INT8-activation serving Linear.

    Symmetric int4 weights move to the "hopper_nk" layout when the module
    is built (exact: the codes are unchanged), unless ``M_INT8_THRESHOLD``
    is raised then: the words stay "tpu_strided" for ``woq_matmul``.
    Forward, by rows M:
      * "hopper_nk" weights, or M >= ``M_INT8_THRESHOLD`` (1, so every M
        by default):
        - outside the envelope of the JAX package's integer kernel
          (``w4a8_tiles_ok``: asymmetric weights, N % 256, K % tk, not
          "hopper_nk"): the bf16 dequant-and-dot that ``w4a8_matmul``
          falls back to;
        - M == 1 inside ``fused_ok``: the fused GEMV with no prologue or
          epilogue;
        - otherwise: int8 per-token activations and the W4A8 GEMM;
      * "tpu_strided" weights below a raised threshold: ``woq_matmul``
        (K8), and at M == 1 the all-integer matvec (K10), which waits for
        its port. The JAX package's serving layout likewise ignores the
        threshold (``layers/woq_linear.py:165-172``).
    """

    M_INT8_THRESHOLD = 1

    def __init__(self, pw: PackedWeight, bias: torch.Tensor | None = None,
                 impl: str = "auto", pre_scale: torch.Tensor | None = None):
        if hopper_eligible(pw) and self.M_INT8_THRESHOLD <= 1:
            pw = to_hopper(pw)
        super().__init__(pw, bias=bias, impl=impl, pre_scale=pre_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..kernels.fused_matvec import fused_matvec
        from ..kernels.w4a8_matmul import w4a8_matmul, w4a8_tiles_ok

        x = self._scale_input(x)
        M = x.numel() // self.in_features
        pw = self.packed_weight()
        if pw.layout == HOPPER_LAYOUT or M >= self.M_INT8_THRESHOLD:
            if not w4a8_tiles_ok(pw, M):
                y = dequant_dot(x, pw, torch.bfloat16, x.dtype)
            else:
                y = fused_matvec(x, pw) if M == 1 else None
                if y is None:
                    y = w4a8_matmul(x, pw)
        elif M == 1:
            raise NotImplementedError(
                "the all-integer M == 1 matvec below M_INT8_THRESHOLD waits "
                "for the port of neural_compressor_tpu.kernels."
                "dequant_matmul.vpu_matvec_int8act (K10)")
        else:
            y = woq_matmul(x, pw, impl=self.impl)
        return self._add_bias(y)


class QDQLinear(nn.Module):
    """Fake-quantized Linear: the kernel stored dequantized in bf16, equal
    to quantization's numeric result at full memory cost; ``y`` is a bf16
    product accumulated in float32, as the JAX package leaves it to XLA."""

    def __init__(self, kernel_qdq: torch.Tensor,
                 bias: torch.Tensor | None = None, meta: dict | None = None):
        super().__init__()
        self.in_features, self.out_features = kernel_qdq.shape
        self.register_buffer("kernel", kernel_qdq.to(torch.bfloat16))
        self.register_buffer("bias", bias)
        self.meta = meta or {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                         self.kernel.to(torch.float32))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y.to(x.dtype)
