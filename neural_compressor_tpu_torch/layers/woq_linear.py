"""Weight-only-quantized Linear modules.

``WOQLinear`` holds a packed weight as RTN leaves it ("tpu_strided", or
"int8" codes) and serves it with bf16 activations through ``woq_matmul``
(K8/K9 on the card); ``neural_compressor_tpu/layers/woq_linear.py:23-105``.
``W4A8Linear`` serves symmetric int4 weights with int8 per-token
activations on the "hopper_nk", "s4_rowpack" or "tpu_strided" layout and
the port's integer kernels (K1, K2, K4, K10); its dispatch mirrors
``neural_compressor_tpu/layers/woq_linear.py:150-184`` and
``kernels/fused_matvec.py:359-396``.
``QDQLinear`` keeps the fake-quantized kernel in bf16 (the numeric
reference of quantization at full memory cost).
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.dequant_matmul import woq_matmul
from ..ops.packing import (HOPPER_LAYOUT, S4_LAYOUT, PackedWeight,
                           dequantize_packed, pack_qtensor)
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

    The module keeps the words it is given, as JAX's does;
    ``to_w4a8_serving`` alone chooses the serving layout ("hopper_nk" by
    default, exact: the codes are unchanged). A module on "hopper_nk"
    ignores a later raise of ``M_INT8_THRESHOLD``, as a JAX module on
    "u4_kpack" does.
    Forward, in the JAX package's order (``layers/woq_linear.py:150-184``;
    the threshold is read at each call):
      * "hopper_nk" (the port's counterpart of "u4_kpack"): at M == 1
        inside the envelope the fused GEMV (K4), else ``w4a8_matmul`` (K1);
      * "s4_rowpack": ``s4_matmul`` (K2) at every M;
      * M >= ``M_INT8_THRESHOLD`` (1 by default): ``w4a8_matmul``, K1 on
        the "tpu_strided" words;
      * M == 1: ``vpu_matvec_int8act`` (K10), and ``woq_matmul`` where it
        declines;
      * otherwise ``woq_matmul``.
    Outside the integer kernels' envelope (asymmetric weights, N % 256,
    K % tk) ``w4a8_matmul`` and ``s4_matmul`` take the bf16
    dequant-and-dot, as JAX's do.
    """

    M_INT8_THRESHOLD = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..kernels.dequant_matmul import vpu_matvec_int8act
        from ..kernels.fused_matvec import fused_matvec
        from ..kernels.s4_matmul import s4_matmul
        from ..kernels.w4a8_matmul import w4a8_matmul, w4a8_tiles_ok

        x = self._scale_input(x)
        M = x.numel() // self.in_features
        pw = self.packed_weight()
        if pw.layout == HOPPER_LAYOUT:
            y = (fused_matvec(x, pw) if M == 1 and w4a8_tiles_ok(pw, M)
                 else None)
            if y is None:
                y = w4a8_matmul(x, pw)
        elif pw.layout == S4_LAYOUT:
            y = s4_matmul(x, pw)
        elif M >= self.M_INT8_THRESHOLD:
            y = w4a8_matmul(x, pw)
        elif M == 1:
            y = vpu_matvec_int8act(x, pw)
            if y is None:
                y = woq_matmul(x, pw, impl=self.impl)
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
