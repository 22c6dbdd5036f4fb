"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. A wrapper takes the plain version only for CPU tensors; for a
CUDA tensor it launches its kernel (and counts the launch in its
``launches`` attribute) or raises."""

from .w4a8_matmul import w4a8_gemm, w4a8_gemm_plain, w4a8_matmul
from .fused_matvec import fused_gemv, fused_gemv_plain, fused_matvec, fused_ok
from .decode_attention import (batched_decode_attention, batched_decode_attn,
                               batched_decode_attn_plain, decode_attn,
                               decode_attn_plain, decode_attention)
from .paged_attention import (paged_attn, paged_attn_plain,
                              paged_decode_attention, paged_write,
                              paged_write_plain, paged_write_rows)
from .dequant_matmul import (dequant_dot, dequant_gemm, dequant_gemm_plain,
                             set_default_impl, vpu_gemv, vpu_gemv_plain,
                             vpu_matvec, woq_matmul)

KERNEL_WRAPPERS = (w4a8_gemm, fused_gemv, decode_attn, batched_decode_attn,
                   paged_attn, paged_write, dequant_gemm, vpu_gemv)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
