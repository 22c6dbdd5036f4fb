"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. A wrapper takes the plain version only for CPU tensors; for a
CUDA tensor it launches its kernel (and counts the launch in its
``launches`` attribute: an int, or for the kernels that take several
cache formats a dict of counts by format) or raises."""

from .w4a8_matmul import w4a8_gemm, w4a8_gemm_plain, w4a8_matmul
from .fused_matvec import (attn_o, attn_o_fused, attn_o_plain, fused_gemv,
                           fused_gemv_plain, fused_matvec, fused_ok)
from .omlp_matvec import (mlp_fused, omlp, omlp_fused, omlp_plain,
                          set_omlp_fused)
from .decode_attention import (batched_decode_attention, batched_decode_attn,
                               batched_decode_attn_plain, decode_attn,
                               decode_attn_hbm, decode_attn_hbm_plain,
                               decode_attn_plain, decode_attn_quant,
                               decode_attn_quant_plain, decode_attn_write,
                               decode_attn_write_plain, decode_attention,
                               decode_attention_quant, set_cache_write_mode,
                               set_ro_cache_space)
from .paged_attention import (paged_attn, paged_attn_gemma, paged_attn_plain,
                              paged_attn_v1, paged_attn_v1_plain,
                              paged_decode_attention, paged_latent_attention,
                              paged_latent_attn, paged_latent_attn_plain,
                              paged_latent_write, paged_latent_write_plain,
                              paged_window_attention, paged_window_attn,
                              paged_window_attn_plain, paged_write,
                              paged_write_latent, paged_write_plain,
                              paged_write_rows, paged_write_window,
                              paged_write_window_kernel,
                              paged_write_window_plain, set_paged_v2)
from .dequant_matmul import (dequant_dot, dequant_gemm, dequant_gemm_plain,
                             set_default_impl, vpu_gemv, vpu_gemv_plain,
                             vpu_matvec, woq_matmul)

KERNEL_WRAPPERS = (w4a8_gemm, fused_gemv, decode_attn, decode_attn_quant,
                   batched_decode_attn, paged_attn, paged_write, dequant_gemm,
                   vpu_gemv, paged_write_window_kernel, paged_window_attn,
                   paged_attn_gemma, paged_latent_write, paged_latent_attn,
                   paged_attn_v1, decode_attn_write, decode_attn_hbm, omlp,
                   attn_o)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        if isinstance(fn.launches, dict):
            fn.launches = dict.fromkeys(fn.launches, 0)
        else:
            fn.launches = 0
