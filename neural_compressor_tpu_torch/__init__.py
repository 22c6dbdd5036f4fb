"""neural_compressor_tpu_torch — the PyTorch/CUDA port of
``neural_compressor_tpu``.

It serves RTN-quantized Llama models with greedy decoding through
hand-written Hopper kernels (``kernels/``, sources in ``csrc/``): build or
load a model, quantize it (weight-only ``WOQLinear``: sym or asym int4,
int2, int8, nf4, fp4), optionally convert symmetric int4 to W4A8 serving,
then generate, or serve many requests through the continuous-batching
engine over contiguous or paged KV caches.

    from neural_compressor_tpu_torch import (
        RTNConfig, build_quantized, fuse_for_serving, to_w4a8_serving,
        enable_fused_decode, generate, ContinuousBatchingEngine)

It imports PyTorch, never JAX. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch
version runs instead."""

from .version import __version__
from .common import logger, set_log_level, options
from .quantization import (RTNConfig, enable_fused_decode, fuse_for_serving,
                           quantize, to_w4a8_serving)
from .models import (LLAMA_PRESETS, LlamaConfig, LlamaForCausalLM,
                     build_quantized, from_jax_params)
from .generation import generate, greedy_search
from .serving import ContinuousBatchingEngine
