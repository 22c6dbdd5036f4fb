"""neural_compressor_tpu_torch — the PyTorch/CUDA port of
``neural_compressor_tpu``.

It serves RTN-quantized Llama, Gemma (gemma-1/2/3 text) and DeepSeek-V3
(MLA with a latent cache, routed MoE) models with
greedy decoding (plain, or speculative for Llama: draft-verify or prompt
lookup) through
hand-written Hopper kernels (``kernels/``, sources in ``csrc/``): build or
load a model, quantize it (weight-only ``WOQLinear``: sym or asym int4,
int2, int8, nf4, fp4; add ``KVCacheQuantConfig`` for int8, fp8-e4m3 or
int4 KV caches), optionally convert symmetric int4 to W4A8 serving, then
generate, or serve many requests through the continuous-batching engine
over contiguous or paged KV caches.

    from neural_compressor_tpu_torch import (
        RTNConfig, KVCacheQuantConfig, build_quantized, fuse_for_serving,
        to_w4a8_serving, enable_fused_decode, generate,
        ngram_speculative_greedy_search, speculative_greedy_search,
        ContinuousBatchingEngine)

It imports PyTorch, never JAX. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch
version runs instead."""

from .version import __version__
from .common import logger, set_log_level, options
from .quantization import (KVCacheQuantConfig, RTNConfig,
                           enable_fused_decode, fuse_for_serving, quantize,
                           to_w4a8_serving)
from .models import (DEEPSEEK_PRESETS, GEMMA_PRESETS, LLAMA_PRESETS,
                     DeepseekConfig, DeepseekForCausalLM, GemmaConfig,
                     GemmaForCausalLM, LlamaConfig, LlamaForCausalLM,
                     build_quantized, enable_mla_latent_cache,
                     from_jax_params)
from .generation import (generate, greedy_search,
                         ngram_speculative_greedy_search,
                         speculative_greedy_search)
from .serving import ContinuousBatchingEngine
