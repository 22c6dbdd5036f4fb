from .llama import (LLAMA_PRESETS, KVCache, LlamaConfig, LlamaForCausalLM,
                    PagedKVCache, build_quantized, from_jax_params,
                    init_kv_cache, init_paged_pool)
from .gemma import GEMMA_PRESETS, GemmaConfig, GemmaForCausalLM
from .deepseek import (DEEPSEEK_PRESETS, DeepseekConfig, DeepseekForCausalLM,
                       enable_mla_latent_cache)
