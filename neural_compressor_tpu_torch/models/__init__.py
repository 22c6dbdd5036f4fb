from .llama import (LLAMA_PRESETS, KVCache, LlamaConfig, LlamaForCausalLM,
                    build_quantized, from_jax_params, init_kv_cache)
