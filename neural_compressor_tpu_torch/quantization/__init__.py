from .config import (GPTQConfig, HybridGPTQConfig, KVCacheQuantConfig,
                     RTNConfig)
from .fuse import (enable_fused_decode, fuse_for_serving, s4_prepare,
                   to_w4a8_serving)
from .quantize import convert, finalize_calibration, prepare, quantize
