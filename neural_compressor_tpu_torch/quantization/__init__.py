from .config import KVCacheQuantConfig, RTNConfig
from .fuse import enable_fused_decode, fuse_for_serving, to_w4a8_serving
from .quantize import quantize
