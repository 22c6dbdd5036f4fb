from .activations import gelu_tanh, softcap
from .qtensor import (CODEBOOKS, QTensor, dequantize, qdq_tensor,
                      quantize_act_per_token, quantize_codebook,
                      quantize_int_asym, quantize_int_sym, quantize_tensor,
                      search_clip)
from .packing import (HOPPER_LAYOUT, PackedWeight, apply_double_quant,
                      dequantize_packed, effective_scales, pack_codes,
                      pack_codes_hopper, pack_qtensor, resolve_double_quant,
                      to_hopper, to_tpu_strided, unpack_codes,
                      unpack_codes_hopper, unpack_to_codes)
