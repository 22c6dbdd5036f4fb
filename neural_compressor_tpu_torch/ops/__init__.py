from .qtensor import (QTensor, quantize_tensor, quantize_int_sym, dequantize,
                      quantize_act_per_token)
from .packing import (PackedWeight, pack_codes, unpack_codes, pack_qtensor,
                      pack_codes_hopper, unpack_codes_hopper, to_hopper,
                      to_tpu_strided, dequantize_packed, unpack_to_codes,
                      HOPPER_LAYOUT)
