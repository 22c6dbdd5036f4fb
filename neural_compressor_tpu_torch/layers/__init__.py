from .linear import Embed, Linear
from .module_utils import (get_model_info, get_module, module_type_name,
                           named_modules, replace_module)
from .woq_linear import QDQLinear, W4A8Linear, WOQLinear
