"""GPTQ's two-step flow (``prepare``, the user's calibration calls,
``convert``) on the trained checkpoints in the port against the JAX
package's GPTQ, and the reference fault the port does not copy. Helpers
and tolerances: ``test_torch_hybrid_gptq.py``. At group size 32 the NLL
cannot tell GPTQ from RTN on tiny_lm (RTN's NLL is 2.4e-4 from JAX's
GPTQ, inside ``NLL_TOL``); GPTQ's objective can (RTN, whose codes GPTQ
without error feedback repeats, scores 2.1-2.4 times JAX's), so the flow
test holds both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_compressor_tpu.algorithms import gptq as jg
from neural_compressor_tpu.algorithms.calib_capture import \
    calibration_forward as j_calibration_forward
from neural_compressor_tpu.quantization import GPTQConfig as JGPTQ
from neural_compressor_tpu.quantization import convert as j_convert
from neural_compressor_tpu.quantization import prepare as j_prepare
from neural_compressor_tpu.quantization import quantize as j_quantize
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.algorithms import gptq as tg
from neural_compressor_tpu_torch.algorithms.calib_capture import \
    calibration_forward
from neural_compressor_tpu_torch.layers import WOQLinear

from test_torch_hybrid_gptq import (GPTQ, NLL_TOL, _batches, _dequant_jax,
                                    _dequant_port, _float_pair, _val_nll,
                                    check_objectives, objectives)

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["tiny_lm", "tiny_gqa"])
def test_gptq_prepare_convert_nll_matches_jax(name):
    """GPTQ's two-step flow in the port: ``prepare``, the user's
    calibration calls, ``convert``; every projection and the lm_head a
    ``WOQLinear``; GPTQ's objective within ``OBJ_TOL`` of JAX's GPTQ
    through ``quantize(run_fn=...)``, which quantizes every block, RTN and
    GPTQ without error feedback far outside it, and the mean validation
    NLL within ``NLL_TOL`` of JAX's.
    JAX's own two-step flow leaves block 0 in float (its ops are mapped
    under the capture wrapper's path, ``model.layers.0.inner...``, and
    ``convert`` looks them up under their own): the port does not copy
    that (ROADMAP.md, Queue 3)."""
    jm, tm = _float_pair(name)
    batches = _batches(name)
    with objectives(jg, _dequant_jax) as jax_sums:
        j_quantize(jm, JGPTQ(**GPTQ), run_fn=lambda m: j_calibration_forward(
            m, [jnp.asarray(b) for b in batches]))
    tm = nct.prepare(tm, nct.GPTQConfig(**GPTQ))
    calibration_forward(tm, [torch.from_numpy(b) for b in batches])
    with objectives(tg, _dequant_port, controls=True) as sums:
        tm = nct.convert(tm)
    check_objectives(sums, jax_sums["gptq"])
    woq = [m for n, m in tm.named_modules()
           if n.endswith("_proj") or n == "lm_head"]
    assert len(woq) == 7 * 4 + 1 and all(type(m) is WOQLinear for m in woq)
    t, j = _val_nll(jm, tm, name)
    assert abs(t - j) <= NLL_TOL * j, (t, j)
    assert 1.0 < np.exp(t) < 10.0      # a trained model, not noise


def test_jax_prepare_convert_leaves_block_0_float():
    """The reference fault the port does not copy, shown on tiny_lm: JAX's
    ``prepare``/``convert`` leaves block 0's projections ``Linear``; the
    port's quantizes them."""
    from neural_compressor_tpu.layers.module_utils import get_module

    jm, tm = _float_pair("tiny_lm")
    batches = _batches("tiny_lm")[:1]
    jm = j_prepare(jm, JGPTQ(**GPTQ))
    j_calibration_forward(jm, [jnp.asarray(b) for b in batches])
    jm = j_convert(jm)
    tm = nct.prepare(tm, nct.GPTQConfig(**GPTQ))
    calibration_forward(tm, [torch.from_numpy(b) for b in batches])
    tm = nct.convert(tm)
    path = "model.layers.0.mlp.down_proj"
    assert type(get_module(jm, path)).__name__ == "Linear"
    assert type(tm.get_submodule(path)) is WOQLinear
    assert type(get_module(jm, "model.layers.1.mlp.down_proj")).__name__ \
        == "WOQLinear"
