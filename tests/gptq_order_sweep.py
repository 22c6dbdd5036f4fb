"""GPTQ on the trained checkpoints over every calibration order, in the
port and in the JAX package: the spread that the tolerances of
``test_torch_hybrid_gptq.py`` and ``test_torch_gptq_tiny.py`` rest on.

For each of the 12 distinct orders of the 4 calibration batches (the
first two commute in the Hessian's sum), both packages calibrate their
own copy of the float checkpoint and the script prints the mean
validation NLL of each and GPTQ's objective of each (summed over every
quantized matrix, each under its package's own Hessian), with RTN's
objective under the port's Hessians. Then two wrong calibrations of the
port, served the way the configuration serves: RTN, and GPTQ without
error feedback (every matrix's Hessian replaced by I, the lm_head's too). A summary line a checkpoint
gives the largest NLL and objective gaps over the orders, the gap of the
order-means, and the controls' NLL and objective against JAX's GPTQ in
the tests' order (0, 1, 2, 3).

Run on the CPU from the repository's root, a few minutes a configuration:

    JAX_PLATFORMS=cpu python tests/gptq_order_sweep.py [gptq] [hybrid]

"gptq" is ``GPTQConfig`` at group size 32 through ``prepare``/``convert``
in the port, "hybrid" ``HybridGPTQConfig`` at group size 128 through
``quantize(run_fn=...)`` and served on "tpu_strided" W4A8 words.
"""

import itertools
import logging
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (JAX on the CPU, as the tests run it)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from neural_compressor_tpu.algorithms import gptq as jg  # noqa: E402
from neural_compressor_tpu.algorithms.calib_capture import \
    calibration_forward as j_calibration_forward  # noqa: E402
from neural_compressor_tpu.quantization import GPTQConfig as JGPTQ  # noqa: E402
from neural_compressor_tpu.quantization import \
    HybridGPTQConfig as JHybrid  # noqa: E402
from neural_compressor_tpu.quantization import \
    quantize as j_quantize  # noqa: E402
import neural_compressor_tpu_torch as nct  # noqa: E402
from neural_compressor_tpu_torch.algorithms import gptq as tg  # noqa: E402
from neural_compressor_tpu_torch.algorithms.calib_capture import \
    calibration_forward  # noqa: E402

from test_torch_hybrid_gptq import (GPTQ, HYBRID, _batches,  # noqa: E402
                                    _dequant_jax, _dequant_port, _float_pair,
                                    _val_nll, objectives)

torch.set_num_threads(2)
NAMES = ("tiny_lm", "tiny_gqa")
ORDERS = [o for o in itertools.permutations(range(4)) if o[0] < o[1]]


def _port_calibrate(tm, which, batches):
    tb = [torch.from_numpy(b) for b in batches]
    if which == "hybrid":
        nct.quantize(tm, nct.HybridGPTQConfig(**HYBRID),
                     run_fn=lambda m: calibration_forward(m, tb))
        return tm
    tm = nct.prepare(tm, nct.GPTQConfig(**GPTQ))
    calibration_forward(tm, tb)
    return nct.convert(tm)


def _jax_calibrate(jm, which, batches):
    cfg = JHybrid(**HYBRID) if which == "hybrid" else JGPTQ(**GPTQ)
    j_quantize(jm, cfg, run_fn=lambda m: j_calibration_forward(
        m, [jnp.asarray(b) for b in batches]))


def _rtn(tm, which):
    kw = HYBRID if which == "hybrid" else GPTQ
    nct.quantize(tm, nct.RTNConfig(dtype="int4", group_size=kw["group_size"],
                                   quant_lm_head=True))
    if which == "hybrid":
        nct.to_w4a8_serving(tm, s4=False)
    return tm


def sweep(which: str, name: str) -> None:
    batches = _batches(name)
    rows = []
    for order in ORDERS:
        calib = [batches[i] for i in order]
        jm, tm = _float_pair(name)
        with objectives(jg, _dequant_jax) as js:
            _jax_calibrate(jm, which, calib)
        with objectives(tg, _dequant_port, controls=True) as ts:
            tm = _port_calibrate(tm, which, calib)
        t, j = _val_nll(jm, tm, name)
        rows.append((t, j, ts["gptq"], js["gptq"], ts["rtn"]))
        print(f"{which} {name} order {order}: NLL port {t:.6f} jax {j:.6f} "
              f"({(t - j) / j:+.3e}); objective port {ts['gptq']:.5e} jax "
              f"{js['gptq']:.5e} ({(ts['gptq'] - js['gptq']) / js['gptq']:+.3e})"
              f"; RTN objective {ts['rtn'] / js['gptq']:.3f}x jax",
              flush=True)
    a = np.array(rows)
    t_nll, j_nll, t_obj, j_obj, r_obj = a.T
    nll_gap = np.abs(t_nll - j_nll) / j_nll
    obj_gap = np.abs(t_obj - j_obj) / j_obj
    j0 = j_nll[0]
    jm, tm = _float_pair(name)
    rtn_nll = _val_nll(jm, _rtn(tm, which), name)[0]
    jm, tm = _float_pair(name)
    real = tg.gptq_layer_to_woq
    tg.gptq_layer_to_woq = lambda kernel, H, cfg, bias=None: real(
        kernel, torch.eye(H.shape[0], device=H.device), cfg, bias=bias)
    try:
        nf_nll = _val_nll(jm, _port_calibrate(tm, which, batches), name)[0]
    finally:
        tg.gptq_layer_to_woq = real
    print(f"{which} {name} SUMMARY over {len(ORDERS)} orders: NLL gap max "
          f"{nll_gap.max():.3e}, order-means {t_nll.mean():.6f} / "
          f"{j_nll.mean():.6f} ({(t_nll.mean() - j_nll.mean()) / j_nll.mean():+.3e}), "
          f"JAX's own NLL range {(j_nll.max() - j_nll.min()) / j_nll.min():.3e}; "
          f"objective gap max {obj_gap.max():.3e}; RTN objective "
          f"{(r_obj / j_obj).min():.3f}-{(r_obj / j_obj).max():.3f}x jax; "
          f"against JAX's GPTQ NLL in order (0, 1, 2, 3): RTN "
          f"{(rtn_nll - j0) / j0:+.3e}, no error feedback "
          f"{(nf_nll - j0) / j0:+.3e}", flush=True)


def main(argv) -> None:
    logging.disable(logging.INFO)
    for which in argv or ("gptq", "hybrid"):
        if which not in ("gptq", "hybrid"):
            sys.exit(f"unknown configuration {which!r}: gptq or hybrid")
        for name in NAMES:
            sweep(which, name)


if __name__ == "__main__":
    main(sys.argv[1:])
