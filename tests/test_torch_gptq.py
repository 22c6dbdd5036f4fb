"""GPTQ in the port against the JAX package: the column sweep
(``gptq_quantize_matrix``) on the same seeded W and H in every option,
the Hessian observer, ``gptq_layer_to_woq`` and the calibration capture.

The two sweeps take the same steps in float32, but the damped Cholesky
factor and its inverse come from different linear-algebra libraries, so
the QDQ values agree to float32 ulps, not bit for bit; a code that sits
on a rounding tie can flip, and in a dynamic group that flip moves the
error fed to the row's later columns. Stated tolerances: codes equal in at
least ``CODE_SHARE``, scales within ``SCALE_TOL`` relative in at least
``SCALE_SHARE`` of them (a flipped code moves its row's later dynamic
group scales), GPTQ's objective tr((W-Q)ᵀH(W-Q)) within
``OBJ_TOL`` relative (one flipped code in a 128-row matrix can cascade
along its row to 1.9e-3; ``test_gptq_objective_at_width`` holds a
512-column matrix to 1e-3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_compressor_tpu.algorithms import gptq as jgptq
from neural_compressor_tpu.algorithms.calib_capture import \
    find_target_blocks as j_find_blocks
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.ops.qtensor import \
    quantize_with_scale as j_quantize_with_scale
from neural_compressor_tpu.quantization.config import GPTQConfig as JGPTQ
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.algorithms import gptq as tgptq
from neural_compressor_tpu_torch.algorithms.calib_capture import (
    CaptureAbort, calibration_forward, find_target_blocks)
from neural_compressor_tpu_torch.layers import WOQLinear
from neural_compressor_tpu_torch.ops import qdq_tensor, unpack_to_codes
from neural_compressor_tpu_torch.ops.qtensor import quantize_with_scale

from test_torch_woq_llama import _f32, _flat, _port_cfg
from neural_compressor_tpu_torch.models import llama as tl

torch.set_num_threads(2)

CODE_SHARE = 0.995
SCALE_TOL = 1e-5
SCALE_SHARE = 0.99
OBJ_TOL = 5e-3


def _problem(K=256, N=128, seed=0):
    """A seeded weight and the Hessian 2XᵀX/n of correlated inputs."""
    rng = np.random.default_rng(seed)
    mix = np.eye(K) + 0.5 * rng.standard_normal((K, K))
    X = (rng.standard_normal((512, K)) @ mix).astype(np.float32)
    W = rng.standard_normal((K, N)).astype(np.float32)
    H = (2.0 * X.T.astype(np.float64) @ X / 512).astype(np.float32)
    return W, H


def _objective(W, Q, H) -> float:
    D = W.astype(np.float64) - np.asarray(Q, dtype=np.float64)
    return float((D * (H.astype(np.float64) @ D)).sum())


OPTIONS = {"default": {}, "act_order": dict(act_order=True),
           "static_groups": dict(static_groups=True),
           "hybrid_order": dict(hybrid_order=True),
           "fp8_aware": dict(fp8_aware=True), "nf4": dict(wdtype="nf4"),
           "fp4": dict(wdtype="fp4"), "asym": dict(sym=False),
           "asym_act_order": dict(sym=False, act_order=True),
           "per_channel": dict(group_size=-1),
           "panel_32": dict(block_size=32), "int2": dict(bits=2),
           "percdamp": dict(percdamp=0.1)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_gptq_sweep_matches_jax(opt, seed):
    kw = dict(dict(bits=4, group_size=32, sym=True, block_size=64),
              **OPTIONS[opt])
    W, H = _problem(seed=seed)
    jq, js, jz, jp, jf = jgptq.gptq_quantize_matrix(
        jnp.asarray(W), jnp.asarray(H), **kw)
    tq, ts, tz, tp, tf = tgptq.gptq_quantize_matrix(
        torch.from_numpy(W), torch.from_numpy(H), **kw)
    jq, tq = np.asarray(jq), tq.numpy()
    js, ts = np.asarray(js), ts.numpy()
    assert tq.shape == W.shape and ts.shape == js.shape
    K = W.shape[0]
    G = kw["group_size"] if kw["group_size"] > 0 else K
    if "wdtype" in kw:
        # codebook QDQ values: the same entry times the same scale
        same = np.abs(tq - jq) <= SCALE_TOL * np.abs(jq).max()
    else:
        scheme = "sym" if kw["sym"] else "asym"
        jz_ = None if kw["sym"] else jz
        tz_ = None if kw["sym"] else tz
        jc = np.asarray(j_quantize_with_scale(jnp.asarray(jq), jnp.asarray(js),
                                              jz_, kw["bits"], G, scheme))
        tc = quantize_with_scale(torch.from_numpy(tq), torch.from_numpy(ts),
                                 tz_, kw["bits"], G, scheme).numpy()
        same = jc == tc
        if not kw["sym"]:
            assert (np.asarray(jz) == tz.numpy()).mean() >= CODE_SHARE
    assert same.mean() >= CODE_SHARE, same.mean()
    rel = np.abs(ts - js) / np.abs(js)
    assert (rel <= SCALE_TOL).mean() >= SCALE_SHARE
    if kw.get("hybrid_order"):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        # Wq stays in GAR's row order: the objective on the permuted rows
        W, H = W[jp], H[jp][:, jp]
    else:
        assert tp is None and jp is None
    assert float(tf) == float(jf)
    oj, ot = _objective(W, jq, H), _objective(W, tq, H)
    assert abs(ot - oj) <= OBJ_TOL * oj
    # and GPTQ beats RTN on its own objective
    scheme = "sym" if kw["sym"] else "asym"
    if "wdtype" not in kw and not kw.get("fp8_aware"):
        rtn = qdq_tensor(torch.from_numpy(W), bits=kw["bits"], group_size=G,
                         scheme=scheme, out_dtype=torch.float32).numpy()
        assert ot < _objective(W, rtn, H)


def test_gptq_objective_at_width():
    """A wider matrix (512 rows of 512 columns), default options: the
    objective within 1e-3 relative of JAX's."""
    W, H = _problem(K=512, N=512, seed=2)
    kw = dict(bits=4, group_size=128, sym=True, block_size=128)
    jq = np.asarray(jgptq.gptq_quantize_matrix(jnp.asarray(W), jnp.asarray(H),
                                               **kw)[0])
    tq = tgptq.gptq_quantize_matrix(torch.from_numpy(W), torch.from_numpy(H),
                                    **kw)[0].numpy()
    oj, ot = _objective(W, jq, H), _objective(W, tq, H)
    assert abs(ot - oj) <= 1e-3 * oj


@pytest.mark.parametrize("G", [32, 128])
def test_gptq_without_error_feedback_is_rtn(G):
    """GPTQ's sweep on H = I feeds no error forward (the damped Cholesky
    factor of a multiple of I is diagonal), so its values are RTN's bit
    for bit, in the port as in JAX: the tiny checkpoints' flow tests let
    RTN stand for both wrong calibrations, RTN and GPTQ without error
    feedback."""
    W, _H = _problem(seed=3)
    eye = np.eye(W.shape[0], dtype=np.float32)
    kw = dict(bits=4, group_size=G, sym=True, block_size=128)
    tq = tgptq.gptq_quantize_matrix(torch.from_numpy(W),
                                    torch.from_numpy(eye), **kw)[0].numpy()
    jq = np.asarray(jgptq.gptq_quantize_matrix(jnp.asarray(W),
                                               jnp.asarray(eye), **kw)[0])
    rtn = qdq_tensor(torch.from_numpy(W), bits=4, group_size=G,
                     scheme="sym", out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(tq, rtn)
    np.testing.assert_array_equal(jq, rtn)


def test_hessian_observer_matches_jax():
    """H = 2·XᵀX/n over every call's rows, float32; the inner module
    still runs."""
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 5, 64)).astype(np.float32) for _ in range(3)]
    inner = torch.nn.Identity()
    obs = tgptq.HessianObserver(inner, 64)
    xtx, n = jnp.zeros((64, 64)), jnp.array(0.0)
    for x in xs:
        np.testing.assert_array_equal(obs(torch.from_numpy(x)).numpy(), x)
        xtx, n = jgptq._xtx_update(xtx, n, jnp.asarray(x))
    want = np.asarray(2.0 * xtx / n)
    got = obs.hessian().numpy()
    assert float(obs.count) == 30.0
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert "xtx" in dict(obs.named_buffers())


@pytest.mark.parametrize("case", ["ragged", "hybrid_order", "nf4",
                                  "fp8_aware"])
def test_gptq_layer_to_woq_matches_jax(case):
    """``gptq_layer_to_woq``: ragged K padded with dead rows, GAR's row
    permutation recorded on the packed weight, codebook codes, fp8_aware's
    recorded scale; the layer's output within 1e-2 of max|y| of JAX's
    (bf16 activations) and codes equal in ``CODE_SHARE``."""
    K = 200 if case == "ragged" else 256
    W, H = _problem(K=K, N=128, seed=3)
    kw = dict(group_size=32, block_size=64, quant_lm_head=False)
    if case == "hybrid_order":
        kw["hybrid_order"] = True
    if case == "nf4":
        kw["dtype"] = "nf4"
    if case == "fp8_aware":
        kw["fp8_aware"] = True
    jlin = jgptq.gptq_layer_to_woq(jnp.asarray(W), jnp.asarray(H), JGPTQ(**kw))
    tlin = tgptq.gptq_layer_to_woq(torch.from_numpy(W), torch.from_numpy(H),
                                   nct.GPTQConfig(**kw))
    assert type(tlin) is WOQLinear and tlin.layout == jlin.layout
    jpw = jlin.packed_weight()
    tpw = tlin.packed_weight()
    from neural_compressor_tpu.ops.packing import unpack_to_codes as j_codes

    share = (np.asarray(j_codes(jpw)) == unpack_to_codes(tpw).numpy()).mean()
    assert share >= CODE_SHARE
    if case == "hybrid_order":
        np.testing.assert_array_equal(tpw.perm.numpy(), np.asarray(jpw.perm))
    if case == "fp8_aware":
        assert float(tlin.scale_bf16_to_fp8) == float(
            jlin.scale_bf16_to_fp8[...])
    x = np.random.default_rng(4).standard_normal((3, K)).astype(np.float32)
    ty = _f32(tlin(torch.from_numpy(x)))
    jy = _f32(jlin(jnp.asarray(x)))
    assert np.abs(ty - jy).max() <= 1e-2 * np.abs(jy).max()
    if case == "hybrid_order":
        with pytest.raises(ValueError, match="hybrid_order"):
            tgptq.gptq_layer_to_woq(torch.from_numpy(W[:200]),
                                    torch.from_numpy(H[:200, :200]),
                                    nct.GPTQConfig(**kw))


def test_find_target_blocks_and_capture_match_jax():
    """The block list the JAX package finds, and the capture wrapper:
    block 0's inputs recorded, the forward stopped, the module restored."""
    jm = jl.LlamaForCausalLM.from_preset("llama-test", seed=0)
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu")
    assert find_target_blocks(tm) == j_find_blocks(jm)
    from neural_compressor_tpu_torch.algorithms.calib_capture import \
        CalibCaptureState

    st = CalibCaptureState(tm, *find_target_blocks(tm))
    layer0 = tm.model.layers[0]
    st.attach()
    with pytest.raises(CaptureAbort):
        tm(torch.zeros((1, 4), dtype=torch.int64))
    calibration_forward(tm, [torch.zeros((2, 6), dtype=torch.int64)])
    got = st.detach()
    assert tm.model.layers[0] is layer0
    assert [tuple(a[0].shape) for a, _k in got] == [(1, 4, 128), (2, 6, 128)]


def test_gptq_registered_and_hybrid_config_refuses_what_jax_refuses():
    from neural_compressor_tpu.quantization.config import \
        HybridGPTQConfig as JHybrid
    from neural_compressor_tpu_torch.algorithms import get_algo_entry
    from neural_compressor_tpu_torch.common.config import config_registry

    assert get_algo_entry("gptq") is tgptq.gptq_entry
    assert get_algo_entry("hybrid_gptq").__name__ == "hybrid_gptq_entry"
    assert config_registry.get_config_cls_by_name("hybrid_gptq") is \
        nct.HybridGPTQConfig
    assert config_registry._configs["gptq"]["priority"] == 60
    assert config_registry._configs["hybrid_gptq"]["priority"] == 7
    for bad in (dict(use_sym=False), dict(dtype="int8"), dict(bits=2)):
        with pytest.raises(ValueError):
            JHybrid(**bad)
        with pytest.raises(ValueError):
            nct.HybridGPTQConfig(**bad)
    cfg = nct.HybridGPTQConfig(quant_lm_head=True)
    assert (cfg.group_size, cfg.use_sym, cfg.act_dtype) == (128, True, "int8")
