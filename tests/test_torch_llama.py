"""The port's Llama slice against the JAX package, weights carried across
with ``from_jax_params``.

JAX runs as its own tests run it on the CPU: projections through
``w4a8_matmul`` (the Pallas kernel in interpret mode) on the modular path,
decode attention through the Pallas kernel in interpret mode. The port
runs its plain kernel versions, with the fused decode path enabled.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from neural_compressor_tpu.generation import greedy_search as j_greedy
from neural_compressor_tpu.layers.module_utils import \
    named_modules as j_named_modules
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.quantization import RTNConfig as JRTNConfig
from neural_compressor_tpu.quantization import quantize as j_quantize
from neural_compressor_tpu.quantization import fuse as jfuse
from neural_compressor_tpu.quantization.save_load import _module_meta
import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch.models import llama as tl

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(model) -> dict:
    return {".".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model).flat_state()}


def _meta(model) -> dict:
    """Each quantized module's static attributes, as JAX's save_load
    records them (``from_jax_params`` needs them)."""
    return {path: _module_meta(m) for path, m in j_named_modules(model)
            if type(m).__name__ in ("WOQLinear", "W4A8Linear")}


def _port_cfg(jcfg) -> tl.LlamaConfig:
    return tl.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)
                             if f.name != "dtype"})


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# every projection inside the W4A8 envelope: K in {256, 512}, N % 256 == 0
SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
             max_position_embeddings=128)


def _jax_model(seed=0):
    return jl.LlamaForCausalLM(jl.LlamaConfig(**SMALL), nnx.Rngs(seed))


def _ids(n, vocab=512, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(
        np.int32)


def test_bf16_prefill_logits_match():
    jm = _jax_model()
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu",
                            meta=_meta(jm))
    ids = _ids(16)
    jy = _f32(jm(jnp.asarray(ids)))
    ty = _f32(tm(torch.from_numpy(ids)))
    assert ty.shape == jy.shape == (1, 16, 512)
    assert np.abs(ty - jy).max() <= 1e-2 * np.abs(jy).max()


def test_from_jax_params_carries_every_weight():
    jm = _jax_model(seed=3)
    flat = _flat(jm)
    tm = tl.from_jax_params(flat, _port_cfg(jm.cfg), device="cpu")
    state = tm.state_dict()
    assert set(state) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(_f32(state[k]),
                                      np.asarray(v, dtype=np.float32))


def _served_pair(seed=0):
    """The same RTN-int4 g128 model served by both packages: JAX quantizes,
    fuses and converts (tpu_strided on the CPU, modular path); the port
    takes its packed bytes and converts them to hopper_nk with fused
    decode."""
    jm = _jax_model(seed)
    j_quantize(jm, JRTNConfig(dtype="int4", group_size=128,
                              quant_lm_head=True))
    jfuse.fuse_for_serving(jm)
    jfuse.to_w4a8_serving(jm)
    assert jfuse.enable_fused_decode(jm) == 0  # nothing fuses off the TPU
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu",
                            meta=_meta(jm))
    assert nct.to_w4a8_serving(tm) == 2 * 4 + 1
    assert nct.enable_fused_decode(tm) == 2 and tm.model.norm_in_head
    return jm, tm


def test_served_prefill_and_decode_logits_match():
    jm, tm = _served_pair()
    cfg = jm.cfg
    seq = _ids(24, seed=1)
    P, T = 16, 32
    jc = jl.init_kv_cache(cfg, 1, T)
    tc = tl.init_kv_cache(tm.cfg, 1, T, device="cpu")
    ids = seq[:, :P]
    pos = np.arange(P, dtype=np.int32)[None]
    jy, jc = jm(jnp.asarray(ids), jnp.asarray(pos), jc, 0)
    with torch.no_grad():
        ty, tc = tm(torch.from_numpy(ids), torch.from_numpy(pos), tc, 0)
    assert np.abs(_f32(ty) - _f32(jy)).max() <= 5e-2 * np.abs(_f32(jy)).max()
    # 8 teacher-forced decode steps: JAX modular path vs the port's fused one
    for i in range(8):
        p = P + i
        tok = seq[:, p:p + 1]
        jy, jc = jm(jnp.asarray(tok), jnp.full((1, 1), p, jnp.int32), jc, p)
        with torch.no_grad():
            ty, tc = tm(torch.from_numpy(tok), torch.full((1, 1), p), tc, p)
        jy, ty = _f32(jy), _f32(ty)
        assert ty.shape == (1, 1, 512)
        assert np.abs(ty - jy).max() <= 5e-2 * np.abs(jy).max(), i


def test_served_rtn_on_both_sides_gives_the_same_bytes():
    """Quantizing the bf16 model with the port's own RTN gives the bytes
    JAX's RTN gives (then both serve the same weights)."""
    jm = _jax_model(seed=5)
    flat = _flat(jm)
    tm = tl.from_jax_params(flat, _port_cfg(jm.cfg), device="cpu")
    cfg_kw = dict(dtype="int4", group_size=128, quant_lm_head=True)
    j_quantize(jm, JRTNConfig(**cfg_kw))
    nct.quantize(tm, nct.RTNConfig(**cfg_kw))
    jq = _flat(jm)
    tq = tm.state_dict()
    packed = [k for k in jq if k.endswith((".packed", ".scales"))]
    assert len(packed) == 2 * (7 * 2 + 1)
    for k in packed:
        want = jq[k].view(np.int32) if jq[k].dtype == np.uint32 else jq[k]
        np.testing.assert_array_equal(tq[k].numpy(), want)


def _tiny(name):
    from neural_compressor_tpu.evaluation.train_tiny import load_tiny_model

    jm = load_tiny_model(name)
    if jm is None:
        pytest.fail(f"artifacts/{name} is missing")
    val = np.load(os.path.join(REPO, "artifacts", name, "corpus.npz"))["val"]
    return jm, val[0, :16][None].astype(np.int32)


@pytest.mark.parametrize("served", [False, True], ids=["bf16", "w4a8"])
@pytest.mark.parametrize("name", ["tiny_lm", "tiny_gqa"])
def test_greedy_tokens_equal_on_trained_checkpoints(name, served):
    """bf16: the float model on both sides. w4a8: RTN int4 g128 served,
    JAX on its modular CPU path, the port on its fused decode path; the
    two round bf16 in different places, so equal tokens hold on validation
    row 0 used here but not on every row (ROADMAP.md, Queue 3)."""
    jm, ids = _tiny(name)
    if served:
        j_quantize(jm, JRTNConfig(dtype="int4", group_size=128,
                                  quant_lm_head=True))
        jfuse.fuse_for_serving(jm)
        jfuse.to_w4a8_serving(jm)
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=24))
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu",
                            meta=_meta(jm))
    if served:
        nct.to_w4a8_serving(tm)
        assert nct.enable_fused_decode(tm) == jm.cfg.num_hidden_layers
    got = nct.generate(tm, torch.from_numpy(ids), max_new_tokens=24)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("served", [False, True], ids=["bf16", "w4a8"])
def test_greedy_search_b2_matches_jax(served):
    """B = 2 prompts through ``greedy_search``: every decode step goes
    through the batched attention kernel (K7's plain version) in the port,
    JAX's batch through its own dispatch (K7 needs B*Hkv >= 16, so here
    its XLA attention). Tokens equal for 6 new tokens on this seed."""
    if served:
        jm, tm = _served_pair(seed=2)
    else:
        jm = _jax_model(seed=2)
        tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg),
                                device="cpu", meta=_meta(jm))
    ids = np.concatenate([_ids(8, seed=3), _ids(8, seed=4)])
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), max_new_tokens=6))
    got = nct.greedy_search(tm, torch.from_numpy(ids), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_off_path_raises():
    jm = _jax_model()
    tm = tl.from_jax_params(_flat(jm), _port_cfg(jm.cfg), device="cpu",
                            meta=_meta(jm))
    ids = torch.from_numpy(_ids(4))
    with pytest.raises(NotImplementedError, match="sample"):
        nct.generate(tm, ids, do_sample=True)
    with pytest.raises(NotImplementedError, match="beam_search"):
        nct.generate(tm, ids, num_beams=2)
    with pytest.raises(NotImplementedError, match="paged_write_window"):
        pool = tl.init_paged_pool(tm.cfg, 3, 1, 32, page_size=16,
                                  device="cpu")
        tm(ids, torch.arange(4)[None], pool, torch.tensor([0]))
    with pytest.raises(NotImplementedError, match="QuantKVCache"):
        tl.init_kv_cache(tm.cfg, 1, 8, quantized=True, device="cpu")
    with pytest.raises(NotImplementedError, match="_rope"):
        tl.LlamaForCausalLM(tl.LlamaConfig(**dict(
            SMALL, rope_style="interleaved_partial")), device="cpu")
