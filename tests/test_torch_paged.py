"""The port's paged KV pool against the JAX package: paged decode attention
(K11's plain version), paged row writes (K12's plain version), the pool
itself and the int8 quantizer that fills it, on the same numpy inputs.

JAX runs ``paged_decode_attention`` and ``paged_write_rows`` as its own
tests run them on the CPU: the Pallas kernels in interpret mode. At page
sizes under 128 JAX writes rows with an XLA scatter instead; that is the
same function, and the port is held to both. ``chip_smoke.py`` holds the
CUDA kernels to the plain versions on the card.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_compressor_tpu.kernels import paged_attention as jpa
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu_torch.models import llama as tl

tpa = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "paged_attention")

torch.set_num_threads(2)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                       ).astype(jnp.bfloat16)


def _pool(rng, P, Hkv, page, D, quant):
    if quant:
        kp = jnp.asarray(rng.integers(-127, 128, (P, Hkv, page, D)), jnp.int8)
        vp = jnp.asarray(rng.integers(-127, 128, (P, Hkv, page, D)), jnp.int8)
        ks = jnp.asarray(rng.uniform(0.005, 0.02, (P, Hkv, page)),
                         jnp.float32)
        vs = jnp.asarray(rng.uniform(0.005, 0.02, (P, Hkv, page)),
                         jnp.float32)
        return kp, ks, vp, vs
    return _bf(rng, P, Hkv, page, D), None, _bf(rng, P, Hkv, page, D), None


def _both(kp, ks, vp, vs, bt):
    j = jl.PagedKVCache(kp, ks, vp, vs, jnp.asarray(bt))
    t = tl.PagedKVCache(_t(kp), None if ks is None else _t(ks), _t(vp),
                        None if vs is None else _t(vs), _t(bt))
    return j, t


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("H,Hkv,page,pmax", [
    (8, 8, 16, 4),      # MHA, one 4-page group
    (8, 2, 32, 4),      # GQA rep 4
    (16, 2, 16, 3),     # rep 8, a ragged group
    (4, 4, 16, 8),      # two 4-page groups: the TPU kernel's online softmax
])
def test_paged_attention_plain_matches_k11(quant, H, Hkv, page, pmax):
    """Ragged lengths, a zero-length slot, an idle slot on the trash page.
    Tolerance 1e-2 of max|out|: float32 sums in the TPU kernel against
    float64 here, and (pmax 8) its running max rescaling bf16 numerators."""
    D, B, P = 64, 5, 40
    rng = np.random.default_rng(H * page + pmax + quant)
    kp, ks, vp, vs = _pool(rng, P, Hkv, page, D, quant)
    bt = np.zeros((B, pmax), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B - 1):
        bt[b] = perm[b * pmax:(b + 1) * pmax]
    W = pmax * page
    lengths = np.array([1, W // 2 + 3, W, 0, W], np.int32)  # slot 4 idle
    q = _bf(rng, B, H, 1, D)
    jc, tc = _both(kp, ks, vp, vs, bt)
    jo = _f32(jpa.paged_decode_attention(q, jc, jnp.asarray(lengths)))
    to = tpa.paged_decode_attention(_t(q), tc, _t(lengths))
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == (B, H, 1, D)
    assert np.abs(_f32(to) - jo).max() <= 1e-2 * np.abs(jo).max()
    assert not _f32(to)[3].any() and not jo[3].any()   # zero length


def test_paged_attention_visits_at_most_the_table():
    # lengths past PMAX * page (idle slots running on) read PMAX pages
    rng = np.random.default_rng(3)
    kp, ks, vp, vs = _pool(rng, 6, 2, 16, 32, True)
    bt = np.array([[1, 2], [0, 0]], np.int32)
    _jc, tc = _both(kp, ks, vp, vs, bt)
    q = _t(_bf(rng, 2, 4, 1, 32))
    a = tpa.paged_decode_attention(q, tc, torch.tensor([40, 40]))
    b = tpa.paged_decode_attention(q, tc, torch.tensor([32, 32]))
    assert torch.equal(a, b)


def _write_case(quant, page, Hkv, D, same_row):
    rng = np.random.default_rng(page + quant)
    P, B = 6, 4
    kp, ks, vp, vs = _pool(rng, P, Hkv, page, D, quant)
    # slots 1 and 3 park on the trash page 0 (a duplicate pid); with
    # same_row they write the very same row, as idle engine slots do
    bt = np.array([[1, 2], [0, 0], [3, 4], [0, 0]], np.int32)
    last = 2 * page - 1
    pos = np.array([5, last if same_row else page + 2, page + 8,
                    last], np.int32)
    kn, vn = _bf(rng, B, Hkv, 1, D), _bf(rng, B, Hkv, 1, D)
    return kp, ks, vp, vs, bt, pos, kn, vn


def _assert_written_equal(jc, tc, quant, page, pos, kn, vn):
    """Every pool entry bit-equal, except the trash-page rows that slots 1
    and 3 wrote: several writes to page 0 in one launch leave it
    unspecified in both packages (the TPU kernel stages and writes back
    the whole page per slot, so one slot's block can undo another's row);
    there the port holds one of the rows written."""
    names = ["k_pages", "v_pages"] + (["k_scales", "v_scales"]
                                      if quant else [])
    for name in names:
        want = _f32(getattr(jc, name)).copy()
        got = _f32(getattr(tc, name))
        new = _t(kn if name[0] == "k" else vn)[[1, 3], :, 0]
        if quant:
            codes, scales = tl._kv_quant(new)
            new = scales if name.endswith("scales") else codes
        cands = _f32(new)
        for off in {int(pos[1]) % page, int(pos[3]) % page}:
            assert any(np.array_equal(got[0, :, off], c) for c in cands)
            want[0, :, off] = got[0, :, off] = 0
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("same_row", [False, True])
def test_paged_write_plain_matches_k12(quant, same_row):
    """The Pallas write kernel's envelope: D = 128, page 128, Hkv 8."""
    page, Hkv, D = 128, 8, 128
    kp, ks, vp, vs, bt, pos, kn, vn = _write_case(quant, page, Hkv, D,
                                                  same_row)
    jc, tc = _both(kp, ks, vp, vs, bt)
    jc = jpa.paged_write_rows(jc, kn, vn, jnp.asarray(pos))
    assert jc is not None                  # the kernel, not the fallback
    out = tpa.paged_write_rows(tc, _t(kn), _t(vn), _t(pos))
    assert out is tc                       # in place
    _assert_written_equal(jc, tc, quant, page, pos, kn, vn)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_write_plain_matches_xla_scatter(quant):
    """Page 16 is outside the write kernel's envelope: JAX's model writes
    through its XLA scatter (``_paged_write_row``), and so must the
    port's rows."""
    page, Hkv, D = 16, 2, 64
    kp, ks, vp, vs, bt, pos, kn, vn = _write_case(quant, page, Hkv, D,
                                                  False)
    jc, tc = _both(kp, ks, vp, vs, bt)
    assert jpa.paged_write_rows(jc, kn, vn, jnp.asarray(pos)) is None
    jc = jl._paged_write_row(jc, kn, vn, jnp.asarray(pos))
    tl._paged_write_row(tc, _t(kn), _t(vn), _t(pos))
    _assert_written_equal(jc, tc, quant, page, pos, kn, vn)


def test_paged_write_drops_rows_past_the_table():
    rng = np.random.default_rng(9)
    kp, ks, vp, vs = _pool(rng, 4, 2, 16, 32, True)
    bt = np.array([[1, 2], [3, 0]], np.int32)
    _jc, tc = _both(kp, ks, vp, vs, bt)
    before = [t.clone() for t in tc[:4]]
    tpa.paged_write_rows(tc, _t(_bf(rng, 2, 2, 1, 32)),
                         _t(_bf(rng, 2, 2, 1, 32)),
                         torch.tensor([32, 40], dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(before, tc[:4]))


@pytest.mark.parametrize("quantized", [False, True, "int8"])
def test_init_paged_pool_matches_jax(quantized):
    from neural_compressor_tpu_torch.models.llama import LLAMA_PRESETS

    kw = dict(LLAMA_PRESETS["llama-test"])
    jcfg = jl.LlamaConfig(**kw)
    tcfg = tl.LlamaConfig(**kw)
    jp = jl.init_paged_pool(jcfg, 7, 3, 64, page_size=16, quantized=quantized)
    tp = tl.init_paged_pool(tcfg, 7, 3, 64, page_size=16, quantized=quantized,
                            device="cpu")
    assert len(jp) == len(tp) == jcfg.num_hidden_layers
    for j, t in zip(jp, tp):
        assert t.page_size == j.page_size == 16
        for a, b in zip(j, t):
            assert (a is None) == (b is None)
            if a is not None:
                assert tuple(b.shape) == a.shape
                assert str(b.dtype).split(".")[-1] == a.dtype.name
                np.testing.assert_array_equal(_f32(b), _f32(a))


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int4"])
def test_init_paged_pool_other_formats_raise(fmt):
    """fp8 and int4 pools are built (``tests/test_torch_kv_engine.py`` holds
    them to JAX); what JAX refuses still raises: int4 pages whose size is
    not a multiple of 16, and a format name it does not know."""
    cfg = tl.LlamaConfig(**tl.LLAMA_PRESETS["llama-test"])
    bad = (dict(quantized="int4", page_size=8) if fmt == "int4"
           else dict(quantized="fp8", page_size=16))
    with pytest.raises(ValueError):
        tl.init_paged_pool(cfg, 4, 2, 32, device="cpu", **bad)
    pool = tl.init_paged_pool(cfg, 4, 2, 32, page_size=16, quantized=fmt,
                              device="cpu")
    jpool = jl.init_paged_pool(jl.LlamaConfig(**jl.LLAMA_PRESETS[
        "llama-test"]), 4, 2, 32, page_size=16, quantized=fmt)
    assert pool[0].page_size == jpool[0].page_size == 16
    for a, b in zip(jpool[0], pool[0]):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert tuple(b.shape) == tuple(a.shape)
        assert str(b.dtype).split(".")[-1] == a.dtype.name
        np.testing.assert_array_equal(_f32(b), _f32(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_kv_quant_int8_matches_jax(seed):
    """The staging-to-page commit quantizes whole pages with ``_kv_quant``:
    codes and scales bit-equal to JAX's, jitted as the engine runs it
    (inside ``jit`` XLA turns ``amax / 127`` into ``amax * f32(1/127)``;
    op by op it divides), including all-zero rows (scale 1) and a row
    whose codes land on ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, 4, 32, 64)) * 3).astype(np.float32)
    x[0, 1, 3] = 0.0
    x[0, 2, 5] = np.linspace(-127, 127, 64) / 127 * 2.5   # ties at amax/254
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    jc, js = jax.jit(lambda a: jl._kv_quant(a, fmt="int8"))(xj)
    tc, ts = tl._kv_quant(_t(xj))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_engine_stage_copy_quantizes_pages_like_jax():
    """The port engine's staging-row -> page commit on an int8 pool holds
    the codes and scales JAX's ``_stage_copy_fn`` computes (``_kv_quant``
    over the page's rows)."""
    from neural_compressor_tpu_torch.serving.engine import \
        ContinuousBatchingEngine

    cfg = tl.LlamaConfig(**dict(tl.LLAMA_PRESETS["llama-test"],
                                num_hidden_layers=1))
    m = tl.LlamaForCausalLM(cfg, device="cpu")
    m.kv_cache_quantized = True
    eng = ContinuousBatchingEngine(m, n_slots=2, max_len=64, paged=True,
                                   page_size=16, n_pages=5)
    rng = np.random.default_rng(4)
    rows = _bf(rng, 2, 2, 64, 32)
    eng.staging[0].k.copy_(_t(rows))
    eng.staging[0].v.copy_(_t(rows) * 2)
    eng._stage_copy(1, 3, 32)
    quant = jax.jit(lambda a: jl._kv_quant(a, fmt="int8"))
    jk, jks = quant(rows[1:2, :, 32:48])
    jv, jvs = quant((rows * 2)[1:2, :, 32:48])
    pool = eng.pools[0]
    np.testing.assert_array_equal(pool.k_pages[3].numpy(), np.asarray(jk[0]))
    np.testing.assert_array_equal(pool.k_scales[3].numpy(), np.asarray(jks[0]))
    np.testing.assert_array_equal(pool.v_pages[3].numpy(), np.asarray(jv[0]))
    np.testing.assert_array_equal(pool.v_scales[3].numpy(), np.asarray(jvs[0]))
