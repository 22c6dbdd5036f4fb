"""The plain versions of the flag-selected decode kernels against the JAX
package's Pallas kernels, on the same numpy inputs: K15 (v1 paged
attention), K16 (the in-kernel cache write, bf16 and int8, and the
bulk-copied caches), K17 (o + MLP in one launch) and K18 (attention inside
the o-projection).

JAX runs its kernels as its own tests run them on the CPU, in interpret
mode: ``pl.pallas_call`` is patched inside each test to interpret (the
kernels with no ``interpret`` argument, K16's hbm, K17 and K18, are reached
this way), and K16's hbm kernel also gets the identity for
``pltpu.with_memory_space_constraint``, which has no CPU lowering.
``chip_smoke.py`` holds the CUDA kernels to these plain versions on the
card.

Tolerances: an attention output is a convex combination of V rows, so a
float32 sum (JAX) and a float64 sum rounded once (the port) differ by less
than a bf16 rounding of the output plus one bf16 ulp of a probability on
each term: ``2**-7 * max|v|``. A W4A8 GEMV output differs by its bf16
rounding, plus, where an activation code sits at a rounding tie in one
package and not the other, one code step on one term of the sum:
``2**-7 * max|y|``. Codes and scales that are written are bit-equal.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from neural_compressor_tpu.kernels import decode_attention as jda
from neural_compressor_tpu.kernels import fused_matvec as jfm
from neural_compressor_tpu.kernels import omlp_matvec as jom
from neural_compressor_tpu.kernels import paged_attention as jpa
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu.ops.packing import pack_codes_u4k
from neural_compressor_tpu_torch import kernels as tk
from neural_compressor_tpu_torch.kernels import omlp_matvec as tom
from neural_compressor_tpu_torch.ops import kv_quant as kq
from neural_compressor_tpu_torch.ops.packing import pack_codes_hopper

# the modules (the package exports functions of the same names)
tda = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "decode_attention")
tpa = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "paged_attention")

torch.set_num_threads(2)

ATT_TOL = 2.0 ** -7     # times max|v|: see the module docstring
GEMV_TOL = 2.0 ** -7    # times max|y|


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode, whatever their caller
    passes; ``with_memory_space_constraint`` as the identity."""
    orig = pl.pallas_call

    def call(*a, **k):
        return orig(*a, **{**k, "interpret": True})

    monkeypatch.setattr(pl, "pallas_call", call)
    monkeypatch.setattr(pltpu, "with_memory_space_constraint",
                        lambda x, _space: x)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _t(a):
    """numpy/JAX array -> torch (bf16 through a uint16 view)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _j(t):
    """torch -> JAX (bf16 and fp8 through their bits)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(
            jnp.float8_e4m3fn))
    return jnp.asarray(t.numpy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)


def _att_ok(got, want, v):
    err = np.abs(_f32(got) - _f32(want)).max()
    assert err <= ATT_TOL * np.abs(_f32(v)).max(), err


# ---------------------------------------------------------------------------
# K16: the in-kernel write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,Hkv,pos", [(4, 4, 0), (4, 4, 37), (8, 2, 63),
                                       (4, 4, 64)])
def test_k16_write_bf16_matches_kernel(interpret, H, Hkv, pos):
    """bf16: the row written at pos (none at pos >= T) bit for bit, the
    output within the attention tolerance."""
    rng = np.random.default_rng(pos + H)
    D, T = 128, 64
    q, kn, vn = _bf(rng, 1, H, D), _bf(rng, 1, Hkv, D), _bf(rng, 1, Hkv, D)
    kc, vc = _bf(rng, 1, Hkv, T, D), _bf(rng, 1, Hkv, T, D)
    jk, jv, jo = jda._decode_attn_impl(
        jnp.int32(pos), _j(q), _j(kn[:, :, None]), _j(vn[:, :, None]),
        _j(kc), _j(vc), interpret=True)
    tkc, tvc = kc.clone(), vc.clone()
    to = tk.decode_attn_write_plain(q, kn, vn, tkc, None, tvc, None,
                                    torch.tensor([pos], dtype=torch.int32))
    np.testing.assert_array_equal(_f32(tkc), _f32(jk))
    np.testing.assert_array_equal(_f32(tvc), _f32(jv))
    _att_ok(to, jo[:, :, 0], vc)


@pytest.mark.parametrize("pos", [0, 29, 63, 64])
def test_k16_write_int8_codes_and_scales_bit_equal(interpret, pos):
    """int8: the TPU kernel's own rule (``max(amax, 1e-6) / 127``, clip to
    +-127) on codes and scales bit for bit, an all-zero row included (where
    ``_kv_quant`` would write scale 1), and the quantized row attended."""
    rng = np.random.default_rng(100 + pos)
    H, Hkv, D, T = 8, 4, 128, 64
    q, kn, vn = _bf(rng, 1, H, D), _bf(rng, 1, Hkv, D), _bf(rng, 1, Hkv, D)
    kn[0, 1] = 0                                  # an all-zero new row
    rows_k, rows_v = _bf(rng, 1, Hkv, T, D), _bf(rng, 1, Hkv, T, D)
    kc, ks = kq.kv_quant(rows_k, "int8")
    vc, vs = kq.kv_quant(rows_v, "int8")
    out = jda._decode_attn_quant_impl(
        jnp.int32(pos), _j(q), _j(kn[:, :, None]), _j(vn[:, :, None]),
        _j(kc), _j(ks), _j(vc), _j(vs), interpret=True)
    cache = [t.clone() for t in (kc, ks, vc, vs)]
    to = tk.decode_attn_write_plain(q, kn, vn, *cache,
                                    torch.tensor([pos], dtype=torch.int32))
    for got, want in zip(cache, out[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if pos < T:
        assert float(cache[1][0, 1, pos]) == np.float32(1e-6) * np.float32(
            1 / 127)
        assert float(kq.kv_quant(kn[:, 1:2, None], "int8")[1].reshape(-1)[0]) \
            == 1.0                                # _kv_quant's rule differs
    _att_ok(to, out[4][:, :, 0], rows_v)


def test_k16_hbm_matches_kernel(interpret):
    """The bulk-copy kernel: K5's function over the caches holding the new
    row (the port writes it first; the TPU kernel folds it in)."""
    rng = np.random.default_rng(7)
    H, Hkv, D, T = 8, 2, 128, 64
    for pos in (0, 40, 63):
        q, kn, vn = (_bf(rng, 1, H, D), _bf(rng, 1, Hkv, D),
                     _bf(rng, 1, Hkv, D))
        kc, vc = _bf(rng, 1, Hkv, T, D), _bf(rng, 1, Hkv, T, D)
        jo = jda._decode_attn_ro_hbm_impl(
            jnp.int32(pos), _j(q), _j(kn[:, :, None]), _j(vn[:, :, None]),
            _j(kc), _j(vc))
        kc[:, :, pos], vc[:, :, pos] = kn, vn
        to = tk.decode_attn_hbm_plain(q, kc, vc,
                                      torch.tensor([pos], dtype=torch.int32))
        _att_ok(to, jo[:, :, 0], vc)
        np.testing.assert_array_equal(
            _f32(to), _f32(tk.decode_attn_plain(q, kc, vc, pos)))


def test_k16_switches_select_the_kernels(monkeypatch):
    """``decode_attention`` at B=1 under each switch reaches the wrapper
    the switch names, on the CPU through its plain version."""
    seen = []
    for name in ("decode_attn", "decode_attn_hbm", "decode_attn_write"):
        fn = getattr(tda, name)
        monkeypatch.setattr(tda, name, functools.partial(
            lambda f, n, *a: (seen.append(n), f(*a))[1], fn, name))
    rng = np.random.default_rng(3)
    q = _bf(rng, 1, 4, 1, 64)
    kn, vn = _bf(rng, 1, 2, 1, 64), _bf(rng, 1, 2, 1, 64)
    for mode, space in (("outside", "vmem"), ("outside", "pin"),
                        ("outside", "hbm"), ("kernel", "vmem")):
        monkeypatch.setattr(tda, "_WRITE_MODE", mode)
        monkeypatch.setattr(tda, "_RO_CACHE_SPACE", space)
        kc, vc = _bf(rng, 1, 2, 16, 64), _bf(rng, 1, 2, 16, 64)
        tda.decode_attention(q, kn, vn, kc, vc, torch.tensor([5]))
    assert seen == ["decode_attn", "decode_attn", "decode_attn_hbm",
                    "decode_attn_write"]
    with pytest.raises(ValueError):
        tda.set_cache_write_mode("inside")
    with pytest.raises(ValueError):
        tda.set_ro_cache_space("smem")


# ---------------------------------------------------------------------------
# K15: v1 paged attention
# ---------------------------------------------------------------------------

def _pool(rng, fmt, P, Hkv, page, D, unit_scales=False):
    rows = [_bf(rng, P, Hkv, page, D) for _ in range(2)]
    if fmt == "bf16":
        return rows[0], None, rows[1], None
    kc, ks = kq.kv_quant(rows[0], fmt)
    vc, vs = kq.kv_quant(rows[1], fmt)
    if unit_scales:
        ks, vs = torch.ones_like(ks), torch.ones_like(vs)
    return kc, ks, vc, vs


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("rep", [1, 4])
def test_k15_plain_matches_v1_kernel(interpret, monkeypatch, fmt, rep):
    """Mixed lengths (0, one row, a page boundary, a page and one, the
    whole padded table) over pages of 16 rows, a block table with padded
    entries past each slot's pages, through JAX's ``paged_decode_attention``
    under ``set_paged_v2(False)``."""
    monkeypatch.setattr(jpa, "_PAGED_V2", False)
    rng = np.random.default_rng(11 + rep)
    Hkv, D, page, PMAX, P = 2, 64, 16, 5, 24
    H = Hkv * rep
    lengths = np.array([0, 1, 16, 17, 57, 80], np.int32)
    B = len(lengths)
    kp, ks, vp, vs = _pool(rng, fmt, P, Hkv, page, D)
    bt = np.zeros((B, PMAX), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b, n in enumerate(lengths):
        used = -(-int(n) // page)
        bt[b, :used] = perm[:used]
        perm = np.roll(perm, -used)
        bt[b, used:] = rng.integers(0, P, PMAX - used)   # padding entries
    q = _bf(rng, B, H, 1, D)
    cache = jl.PagedKVCache(_j(kp), None if ks is None else _j(ks), _j(vp),
                            None if vs is None else _j(vs), jnp.asarray(bt))
    jo = jpa.paged_decode_attention(_j(q), cache, jnp.asarray(lengths))
    to = tk.paged_attn_v1_plain(q[:, :, 0], kp, ks, vp, vs,
                                torch.from_numpy(bt),
                                torch.from_numpy(lengths))
    assert not _f32(to)[0].any()                  # length 0: zeros
    vrows = vp.to(torch.float32) * (1 if vs is None else vs[..., None])
    _att_ok(to, jo[:, :, 0], vrows)


def test_k15_is_not_k11():
    """Where the running max moves from page to page, v1's unnormalised
    bf16 probabilities round apart from K11's one-pass ones: the two plain
    versions differ, each by less than the tolerance JAX's own
    test_paged_v2_matches_v1 allows between its kernels (2e-2)."""
    rng = np.random.default_rng(5)
    Hkv, D, page, PMAX, P, B = 2, 64, 16, 8, 40, 4
    kp, _ks, vp, _vs = _pool(rng, "bf16", P, Hkv, page, D)
    # growing keys make the max move at every page
    kp = (kp.float() * torch.linspace(0.2, 3, page)[None, None, :, None]).to(
        torch.bfloat16)
    bt = torch.from_numpy(rng.permutation(np.arange(1, P))[:B * PMAX]
                          .reshape(B, PMAX).astype(np.int32))
    lengths = torch.tensor([128, 100, 77, 40], dtype=torch.int32)
    q = _bf(rng, B, 2 * Hkv, D)
    v1 = tk.paged_attn_v1_plain(q, kp, None, vp, None, bt, lengths)
    v2 = tk.paged_attn_plain(q, kp, None, vp, None, bt, lengths)
    diff = np.abs(_f32(v1) - _f32(v2))
    assert diff.max() > 0
    assert diff.max() <= 2e-2


def test_k15_switch_and_its_limits(monkeypatch):
    """v1 under ``set_paged_v2(False)`` for bf16/int8/fp8 pools; int4 pools
    stay on K11; a window or softcap raises, as in JAX."""
    from neural_compressor_tpu_torch.models import llama as tl

    calls = []
    for name in ("paged_attn", "paged_attn_v1"):
        fn = getattr(tpa, name)
        monkeypatch.setattr(tpa, name, functools.partial(
            lambda f, n, *a, **k: (calls.append(n), f(*a, **k))[1], fn,
            name))
    cfg = tl.LlamaConfig(**{**tl.LLAMA_PRESETS["llama-test"]})
    q = torch.zeros(2, cfg.num_attention_heads, 1, cfg.head_dim,
                    dtype=torch.bfloat16)
    lengths = torch.tensor([3, 0], dtype=torch.int32)
    tpa.set_paged_v2(False)
    try:
        for fmt in (False, "int8", "int4"):
            pool = tl.init_paged_pool(cfg, 4, 2, 32, page_size=16,
                                      quantized=fmt, device="cpu")[0]
            tpa.paged_decode_attention(q, pool, lengths)
            if fmt != "int4":
                with pytest.raises(NotImplementedError,
                                   match="set_paged_v2"):
                    tpa.paged_decode_attention(q, pool, lengths, window=8)
    finally:
        tpa.set_paged_v2(True)
    assert calls == ["paged_attn_v1", "paged_attn_v1", "paged_attn"]


# ---------------------------------------------------------------------------
# K17 and K18
# ---------------------------------------------------------------------------

def _w4(rng, K, N, G=128):
    """The same symmetric int4 weight in both layouts: (JAX "u4_kpack"
    words, scales; the port's "hopper_nk" bytes, scales)."""
    codes = rng.integers(-8, 8, (K, N)).astype(np.int8)
    sc = (rng.random((K // G, N)) * 0.02 + 0.002).astype(np.float32)
    return (pack_codes_u4k(jnp.asarray(codes)), jnp.asarray(sc),
            pack_codes_hopper(torch.from_numpy(codes)), torch.from_numpy(sc))


@pytest.mark.parametrize("has_o,I", [(True, 768), (False, 768), (True, 512),
                                     (False, 512)])
def test_k17_plain_matches_omlp_kernel(interpret, has_o, I):
    """I = 768 gives tn_i 256, three tiles of h and three scales; I = 512
    one tile of 512."""
    rng = np.random.default_rng(I + has_o)
    Kh = Ko = 256
    G = 128
    tn, tn_i = jom._pick_tiles(Kh, I, has_o, Ko)
    assert (tn, tn_i) == tom._pick_tiles(Kh, I, has_o, Ko)
    assert tn_i == (256 if I == 768 else 512)
    jo_w, jo_s, to_w, to_s = _w4(rng, Ko, Kh)
    jg_w, jg_s, tg_w, tg_s = _w4(rng, Kh, 2 * I)
    jd_w, jd_s, td_w, td_s = _w4(rng, I, Kh)
    x, res = _bf(rng, Ko if has_o else Kh), _bf(rng, Kh)
    rw = torch.from_numpy((1 + 0.1 * rng.standard_normal(Kh)).astype(
        np.float32))
    jy = jom._omlp_impl(
        _j(x).reshape(1, -1), _j(res if has_o else x).reshape(1, Kh),
        jnp.asarray(rw.numpy()),
        jo_w if has_o else jnp.zeros((1, 1), jnp.uint32),
        jo_s if has_o else jnp.zeros((1, 1), jnp.float32),
        jg_w, jg_s, jd_w, jd_s, Ko=Ko, Kh=Kh, I=I, Go=G, Gg=G, Gd=G, tn=tn,
        tn_i=tn_i, eps=1e-5, has_o=has_o, out_dtype=jnp.dtype(jnp.bfloat16))
    ty = tk.omlp_plain(x, res if has_o else None, rw,
                       to_w if has_o else None, to_s if has_o else None,
                       tg_w, tg_s, td_w, td_s, eps=1e-5, tn_i=tn_i)
    want = _f32(jy).reshape(-1)
    assert np.abs(_f32(ty) - want).max() <= GEMV_TOL * np.abs(want).max()


def test_k17_per_tile_h_scales_are_not_per_token():
    """One h scale a token (the split path's) is a different function:
    the planted fault moves the output past the tolerance."""
    rng = np.random.default_rng(2)
    Kh, I = 256, 768
    _, _, tg_w, tg_s = _w4(rng, Kh, 2 * I)
    _, _, td_w, td_s = _w4(rng, I, Kh)
    x = _bf(rng, Kh)
    rw = torch.ones(Kh)
    a = tk.omlp_plain(x, None, rw, None, None, tg_w, tg_s, td_w, td_s,
                      eps=1e-5, tn_i=256)
    b = tk.omlp_plain(x, None, rw, None, None, tg_w, tg_s, td_w, td_s,
                      eps=1e-5, tn_i=768)
    assert np.abs(_f32(a) - _f32(b)).max() > 0


@pytest.mark.parametrize("rep,pos", [(1, 0), (1, 30), (1, 63), (2, 0),
                                     (2, 41), (2, 63)])
def test_k18_plain_matches_attn_o_kernel(interpret, rep, pos):
    """rep 1 and 2 (the TPU kernel pads the query group to 8 rows), pos 0,
    mid and T - 1; the port writes the new row first, JAX folds it in."""
    rng = np.random.default_rng(rep * 100 + pos)
    Hkv, D, T = 2, 128, 64
    H = Hkv * rep
    K, N = H * D, 512
    jw, js, tw, ts = _w4(rng, K, N, G=D)
    q, kn, vn = _bf(rng, H, D), _bf(rng, Hkv, D), _bf(rng, Hkv, D)
    kc, vc = _bf(rng, Hkv, T, D), _bf(rng, Hkv, T, D)
    res = _bf(rng, N)
    jy = jfm._attn_o_impl(
        jnp.int32(pos), _j(q).reshape(Hkv, rep, D), _j(kn)[:, None],
        _j(vn)[:, None], _j(kc), _j(vc), jw, js, _j(res).reshape(1, N), K=K,
        N=N, G=D, tn=jfm._pick_tn(N), rep=rep,
        out_dtype=jnp.dtype(jnp.bfloat16))
    kc[:, pos], vc[:, pos] = kn, vn
    ty = tk.attn_o_plain(q, kc, vc, pos, tw, ts, res)
    want = _f32(jy).reshape(-1)
    assert np.abs(_f32(ty) - want).max() <= GEMV_TOL * np.abs(want).max()


def test_k18_quantizes_the_float32_outputs():
    """The planted fault, quantizing the bf16-rounded attention output,
    is another function; so is one scale a head."""
    from neural_compressor_tpu_torch.kernels.decode_attention import \
        _attend_plain

    rng = np.random.default_rng(9)
    Hkv = H = 4
    D, T, N = 128, 32, 256
    _, _, tw, ts = _w4(rng, H * D, N, G=D)
    q, kc, vc = _bf(rng, H, D), _bf(rng, Hkv, T, D), _bf(rng, Hkv, T, D)
    res = _bf(rng, N)
    y = tk.attn_o_plain(q, kc, vc, 20, tw, ts, res)
    o = _attend_plain(q[None], kc[None], vc[None], 20).reshape(-1)
    fault = tk.fused_gemv_plain(o.to(torch.bfloat16), None, tw, ts, None,
                                res, eps=0.0, silu=False,
                                out_dtype=torch.bfloat16)
    assert np.abs(_f32(y) - _f32(fault)).max() > 0
