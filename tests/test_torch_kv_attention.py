"""Attention over quantized KV caches and pools: the port's plain kernel
versions and code-domain attention against the JAX package, on the same
numpy inputs.

JAX runs its Pallas kernels as its own tests run them on the CPU, in
interpret mode: K6 (``_decode_attn_quant_ro_impl``) for int8 codes, K7
(``batched_decode_attention``) for int8 codes inside its envelope (B > 1,
B*Hkv >= 16, D and T multiples of 128), K11 (``paged_decode_attention``)
for fp8 and int4 pools, K12 (``paged_write_rows``) for int4 pools of
128-row pages. Where JAX's CPU path takes another route the port is held
to that route: fp8 B=1 decode dequantizes the cache and runs K5, fp8 K7
falls back to ``_grouped_attention`` on the codes, fp8 writes (and int4
writes off the kernel's envelope) are JAX's jitted XLA scatter.

Tolerances: attention outputs within 1e-2 of max|out| (JAX sums in
float32, the port in float64; bf16 probabilities may round apart by an
ulp; the fp8 B=1 reference rounds dequantized rows to bf16, 2e-2); row
writes bit for bit (codes, scales, offsets, the partner token's nibble),
but for the trash-page row that several idle slots write in one call.
``chip_smoke.py`` holds the CUDA kernels to these plain versions on the
card.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_compressor_tpu.kernels import decode_attention as jda
from neural_compressor_tpu.kernels import paged_attention as jpa
from neural_compressor_tpu.models import llama as jl
from neural_compressor_tpu_torch.models import llama as tl

tda = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "decode_attention")
tpa = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "paged_attention")

torch.set_num_threads(2)

TOL = 1e-2


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            a = a.to(torch.bfloat16)
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bits(a) -> np.ndarray:
    a = _t(a) if not isinstance(a, torch.Tensor) else a
    if a.dtype == torch.float8_e4m3fn:
        return a.view(torch.uint8).numpy()
    return _f32(a)


def _bf(rng, *shape, scale=1.0):
    return jnp.asarray((rng.standard_normal(shape) * scale).astype(
        np.float32)).astype(jnp.bfloat16)


def _close(got, want, tol=TOL):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _quant_cache(rng, B, Hkv, T, D, fmt):
    """A jitted-JAX-quantized cache of random rows (codes, scales)."""
    quant = jax.jit(lambda a: jl._kv_quant(a, fmt=fmt))
    return (*quant(_bf(rng, B, Hkv, T, D, scale=2.0)),
            *quant(_bf(rng, B, Hkv, T, D, scale=2.0)))


# ------------------------------------------------------------------- K6


@pytest.mark.parametrize("H,Hkv,D,T", [(8, 2, 64, 64), (4, 4, 128, 96),
                                       (16, 2, 32, 40)])
@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_k6_plain_matches_jax(fmt, H, Hkv, D, T):
    """int8: against ``_decode_attn_quant_ro_impl`` in interpret mode. fp8:
    JAX's CPU path dequantizes the cache to bf16 and runs K5
    (``decode_attention.py:531-538``); both fold the RAW new row in at pos
    (tolerance 2e-2: the reference rounds each dequantized row to bf16).
    At pos >= T (a one-slot engine running on past its request's end) both
    attend all T code rows and no raw row."""
    rng = np.random.default_rng(H + D + T)
    kc, ks, vc, vs = _quant_cache(rng, 1, Hkv, T, D, fmt)
    for pos in (0, T // 3, T - 1, T, T + 5):
        q = _bf(rng, 1, H, 1, D)
        kn, vn = _bf(rng, 1, Hkv, 1, D), _bf(rng, 1, Hkv, 1, D)
        if fmt == "int8":
            want = jda._decode_attn_quant_ro_impl(
                jnp.asarray(pos), q[:, :, 0], kn, vn, kc, ks, vc, vs,
                interpret=True)[:, :, 0]
            tol = TOL
        else:
            kd = (kc.astype(jnp.float32) * ks[..., None]).astype(jnp.bfloat16)
            vd = (vc.astype(jnp.float32) * vs[..., None]).astype(jnp.bfloat16)
            want = jda._decode_attn_ro_impl(jnp.asarray(pos), q[:, :, 0], kn,
                                            vn, kd, vd,
                                            interpret=True)[:, :, 0]
            tol = 2 * TOL
        got = tda.decode_attn_quant_plain(
            _t(q)[:, :, 0], _t(kn)[:, :, 0], _t(vn)[:, :, 0], _t(kc), _t(ks),
            _t(vc), _t(vs), pos)
        assert got.dtype == torch.bfloat16
        _close(got, want, tol)


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_decode_attention_quant_writes_the_row_after(fmt):
    """``decode_attention_quant``: K6 attends the RAW new row (scale 1), the
    cache then holds its codes, bit-equal to JAX's (the kernel never reads
    the cache at pos, so what it held there does not matter)."""
    rng = np.random.default_rng(5)
    H, Hkv, D, T, pos = 8, 2, 64, 32, 11
    kc, ks, vc, vs = _quant_cache(rng, 1, Hkv, T, D, fmt)
    q = _bf(rng, 1, H, 1, D)
    kn, vn = _bf(rng, 1, Hkv, 1, D), _bf(rng, 1, Hkv, 1, D)
    jcache = jl.QuantKVCache(kc, ks, vc, vs)
    jout, jnew = jax.jit(lambda *a: jda.decode_attention_quant(*a))(
        q, kn, vn, jcache, jnp.asarray(pos))
    tcache = tl.QuantKVCache(_t(kc), _t(ks), _t(vc), _t(vs))
    tcache.k_codes[:, :, pos] = tcache.k_codes[:, :, 0]    # ignored by K6
    tout, tnew = tda.decode_attention_quant(_t(q), _t(kn), _t(vn), tcache,
                                            pos)
    assert tnew is tcache
    _close(tout, jout, TOL if fmt == "int8" else 2 * TOL)
    for a, b in zip(jnew[:4], tnew[:4]):
        np.testing.assert_array_equal(_bits(b), _bits(a))
    # the raw row, not its codes: the same call with the dequantized row
    # attends something else
    kd = tl._kv_dequant(*tl._kv_quant(_t(kn), fmt), torch.bfloat16)
    vd = tl._kv_dequant(*tl._kv_quant(_t(vn), fmt), torch.bfloat16)
    other = tda.decode_attn_quant_plain(_t(kn)[:, :, 0].repeat_interleave(
        4, 1), kd[:, :, 0], vd[:, :, 0], *tnew[:4], pos)
    same = tda.decode_attn_quant_plain(_t(kn)[:, :, 0].repeat_interleave(
        4, 1), _t(kn)[:, :, 0], _t(vn)[:, :, 0], *tnew[:4], pos)
    assert not torch.equal(other, same)


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_decode_attention_quant_past_the_end(fmt):
    """A device position at or past T (a one-slot engine running on inside
    a multi-step dispatch): the output is JAX's (all T code rows, no raw
    row) and no row is written (K12 drops it; JAX clamps the write onto row
    T - 1, which only that slot's discarded tokens could read)."""
    rng = np.random.default_rng(9)
    H, Hkv, D, T = 8, 2, 64, 32
    kc, ks, vc, vs = _quant_cache(rng, 1, Hkv, T, D, fmt)
    q = _bf(rng, 1, H, 1, D)
    kn, vn = _bf(rng, 1, Hkv, 1, D), _bf(rng, 1, Hkv, 1, D)
    for pos in (T, T + 2):
        jout, _ = jax.jit(lambda *a: jda.decode_attention_quant(*a))(
            q, kn, vn, jl.QuantKVCache(kc, ks, vc, vs),
            jnp.asarray([pos], jnp.int32))
        tcache = tl.QuantKVCache(_t(kc), _t(ks), _t(vc), _t(vs))
        tout, tnew = tda.decode_attention_quant(
            _t(q), _t(kn), _t(vn), tcache, torch.tensor([pos]))
        _close(tout, jout, TOL if fmt == "int8" else 2 * TOL)
        for a, b in zip((kc, ks, vc, vs), tnew[:4]):
            np.testing.assert_array_equal(_bits(b), _bits(a))


# ------------------------------------------------------------------- K7


@pytest.mark.parametrize("H,Hkv,T", [(8, 4, 128), (16, 4, 256)])
def test_k7_quant_plain_matches_pallas_int8(H, Hkv, T):
    """int8 codes inside K7's envelope: against the Pallas kernel in
    interpret mode, per-slot positions at 0, mid, T - 1 and past the end."""
    rng = np.random.default_rng(T + H)
    B, D = 4, 128
    kc, ks, vc, vs = _quant_cache(rng, B, Hkv, T, D, "int8")
    q = _bf(rng, B, H, 1, D)
    pos = np.array([0, T // 2 + 3, T - 1, T + 5], np.int32)
    want = jda.batched_decode_attention(q, kc, vc, jnp.asarray(pos), ks, vs)
    assert want is not None
    got = tda.batched_decode_attention(_t(q), _t(kc), _t(vc),
                                       torch.from_numpy(pos), _t(ks), _t(vs))
    _close(got, want)


def test_k7_quant_plain_matches_grouped_attention_fp8():
    """fp8 codes: JAX's CPU path has no fp8 in the interpreter and takes
    ``_grouped_attention`` on the codes with the scales folded, which
    normalises before the bf16 cast (K7 after PV)."""
    rng = np.random.default_rng(7)
    B, H, Hkv, T, D = 3, 8, 2, 96, 64
    kc, ks, vc, vs = _quant_cache(rng, B, Hkv, T, D, "fp8_e4m3")
    q = _bf(rng, B, H, 1, D)
    pos = np.array([0, 40, T - 1], np.int32)
    mask = (jnp.arange(T)[None, None, None, :]
            <= jnp.asarray(pos)[:, None, None, None])
    want = jl._grouped_attention(q, kc.astype(jnp.bfloat16),
                                 vc.astype(jnp.bfloat16), mask, D, ks, vs)
    got = tda.batched_decode_attention(_t(q), _t(kc), _t(vc),
                                       torch.from_numpy(pos), _t(ks), _t(vs))
    _close(got, want)


# ------------------------------------------------- code-domain attention


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "int4"])
def test_grouped_attention_on_codes_matches_jax(fmt):
    """Prefill (S > 1) over a quantized contiguous cache: scores and
    probabilities scaled per (token, head) (int8/fp8), or the int4
    D-half-split codes with their rank-1 offset terms."""
    rng = np.random.default_rng(11)
    B, H, Hkv, S, T, D = 2, 8, 2, 5, 24, 64
    k = _bf(rng, B, Hkv, T, D, scale=2.0)
    v = _bf(rng, B, Hkv, T, D, scale=2.0)
    q = _bf(rng, B, H, S, D)
    qpos = np.array([[10, 11, 12, 13, 14], [19, 20, 21, 22, 23]])
    mask = jnp.arange(T)[None, None, None, :] <= jnp.asarray(qpos)[
        :, None, :, None]
    if fmt == "int4":
        kc, ks, ko = jax.jit(jl._kv_quant4_asym)(k)
        vc, vs, vo = jax.jit(jl._kv_quant4_asym)(v)
        want = jl._grouped_attention_int4(q, kc, vc, mask, D, ks, vs, ko, vo)
        got = tl._grouped_attention_int4(_t(q), _t(kc), _t(vc),
                                         _t(mask), D, _t(ks), _t(vs),
                                         _t(ko), _t(vo))
    else:
        kc, ks = jax.jit(lambda a: jl._kv_quant(a, fmt=fmt))(k)
        vc, vs = jax.jit(lambda a: jl._kv_quant(a, fmt=fmt))(v)
        want = jl._grouped_attention(q, kc.astype(jnp.bfloat16),
                                     vc.astype(jnp.bfloat16), mask, D, ks, vs)
        got = tl._grouped_attention(_t(q), _t(kc).to(torch.bfloat16),
                                    _t(vc).to(torch.bfloat16), _t(mask), D,
                                    _t(ks), _t(vs))
    _close(got, want)


# ------------------------------------------------------------------ K11


def _pool(rng, P, Hkv, page, D, fmt):
    """A JAX page pool of quantized random rows, as its writes fill one."""
    rows_k = _bf(rng, P, Hkv, page, D, scale=2.0)
    rows_v = _bf(rng, P, Hkv, page, D, scale=2.0)
    if fmt == "int4":
        q4 = jax.jit(jl._kv_quant4_asym_codes)
        pack = jax.jit(jl._kv_pack_page_int4)
        kc, ks, ko = q4(rows_k)
        vc, vs, vo = q4(rows_v)
        return dict(k_pages=pack(kc), k_scales=ks, v_pages=pack(vc),
                    v_scales=vs, k_offs=ko, v_offs=vo)
    quant = jax.jit(lambda a: jl._kv_quant(a, fmt=fmt))
    kc, ks = quant(rows_k)
    vc, vs = quant(rows_v)
    return dict(k_pages=kc, k_scales=ks, v_pages=vc, v_scales=vs)


def _both(pool, bt):
    j = jl.PagedKVCache(block_tables=jnp.asarray(bt), **pool)
    t = tl.PagedKVCache(block_tables=_t(bt),
                        **{k: _t(v) for k, v in pool.items()})
    return j, t


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int4"])
@pytest.mark.parametrize("H,Hkv,page,pmax", [
    (8, 8, 16, 4),      # MHA, one 4-page group
    (8, 2, 32, 3),      # GQA rep 4, a ragged group
    (16, 2, 16, 8),     # rep 8, two 4-page groups: the online softmax
])
def test_paged_attention_plain_matches_k11(fmt, H, Hkv, page, pmax):
    """Against ``_paged_attn_impl_v2`` in interpret mode: ragged lengths, a
    zero-length slot, an idle slot on the trash page."""
    D, B, P = 64, 5, 40
    rng = np.random.default_rng(H * page + pmax)
    pool = _pool(rng, P, Hkv, page, D, fmt)
    bt = np.zeros((B, pmax), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B - 1):
        bt[b] = perm[b * pmax:(b + 1) * pmax]
    W = pmax * page
    lengths = np.array([1, W // 2 + 3, W, 0, W], np.int32)  # slot 4 idle
    q = _bf(rng, B, H, 1, D)
    jc, tc = _both(pool, bt)
    assert tc.page_size == jc.page_size == page
    jo = _f32(jpa.paged_decode_attention(q, jc, jnp.asarray(lengths)))
    to = tpa.paged_decode_attention(_t(q), tc, _t(lengths))
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == (B, H, 1, D)
    assert np.abs(_f32(to) - jo).max() <= TOL * np.abs(jo).max()
    assert not _f32(to)[3].any() and not jo[3].any()   # zero length


# ------------------------------------------------------------------ K12


@pytest.mark.parametrize("fmt,page,Hkv,D", [
    ("int4", 128, 8, 128),      # inside JAX's write kernel: interpret mode
    ("int4", 16, 2, 64),        # JAX's XLA scatter fallback
    ("fp8_e4m3", 128, 8, 128),  # fp8: the XLA scatter with _kv_quant
    ("fp8_e4m3", 16, 2, 64),
])
def test_paged_write_plain_matches_jax(fmt, page, Hkv, D):
    """Each slot's row into its page, bit for bit: int4 rows patch one
    nibble (token r low, r + page/2 high) and keep the partner token's;
    positions in both halves of a page, and slots 1 and 3 parked on the
    trash page (their contended row excepted)."""
    rng = np.random.default_rng(page + D)
    P, B = 6, 4
    pool = _pool(rng, P, Hkv, page, D, fmt)
    bt = np.array([[1, 2], [0, 0], [3, 4], [0, 0]], np.int32)
    half = page // 2
    pos = np.array([half - 1, 2 * page - 1, page + half, 2 * page - 1],
                   np.int32)
    for step in range(2):
        kn, vn = _bf(rng, B, Hkv, 1, D), _bf(rng, B, Hkv, 1, D)
        jc, tc = _both(pool, bt)
        jnew = jax.jit(jl._paged_write_row)(jc, kn, vn, jnp.asarray(pos))
        tnew = tl._paged_write_row(tc, _t(kn), _t(vn), _t(pos))
        assert tnew is tc
        for name in pool:
            want = _bits(getattr(jnew, name)).copy()
            got = _bits(getattr(tnew, name)).copy()
            trash = (half - 1 if name.endswith("pages") and fmt == "int4"
                     else page - 1)
            want[0, :, trash] = got[0, :, trash] = 0
            np.testing.assert_array_equal(got, want, err_msg=name)
        pool = {name: getattr(jnew, name) for name in pool}
        # the next step writes the partner tokens of this step's rows
        pos = np.where(pos % page >= half, pos - half, pos + half)
        pos[[1, 3]] = 2 * page - 1


def test_fp8_write_scale_follows_kv_quant_not_the_tpu_kernel():
    """JAX's TPU fp8 write kernel forms its scale as ``(amax / 127) *
    (127 / 448)``; its CPU path and the engine's staging copy use
    ``_kv_quant``'s ``amax * f32(1/448)`` (under jit). The port writes
    ``_kv_quant``'s scale; the two formulas part by an ulp in most rows
    (ROADMAP.md, Queue 3), so following the kernel would make prefill and
    decode rows of one request differ."""
    rng = np.random.default_rng(0)
    amax = rng.uniform(0.0, 10.0, 100_000).astype(np.float32)
    x = np.zeros((amax.size, 2), np.float32)
    x[:, 0] = amax
    _codes, port = tpa.kv_quant(torch.from_numpy(x), "fp8_e4m3")
    jitted = np.asarray(jax.jit(lambda a: jl._kv_quant(
        a[:, None, None, :], fmt="fp8_e4m3")[1])(jnp.asarray(x)))
    np.testing.assert_array_equal(port.numpy(), jitted.reshape(-1))
    tpu_true = (amax / np.float32(127)) * np.float32(127.0 / 448.0)
    tpu_recip = (amax * np.float32(1 / 127)) * np.float32(127.0 / 448.0)
    for tpu in (tpu_true, tpu_recip):
        parted = float((tpu != port.numpy()).mean())
        assert 0.7 < parted < 0.9, parted
