"""The column stream of K4 and K17 (``csrc/w4a8_gemv.cuh``), emulated in
PyTorch on the CPU at small widths and held bit for bit to the plain
versions (``fused_gemv_plain``, ``omlp_plain``).

The emulation follows the kernels' plans (``fused_matvec.w4a8_gemv_plan``,
``omlp_matvec.omlp_plan``) and their order of float operations: each
block's columns (whole quads of four, ``block_ranges``) in tiles of
``cols``, a column a consumer warp; a column's units of 128 codes as its
warp's lanes take them (unit u of a slot of ``upc`` units goes to lane 4
(u % 8), each lane
adding its exact float64 products in order, then the warp's xor shuffles);
the activation's sum of squares as the prologue's threads, warps and warp
order take it; K17's per-block slots of x1's sum of squares and max |x1
w_rms| folded in a fixed order (lane l of a warp takes slots l, l + 32,
... in order, then the shuffles) and h's tile maxima. The CUDA kernels
cannot run here; ``chip_smoke.py`` holds them to the plain versions on the
card. Planted mutations of the emulation (a lost tile, a slot folded
twice, a tile maximum shifted) must change the bits.

At one shape each the emulation is also held to the JAX package's Pallas
kernels (``_fused_impl``, ``_omlp_impl``), run in interpret mode as
``tests/test_torch_variant_kernels.py`` runs them, within the tolerance
that file states for a W4A8 GEMV (``2**-7 * max|y|``).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from neural_compressor_tpu.kernels import fused_matvec as jfm
from neural_compressor_tpu.kernels import omlp_matvec as jom
from neural_compressor_tpu.ops.packing import pack_codes_u4k
from neural_compressor_tpu_torch.kernels import _build
from neural_compressor_tpu_torch.ops.packing import (pack_codes_hopper,
                                                     unpack_codes_hopper_f32)

tfm = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "fused_matvec")
tom = importlib.import_module("neural_compressor_tpu_torch.kernels."
                              "omlp_matvec")

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
N_SM = 12            # a small card: several blocks, several tiles a block
GEMV_TOL = 2.0 ** -7  # times max|y|, as in test_torch_variant_kernels.py
LANES = torch.arange(32)


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode, whatever their caller
    passes."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _w4(rng, K, N, G=128):
    """The same symmetric int4 weight in both layouts: (JAX "u4_kpack"
    words, scales; the port's "hopper_nk" bytes, scales)."""
    codes = rng.integers(-8, 8, (K, N)).astype(np.int8)
    sc = (rng.random((K // G, N)) * 0.02 + 0.002).astype(np.float32)
    return (pack_codes_u4k(jnp.asarray(codes)), jnp.asarray(sc),
            pack_codes_hopper(torch.from_numpy(codes)), torch.from_numpy(sc))


def _bf(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)


def _j(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(F32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def block_ranges(n_out, blocks):
    """Block b's columns: whole quads, [4 (b q / blocks), 4 ((b + 1) q /
    blocks)) of q = ceil(n_out / 4), cut at n_out (``make_stream``)."""
    nq = -(-n_out // 4)
    return [(min(n_out, 4 * (b * nq // blocks)),
             min(n_out, 4 * ((b + 1) * nq // blocks)))
            for b in range(blocks)]


def tiles(n_out, blocks, cols):
    """(block, first column, columns) of every tile, each block's in order."""
    return [(b, n0, min(cols, c1 - n0))
            for b, (c0, c1) in enumerate(block_ranges(n_out, blocks))
            for n0 in range(c0, c1, cols)]


def warp_sum(v):
    """Lane 0's value after ``nctt::warp_sum``'s xor shuffles, v [..., 32]."""
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., LANES ^ o]
    return v[..., 0]


def act_scale(amax):
    s = amax * (1.0 / 127)
    return torch.where(s <= 0, torch.ones_like(s), s)


def codes_of(z, s):
    return torch.clamp(torch.round(z / s), -128, 127)


def x_stats(v, w):
    """The prologue's float64 sum of v^2 and max |v w| (|v| without w):
    thread t takes the chunks of eight t, t + 256, ... in order, then each
    warp's shuffles, then the eight warps in order."""
    K = v.numel()
    rounds = -(-(K // 8) // 256)
    sq = torch.zeros(rounds * 256 * 8, dtype=F64)
    sq[:K] = v.to(F64) * v.to(F64)
    sq = sq.reshape(rounds, 256, 8)
    acc = torch.zeros(256, dtype=F64)
    for r in range(rounds):
        for e in range(8):
            acc = acc + sq[r, :, e]
    ws = warp_sum(acc.reshape(8, 32))
    ss = ws[0]
    for i in range(1, 8):
        ss = ss + ws[i]
    z = v * w if w is not None else v
    return ss, z.abs().amax()


def column_sums(q, w, scales, upc, gmul=None, gdiv=1):
    """Every column's float32 sum as its consumer warp takes it: each unit
    of 128 codes an exact integer, times its group's float32 scale (times
    gmul[g / gdiv] in float32 first) in float64, added by lane 4 (u % 8) of
    the unit's slot in order, then the warp's shuffles, rounded once."""
    K = q.numel()
    N = w.shape[0]
    nu, G = K // 128, K // scales.shape[0]
    c = unpack_codes_hopper_f32(w).to(F64).reshape(nu, 128, N)
    parts = (q.to(F64).reshape(nu, 128, 1) * c).sum(dim=1)     # exact
    g = torch.arange(nu) // (G // 128)
    f = scales[g]
    if gmul is not None:
        f = f * gmul[g // gdiv][:, None]
    prod = parts * f.to(F64)                                  # exact
    lanes = torch.zeros(N, 32, dtype=F64)
    for u in range(nu):
        lane = 4 * ((u % upc) % 8)
        lanes[:, lane] = lanes[:, lane] + prod[u]
    return warp_sum(lanes).to(F32)


def k4_emulated(x, rms_w, w, scales, bias, residual, *, eps, silu, plan,
                fault=None):
    """K4 on ``plan``: the prologue, the column sums, each tile's epilogue;
    ``fault`` "lost tile" leaves one tile out."""
    K = x.numel()
    xf = x.to(F32)
    ss, am = x_stats(xf, rms_w)
    s = act_scale(am)
    inv = ((1.0 / torch.sqrt(ss / K + torch.tensor(eps, dtype=F32).to(F64)))
           .to(F32) if rms_w is not None else torch.ones((), dtype=F32))
    ssc = s * inv
    q = codes_of(xf * rms_w if rms_w is not None else xf, s)
    sums = column_sums(q, w, scales, plan.upc)
    N = scales.shape[1]
    n_out = N // 2 if silu else N
    y = torch.zeros(n_out, dtype=F32)
    todo = tiles(n_out, plan.blocks, plan.cols)
    if fault == "lost tile":
        del todo[len(todo) // 2]
    for _b, n0, tc in todo:
        n = slice(n0, n0 + tc)
        if silu:
            ga = sums[n] * ssc
            ua = sums[n0 + n_out:n0 + n_out + tc] * ssc
            sig = (1.0 / (1.0 + torch.exp(-ga.to(F64)))).to(F32)
            v = ga * sig * ua
        else:
            v = sums[n] * ssc
        if bias is not None:
            v = v + bias[n]
        if residual is not None:
            v = v + residual[n].to(F32)
        y[n] = v
    return y.to(torch.bfloat16)


def k17_emulated(x, residual, rms_w, ow, osc, guw, gusc, dw, dsc, *, eps,
                 tn_i, plan, fault=None):
    """K17 on ``plan``; ``fault`` "slot folded twice" adds block 1's slot of
    x1's sum of squares twice, "tile max shifted" takes h's first tile's
    maximum from the second tile, "lost tile" leaves one of down's tiles
    out."""
    has_o = ow is not None
    Kh, I = dw.shape[0], guw.shape[0] // 2
    if has_o:
        xf = x.to(F32)
        s = act_scale(xf.abs().amax())
        x1 = (column_sums(codes_of(xf, s), ow, osc, plan.upc_o) * s
              + residual.to(F32))
        # each block's slot: its warps' sums over their columns in tile
        # order, then the warps in order; the fold: lane l takes slots l,
        # l + 32, ... in order, then the shuffles
        ssb, amb = [], []
        for c0, c1 in block_ranges(Kh, plan.blocks):
            wss = [torch.zeros((), dtype=F64) for _ in range(8)]
            for n0 in range(c0, c1, plan.cols):
                for j in range(min(plan.cols, c1 - n0)):
                    v = x1[n0 + j].to(F64)
                    wss[j % 8] = wss[j % 8] + v * v
            bs = wss[0]
            for i in range(1, 8):
                bs = bs + wss[i]
            ssb.append(bs)
            amb.append((x1[c0:c1] * rms_w[c0:c1]).abs().amax()
                       if c1 > c0 else torch.zeros((), dtype=F32))
        if fault == "slot folded twice":
            ssb.append(ssb[1])
        lanes = torch.zeros(32, dtype=F64)
        for i, v in enumerate(ssb):
            lanes[i % 32] = lanes[i % 32] + v
        ss = warp_sum(lanes)
        am = torch.stack(amb).amax()
    else:
        x1 = x.to(F32)
        ss, am = x_stats(x1, rms_w)
    s2 = act_scale(am)
    inv = (1.0 / torch.sqrt(ss / Kh + torch.tensor(eps, dtype=F32).to(F64))
           ).to(F32)
    acc = column_sums(codes_of(x1 * rms_w, s2), guw, gusc, plan.upc_g) * (
        s2 * inv)
    g, u = acc[:I], acc[I:]
    h = g * (1.0 / (1.0 + torch.exp(-g.to(F64)))).to(F32) * u
    hm = h.reshape(I // tn_i, tn_i).abs().amax(dim=1)
    if fault == "tile max shifted":
        hm[0] = hm[1]
    hsc = act_scale(hm)
    Gd = I // dsc.shape[0]
    d = column_sums(codes_of(h, hsc.repeat_interleave(tn_i)), dw, dsc,
                    plan.upc_d, gmul=hsc, gdiv=tn_i // Gd)
    y = (d + x1).to(torch.bfloat16)
    if fault == "lost tile":
        _b, n0, tc = tiles(Kh, plan.blocks, plan.cols)[1]
        y[n0:n0 + tc] = 0
    return y


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

K4_CASES = {   # name: (K, N, G, form)
    "rms": (512, 384, 128, "rms"),
    "rms+silu": (512, 768, 128, "rms+silu"),
    "res": (384, 256, 128, "res"),
    "bias+res ragged": (256, 100, 128, "bias+res"),
    "silu ragged": (256, 136, 128, "rms+silu"),
    "G 256": (1024, 192, 256, "rms"),
}


def _k4_operands(K, N, G, form, seed):
    rng = np.random.default_rng(seed)
    silu = "silu" in form
    n_out = N // 2 if silu else N
    _jw, _js, w, sc = _w4(rng, K, N, G)
    x = _bf(rng, K)
    rms_w = (torch.from_numpy((1 + 0.1 * rng.standard_normal(K)).astype(
        np.float32)) if "rms" in form else None)
    bias = (torch.from_numpy((0.1 * rng.standard_normal(n_out)).astype(
        np.float32)) if "bias" in form else None)
    res = _bf(rng, n_out) if "res" in form else None
    return (x, rms_w, w, sc, bias, res), dict(eps=1e-5, silu=silu)


@pytest.mark.parametrize("slot", [None, 1024])
@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_emulated_plan_bit_equal(monkeypatch, case, slot):
    """Every form on its plan, and (``slot`` 1024 bytes) on slots of one
    unit of 128 codes, several a column, as past the slot's limit."""
    K, N, G, form = K4_CASES[case]
    if slot:
        monkeypatch.setattr(tfm, "W4A8_SLOT", slot)
    tfm.w4a8_gemv_plan.cache_clear()
    args, kw = _k4_operands(K, N, G, form, seed=K + N)
    n_out = N // 2 if kw["silu"] else N
    plan = tfm.w4a8_gemv_plan(K, N, G, n_out, kw["silu"], n_sm=N_SM)
    assert (plan.chunks > 1) == bool(slot)
    got = k4_emulated(*args, **kw, plan=plan)
    want = tfm.fused_gemv_plain(*args, **kw, out_dtype=torch.bfloat16)
    tfm.w4a8_gemv_plan.cache_clear()
    assert torch.equal(got, want)


def test_k4_lost_tile_changes_bits():
    args, kw = _k4_operands(512, 384, 128, "rms", seed=3)
    plan = tfm.w4a8_gemv_plan(512, 384, 128, 384, False, n_sm=N_SM)
    want = tfm.fused_gemv_plain(*args, **kw, out_dtype=torch.bfloat16)
    assert torch.equal(k4_emulated(*args, **kw, plan=plan), want)
    assert not torch.equal(k4_emulated(*args, **kw, plan=plan,
                                       fault="lost tile"), want)


def test_k4_emulation_matches_the_pallas_kernel(interpret):
    K, N, G = 512, 768, 128
    rng = np.random.default_rng(17)
    jw, js, w, sc = _w4(rng, K, N, G)
    x = _bf(rng, K)
    rms_w = torch.from_numpy((1 + 0.1 * rng.standard_normal(K)).astype(
        np.float32))
    plan = tfm.w4a8_gemv_plan(K, N, G, N // 2, True, n_sm=N_SM)
    got = k4_emulated(x, rms_w, w, sc, None, None, eps=1e-5, silu=True,
                      plan=plan)
    jy = jfm._fused_impl(_j(x).reshape(1, K), _j(rms_w), jw, js, None, None,
                         K=K, N=N, G=G, tn=jfm._pick_tn(N // 2), eps=1e-5,
                         silu=True, out_dtype=jnp.dtype(jnp.bfloat16))
    want = _f32(jy).reshape(-1)
    assert np.abs(_f32(got) - want).max() <= GEMV_TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# K17
# ---------------------------------------------------------------------------

def _k17_operands(has_o, I, seed, Kh=256):
    rng = np.random.default_rng(seed)
    ow, osc = _w4(rng, Kh, Kh)[2:]
    guw, gusc = _w4(rng, Kh, 2 * I)[2:]
    dw, dsc = _w4(rng, I, Kh)[2:]
    x, res = _bf(rng, Kh), _bf(rng, Kh)
    rw = torch.from_numpy((1 + 0.1 * rng.standard_normal(Kh)).astype(
        np.float32))
    return ((x if has_o else res), res if has_o else None, rw,
            ow if has_o else None, osc if has_o else None, guw, gusc, dw,
            dsc)


@pytest.mark.parametrize("has_o,I", [(True, 768), (False, 768),
                                     (True, 512), (False, 384)])
def test_k17_emulated_plan_bit_equal(has_o, I):
    Kh = 256
    tn_i = tom._pick_tiles(Kh, I, has_o, Kh)[1]
    args = _k17_operands(has_o, I, seed=I + has_o)
    plan = tom.omlp_plan(Kh, Kh, I, 128, 128, 128, tn_i, has_o, n_sm=N_SM)
    got = k17_emulated(*args, eps=1e-5, tn_i=tn_i, plan=plan)
    want = tom.omlp_plain(*args, eps=1e-5, tn_i=tn_i)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fault,has_o", [("slot folded twice", True),
                                         ("tile max shifted", True),
                                         ("tile max shifted", False),
                                         ("lost tile", False)])
def test_k17_planted_faults_change_bits(fault, has_o):
    Kh, I = 256, 768
    tn_i = tom._pick_tiles(Kh, I, has_o, Kh)[1]
    args = _k17_operands(has_o, I, seed=5)
    plan = tom.omlp_plan(Kh, Kh, I, 128, 128, 128, tn_i, has_o, n_sm=N_SM)
    want = tom.omlp_plain(*args, eps=1e-5, tn_i=tn_i)
    assert not torch.equal(
        k17_emulated(*args, eps=1e-5, tn_i=tn_i, plan=plan, fault=fault),
        want)


def test_k17_emulation_matches_the_pallas_kernel(interpret):
    Kh = Ko = 256
    I, G = 768, 128
    tn, tn_i = jom._pick_tiles(Kh, I, True, Ko)
    rng = np.random.default_rng(23)
    jo_w, jo_s, to_w, to_s = _w4(rng, Ko, Kh)
    jg_w, jg_s, tg_w, tg_s = _w4(rng, Kh, 2 * I)
    jd_w, jd_s, td_w, td_s = _w4(rng, I, Kh)
    x, res = _bf(rng, Ko), _bf(rng, Kh)
    rw = torch.from_numpy((1 + 0.1 * rng.standard_normal(Kh)).astype(
        np.float32))
    jy = jom._omlp_impl(
        _j(x).reshape(1, -1), _j(res).reshape(1, Kh), jnp.asarray(rw.numpy()),
        jo_w, jo_s, jg_w, jg_s, jd_w, jd_s, Ko=Ko, Kh=Kh, I=I, Go=G, Gg=G,
        Gd=G, tn=tn, tn_i=tn_i, eps=1e-5, has_o=True,
        out_dtype=jnp.dtype(jnp.bfloat16))
    plan = tom.omlp_plan(Ko, Kh, I, G, G, G, tn_i, True, n_sm=N_SM)
    got = k17_emulated(x, res, rw, to_w, to_s, tg_w, tg_s, td_w, td_s,
                       eps=1e-5, tn_i=tn_i, plan=plan)
    want = _f32(jy).reshape(-1)
    assert np.abs(_f32(got) - want).max() <= GEMV_TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4096, 12288, 128, 12288, False),
                                   (4096, 22016, 128, 11008, True),
                                   (4096, 4096, 128, 4096, False),
                                   (11008, 4096, 128, 4096, False),
                                   (4096, 32000, 128, 32000, False),
                                   (65536, 512, 128, 512, False),
                                   (262144, 256, 128, 256, False)])
def test_k4_served_plans_cover_each_column_once_and_fit(shape):
    K, N, G, n_out, silu = shape
    plan = tfm.w4a8_gemv_plan(K, N, G, n_out, silu)
    seen = torch.zeros(n_out, dtype=torch.int32)
    for _b, n0, tc in tiles(n_out, plan.blocks, plan.cols):
        seen[n0:n0 + tc] += 1
    assert bool((seen == 1).all())
    assert plan.chunks * plan.upc >= K // 128 > (plan.chunks - 1) * plan.upc
    assert plan.smem == tfm.k4_smem(K, plan.stages, plan.slot,
                                    plan.codes_bytes > 0)
    assert plan.smem <= tfm.MAX_DYN_SMEM
    assert plan.stages * plan.slot >= min(tfm.W4A8_RING, 2 * plan.slot)
    assert plan.slot <= tfm.W4A8_SLOT or plan.upc == 1
    assert (plan.codes_bytes > 0) == (K > tfm.MAX_K)


def test_k17_served_plan_fits_and_covers():
    Kh, I = 4096, 11008
    tn_i = tom._pick_tiles(Kh, I, True, Kh)[1]
    for has_o in (True, False):
        plan = tom.omlp_plan(Kh, Kh, I, 128, 128, 128, tn_i, has_o)
        assert plan.smem == tom.omlp_smem(I, I // tn_i, plan.stages,
                                          plan.slot) <= tfm.MAX_DYN_SMEM
        assert (plan.upc_o, plan.upc_g, plan.upc_d) == (32, 32, 86)
        assert plan.blocks == tfm.N_SM and plan.stages >= 2
        for n in (Kh, I):
            seen = torch.zeros(n, dtype=torch.int32)
            for _b, n0, tc in tiles(n, plan.blocks, plan.cols):
                seen[n0:n0 + tc] += 1
            assert bool((seen == 1).all())


def test_plans_refuse_what_the_kernels_do_not_take():
    for args in ((250, 512, 128, 512, False), (512, 512, 100, 512, False),
                 (512, 512, 384, 512, False), (512, 512, 128, 256, False)):
        with pytest.raises(ValueError):
            tfm.w4a8_gemv_plan(*args)
    with pytest.raises(ValueError):
        tom.omlp_plan(256, 256, 768, 128, 128, 128, 200, True)


def test_plans_and_argument_blocks_are_cached():
    tfm.w4a8_gemv_plan.cache_clear()
    p = tfm.w4a8_gemv_plan(4096, 4096, 128, 4096, False, n_sm=N_SM)
    assert tfm.w4a8_gemv_plan(4096, 4096, 128, 4096, False, n_sm=N_SM) is p
    assert tfm.w4a8_gemv_plan.cache_info().hits == 1
    q = tom.omlp_plan(256, 256, 768, 128, 128, 128, 256, True, n_sm=N_SM)
    assert tom.omlp_plan(256, 256, 768, 128, 128, 128, 256, True,
                         n_sm=N_SM) is q
    dev = torch.device("cpu")
    a = tfm.w4a8_gemv_workspace(p, dev)
    assert tfm.w4a8_gemv_workspace(p, dev) == a
    b = tom.omlp_workspace(q, dev)
    assert tom.omlp_workspace(q, dev) == b
    bufs = tom._OMLP_SCRATCH[(q, dev)][0]
    assert [t.numel() for t in bufs[:4]] == [256, 768, q.blocks, q.blocks]
    assert int(bufs[4].abs().sum()) == 0 and bufs[4].numel() == 2 * 3
    del tfm._K4_SCRATCH[dev], tom._OMLP_SCRATCH[(q, dev)]


class _Entry:
    """A stand-in for the kernel library: records each C call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("k17", [False, True])
def test_a_wrapper_call_allocates_only_its_output(monkeypatch, k17):
    """On a non-CPU tensor (meta, with the library and the stream stood
    in) a second call makes one tensor, the output, and one C call with
    the cached argument block."""
    lib = _Entry()
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(_build, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(tfm, "_n_sm", lambda dev: N_SM)
    monkeypatch.setattr(tom, "_n_sm", lambda dev: N_SM)
    meta = torch.device("meta")
    Kh, I = 512, 768

    def e(*shape, dtype=F32):
        return torch.empty(shape, dtype=dtype, device=meta)

    x = e(Kh, dtype=torch.bfloat16)
    if k17:
        fn = tom.omlp
        args = (x, x, e(Kh), e(Kh, Kh // 2, dtype=torch.uint8),
                e(Kh // 128, Kh), e(2 * I, Kh // 2, dtype=torch.uint8),
                e(Kh // 128, 2 * I), e(Kh, I // 2, dtype=torch.uint8),
                e(I // 128, Kh))
        kw = dict(eps=1e-5, tn_i=256)
        n_y, at = Kh, 10
    else:
        fn = tfm.fused_gemv
        args = (x, e(Kh), e(2 * I, Kh // 2, dtype=torch.uint8),
                e(Kh // 128, 2 * I), None, None)
        kw = dict(eps=1e-5, silu=True, out_dtype=torch.bfloat16)
        n_y, at = I, 7
    fn(*args, **kw)
    made = []
    for name in ("empty", "zeros"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, **k: (
            made.append(a), _r(*a, **k))[1])
    before = fn.launches
    y = fn(*args, **kw)
    assert y.shape == (n_y,) and fn.launches == before + 1
    assert made == [(n_y,)]
    (n1, a1), (n2, a2) = lib.calls
    assert n1 == n2 == ("nctt_omlp" if k17 else "nctt_fused_gemv")
    if k17:
        plan = tom.omlp_plan(Kh, Kh, I, 128, 128, 128, 256, True, n_sm=N_SM)
        assert a1[at] == a2[at] == tom.omlp_workspace(plan, meta)
        del tom._OMLP_SCRATCH[(plan, meta)]
        tom._OMLP_BLOCKS.clear()
    else:
        plan = tfm.w4a8_gemv_plan(Kh, 2 * I, 128, I, True, n_sm=N_SM)
        assert a1[at] == a2[at] == tfm.w4a8_gemv_workspace(plan, meta)
        del tfm._K4_SCRATCH[meta]
        tfm._K4_BLOCKS.clear()
