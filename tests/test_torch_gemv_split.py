"""K9's and K10's plan (``kernels/dequant_matmul.py`` ``gemv_plan``) on the
CPU: a numpy emulation of the order of work of their streaming core
(``csrc/vpu_gemv.cuh``: blocks over strips of columns and ranges of whole
groups, K10's whole tiles, a contiguous run of groups a warp, x staged in
the words' field order, the folds of warps, tiles and splits), held to the
plain versions: K10's bit for bit with ``vpu_int8act_plain`` (sym and asym
int4, int2, a row permutation, float32 and bf16 out), K9's within the bound
``chip_smoke.py``'s ``woq_tol`` holds the kernel to. Planted mutations of
the order (a group lost or counted twice at a block boundary, K10's tiles
folded out of order, one of K9's split partials dropped) must fail those
checks. The plans of the served projections (llama2-7b, gemma2-9b,
deepseek-v3 and its experts) cover every group once, keep K10's tile
boundaries and fit the card and the workspace; the plans and argument
blocks are cached, and a wrapper call allocates only its output.

The CUDA kernels run only on the card; ``chip_smoke.py`` holds them to the
plain versions there.
"""

import numpy as np
import pytest
import torch

from neural_compressor_tpu_torch.kernels import _build
from neural_compressor_tpu_torch.kernels import dequant_matmul as dm
from neural_compressor_tpu_torch.kernels.w4a8_matmul import MAX_DYN_SMEM
from neural_compressor_tpu_torch.ops import pack_qtensor, quantize_tensor

torch.set_num_threads(2)

N_SM = 132
# (K, N) of the served M = 1 projections: llama2-7b (fused qkv and
# gate_up), gemma2-9b, DeepSeek-V3's dense layers and its experts
LLAMA = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
         (4096, 32000)]
GEMMA = [(3584, 4096), (3584, 2048), (3584, 8192), (4096, 3584),
         (3584, 28672), (14336, 3584), (3584, 256000)]
DEEPSEEK = [(7168, 1536), (1536, 24576), (512, 32768), (16384, 7168),
            (7168, 18432), (7168, 36864), (18432, 7168), (7168, 129280)]
EXPERTS = [(7168, 2048), (7168, 4096), (2048, 7168)]
SERVED = LLAMA + GEMMA + DEEPSEEK + EXPERTS


def _weight(K, N, G, bits, scheme, seed):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((K, N), generator=gen) * K ** -0.5
    return pack_qtensor(quantize_tensor(w, bits=bits, group_size=G,
                                        scheme=scheme))


def _x(K, seed, dtype=torch.bfloat16):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        K).astype(np.float32)).to(dtype)


def block_ranges(plan, K, G, fault=None):
    """Each block's and warp's groups as the kernel cuts them: split z
    takes units [z per, (z + 1) per) (ngk groups each), its warp w the
    groups [bg0 + w nb / W, bg0 + (w + 1) nb / W). -> [(z, bg0, nb,
    [(g0, g1) a warp])]. ``fault`` "lost" starts every block after the
    first one group late, "twice" one group early."""
    ng, W = K // G, plan.warps
    out = []
    for z in range(plan.splits):
        bg0 = min(z * plan.per * plan.ngk, ng)
        nb = min(bg0 + plan.per * plan.ngk, ng) - bg0
        if z and fault == "lost":
            bg0, nb = bg0 + 1, nb - 1
        if z and fault == "twice":
            bg0, nb = bg0 - 1, nb + 1
        out.append((z, bg0, nb, [(bg0 + w * nb // W, bg0 + (w + 1) * nb // W)
                                 for w in range(W)]))
    return out


def _fields(pw, G, K):
    """u [K/P, P, N] (uint32 fields of the words) and the staged x order:
    the k of field s of word row r."""
    P = 32 // pw.bits
    wpg = G // P
    words = pw.packed.numpy().view(np.uint32)
    sh = (pw.bits * np.arange(P, dtype=np.uint32))[None, :, None]
    u = (words[:, None, :] >> sh) & np.uint32((1 << pw.bits) - 1)
    r = np.arange(K // P)[:, None]
    k = (r // wpg) * G + np.arange(P)[None, :] * wpg + r % wpg
    return u, k


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _fma(a, b, c):
    """fma in float32: the exact product, one rounding of the sum (float64
    holds a float32 product exactly; its sum rounds once more only past 2^29
    of the smaller term's ulps, far beyond these sums)."""
    return _f32(np.float64(a) * np.float64(b) + np.float64(c))


def emulate_k9(x, pw, G, plan, fault=None):
    """K9's order of work on its float32 path: each warp's groups, each
    group's word rows in order and in a row the fields by mask j (shift
    bits*j) and byte b (field b * FB + j), u x added by FMA; per group acc
    = fma(s, sa - off sb, acc); the warps' sums in warp order, then the
    splits in order. (Over bf16 x the kernel forms each group's sums on the
    tensor cores, exact products in another order: within the same
    bound.)
    ``fault``: "lost" / "twice" (block_ranges), "drop" (split 1's partial
    left out of the fold)."""
    K, N = pw.orig_shape
    P, FB = 32 // pw.bits, 8 // pw.bits
    wpg = G // P
    u, kk = _fields(pw, G, K)
    uf = u.astype(np.float32)
    xf = x.float().numpy()
    s = pw.scales.numpy()
    off = np.float32(1 << (pw.bits - 1))
    offs = (off + pw.zeros.numpy()).astype(np.float32) if pw.zeros is not None \
        else np.full_like(s, off)
    order = [b * FB + j for j in range(FB) for b in range(4)]
    parts = []
    for _z, bg0, nb, warps in block_ranges(plan, K, G, fault):
        sums = []
        for g0, g1 in warps:
            acc = np.zeros(N, np.float32)
            for g in range(g0, g1):
                sa = np.zeros(N, np.float32)
                for r in range(g * wpg, (g + 1) * wpg):
                    for f in order:
                        sa = _fma(uf[r, f], xf[kk[r, f]], sa)
                sb = _f32(xf[g * G:(g + 1) * G].sum(dtype=np.float32))
                acc = _fma(s[g], _f32(sa - _f32(offs[g] * sb)), acc)
            sums.append(acc)
        y = sums[0]
        for v in sums[1:]:
            y = _f32(y + v)
        parts.append(y)
    if fault == "drop":
        parts = parts[:1] + parts[2:]
    y = parts[0]
    for v in parts[1:]:
        y = _f32(y + v)
    return y


def emulate_k10(x, pw, G, tk, plan, fault=None):
    """K10's order of work: each warp's groups' exact integer sums a, b
    and af = f32(a) - f32(off f32(b)); each block's tiles part = fma(s, af,
    part) over the tile's groups in order; every tile's part chained acc =
    fma(part, xs, acc) in tile order. ``fault``: "lost" / "twice"
    (block_ranges), "order" (two tiles chained swapped)."""
    K, N = pw.orig_shape
    ngk = tk // G
    xq, xs = dm.act_quant_per_tensor(x)
    q = xq.numpy().astype(np.int64)
    u, kk = _fields(pw, G, K)
    P = 32 // pw.bits
    wpg = G // P
    s = pw.scales
    off = float(1 << (pw.bits - 1))
    offs = (off + pw.zeros) if pw.zeros is not None else torch.full_like(s,
                                                                         off)
    nk = K // tk
    parts = torch.zeros((nk, N), dtype=torch.float32)
    for _z, bg0, nb, warps in block_ranges(plan, K, G, fault):
        af = {}
        for g0, g1 in warps:
            for g in range(g0, g1):
                rows = slice(g * wpg, (g + 1) * wpg)
                a = np.einsum("rpn,rp->n", u[rows].astype(np.int64),
                              q[kk[rows]])
                b = torch.tensor(float(q[g * G:(g + 1) * G].sum()),
                                 dtype=torch.float32)
                af[g] = (torch.from_numpy(a.astype(np.float32))
                         - offs[g] * b)
        for t in range(bg0 // ngk, -(-(bg0 + nb) // ngk)):
            part = torch.zeros(N, dtype=torch.float32)
            for g in range(t * ngk, (t + 1) * ngk):
                if g in af:
                    part = dm.fma_f32(s[g], af[g], part)
            parts[t] = part
    chain = list(range(nk))
    if fault == "order":
        chain[0], chain[1] = chain[1], chain[0]
    acc = torch.zeros(N, dtype=torch.float32)
    for t in chain:
        acc = dm.fma_f32(parts[t], xs.expand(N), acc)
    return acc


def _k9_bound(x, pw, G, y_ref):
    """``woq_tol``'s K9 bound (chip_smoke.py): each side within (G + K/G +
    4) 2^-24 (|x| @ A), A = s (u + |2^(b-1) + z|), plus a bf16 rounding of
    a bf16 y."""
    K, N = pw.orig_shape
    u = dm.unpack_codes(pw.packed, pw.bits, G, K, signed=False).float()
    off = torch.full_like(pw.scales, float(1 << (pw.bits - 1)))
    if pw.zeros is not None:
        off = off + pw.zeros
    A = ((u.reshape(-1, G, N) + off.abs()[:, None, :])
         * pw.scales[:, None, :]).reshape(K, N)
    tol = 2 * (G + K // G + 4) * 2.0 ** -24 * (x.float().abs() @ A)
    if y_ref.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * y_ref.float().abs()
    return tol.numpy()


def _k9_case(K, N, G, bits, scheme, xdtype, n_sm, fault=None, seed=0):
    pw = _weight(K, N, G, bits, scheme, seed)
    x = _x(K, seed + 1, xdtype)
    plan = dm.gemv_plan(N, K, G, bits, 0, n_sm)
    y = emulate_k9(x, pw, G, plan, fault)
    ref = dm.vpu_gemv_plain(x, pw.packed, pw.scales, pw.zeros, bits=bits,
                            group_size=G, out_dtype=torch.float32)
    d = np.abs(y - ref.numpy())
    return plan, d, _k9_bound(x, pw, G, ref)


def _k10_case(K, N, G, bits, scheme, xdtype, n_sm, fault=None, seed=0,
              out=torch.float32):
    pw = _weight(K, N, G, bits, scheme, seed)
    x = _x(K, seed + 1, xdtype)
    tk = dm._vpu_tiles(K, N, G)[0]
    plan = dm.gemv_plan(N, K, G, bits, tk, n_sm=n_sm)
    y = emulate_k10(x, pw, G, tk, plan, fault).to(out)
    ref = dm.vpu_int8act_plain(x, pw.packed, pw.scales, pw.zeros, bits=bits,
                               group_size=G, tk=tk, out_dtype=out)
    return plan, y, ref


# (K, N, G, bits, scheme, x dtype, SMs): splits across blocks (many SMs
# for few strips), one split (one SM), G 32 and 64, int2, f32 x
K9_CASES = [(2048, 256, 128, 4, "asym", torch.bfloat16, N_SM),
            (2048, 256, 128, 4, "sym", torch.bfloat16, 1),
            (1024, 384, 32, 4, "asym", torch.float32, N_SM),
            (1024, 256, 64, 2, "asym", torch.bfloat16, N_SM),
            (512, 132, 512, 4, "sym", torch.bfloat16, N_SM)]


@pytest.mark.parametrize("case", K9_CASES)
def test_k9_emulated_plan_within_the_bound(case):
    plan, d, tol = _k9_case(*case)
    assert (d <= tol).all(), (plan, float((d / tol).max()))


# K10: the same with tiles of several groups (tk 1024 at K 2048, G 128),
# tiles of one group (G = K), sym and asym int4, int2, f32 x
K10_CASES = [(2048, 256, 128, 4, "sym", torch.bfloat16, N_SM),
             (2048, 256, 128, 4, "asym", torch.bfloat16, N_SM),
             (2048, 256, 128, 4, "sym", torch.float32, 1),
             (2560, 128, 128, 2, "sym", torch.bfloat16, N_SM),
             (1024, 384, 32, 4, "asym", torch.float32, N_SM),
             (1536, 256, 1536, 4, "sym", torch.bfloat16, N_SM)]


@pytest.mark.parametrize("case", K10_CASES)
def test_k10_emulated_plan_bit_equal(case):
    plan, y, ref = _k10_case(*case)
    assert torch.equal(y, ref), (plan, float((y - ref).abs().max()))


def test_k10_emulated_bf16_out_and_perm():
    """bf16 outputs, and a row permutation gathered as vpu_matvec_int8act
    gathers it (x in the stored order)."""
    plan, y, ref = _k10_case(2048, 256, 128, 4, "asym", torch.bfloat16, N_SM,
                             out=torch.bfloat16)
    assert torch.equal(y, ref)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(2048))
    gen = torch.Generator().manual_seed(6)
    w = torch.randn((2048, 256), generator=gen) * 2048 ** -0.5
    pw = pack_qtensor(quantize_tensor(w[perm], bits=4, group_size=128),
                      perm=perm.to(torch.int32))
    x = _x(2048, 7).reshape(1, 2048)
    want = dm.vpu_matvec_int8act(x, pw, out_dtype=torch.float32)
    xg, pwg = dm._gather_perm(x, pw)
    tk = dm._vpu_tiles(2048, 256, 128)[0]
    got = emulate_k10(xg[0], pwg, 128, tk, dm.gemv_plan(256, 2048, 128, 4, tk))
    assert torch.equal(got, want.reshape(-1))


@pytest.mark.parametrize("fault", ["lost", "twice", "drop"])
def test_k9_planted_faults_leave_the_bound(fault):
    plan, d, tol = _k9_case(2048, 256, 128, 4, "asym", torch.bfloat16, N_SM,
                            fault=fault)
    assert plan.splits > 1
    assert (d > tol).sum() > 0


@pytest.mark.parametrize("fault", ["lost", "twice", "order"])
def test_k10_planted_faults_change_bits(fault):
    plan, y, ref = _k10_case(2048, 256, 128, 4, "sym", torch.bfloat16, N_SM,
                             fault=fault, out=torch.float32)
    assert plan.splits > 1
    assert not torch.equal(y, ref)


def _covered(plan, K, G):
    seen = np.zeros(K // G, dtype=np.int64)
    for _z, _bg0, _nb, warps in block_ranges(plan, K, G):
        for g0, g1 in warps:
            seen[g0:g1] += 1
    return seen


@pytest.mark.parametrize("k10", [False, True])
@pytest.mark.parametrize("shape", SERVED)
def test_served_plans_cover_each_group_once_and_fit(shape, k10):
    K, N = shape
    G = 128
    tk = dm._vpu_tiles(K, N, G)[0] if k10 else 0
    plan = dm.gemv_plan(N, K, G, 4, tk, n_sm=N_SM)
    assert (_covered(plan, K, G) == 1).all(), plan
    assert plan.grid == (-(-N // dm.GEMV_BN), plan.splits)
    if k10:   # blocks start and end on tile boundaries
        assert plan.ngk == tk // G
        for _z, bg0, nb, _w in block_ranges(plan, K, G):
            assert bg0 % plan.ngk == 0 and nb % plan.ngk == 0
    assert (G // 8) % plan.rows == 0 and plan.rows <= dm.GEMV_MAX_ROWS
    assert plan.smem == dm.gemv_smem(k10, G, plan.warps, plan.stages,
                                     plan.rows, plan.per * plan.ngk)
    assert plan.smem <= MAX_DYN_SMEM
    # the workspace: a split's sums (K9) or a tile's parts (K10), N each
    if plan.splits > 1:
        assert plan.partials == N * (K // tk if k10 else plan.splits)
        assert plan.tickets == plan.grid[0]
    else:
        assert plan.partials == plan.tickets == 0
    # every block in one wave unless the strips alone exceed it, and a
    # group for every warp where K is split
    resident = N_SM * min(dm.SM_SMEM // (plan.smem + dm.SM_BLOCK_SMEM),
                          dm.SM_THREADS // (32 * plan.warps))
    assert plan.grid[0] * plan.splits <= resident or plan.splits == 1
    assert plan.splits == 1 or plan.per * plan.ngk >= plan.warps


def test_plan_refuses_what_the_kernels_do_not_take():
    for args in ((250, 4096, 128, 4), (256, 4096, 128, 8),
                 (256, 4096, 100, 4), (256, 4000, 128, 4),
                 (256, 4096, 128, 4, 192)):
        with pytest.raises(ValueError):
            dm.gemv_plan(*args)


def test_plans_and_argument_blocks_are_cached():
    dm.gemv_plan.cache_clear()
    p = dm.gemv_plan(4096, 4096, 128, 4, n_sm=N_SM)
    assert dm.gemv_plan(4096, 4096, 128, 4, n_sm=N_SM) is p
    assert dm.gemv_plan.cache_info().hits == 1
    dev = torch.device("cpu")
    # K10's down projection needs the most partials (43 tiles of N): its
    # workspace then holds K9's o projection too, and both blocks stay
    q = dm.gemv_plan(4096, 11008, 128, 4, 256, n_sm=N_SM)
    b = dm.gemv_workspace(q, dev)
    a = dm.gemv_workspace(p, dev)
    assert dm.gemv_workspace(p, dev) == a and dm.gemv_workspace(q, dev) == b
    sizes, bufs, blocks = dm._GEMV_SCRATCH[dev]
    assert bufs[0].numel() >= max(p.partials, q.partials, 1)
    assert (bufs[1] == 0).all() and bufs[1].numel() >= max(p.tickets,
                                                           q.tickets)
    assert set(blocks) == {p, q}
    del dm._GEMV_SCRATCH[dev]


class _Entry:
    """A stand-in for the kernel library: records each C call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("k10", [False, True])
def test_a_wrapper_call_allocates_only_its_output(monkeypatch, k10):
    """On a non-CPU tensor (meta, with the library and the stream stood
    in) a second call makes one tensor, the output, and one C call with
    the cached argument block."""
    lib = _Entry()
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(_build, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(dm, "_sm_count", lambda dev: N_SM)
    meta = torch.device("meta")
    K, N, G = 4096, 4096, 128
    x = torch.empty(K, dtype=torch.bfloat16, device=meta)
    w = torch.empty(K // 8, N, dtype=torch.int32, device=meta)
    s = torch.empty(K // G, N, dtype=torch.float32, device=meta)
    fn = dm.vpu_int8act if k10 else dm.vpu_gemv
    kw = dict(bits=4, group_size=G, out_dtype=torch.bfloat16)
    if k10:
        kw["tk"] = 1024
    fn(x, w, s, s, **kw)
    made = []
    for name in ("empty", "zeros"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, **k: (
            made.append(a), _r(*a, **k))[1])
    before = fn.launches
    y = fn(x, w, s, s, **kw)
    assert y.shape == (N,) and fn.launches == before + 1
    assert made == [(N,)]
    (n1, a1), (n2, a2) = lib.calls
    assert n1 == n2 == ("nctt_vpu_int8act" if k10 else "nctt_vpu_gemv")
    assert a1[5] == a2[5] == dm.gemv_workspace(
        dm.gemv_plan(N, K, G, 4, 1024 if k10 else 0, n_sm=N_SM), meta)
    del dm._GEMV_SCRATCH[meta]
