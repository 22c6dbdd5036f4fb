"""K4 (``fused_gemv``) and K17 (``omlp``) rows of a checkout of the port, for
comparing two checkouts on one card and for choosing the column stream's
plan: K4 in its five forms at llama2-7b's projections (qkv with the norm,
o with the residual, gate_up with the norm and silu, down with the
residual, lm_head with the norm) and K17 with and without the
o-projection, sym int4 g128. Each row: the kernel against its plain
version (K4 bit for bit, and within the relative 1e-2 of
``chip_smoke.TOL``; K17 within ``chip_smoke.ulp_check``; a repeated launch
must give the same bits), event ms (back-to-back calls, weights rotated
through >200 MB of copies), device ms (torch.profiler, the call's kernels
summed) and back-to-back ms (calls queued behind a sleeping kernel, so
none waits for the host); beside K17 the three ``torch.matmul`` of the bf16
weights (event, device, back to back). Then each wrapper's host µs a
call, at a small shape where the device keeps up: the whole call, the C
entry alone (its arguments' conversion by ctypes and the launch) and the
Python around it. The timers are ``chip_smoke.py``'s (``timed_ms``,
``backlog_ms``, ``profiled``).

    python3 tools/w4a8_gemv_rows.py [--root <checkout>] [--sweep]

``--root`` imports the port from another checkout (only the wrappers'
public arguments are used), so run parent, change, change, parent in one
call. ``--sweep`` (a checkout with ``w4a8_gemv_plan``) also runs the rows at
other plans: tiles of 8 or 16 columns (``W4A8_COLS``), rings that aim at
64, 96 or 160 KB (``W4A8_RING``; K17's ``OMLP_RING`` 96, 192 KB or the
most that fits), one or two blocks an SM (``W4A8_BLOCKS_PER_SM``), each
constant set for the measurement and then restored.
"""

import argparse
import importlib
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its timers; it imports no kernel at load)

SHAPES = chip_smoke.SHAPES
G = 128
FORMS = {"qkv": dict(rms=True), "o": dict(res=True),
         "gate_up": dict(rms=True, silu=True), "down": dict(res=True),
         "lm_head": dict(rms=True)}
# the kernels a call may launch, as torch.profiler names them (a parent
# checkout's too)
K4_NAMES = ("fused_gemv_kernel", "fused_gemv_quant_kernel")
K17_NAMES = ("omlp_kernel",)
SWEEP_K4 = [(cols, ring, bps) for cols in (8, 16)
            for ring in (64, 96, 160) for bps in (1, 2)]
SWEEP_K17 = [(cols, ring) for cols in (8, 16) for ring in (96, 192, 1024)]


def host_us(fn, n=2000):
    for _ in range(50):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from neural_compressor_tpu_torch import kernels as K
    from neural_compressor_tpu_torch.kernels import _build
    from neural_compressor_tpu_torch.ops import (dequantize_packed,
                                                 pack_qtensor,
                                                 quantize_tensor, to_hopper)

    fm = importlib.import_module(
        "neural_compressor_tpu_torch.kernels.fused_matvec")
    om = importlib.import_module(
        "neural_compressor_tpu_torch.kernels.omlp_matvec")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), f"root={args.root}",
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def weight(K_, N_):
        w = randn(K_, N_, dtype=torch.float32) * K_ ** -0.5
        return to_hopper(pack_qtensor(quantize_tensor(w, bits=4,
                                                      group_size=G)))

    def n_copies(nbytes):
        return max(2, math.ceil(200e6 / nbytes))

    lib = _build.library()

    class Recorder:
        """The C entry a wrapper calls, and its arguments."""

        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            real = getattr(lib, name)

            def call(*a):
                self.calls.append((real, a))
                return 0
            return call

    def host_row(label, fn):
        whole = host_us(fn)
        torch.cuda.synchronize()
        rec = Recorder()
        _build._lib = rec
        try:
            python = host_us(fn)     # the launching entry not called
            rec.calls.clear()
            fn()
        finally:
            _build._lib = lib
        entries = list(rec.calls)
        centry = host_us(lambda: [e(*a) for e, a in entries])
        torch.cuda.synchronize()
        print(f"host us a call, {label}: {whole:.2f} (C entry {centry:.2f}: "
              f"{len(entries)} calls, {sum(len(a) for _e, a in entries)} "
              f"arguments; Python around it {python:.2f})", flush=True)

    # host µs a call, at a small shape where the device keeps up
    pw = weight(512, 256)
    x = randn(512)
    rw = 1.0 + 0.1 * randn(512, dtype=torch.float32)
    host_row("fused_gemv K=512 N=256 rms", lambda: K.fused_gemv(
        x, rw, pw.packed, pw.scales, None, None, eps=1e-5, silu=False,
        out_dtype=bf16))
    po, pg, pd = weight(512, 512), weight(512, 1024), weight(512, 512)
    host_row("omlp Kh=512 I=512 has_o", lambda: K.omlp(
        x, x, rw, po.packed, po.scales, pg.packed, pg.scales, pd.packed,
        pd.scales, eps=1e-5, tn_i=512))

    weights = {n: weight(*SHAPES[n]) for n in FORMS}

    def k4_rows(tag):
        unit = {}
        for name, form in FORMS.items():
            pw = weights[name]
            K_, N_ = pw.orig_shape
            silu = form.get("silu", False)
            n_out = N_ // 2 if silu else N_
            x = randn(K_)
            rms_w = (1.0 + 0.1 * randn(K_, dtype=torch.float32)
                     if form.get("rms") else None)
            res = randn(n_out) if form.get("res") else None
            kw = dict(eps=1e-5, silu=silu, out_dtype=bf16)
            yk = K.fused_gemv(x, rms_w, pw.packed, pw.scales, None, res, **kw)
            again = K.fused_gemv(x, rms_w, pw.packed, pw.scales, None, res,
                                 **kw)
            yp = K.fused_gemv_plain(x, rms_w, pw.packed, pw.scales, None,
                                    res, **kw)
            torch.cuda.synchronize()
            err = float((yk.float() - yp.float()).abs().max())
            ok = (err <= chip_smoke.TOL["gemv"] * float(yp.float().abs().max())
                  and torch.equal(yk, again))
            cps = [(pw.packed.clone(), pw.scales.clone()) for _ in range(
                n_copies(pw.packed.numel() + pw.scales.numel() * 4))]
            fns = [lambda p=p, s=s: K.fused_gemv(x, rms_w, p, s, None, res,
                                                  **kw) for p, s in cps]
            ms = chip_smoke.timed_ms(torch, fns, 200)
            dms = sum(chip_smoke.profiled(torch, fns,
                                          names=K4_NAMES).values())
            b2b = chip_smoke.backlog_ms(torch, fns, 400)
            del cps
            reps = 32 if name != "lm_head" else 1
            for key, v in (("ms", ms), ("device_ms", dms), ("b2b_ms", b2b)):
                unit[key] = unit.get(key, 0.0) + reps * v
            plan = (fm.w4a8_gemv_plan(K_, N_, G, n_out, silu)
                    if hasattr(fm, "w4a8_gemv_plan") else "")
            print(f"{tag}k4 {name:8s} K={K_:5d} N={N_:5d} "
                  f"bit_equal={torch.equal(yk, yp)} max_abs_err={err:.3e} "
                  f"ok={ok} ms={ms:.4f} device_ms={dms:.4f} "
                  f"back_to_back_ms={b2b:.4f} "
                  f"GB/s={(K_ * N_ // 2 + K_ // G * N_ * 4) / max(dms, 1e-9) / 1e6:.0f}"
                  f" {plan}", flush=True)
        print(f"{tag}k4 unit (32 x 4 + lm_head): " + " ".join(
            f"{k}={v:.4f}" for k, v in unit.items()), flush=True)

    pwo, pwg, pwd = (weight(*SHAPES[n]) for n in ("o", "gate_up", "down"))
    Kh, I = SHAPES["down"][1], SHAPES["down"][0]
    tn_i = om._pick_tiles(Kh, I, True, Kh)[1]
    wo, wg, wd = (dequantize_packed(p, bf16) for p in (pwo, pwg, pwd))

    def k17_rows(tag, library=False):
        xo, res = randn(Kh), randn(Kh)
        rms_w = 1.0 + 0.1 * randn(Kh, dtype=torch.float32)
        wbytes = sum(p.packed.numel() + p.scales.numel() * 4
                     for p in (pwo, pwg, pwd))
        cps = [[(p.packed.clone(), p.scales.clone()) for p in (pwo, pwg, pwd)]
               for _ in range(n_copies(wbytes))]
        for has_o in (True, False):
            xin = xo if has_o else res

            def call(ws, fn=K.omlp):
                (ow, osc), (gw, gsc), (dw_, dsc) = ws
                return fn(xin, res if has_o else None, rms_w,
                          ow if has_o else None, osc if has_o else None, gw,
                          gsc, dw_, dsc, eps=1e-5, tn_i=tn_i)

            out, again = call(cps[0]), call(cps[0])
            ref = call(cps[0], K.omlp_plain)
            err, share, ok = chip_smoke.ulp_check(torch, out, ref)
            ok = ok and torch.equal(out, again)
            fns = [lambda c=c: call(c) for c in cps]
            ms = chip_smoke.timed_ms(torch, fns, 50)
            dms = sum(chip_smoke.profiled(torch, fns,
                                          names=K17_NAMES).values())
            b2b = chip_smoke.backlog_ms(torch, fns, 100)
            plan = (om.omlp_plan(Kh, Kh, I, G, G, G, tn_i, has_o)
                    if hasattr(om, "omlp_plan") else "")
            print(f"{tag}k17 has_o={has_o} max_abs_err={err:.3e} "
                  f"ulp_share={share:.2e} ok={ok} ms={ms:.4f} "
                  f"device_ms={dms:.4f} back_to_back_ms={b2b:.4f} {plan}",
                  flush=True)
            if library and has_o:
                x2 = xin.reshape(1, Kh)

                def lib3():
                    g = torch.matmul(torch.matmul(x2, wo), wg)
                    return torch.matmul(g[:, :I], wd)

                lms = chip_smoke.timed_ms(torch, [lib3], 50)
                ldms = sum(chip_smoke.profiled(torch, [lib3],
                                               names=("",)).values())
                lb2b = chip_smoke.backlog_ms(torch, [lib3], 100)
                print(f"{tag}k17 library (three torch.matmul) ms={lms:.4f} "
                      f"device_ms={ldms:.4f} back_to_back_ms={lb2b:.4f}",
                      flush=True)
        del cps

    k4_rows("")
    k17_rows("", library=True)
    if args.sweep:
        names = ("W4A8_COLS", "W4A8_RING", "W4A8_BLOCKS_PER_SM")
        keep = {k: getattr(fm, k) for k in names}
        keep_cols, keep_ring = om.W4A8_COLS, om.OMLP_RING
        for values in SWEEP_K4:
            fm.W4A8_COLS, fm.W4A8_RING, fm.W4A8_BLOCKS_PER_SM = (
                values[0], values[1] * 1024, values[2])
            fm.w4a8_gemv_plan.cache_clear()
            k4_rows("sweep cols={} ring={}K blocks_per_sm={} ".format(
                *values))
        for k, v in keep.items():
            setattr(fm, k, v)
        fm.w4a8_gemv_plan.cache_clear()
        for cols, ring in SWEEP_K17:
            om.W4A8_COLS, om.OMLP_RING = cols, ring * 1024
            om.omlp_plan.cache_clear()
            k17_rows(f"sweep cols={cols} ring={ring}K ")
        om.W4A8_COLS, om.OMLP_RING = keep_cols, keep_ring
        om.omlp_plan.cache_clear()


if __name__ == "__main__":
    main()
