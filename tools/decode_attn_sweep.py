"""K5 (``decode_attn``), K6 (``decode_attn_quant``), K7
(``batched_decode_attn``), K16's in-kernel write (``decode_attn_write``)
and K18 (``attn_o``) at the llama2-7b shapes of the main paths, for
choosing the split's plan and for comparing two checkouts on one card:
each call against its plain version (bit for bit, and within
``chip_smoke.kv_tol``), its event ms (back-to-back calls, caches rotated
through >200 MB of copies), its device ms (torch.profiler: the call's
kernels summed, and each kernel apart), its back-to-back ms (calls queued
behind a sleeping kernel, so none waits for the host), and the wrappers'
host µs a call: the whole call, the C entry alone (its arguments'
conversion by ctypes and the CUDA launches) and the Python around it. The
timers are ``chip_smoke.py``'s (``timed_ms``, ``backlog_ms``,
``profiled``).

    python3 tools/decode_attn_sweep.py [--root <checkout>] [--sweep]

Cases: K7 over 8 slots at ``chip_smoke.SLOT_POS`` (bf16, int8, fp8), K6 at
B=1 at positions 0, 517 and 1023 (int8, fp8), K5 and K16's write (bf16 and
int8, an all-zero new k row in the int8 case) at B=1 at the same positions
and K18 there with the o-projection of N 4096, all over 1024-row caches of
32 heads of 128; beside K5 and K16's write, the yardstick SDPA over the
visited rows, beside K18 SDPA then ``torch.matmul`` of the bf16 weights
(event, device and back-to-back ms). Every case must equal its plain
version bit for bit but K18's, which is held to ``chip_smoke.ulp_check``
(its plain version sums the o-projection's groups in another order). ``--root`` imports the port from another checkout
(only the wrappers' public arguments are used), so run parent, change,
change, parent in one call. ``--sweep`` (a checkout with ``decode_plan``)
also runs every case at other plans: parts of 64, 128, 192 and 256 keys
(``PART_KEYS``) at 128 and 256 threads a block at D 128
(``THREADS_D128``), rings of 1 to 4 tiles (``RING_STAGES``), K5's and
K6's part sums in a third launch at every part count (``LSUM_PARTS`` 0),
and K18's o-projection stage at 8, 32 and 64 columns a block
(``fused_matvec.ATTN_O_COLS``) and as a programmatic dependent launch of
PV (``fused_matvec.ATTN_O_DEPENDENT`` 1), each constant set for the
measurement and then restored.
"""

import argparse
import importlib
import itertools
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its timers; it imports no kernel at load)

SLOT_POS = (0, 127, 128, 300, 517, 640, 901, 1023)
K6_POS = (0, 517, 1023)
H = HKV = 32
D, T = 128, 1024
N_O = 4096                       # K18's o-projection: [H*D, N_O]
# the kernels a case may launch, as torch.profiler names them (the split's,
# K18's o-projection stage, and the single-pass kernels of a parent
# checkout)
NAMES = ("nctt_dsplit::scores_kernel", "nctt_dsplit::pv_kernel",
         "nctt_dsplit::lsum_kernel", "oproj_kernel", "attn_o_kernel",
         "batched_decode_attention_kernel", "decode_attention_quant_kernel",
         "::decode_attention_kernel<")


def yardstick(torch, label, fns):
    """A library call's event, device (every kernel torch.profiler sees)
    and back-to-back ms."""
    ms = chip_smoke.timed_ms(torch, fns, 100)
    dev = sum(chip_smoke.profiled(torch, fns, names=("",)).values())
    b2b = chip_smoke.backlog_ms(torch, fns, 200)
    print(f"{label}: ms={ms:.4f} device_ms={dev:.4f} "
          f"back_to_back_ms={b2b:.4f}", flush=True)


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
    from neural_compressor_tpu_torch.ops import (dequantize_packed,
                                                 pack_qtensor,
                                                 quantize_tensor, to_hopper)
    from neural_compressor_tpu_torch.ops import kv_quant as kq

    da = importlib.import_module(
        "neural_compressor_tpu_torch.kernels.decode_attention")
    fm = importlib.import_module(
        "neural_compressor_tpu_torch.kernels.fused_matvec")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), f"root={args.root}",
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(53)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def n_copies(nbytes):
        return max(2, math.ceil(200e6 / nbytes))

    # host µs a call, at a small shape where the device keeps up
    q1, kn1, vn1 = randn(1, 8, D), randn(1, 8, D), randn(1, 8, D)
    c1 = (*kq.kv_quant(randn(1, 8, 128, D), "int8"),
          *kq.kv_quant(randn(1, 8, 128, D), "int8"))
    p1 = torch.tensor([100], dtype=torch.int32, device=dev)
    qb, pb = randn(8, 8, D), torch.tensor(SLOT_POS, dtype=torch.int32,
                                          device=dev) % 128
    kb, vb = randn(8, 8, 128, D), randn(8, 8, 128, D)
    from neural_compressor_tpu_torch.kernels import _build

    lib = _build.library()

    class Recorder:         # the C entry a wrapper calls, and its arguments
        def __getattr__(self, name):
            def call(*a):
                self.last = (getattr(lib, name), a)
                return 0
            return call

    k1b, v1b = randn(1, 8, 128, D), randn(1, 8, 128, D)
    wo = to_hopper(pack_qtensor(quantize_tensor(
        torch.randn(8 * D, 1024, generator=gen, device=dev) * 0.03, bits=4,
        group_size=D)))
    r1 = randn(1024)
    for label, fn in (
            ("decode_attn B=1 T=128", lambda: K.decode_attn(q1, k1b, v1b,
                                                             p1)),
            ("decode_attn_quant B=1 T=128", lambda: K.decode_attn_quant(
                q1, kn1, vn1, *c1, p1)),
            ("batched_decode_attn B=8 T=128", lambda: K.batched_decode_attn(
                qb, kb, vb, pb)),
            ("decode_attn_write bf16 B=1 T=128", lambda: K.decode_attn_write(
                q1, kn1, vn1, k1b, None, v1b, None, p1)),
            ("decode_attn_write int8 B=1 T=128", lambda: K.decode_attn_write(
                q1, kn1, vn1, *c1, p1)),
            ("attn_o H=8 T=128 N=1024", lambda: K.attn_o(
                q1[0], k1b[0], v1b[0], p1, wo.packed, wo.scales, r1))):
        whole = host_us(fn)
        torch.cuda.synchronize()
        rec = Recorder()
        _build._lib = rec
        try:
            python = host_us(fn)     # the C entry not called
        finally:
            _build._lib = lib
        entry, a = rec.last
        centry = host_us(lambda: entry(*a))
        torch.cuda.synchronize()
        print(f"host us a call, {label}: {whole:.2f} (C entry {centry:.2f}, "
              f"its {len(a)} arguments; Python around it {python:.2f})",
              flush=True)

    cases = {}
    q8 = randn(8, H, D)
    pos8 = torch.tensor(SLOT_POS, dtype=torch.int32, device=dev)
    for fmt in ("bf16", "int8", "fp8_e4m3"):
        esize = 2 if fmt == "bf16" else 1
        nb = 2 * 8 * HKV * T * (D * esize + (0 if fmt == "bf16" else 4))
        if fmt == "bf16":
            caches = [(randn(8, HKV, T, D), None, randn(8, HKV, T, D), None)
                      for _ in range(n_copies(nb))]
        else:
            caches = [(*kq.kv_quant(randn(8, HKV, T, D), fmt),
                       *kq.kv_quant(randn(8, HKV, T, D), fmt))
                      for _ in range(n_copies(nb))]
        cases[f"k7 {fmt} B=8 pos={SLOT_POS}"] = (
            [lambda c=c: K.batched_decode_attn(q8, c[0], c[2], pos8, c[1],
                                               c[3]) for c in caches],
            lambda c=caches[0]: K.batched_decode_attn_plain(
                q8.cpu(), c[0].cpu(), c[2].cpu(), pos8.cpu(),
                *(None if t is None else t.cpu() for t in (c[1], c[3]))))
    q1, kn1, vn1 = randn(1, H, D), randn(1, HKV, D), randn(1, HKV, D)
    for fmt in ("int8", "fp8_e4m3"):
        nb = 2 * HKV * T * (D + 4)
        caches = [(*kq.kv_quant(randn(1, HKV, T, D), fmt),
                   *kq.kv_quant(randn(1, HKV, T, D), fmt))
                  for _ in range(n_copies(nb))]
        for pos in K6_POS:
            cases[f"k6 {fmt} B=1 pos={pos}"] = (
                [lambda c=c, pos=pos: K.decode_attn_quant(q1, kn1, vn1, *c,
                                                          pos)
                 for c in caches],
                lambda c=caches[0], pos=pos: K.decode_attn_quant_plain(
                    q1.cpu(), kn1.cpu(), vn1.cpu(),
                    *(t.cpu() for t in c), pos))
    caches = [(randn(1, HKV, T, D), randn(1, HKV, T, D))
              for _ in range(n_copies(2 * HKV * T * D * 2))]
    for pos in K6_POS:
        pos1 = torch.tensor([pos], dtype=torch.int32, device=dev)
        cases[f"k5 bf16 B=1 pos={pos}"] = (
            [lambda c=c, p=pos1: K.decode_attn(q1, c[0], c[1], p)
             for c in caches],
            lambda c=caches[0], p=pos1: K.decode_attn_plain(
                q1.cpu(), c[0].cpu(), c[1].cpu(), p.cpu()))
    # K16's write, over caches of its own: its calls store the same row at
    # pos each time (a case's reference is taken before its first call)
    wcaches = [(a.clone(), b.clone()) for a, b in caches]
    for pos in K6_POS:
        pos1 = torch.tensor([pos], dtype=torch.int32, device=dev)
        cases[f"k16w bf16 B=1 pos={pos}"] = (
            [lambda c=c, p=pos1: K.decode_attn_write(q1, kn1, vn1, c[0],
                                                     None, c[1], None, p)
             for c in wcaches],
            lambda c=wcaches[0], p=pos1: K.decode_attn_write_plain(
                q1.cpu(), kn1.cpu(), vn1.cpu(), c[0].cpu(), None,
                c[1].cpu(), None, p.cpu()))
    kz = kn1.clone()
    kz[0, 1] = 0                     # an all-zero new row
    caches8 = [(*kq.kv_quant(randn(1, HKV, T, D), "int8"),
                *kq.kv_quant(randn(1, HKV, T, D), "int8"))
               for _ in range(n_copies(2 * HKV * T * (D + 4)))]
    for pos in K6_POS:
        pos1 = torch.tensor([pos], dtype=torch.int32, device=dev)
        cases[f"k16w int8 B=1 pos={pos}"] = (
            [lambda c=c, p=pos1: K.decode_attn_write(q1, kz, vn1, *c, p)
             for c in caches8],
            lambda c=caches8[0], p=pos1: K.decode_attn_write_plain(
                q1.cpu(), kz.cpu(), vn1.cpu(), *(t.cpu() for t in c),
                p.cpu()))
    # K18: the caches above as one slot's, the o weights in copies
    pw = to_hopper(pack_qtensor(quantize_tensor(
        torch.randn(H * D, N_O, generator=gen, device=dev) * (H * D) ** -0.5,
        bits=4, group_size=D)))
    wbytes = pw.packed.numel() + pw.scales.numel() * 4
    wcs = [(pw.packed.clone(), pw.scales.clone())
           for _ in range(n_copies(wbytes))]
    qh, res = q1[0], randn(N_O)
    n18 = max(len(caches), len(wcs))
    for pos in K6_POS:
        pos1 = torch.tensor([pos], dtype=torch.int32, device=dev)
        cases[f"k18 B=1 pos={pos} N={N_O}"] = (
            [lambda i=i, p=pos1: K.attn_o(
                qh, caches[i % len(caches)][0][0],
                caches[i % len(caches)][1][0], p, *wcs[i % len(wcs)], res)
             for i in range(n18)],
            lambda p=pos1: K.attn_o_plain(
                qh.cpu(), caches[0][0][0].cpu(), caches[0][1][0].cpu(),
                p.cpu(), pw.packed.cpu(), pw.scales.cpu(), res.cpu()))
    # the yardstick of K5's rows (never used by the port): SDPA over the
    # visited rows, its event, device and back-to-back ms
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for pos in K6_POS:
        fns = [lambda c=c, n=pos + 1: sdpa(q1[:, :, None], c[0][:, :, :n],
                                          c[1][:, :, :n]) for c in caches]
        yardstick(torch, f"sdpa beside k5 and k16w bf16 B=1 pos={pos}", fns)
        deq = [(kq.kv_dequant(c[0], c[1], torch.bfloat16),
                kq.kv_dequant(c[2], c[3], torch.bfloat16))
               for c in caches8[:4]]
        fns = [lambda c=c, n=pos + 1: sdpa(q1[:, :, None], c[0][:, :, :n],
                                          c[1][:, :, :n]) for c in deq]
        yardstick(torch, f"sdpa beside k16w int8 B=1 pos={pos}", fns)
        # K18's: SDPA then torch.matmul of the o weights in bf16
        wds = [dequantize_packed(pw, torch.bfloat16)] + [
            dequantize_packed(pw, torch.bfloat16).clone()
            for _ in range(n_copies(H * D * N_O * 2) - 1)]
        fns = [lambda i=i, n=pos + 1: torch.matmul(sdpa(
            qh[None, :, None], caches[i % len(caches)][0][:, :, :n],
            caches[i % len(caches)][1][:, :, :n]).reshape(1, H * D),
            wds[i % len(wds)]) for i in range(max(len(caches), len(wds)))]
        yardstick(torch, f"sdpa + torch.matmul beside k18 B=1 pos={pos}",
                  fns)
        del wds
    plans = [{}]
    if args.sweep:
        plans += [dict(PART_KEYS=pk, THREADS_D128=nt)
                  for pk, nt in itertools.product((64, 128, 192, 256),
                                                  (128, 256))]
        plans += [dict(PART_KEYS=pk, RING_STAGES=st)
                  for pk, st in ((192, 2), (256, 2), (256, 3))]
        plans += [dict(RING_STAGES=1), dict(LSUM_PARTS=0)]
        if hasattr(fm, "ATTN_O_COLS"):      # K18's o-projection stage
            plans += [dict(ATTN_O_COLS=c) for c in (8, 32, 64)]
            plans += [dict(ATTN_O_DEPENDENT=1)]
    refs = {}
    bad = []
    for plan in plans:
        k18_only = any(k.startswith("ATTN_O_") for k in plan)
        mod = fm if k18_only else da
        saved = {k: getattr(mod, k) for k in plan}
        for k, v in plan.items():
            setattr(mod, k, v)
        if plan:
            da.decode_plan.cache_clear()
        try:
            for label, (fns, plain) in cases.items():
                if "LSUM_PARTS" in plan and label.startswith("k7"):
                    continue        # K7 has no third launch
                if k18_only and not label.startswith("k18"):
                    continue
                if label not in refs:
                    refs[label] = plain()
                out = fns[0]()
                ref = refs[label]
                torch.cuda.synchronize()
                d = (out.float().cpu() - ref.float()).abs()
                tol = 2.0 ** -7 * ref.float().abs() + 2.0 ** -20
                equal = torch.equal(out.cpu(), ref)
                ok = (chip_smoke.ulp_check(torch, out.cpu(), ref)[2]
                      if label.startswith("k18") else equal)
                if not ok:
                    bad.append(f"{plan} {label}")
                ms = chip_smoke.timed_ms(torch, fns, 100)
                kern = chip_smoke.profiled(torch, fns, names=NAMES)
                bms = chip_smoke.backlog_ms(torch, fns, 200)
                print(f"{plan or 'plan as committed'} {label}: equal={equal} "
                      f"max_abs_err={float(d.max()):.3e} within kv_tol="
                      f"{bool((d <= tol).all())} ms={ms:.4f} "
                      f"device_ms={sum(kern.values()):.4f} "
                      f"back_to_back_ms={bms:.4f} "
                      f"{ {k: round(v, 4) for k, v in kern.items()} }",
                      flush=True)
        finally:
            for k, v in saved.items():
                setattr(mod, k, v)
            if plan:
                da.decode_plan.cache_clear()
    print(f"off their plain versions: {bad}" if bad else
          "every case bit for bit (K18 within ulp_check)", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
