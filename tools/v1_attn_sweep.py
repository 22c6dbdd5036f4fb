"""K15 (``paged_attn_v1``, the v1 paged decode attention) at the shapes of
the check's 8-slot step, for comparing two checkouts on one card: each
call against its plain version (``chip_smoke.ulp_check``: no output more
than one bf16 ulp off, at most ``VARIANT_ULP_SHARE`` of them one ulp), its
event ms (back-to-back calls, pools rotated through >200 MB of copies),
its device ms (torch.profiler: the call's kernels summed, and each kernel
apart), its back-to-back ms (calls queued behind a sleeping kernel, so
none waits for the host), and the wrapper's host µs a call: the whole
call, the C entry alone (its arguments' conversion by ctypes and the CUDA
launches) and the Python around it. The timers are ``chip_smoke.py``'s
(``timed_ms``, ``backlog_ms``, ``profiled``).

    python3 tools/v1_attn_sweep.py [--root <checkout>]

Cases: 8 slots at lengths ``chip_smoke.SLOT_POS`` + 1 over pools of 128-row
pages, 8 pages a slot, llama2-7b's 32 heads of 128, bf16, int8 and fp8-e4m3
pools; beside each, its yardstick SDPA over the rows gathered out of the
pages (event, device and back-to-back ms). ``--root`` imports the port from
another checkout (only the wrapper's public arguments are used), so run
parent, change, change, parent in one call.
"""

import argparse
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its timers; it imports no kernel at load)
from decode_attn_sweep import host_us, yardstick  # noqa: E402

H = HKV = 32
D, PAGE, PMAX = 128, 128, 8
# the kernels a case may launch, as torch.profiler names them: K15's split
# (K11's scores launch in its v1 form, then PV and the fold) and the
# one-block kernel of a parent checkout
NAMES = ("nctt_k11::scores_kernel", "nctt_v1::pv_fold_kernel",
         "paged_v1_kernel")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from neural_compressor_tpu_torch import kernels as K
    from neural_compressor_tpu_torch.kernels import _build
    from neural_compressor_tpu_torch.ops import kv_quant as kq

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), f"root={args.root}",
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(71)
    B = len(chip_smoke.SLOT_POS)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def pool(fmt, n_pages, hkv, d):
        kr, vr = randn(n_pages, hkv, PAGE, d), randn(n_pages, hkv, PAGE, d)
        if fmt == "bf16":
            return kr, None, vr, None
        return (*kq.kv_quant(kr, fmt), *kq.kv_quant(vr, fmt))

    n_pages = B * PMAX + 1
    bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                         .manual_seed(62)) + 1).reshape(B, PMAX)
    bt = bt.to(torch.int32).to(dev)
    lengths = torch.tensor(chip_smoke.SLOT_POS, dtype=torch.int32,
                           device=dev) + 1

    # host µs a call, at a small shape where the device keeps up
    lib = _build.library()
    p1 = pool("int8", 9, 8, D)
    q1 = randn(8, 8, D)
    bt1 = torch.arange(1, 9, dtype=torch.int32, device=dev).reshape(8, 1)
    l1 = torch.full((8,), 100, dtype=torch.int32, device=dev)

    class Recorder:         # the C entry a wrapper calls, and its arguments
        def __getattr__(self, name):
            def call(*a):
                self.last = (getattr(lib, name), a)
                return 0
            return call

    def fn():
        return K.paged_attn_v1(q1, *p1, bt1, l1)

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
    print(f"host us a call, paged_attn_v1 B=8 int8 length 100: {whole:.2f} "
          f"(C entry {centry:.2f}, its {len(a)} arguments; Python around it "
          f"{python:.2f})", flush=True)

    q = randn(B, H, D)
    bad = []
    for fmt in ("bf16", "int8", "fp8_e4m3"):
        esize = 2 if fmt == "bf16" else 1
        nb = 2 * n_pages * HKV * PAGE * D * esize
        pools = [pool(fmt, n_pages, HKV, D)
                 for _ in range(max(2, math.ceil(200e6 / nb)))]
        fns = [lambda p=p: K.paged_attn_v1(q, *p, bt, lengths)
               for p in pools]
        out = fns[0]()
        ref = K.paged_attn_v1_plain(q.cpu(), *(None if t is None else t.cpu()
                                               for t in pools[0]),
                                    bt.cpu(), lengths.cpu())
        torch.cuda.synchronize()
        err, share, ok = chip_smoke.ulp_check(torch, out.cpu(), ref)
        if not ok:
            bad.append(fmt)
        ms = chip_smoke.timed_ms(torch, fns, 100)
        kern = chip_smoke.profiled(torch, fns, names=NAMES)
        bms = chip_smoke.backlog_ms(torch, fns, 200)
        print(f"k15 {fmt} B={B} lengths={tuple(lengths.tolist())}: "
              f"equal={torch.equal(out.cpu(), ref)} max_abs_err={err:.3e} "
              f"ulp_share={share:.2e} ok={ok} ms={ms:.4f} "
              f"device_ms={sum(kern.values()):.4f} "
              f"back_to_back_ms={bms:.4f} "
              f"{ {k: round(v, 4) for k, v in kern.items()} }", flush=True)
        # the yardstick (never used by the port): SDPA over the rows
        # gathered out of the pages, dequantized to bf16 (not timed)
        Lmax = int(lengths.max())
        mask = (torch.arange(Lmax, device=dev)[None, :]
                < lengths[:, None])[:, None, None]

        def gathered(pages, scales):
            g = pages[bt.long()].transpose(1, 2).reshape(B, HKV, -1, D)
            if scales is not None:
                s_ = scales[bt.long()].transpose(1, 2).reshape(B, HKV, -1)
                g = g.float() * s_[..., None]
            return g[:, :, :Lmax].to(torch.bfloat16).contiguous()

        rows = [(gathered(p[0], p[1]), gathered(p[2], p[3])) for p in pools]
        fns = [lambda a=a, b=b: torch.nn.functional.
               scaled_dot_product_attention(q[:, :, None], a, b,
                                            attn_mask=mask)
               for a, b in rows]
        yardstick(torch, f"sdpa beside k15 {fmt}", fns)
        del pools, fns, rows
    print(f"outside ulp_check: {bad}" if bad else "every case within "
          "ulp_check", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
