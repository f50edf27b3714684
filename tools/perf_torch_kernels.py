#!/usr/bin/env python3
"""Kernel sweeps for the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 tools/perf_torch_kernels.py [k3] [k2]

k3: the flash-attention kernel at each tile size BQ it is built for (direct
    calls of the C function, so the wrapper's choice is not in the way) at the
    encoder's shapes, checked against the plain version, with the wrapper's
    own choice, SDPA and the float32 bound beside it.
k2: the conv module's two bf16 GEMMs alone at the main shape, with
    ``torch.matmul`` on the same operands as a yardstick (it computes no LN,
    SwiGLU or bias, and the port never calls it).

Times are CUDA-event means over 20 launches after 3 warm-ups. Exits non-zero
if a kernel disagrees with its plain version.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from diffsinger_tpu_torch.ops import flash_attention as fa  # noqa: E402
from diffsinger_tpu_torch.ops import lynx_fused as lf  # noqa: E402
from diffsinger_tpu_torch.ops import native  # noqa: E402

PEAK_F32 = 67e12  # H100 SXM, CUDA cores


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sweep_k3(dev, gen) -> int:
    lib = native.load("flash_attention")
    bad = 0
    for b, h, length, d in ((16, 2, 128, 128), (16, 2, 512, 128), (1, 2, 512, 128)):
        q, k, v = (torch.randn(b, h, length, d, generator=gen, device=dev) for _ in range(3))
        pad = torch.zeros(b, length, dtype=torch.bool, device=dev)
        pad[-1, length // 2:] = True
        want = fa.flash_attention_plain(q, k, v, pad)
        visible = pad[:, None, :, None] == pad[:, None, None, :]
        out = torch.empty_like(q)
        pad_ptr = pad.view(torch.uint8).data_ptr()

        def call(bq):
            native.check(lib.ds_flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, out.data_ptr(), b, h, length, d,
                1 / math.sqrt(d), bq, native.stream_ptr(q)), "flash_attention")

        for bq in reversed(fa.BQ_CHOICES):
            out.fill_(float("nan"))
            call(bq)
            err = (out - want).abs().max().item()
            bad += not err <= 1e-4
            print(f"K3 [{b},{h},{length},{d}] BQ={bq}: {time_ms(lambda: call(bq)):.4f} ms, "
                  f"max|err| {err:.2e}")
        pairs = int(visible.sum().item()) * h
        print(f"   wrapper (BQ={fa.choose_bq(length, b * h)}) "
              f"{time_ms(lambda: fa.flash_attention(q, k, v, pad)):.4f} ms; SDPA "
              f"{time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=visible)):.4f}"
              f" ms; bound {4 * pairs * d / PEAK_F32 * 1e3:.4f} ms")
    return bad


def sweep_k2(dev, gen) -> int:
    lib = native.load("lynx_fused")
    bf = torch.bfloat16
    m, c, inner = 16 * 1024, 1024, 2048

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(bf)

    x, ln_w, ln_b = rnd(m, c), rnd(c, scale=0.2) + 1, rnd(c, scale=0.1)
    w1, b1 = rnd(2 * inner, c, scale=c ** -0.5), rnd(2 * inner, scale=0.1)
    w2, b2 = rnd(c, inner, scale=inner ** -0.5), rnd(c, scale=0.1)
    mean, rstd = torch.empty(m, device=dev), torch.empty(m, device=dev)
    s, y = torch.empty(m, inner, device=dev, dtype=bf), torch.empty(m, c, device=dev, dtype=bf)
    stream = native.stream_ptr(x)
    native.check(lib.ds_lynx_ln_stats(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), m, c,
                                      lf.LN_EPS, 1, stream), "ln_stats")
    t1 = time_ms(lambda: native.check(lib.ds_lynx_pw1_swiglu(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), s.data_ptr(), m, c, inner, 1, stream), "pw1"))
    t2 = time_ms(lambda: native.check(lib.ds_lynx_pw2(
        s.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(), m, inner, c, 1, stream), "pw2"))
    print(f"K2 pw1 {t1:.4f} ms ({4 * m * c * inner / t1 / 1e9:.1f} TFLOP/s), "
          f"pw2 {t2:.4f} ms ({2 * m * c * inner / t2 / 1e9:.1f} TFLOP/s), sum {t1 + t2:.4f} ms")
    print(f"   torch.matmul on the same operands: {time_ms(lambda: x @ w1.t()):.4f} ms and "
          f"{time_ms(lambda: s @ w2.t()):.4f} ms")
    want = s.float() @ w2.float().t() + b2.float()
    err = (y.float() - want).abs().max().item()
    tol = 2 ** -7 * want.abs().max().item()  # one bf16 ulp of the largest output
    print(f"   pw2 against float32 matmul: max|err| {err:.3e} (tolerance {tol:.3e})")
    return int(not err <= tol)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    which = sys.argv[1:] or ["k3", "k2"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    if "k3" in which:
        bad += sweep_k3(dev, gen)
    if "k2" in which:
        bad += sweep_k2(dev, gen)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
