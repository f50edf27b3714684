#!/usr/bin/env python3
"""Kernel sweeps for the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 tools/perf_torch_kernels.py [k1] [k3] [k3bwd] [k2] [wavenet] [k1probe] [k3bwdprobe]
                                        [mmarate]

k1: the depthwise conv + PReLU kernel at the main path's shape, the long
    phrase's and the ConvNeXt-like k = 7 shape in bf16: the generic kernel and
    the tile kernel at each tile length it is built for and several spans
    (tiles a block; direct calls of the C function), each checked against the
    plain version, with the achieved GB/s (of the 2 x B x T x C x 2 bytes a
    call must move), the wrapper's own choice, the bound, a plain copy of the
    tensor (what the card's memory really gives) and ``F.conv1d(groups=C)``
    beside it.
k3: the flash-attention kernel at each tile size BQ it is built for (direct
    calls of the C function, so the wrapper's choice is not in the way) at the
    encoder's shapes, checked against the plain version, with the wrapper's
    own choice, SDPA and the float32 bound beside it.
k3bwd: K3's backward (3xTF32 on the tensor cores) over L in 32, 128, 512,
    1024 and B * H in 32, 96 (H = 2, D = 128, each row's tail padded as in
    ``chip_smoke.py``), checked against the plain backward (1e-4 of the
    largest entry): the wrapper's time, its two kernels together in one C
    call, the bound of its route (3xTF32) and that of float32 on the CUDA
    cores, and SDPA's backward with a bool mask.
k2: the conv module's two bf16 GEMMs alone at the main shape, with
    ``torch.matmul`` on the same operands as a yardstick (it computes no LN,
    SwiGLU or bias, and the port never calls it).

wavenet: K4, the WaveNet's residual blocks. In float32, as the pitch WaveNet
    (20 blocks of 256, dilations 1-16) and the variance WaveNet (10 of 192,
    1-8) run them, at [16, 1024] and a served chunk's [16, 861]: a block on
    the kernels and on the stock ops (the plain version), each averaged over
    the stack; kernel A (conv + gate) at each dilation and kernel B (output
    projection, residual, skip, next input) alone, with their float32
    bounds; checked against the plain version (1e-4). In bfloat16, as the
    acoustic WaveNet (20 blocks of 512, dilations 1-8) runs it, at [16, 544]
    (about the render cell's mean chunk) and [16, 861]: a block on the
    tensor-core kernels, kernel A at each dilation and kernel B alone,
    beside their bf16 bounds, the float32 route and the stock bf16 ops at
    the same shapes; checked against the bf16
    route's plain version (2^-6 of the largest entry), and against the
    float32 stack (2^-7, and no further than the stock bf16 ops). Then the
    opcodes of each kernel's SASS (``cuobjdump``): the float32 kernels must
    hold no HMMA or HGMMA, the bf16 ones HGMMA.

k1probe (only when named): where K1's time goes. Builds ``depthwise_conv.cu``
    again with its probe macros (without the copies from device memory;
    without the multiply-adds; with chunks of 8 and 32 rows; with three
    blocks an SM), times each at the main shape, and counts the instructions
    of the k = 31 tile kernel by opcode (``cuobjdump``, where the toolkit
    has it). Probe builds compute nothing useful and are checked against
    nothing.

k3bwdprobe (only when named): K3's backward built again with its probe
    macro (one TF32 product instead of three, which misses the tolerance)
    beside the shipped build: each kernel alone at [48, 2, 128, 128], its
    registers and spills, and its error. The difference is what the two extra
    products of 3xTF32 cost.
mmarate (only when named): the rate and latency of mma.sync m16n8k8 tf32
    (``tools/mma_rate.cu``): one chain of dependent products a warp, and
    eight, at 2 blocks of 8 warps an SM.

Times are CUDA-event means over 20 launches after 3 warm-ups. Exits non-zero
if a kernel disagrees with its plain version.
"""

from __future__ import annotations

import collections
import ctypes
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from diffsinger_tpu_torch.ops import depthwise_conv as dw  # noqa: E402
from diffsinger_tpu_torch.ops import flash_attention as fa  # noqa: E402
from diffsinger_tpu_torch.ops import lynx_fused as lf  # noqa: E402
from diffsinger_tpu_torch.ops import native  # noqa: E402

PEAK_F32 = 67e12  # H100 SXM, CUDA cores
PEAK_TF32 = 495e12  # H100 SXM, TF32 tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM, device memory
PEAK_BF16 = 989e12  # H100 SXM, bf16 tensor cores, dense


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


def sweep_k1(dev, gen) -> int:
    lib = native.load("depthwise_conv")
    bf = torch.bfloat16
    bad = 0
    for b, t, c, k in ((16, 1024, 2048, 31), (1, 4096, 2048, 31), (16, 1024, 512, 7)):
        x = torch.randn(b, t, c, generator=gen, device=dev).to(bf)
        w = (0.2 * torch.randn(c, k, generator=gen, device=dev)).to(bf)
        bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(bf)
        alpha = (0.1 + 0.3 * torch.rand(c, generator=gen, device=dev)).to(bf)
        want = dw.depthwise_conv1d_prelu_plain(x, w, alpha, bias)
        tol = 2 ** -7 * want.float().abs().max().item()  # one bf16 ulp of the largest output
        out = torch.empty_like(x)
        moved = 2 * x.numel() * 2
        bound = max((moved + 2 * (w.numel() + 2 * c)) / PEAK_BYTES,
                    2 * k * x.numel() / PEAK_F32) * 1e3

        def call(rows, span):
            native.check(lib.ds_dwconv_prelu(
                x.data_ptr(), w.data_ptr(), bias.data_ptr(), alpha.data_ptr(), out.data_ptr(),
                b, t, c, k, 1, rows, span, 0, native.stream_ptr(x)), "depthwise_conv1d_prelu")

        choices = [(0, 1)] + [(rows, span) for rows in reversed(dw.TILE_ROWS)
                              for span in (1, 2, 4, 8, 16, 64) if span == 1 or span < 2 * t // rows]
        for rows, span in choices:
            out.fill_(float("nan"))
            call(rows, span)
            err = (out.float() - want.float()).abs().max().item()
            bad += not err <= tol
            ms = time_ms(lambda: call(rows, span))
            name = "generic" if rows == 0 else f"tile {rows} x {span}"
            print(f"K1 [{b},{t},{c}] k={k} {name}: {ms:.4f} ms, {moved / ms / 1e6:.0f} GB/s, "
                  f"max|err| {err:.2e} (tolerance {tol:.2e})")
        x_t, w_conv = x.transpose(1, 2).contiguous(), w[:, None, :].contiguous()
        print("   wrapper (tile %d x %d) " % dw.choose_tile(b, t, c, k) +
              f"{time_ms(lambda: dw.depthwise_conv1d_prelu(x, w, alpha, bias)):.4f} ms; "
              "F.conv1d(groups=C), channel-first, no PReLU "
              f"{time_ms(lambda: F.conv1d(x_t, w_conv, bias, padding=k // 2, groups=c)):.4f} ms; "
              f"a copy of x {time_ms(lambda: out.copy_(x)):.4f} ms; bound {bound:.4f} ms")
    return bad


def probe_k1(dev, gen) -> int:
    src = native.CSRC / "depthwise_conv.cu"
    out_dir = native.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    builds = {
        "as shipped": [],
        "no copies from device memory": ["-DDW_PROBE_NO_LOAD"],
        "one multiply-add a row": ["-DDW_PROBE_NO_FMA"],
        "no staging at all": ["-DDW_PROBE_NO_STAGE"],
        "no staging, no stores": ["-DDW_PROBE_NO_STAGE", "-DDW_PROBE_NO_STORE"],
        "no stores": ["-DDW_PROBE_NO_STORE"],
        "chunks of 8 rows": ["-DDW_PROBE_R=8"],
        "chunks of 32 rows, 3 blocks an SM": ["-DDW_PROBE_R=32", "-DDW_PROBE_BLOCKS=3"],
        "3 blocks an SM": ["-DDW_PROBE_BLOCKS=3"],
    }
    procs = {}
    for n, (name, flags) in enumerate(builds.items()):
        lib_path = out_dir / f"libk1_probe{n}.so"
        procs[name] = (lib_path, subprocess.Popen(
            [nvcc, *native.NVCC_FLAGS, *flags, "-o", str(lib_path), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    b, t, c, k = 16, 1024, 2048, 31
    bf = torch.bfloat16
    x = torch.randn(b, t, c, generator=gen, device=dev).to(bf)
    w = (0.2 * torch.randn(c, k, generator=gen, device=dev)).to(bf)
    bias = torch.zeros(c, device=dev, dtype=bf)
    alpha = torch.full((c,), 0.25, device=dev, dtype=bf)
    out = torch.empty_like(x)
    rows, span = dw.choose_tile(b, t, c, k)
    kernel = f"dwconv_prelu_tile_kernelI13__nv_bfloat16Li{k}ELi{rows}E"
    for name, (lib_path, proc) in procs.items():
        msg, _ = proc.communicate()
        if proc.returncode:
            print(msg)
            return 1
        lines = msg.splitlines()
        used = next((" ".join(part.replace("ptxas info    :", "").strip()
                              for part in lines[i + 2:i + 4])
                     for i, line in enumerate(lines) if "Compiling" in line and kernel in line), "")
        lib = ctypes.CDLL(str(lib_path))
        lib.ds_dwconv_prelu.argtypes = list(native.SIGNATURES[("depthwise_conv", "ds_dwconv_prelu")])
        ms = time_ms(lambda: native.check(lib.ds_dwconv_prelu(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), alpha.data_ptr(), out.data_ptr(),
            b, t, c, k, 1, rows, span, 0, native.stream_ptr(x)), "probe"))
        print(f"K1 probe [{b},{t},{c}] k={k} tile {rows} x {span}, {name}: {ms:.4f} ms ({used})")
    print(f"   a copy of x: {time_ms(lambda: out.copy_(x)):.4f} ms")
    # the SM clock and the power draw while the shipped kernel runs back to back
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                            "--format=csv,noheader", "-lms", "250"],
                           stdout=subprocess.PIPE, text=True)
    for _ in range(30000):
        dw.depthwise_conv1d_prelu(x, w, alpha, bias)
    torch.cuda.synchronize()
    smi.terminate()
    samples = smi.communicate()[0].strip().splitlines()
    print(f"   under load (clocks.sm, clocks.max.sm, power.draw): {samples[1:-1][:8]}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        print("   no cuobjdump: instructions not counted")
        return 0
    sass = subprocess.run([cuobjdump, "-sass", str(procs["as shipped"][0])],
                          capture_output=True, text=True).stdout
    counts, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)", line)
        if inside and m:
            counts[m.group(1)] += 1
    print(f"   instructions of the k={k} {rows}-row bf16 tile kernel (whole kernel, the chunk is "
          f"unrolled once): {sum(counts.values())}: {dict(counts.most_common(12))}")
    return 0


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
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, out.data_ptr(), None, b, h,
                length, d, 1 / math.sqrt(d), bq, native.stream_ptr(q)), "flash_attention")

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


def sweep_k3bwd(dev, gen) -> int:
    lib = native.load("flash_attention")
    bad = 0
    for length in (32, 128, 512, 1024):
        for b in (16, 48):
            h, d = 2, 128
            scale = d ** -0.5
            q, k, v, dout = (torch.randn(b, h, length, d, generator=gen, device=dev)
                             for _ in range(4))
            pad = torch.zeros(b, length, dtype=torch.bool, device=dev)
            for i in range(b):
                pad[i, length - (7 * i) % (length // 2):] = True
            lse = torch.empty(b, h, length, device=dev)
            out = fa._launch_fwd(q, k, v, pad, scale, lse)
            got = fa.flash_attention_bwd(q, k, v, pad, out, lse, dout, sm_scale=scale)
            want = fa.flash_attention_bwd_plain(q, k, v, pad, out, lse, dout, sm_scale=scale)
            err = max((a - w).abs().max().item() / w.abs().max().item()
                      for a, w in zip(got, want))
            bad += not err <= 1e-4
            ds = fa.bwd_scratch(b * h, length, dev)
            grads = [torch.empty_like(q) for _ in range(3)]
            args = [t.data_ptr() for t in (q, k, v, pad.view(torch.uint8), out, dout, lse, ds,
                                           *grads)]
            stream = native.stream_ptr(q)
            alone = time_ms(lambda: native.check(lib.ds_flash_attn_bwd(
                *args, b, h, length, d, scale, 3, stream), "flash_attention bwd"))
            wrapper = time_ms(lambda: fa.flash_attention_bwd(q, k, v, pad, out, lse, dout,
                                                             sm_scale=scale))
            visible = pad[:, None, :, None] == pad[:, None, None, :]
            flop = 10 * int(visible.sum().item()) * h * d
            bytes_ = 4 * 8 * q.numel() + 4 * lse.numel() + pad.numel()
            bound_tc = max(3 * flop / PEAK_TF32, bytes_ / PEAK_BYTES) * 1e3
            bound_f32 = max(flop / PEAK_F32, bytes_ / PEAK_BYTES) * 1e3
            qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
            o = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=visible)
            sdpa = time_ms(lambda: torch.autograd.grad(o, (qr, kr, vr), dout, retain_graph=True))
            print(f"K3-bwd [{b},{h},{length},{d}] padded: wrapper {wrapper:.4f} ms, kernels "
                  f"{alone:.4f} ms; bound {bound_tc:.4f} ms (3xTF32), {bound_f32:.4f} ms "
                  f"(float32, CUDA cores); SDPA backward {sdpa:.4f} ms; max|err|/max|ref| {err:.2e}")
    return bad


def probe_k3bwd(dev, gen) -> int:
    src = native.CSRC / "flash_attention.cu"
    out_dir = native.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    builds = {"as shipped": [], "one TF32 product (misses the tolerance)": ["-DDS_PROBE_ONE_MMA"]}
    procs = {}
    for n, (name, flags) in enumerate(builds.items()):
        lib_path = out_dir / f"libk3bwd_probe{n}.so"
        procs[name] = (lib_path, subprocess.Popen(
            [nvcc, *native.NVCC_FLAGS, *flags, "-o", str(lib_path), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    b, h, length, d = 48, 2, 128, 128
    scale = d ** -0.5
    q, k, v, dout = (torch.randn(b, h, length, d, generator=gen, device=dev) for _ in range(4))
    pad = torch.zeros(b, length, dtype=torch.bool, device=dev)
    for i in range(b):
        pad[i, length - (7 * i) % (length // 2):] = True
    lse = torch.empty(b, h, length, device=dev)
    out = fa._launch_fwd(q, k, v, pad, scale, lse)
    want = fa.flash_attention_bwd_plain(q, k, v, pad, out, lse, dout, sm_scale=scale)
    ds = fa.bwd_scratch(b * h, length, dev)
    grads = [torch.empty_like(q) for _ in range(3)]
    args = [t.data_ptr() for t in (q, k, v, pad.view(torch.uint8), out, dout, lse, ds, *grads)]
    for name, (lib_path, proc) in procs.items():
        msg, _ = proc.communicate()
        if proc.returncode:
            print(msg)
            return 1
        lines = msg.splitlines()
        used = {kern: next((" ".join(part.replace("ptxas info    :", "").strip()
                                     for part in lines[i + 2:i + 4])
                            for i, line in enumerate(lines)
                            if "Compiling" in line and f"flash_bwd_{kern}_kernelILi128" in line), "")
                for kern in ("dkv", "dq")}
        lib = ctypes.CDLL(str(lib_path))
        lib.ds_flash_attn_bwd.argtypes = list(native.SIGNATURES[("flash_attention", "ds_flash_attn_bwd")])

        def call(parts):
            native.check(lib.ds_flash_attn_bwd(*args, b, h, length, d, scale, parts,
                                               native.stream_ptr(q)), "probe")

        call(3)
        err = max((a - w).abs().max().item() / w.abs().max().item() for a, w in zip(grads, want))
        print(f"K3-bwd probe [{b},{h},{length},{d}], {name}: dK/dV {time_ms(lambda: call(1)):.4f} "
              f"ms ({used['dkv']}), dQ {time_ms(lambda: call(2)):.4f} ms ({used['dq']}); "
              f"max|err|/max|ref| {err:.2e}")
    return 0


def mma_rate(dev) -> int:
    out_dir = native.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libmma_rate.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *native.NVCC_FLAGS, "-o", str(lib_path),
                    str(Path(__file__).resolve().parent / "mma_rate.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    out = torch.zeros(1024, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout.split()[0]) * 1e6
    for blocks_per_sm, threads, chains in ((1, 128, 1), (2, 256, 8)):
        blocks, iters = sms * blocks_per_sm, 4000
        native.check(lib.mma_rate(out.data_ptr(), blocks, threads, 10, chains), "mma_rate")
        ms = time_ms(lambda: native.check(lib.mma_rate(out.data_ptr(), blocks, threads, iters,
                                                       chains), "mma_rate"), iters=3, warmup=1)
        per_sm = blocks * threads / 32 * iters * chains / sms / (ms * 1e-3)
        in_flight = blocks_per_sm * threads / 32 * chains
        print(f"mma.sync m16n8k8 tf32, {blocks_per_sm} x {threads} threads an SM, {chains} chain(s) "
              f"a warp: {per_sm * sms * 2048 / 1e12:.1f} TFLOP/s, {per_sm / 1e9:.3f} G mma/s an SM"
              + (f", {in_flight * clock / per_sm:.1f} clocks from one mma to the next of a chain "
                 f"at {clock / 1e6:.0f} MHz" if chains == 1 else ""))
    return 0


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


def sweep_wavenet(dev, gen) -> int:
    from diffsinger_tpu_torch.ops import wavenet_block as wb
    from diffsinger_tpu_torch.utils import no_tf32

    lib = native.load("wavenet_block")
    bad = 0
    # (B, T, C, blocks, dilation cycle): the pitch WaveNet's and the variance WaveNet's widths
    for b, t, c, layers, cycle in ((16, 1024, 256, 20, 5), (16, 861, 256, 20, 5),
                                   (16, 1024, 192, 10, 4), (16, 861, 192, 10, 4)):
        dilations = [2 ** (i % cycle) for i in range(layers)]

        def rnd(*shape, scale=1.0):
            return scale * torch.randn(shape, generator=gen, device=dev)

        x, step = rnd(b, t, c), rnd(b, c)
        cond_proj = rnd(layers, b, t, 2 * c)
        weights = ([rnd(c, c, scale=0.05) for _ in dilations],
                   [rnd(c, scale=0.1) for _ in dilations],
                   [rnd(2 * c, c, 3, scale=0.05) for _ in dilations],
                   [rnd(2 * c, scale=0.1) for _ in dilations],
                   [rnd(2 * c, c, 1, scale=0.05) for _ in dilations],
                   [rnd(2 * c, scale=0.1) for _ in dilations], dilations)
        with torch.no_grad(), no_tf32():
            want = wb.residual_stack_plain(x, step, cond_proj, *weights)
            got = wb.residual_stack(x, step, cond_proj, *weights)
            err = (got - want).abs().max().item()
            bad += not err <= 1e-4
            ms = time_ms(lambda: wb.residual_stack(x, step, cond_proj, *weights)) / layers
            ms_plain = time_ms(lambda: wb.residual_stack_plain(x, step, cond_proj, *weights)
                               ) / layers
        m = b * t
        flops_a, flops_b = 2 * m * 3 * c * 2 * c, 2 * m * c * 2 * c
        # the k-major weights and the step projections the stack's calls made and kept
        w_conv, w_out, b_conv, b_out = wb.kept(weights[2][0],
                                               [w for ws in weights[2:6] for w in ws], None)
        d = wb.step_projections(step, weights[0], weights[1])
        xd, z, out, skip, xd_next = (torch.empty_like(x) for _ in range(5))
        stream = native.stream_ptr(x)
        times_a = {}
        for i in range(cycle):
            times_a[dilations[i]] = time_ms(lambda: native.check(lib.ds_wavenet_conv_gate(
                xd.data_ptr(), w_conv[i].data_ptr(), b_conv[i].data_ptr(),
                cond_proj[i].data_ptr(), z.data_ptr(), b, t, c, dilations[i], stream), "A"))
        ms_b = time_ms(lambda: native.check(lib.ds_wavenet_out_skip(
            z.data_ptr(), w_out[0].data_ptr(), b_out[0].data_ptr(), x.data_ptr(),
            out.data_ptr(), skip.data_ptr(), 0, wb.INV_SQRT2, d[:, 1].data_ptr(),
            xd_next.data_ptr(), layers * c, b, t, c, stream), "B"))
        ms_a = sum(times_a.values()) / len(times_a)
        print(f"K4 [{b},{t},{c}] x {layers} blocks: {ms:.4f} ms a block on the kernels, "
              f"{ms_plain:.4f} ms on the stock ops; A {ms_a:.4f} ms "
              f"({flops_a / ms_a / 1e9:.1f} TFLOP/s, bound {flops_a / PEAK_F32 * 1e3:.4f}; by "
              f"dilation {', '.join(f'{k}: {v:.4f}' for k, v in times_a.items())}), "
              f"B {ms_b:.4f} ms ({flops_b / ms_b / 1e9:.1f} TFLOP/s, bound "
              f"{flops_b / PEAK_F32 * 1e3:.4f}); max|err| {err:.2e} (tolerance 1e-4)")
    bad += sweep_wavenet_bf16(dev, gen)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(native.library_path("wavenet_block"))],
                          capture_output=True, text=True).stdout
    # opcodes by kernel: the float32 kernels (wavenet_block_kernel) and the
    # tensor-core ones (wavenet_tc_kernel)
    ops = {"float32": collections.Counter(), "bf16": collections.Counter()}
    kind = None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            kind = ("bf16" if "wavenet_tc_kernel" in fn.group(1) else
                    "float32" if "wavenet_block_kernel" in fn.group(1) else None)
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)", line)
        if m and kind:
            ops[kind][m.group(1)] += 1
    for kind, counts in ops.items():
        tensor = {op: n for op, n in counts.items() if "MMA" in op}
        print(f"   SASS of the {kind} kernels: {sum(counts.values())} instructions, "
              f"FFMA {counts.get('FFMA', 0)}, tensor-core ops {tensor or 'none'}")
    return (bad + (not ops["float32"]) + any("MMA" in op for op in ops["float32"])
            + (ops["bf16"].get("HGMMA", 0) == 0))


def sweep_wavenet_bf16(dev, gen) -> int:
    """The tensor-core route at the acoustic WaveNet's width (see the module
    note)."""
    from diffsinger_tpu_torch.ops import wavenet_block as wb
    from diffsinger_tpu_torch.utils import no_tf32

    lib = native.load("wavenet_block")
    bad = 0
    bf = torch.bfloat16
    for b, t, c, layers, cycle in ((16, 544, 512, 20, 4), (16, 861, 512, 20, 4)):
        dilations = [2 ** (i % cycle) for i in range(layers)]

        def rnd(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen, device=dev)).to(bf)

        args = (rnd(b, t, c), rnd(b, c), rnd(layers, b, t, 2 * c),
                [rnd(c, c, scale=c ** -0.5) for _ in dilations],
                [rnd(c, scale=0.1) for _ in dilations],
                [rnd(2 * c, c, 3, scale=(3 * c) ** -0.5) for _ in dilations],
                [rnd(2 * c, scale=0.1) for _ in dilations],
                [rnd(2 * c, c, 1, scale=c ** -0.5) for _ in dilations],
                [rnd(2 * c, scale=0.1) for _ in dilations], dilations)
        as_f32 = tuple([w.float() for w in a] if isinstance(a, list) and a is not dilations
                       else a.float() if torch.is_tensor(a) else a for a in args)
        with torch.no_grad(), no_tf32():
            want = wb.residual_stack_plain(*as_f32)
            plain = wb.residual_stack_bf16_plain(*args)
            stock = wb.residual_stack_plain(*args)
            ms_stock = time_ms(lambda: wb.residual_stack_plain(*args)) / layers
            ms_f32 = time_ms(lambda: wb.residual_stack(*as_f32)) / layers
        scale = want.abs().max().item()
        err_stock = (stock.float() - want).abs().max().item()
        m = b * t
        flops_a, flops_b = 2 * m * 3 * c * 2 * c, 2 * m * c * 2 * c
        # A: x + d, the condition's 2C, z; B: z, x, x', the skip sum read and
        # written, the next x + d (bytes a frame and channel: 8 and 20)
        bound_a = max(flops_a / PEAK_BF16, (8 * m * c + 6 * c * 2 * c) / PEAK_BYTES) * 1e3
        bound_b = max(flops_b / PEAK_BF16, (20 * m * c + 2 * c * 2 * c) / PEAK_BYTES) * 1e3
        print(f"K4 bf16 [{b},{t},{c}] x {layers} blocks: bound {bound_a + bound_b:.4f} ms a "
              f"block (A {bound_a:.4f}, B {bound_b:.4f}); float32 route {ms_f32:.4f} ms, "
              f"stock bf16 ops {ms_stock:.4f} ms; stock bf16 max|err| against float32 "
              f"{err_stock / scale:.2e} of the largest entry")
        with torch.no_grad():
            got = wb.residual_stack(*args)
            ms = time_ms(lambda: wb.residual_stack(*args)) / layers
        err_plain = (got.float() - plain.float()).abs().max().item()
        err = (got.float() - want).abs().max().item()
        bad += not (err_plain <= 2 ** -6 * scale and err <= min(2 ** -7 * scale, err_stock))
        w_conv, w_out, b_conv, b_out = wb.kept(
            args[5][0], [w for ws in args[5:9] for w in ws], None)
        d = wb.step_projections(args[1], args[3], args[4])
        xd, z = torch.empty_like(args[0]), torch.empty_like(args[0])
        x, skip = torch.zeros(b, t, c, device=dev), torch.zeros(b, t, c, device=dev)
        stream = native.stream_ptr(x)
        times_a = {}
        for i in range(cycle):
            times_a[dilations[i]] = time_ms(lambda: native.check(lib.ds_wavenet_conv_gate_bf16(
                xd.data_ptr(), w_conv[i].data_ptr(), b_conv[i].data_ptr(),
                args[2][i].data_ptr(), z.data_ptr(), b, t, c, dilations[i], stream), "A"))
        ms_b = time_ms(lambda: native.check(lib.ds_wavenet_out_skip_bf16(
            z.data_ptr(), w_out[0].data_ptr(), b_out[0].data_ptr(), x.data_ptr(),
            x.data_ptr(), skip.data_ptr(), 0, wb.INV_SQRT2, d[:, 1].data_ptr(),
            xd.data_ptr(), layers * c, b, t, c, stream), "B"))
        ms_a = sum(times_a.values()) / len(times_a)
        print(f"   tensor cores: {ms:.4f} ms a block; A {ms_a:.4f} ms "
              f"({flops_a / ms_a / 1e9:.1f} TFLOP/s; by dilation "
              f"{', '.join(f'{k}: {v:.4f}' for k, v in times_a.items())}), "
              f"B {ms_b:.4f} ms ({(20 * m * c) / ms_b / 1e6:.0f} GB/s); max|err| against "
              f"the bf16 plain {err_plain / scale:.2e}, against float32 {err / scale:.2e} "
              f"of the largest entry")
    return bad


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    which = sys.argv[1:] or ["k1", "k3", "k3bwd", "k2"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    if "k1" in which:
        bad += sweep_k1(dev, gen)
    if "k1probe" in which:
        bad += probe_k1(dev, gen)
    if "k3" in which:
        bad += sweep_k3(dev, gen)
    if "k3bwd" in which:
        bad += sweep_k3bwd(dev, gen)
    if "k2" in which:
        bad += sweep_k2(dev, gen)
    if "wavenet" in which:
        bad += sweep_wavenet(dev, gen)
    if "k3bwdprobe" in which:
        bad += probe_k3bwd(dev, gen)
    if "mmarate" in which:
        bad += mma_rate(dev)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
