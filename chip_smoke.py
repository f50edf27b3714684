#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:

1. card and build: the card's name and power limit (nvidia-smi), then the
   three CUDA kernels built from ``diffsinger_tpu_torch/ops/csrc`` at once;
2. kernels: each kernel against its plain PyTorch version at main-path
   shapes in the working dtype (bf16; K3 float32), with the max abs error
   beside its tolerance; K1 also at the shapes that break its tiles (ragged
   lengths, a length under the halo, an even and a one-tap kernel, a width
   that only the generic kernel takes), each with a large value in the last
   row of sequence 0 that must not reach sequence 1; K2 also in float32 at a
   small shape and in bf16 at ragged shapes (rows not a multiple of the tile,
   widths that are multiples of 32 and of nothing larger), K3 also at a
   ragged length without a mask;
3. e2e: the acoustic model (configs/acoustic.yaml at full width, seeded
   random weights, 50 euler steps, bf16) and the mini-NSF vocoder, driven
   through ``DiffSingerAcoustic.forward_infer`` and ``Generator``: timed
   requests at B=16, T_txt=128, T_mel=1024, with the host's own time in
   ``forward_infer`` (call to return, before any wait for the device) beside
   the acoustic seconds; one request with padding; one
   long phrase at T_txt=512. Launch counters, reset before each of these
   and read after it, show the kernels ran (per request: K2 and K1 6 x 50
   times, K3 4 times). A reduced-batch float32 run is compared with the same
   run on every kernel's plain version;
4. serve: a temporary experiment folder in the formats a user's files have
   (``config.yaml`` at full width with ``infer_precision: bf16``, the
   dictionary, the acoustic weights as ``model_ckpt_steps_1000.ckpt``, a
   full-NSF vocoder ``model.ckpt`` + ``config.json``; seeded random weights),
   loaded through ``utils/ckpt.py`` and ``NsfHifiGAN`` (a loader's warning of
   random weights fails the run, and every loaded tensor is held against the
   saved one). ``AcousticServer``
   with batches of 16 serves samples/09_xing_he.ds and samples/08_qiu_yu.ds
   together (17 segments of 423-793 frames): per chunk its batch, buckets and
   the host's split, then seconds, true mel frames/s, audio seconds per second
   and the padded share; the same call under the profiler; samples/00 through
   the entry point ``diffsinger_tpu_torch.cli.infer`` (a wav file) and the
   seconds per segment at B=1; three segments in float32 at 8 steps, kernels
   against plain versions, as served (after the 16-bit step: one step plus a
   thousandth of the signal's rms) and through ``forward_wav`` (a thousandth
   of the rms). Then K1, K2 and K3 against their plain versions at every
   (batch, token bucket, frame bucket) that the served chunks and the entry
   point's segments had, in the dtype they ran in. The folder is removed at
   the end;
5. variance: ``configs/variance.yaml`` at full width with all four variances
   on, float32, seeded random weights saved as a reference-format checkpoint
   in a temporary experiment folder; ``VarianceServer(max_batch_size=16)``
   over the 16 segments of samples 01-07 and 10: the chunks and their
   buckets, the call's seconds, the host's enqueue alone, predicted frames/s,
   the profile (idle share, kernel launches), K3's launches against 4 per
   chunk, K3 against plain at the chunks' shapes (and at the melody encoder's
   head dim 64), the first chunk in float32 on the kernels against the plain
   versions (durations before rounding, pitch, variances; 1e-3); then the
   chain (the predicted .ds through ``AcousticServer`` to wavs, true mel
   frames/s) and ``cli.infer variance`` on samples/01 (seconds with loading);
6. ddpm: the acoustic config with ``diffusion_type: ddpm`` (K_step 400,
   speedup 10) at B=16, T_mel=1024, bf16 under ddim, pndm, dpm-solver and
   unipc: mel frames/s of the acoustic part, K1 and K2 launches against 6 x
   the denoiser calls, and a float32 B=2, T_mel=512 request against the
   plain versions (mel 1e-3);
6b. lynx_act: LYNXNet with ``activation: SiLU`` or ``ReLU``: K1 and K2 with
   each against their plain versions (the main path's shapes, ragged ones,
   float32); configs/acoustic.yaml with SiLU at full width at the bench
   request with [e2e]'s mini-NSF vocoder (mel frames/s, K1 = K2 = 6 x 50 and
   K3 4 a request from the counters), the same weights under ReLU (two
   requests, their launches); a float32 SiLU request (B=1, T_mel 128, 8
   steps) on the card against the CPU (mel 1e-3); one float32 training step
   of a narrow SiLU model on the card against the CPU (as [train]'s); the
   SiLU experiment as a ``.pt2`` at (16, 64) on the card, launching K2 and
   bit-equal to eager; the kernel line's SiLU and ReLU rows (``[lynx_act]``
   lines);
6c. vocoders: on the 11.9 s request's mel and f0, DDSP (a pc-ddsp CombSub
   bundle traced at its published widths: 128 mels, 512 harmonic and 256
   noise bands, window 2048), DDSPNative at its defaults and Griffin-Lim (32
   rounds), each on the card against the CPU on the same noise
   (``VOCODER_TOL``), its seconds a second of audio, kernel launches and
   idle share under the profiler, the port's counters at 0; then
   ``cli.vocode`` (a ``.mel.npz`` of two overlapping segments) and
   ``cli.val_nsf_hifigan`` (a 3 s take) once on the card with a full-NSF
   experiment folder (``[vocoders]`` lines);
7. export: the acoustic model at full width (seeded weights in an
   experiment folder, 50 steps) exported on the card through
   ``deployment.exporters`` as ``.pt2`` programs and ONNX graphs at the
   buckets (64, 512) and (16, 64), with the export seconds by step and the
   artifacts' sizes; the ``.pt2`` request through ``AcousticArtifactRuntime``
   against eager ``forward_infer_dynamic`` on the same noise (float32, 1e-4),
   its launches (K2 and K1 6 x 50, K3 4), its time in turns with eager, its
   profile (idle share), its waits for the device and allocator calls at 50
   and at 10 steps (equal: none a step); the same config under DDPM with its
   shallow source as a ``.pt2`` at (64, 512) against eager (1e-4; K2 and K1
   6 x 50 DDIM calls, K3 4); the
   full-NSF vocoder's ``.pt2`` through ``VocoderArtifactRuntime`` against the
   eager generator on the same draws; every ONNX graph through the
   structural checker, and the small bucket's acoustic graph at 2 steps
   through the numpy interpreter against the card (1e-3); then the variance
   model (``configs/variance.yaml`` at full width, all four variances,
   seeded weights, 20 steps) exported in both formats at the same buckets:
   each ``.pt2`` view (linguistic, pitch, variance) through
   ``VarianceArtifactRuntime`` against the eager view on the same padded
   inputs and noise (1e-6), its launches (K3 4 for the linguistic view, no
   kernel for the WaveNet views), each view's time in turns with eager, the
   profile of a pitch + variance request, the chain variance -> acoustic ->
   vocoder bundles through the three runtimes, and the small bucket's pitch
   and variance graphs through the interpreter against the card (1e-3)
   (``[export]`` lines);
8. train: the acoustic model's training through ``AcousticTask`` (the task
   ``cli.train`` runs) at full width in '16-mixed' (bf16 autocast over float32
   AdamW), an in-memory seeded batch of B=48 segments of 600-1024 frames
   (T_mel 1024, T_txt 128, ragged): K3's backward against its plain version
   at [48,2,128,128] and [16,2,512,128] with padded rows (dq, dk, dv within
   1e-4 of the largest reference entry); one float32 step of a narrow model on
   the card against the same step on CPU tensors (gradients, parameters after
   the step); the loss falling over 20 steps on the fixed batch with fixed t
   and noise; 10 timed steps after 3 warm-ups (optimizer steps/s, mel
   frames/s, peak memory, launches per step: K3 4, K3's backward 4, K2 and K1
   6); one step under the profiler (idle share); a validation batch; a save
   and resume round trip in a temporary folder (``[train]`` lines);
9. train_variance: the variance model's training through ``VarianceTask``
   (the task ``cli.train`` runs for configs/variance.yaml) at full width with
   the four variances on, in '16-mixed', an in-memory seeded batch of B=48
   segments of 1000-1664 frames (T_mel 1664, T_txt about 176, one note a
   word) made by ``VarianceDataset.collater``: K3 and its backward against
   their plain versions at the encoder's shape and at the melody encoder's
   head width 64; one float32 step of a narrow model with the melody encoder
   and glides on the card against the same step on CPU tensors; the
   full-width melody encoder's forward and backward at the batch's notes
   (its K3 launches, counted from 0); the loss falling over 20 steps with
   fixed t, noise and retake masks; 10 timed steps
   after 3 warm-ups (optimizer steps/s, true frames/s, peak memory, launches
   per step: K3 4, K3's backward 4, K1 and K2 0); one step under the profiler
   (idle share, top device operations); a validation batch (losses and
   metrics); a save and resume round trip (``[train_variance]`` lines);
9b. train_remat: ``recompute_grads`` on [train]'s task and batch: for off,
   full, dots and dots_no_batch the peak memory, steps/s over 10 steps and
   the launches a step (K1 = K2 twice a LYNXNet layer under recomputation);
   a float32 step under each policy against off (loss and every gradient);
   [train_variance]'s model with full against off; one batch as
   ``train_wire_dtype: float16`` through the trainer's upload stage against
   float32 (bytes, loss) (``[train_remat]`` lines);
10. train_dist: training over ranks and serving over replicas on the one
   card. (a) two gloo ranks, each its own process on the card, train a
   narrow float32 variance model with the melody encoder through
   ``BaseTask.start`` (4 + 4 rows, accumulation 2, 3 updates) against one
   process on the 8 stitched rows: the ranks' parameters equal, the one
   process's within 1e-4 of its largest update but for at most a 1e-4 share
   of the elements (none beyond 2 lr), rank 0 alone writing the checkpoint;
   (b) one NCCL rank with DDP around [train]'s task, batch and timed steps:
   steps/s with and without DDP in turns, peak memory, launches per step as
   [train]'s; (c) ``AcousticServer`` and ``VarianceServer`` with
   ``devices=[cuda:0, cuda:0]`` against the one-device servers on
   [serve]'s and [variance]'s segments, each chunk whole on a replica in
   turn (enqueue seconds a chunk, the replica it ran on, true frames/s;
   float32 and bf16 outputs within 1e-3) (``[train_dist]`` lines);
11. binarize: a synthetic corpus of 120 sung phrases of 3-12 s (about 15
   minutes at 44.1 kHz; 16-bit wavs, transcriptions.csv, .ds labels) made
   from a seed and binarized through ``cli.binarize.binarize`` on the card:
   configs/acoustic.yaml with every embed on, without augmentation, with
   random pitch shifting and time stretching, with fixed pitch shifting;
   configs/variance.yaml with the four curves (labels from the .ds files).
   Per run: seconds of binarization per second of audio, items/s, the split
   into wav read, mel, pitch (candidates on the card, path on the host),
   harmonic split, curves (energy and smoothing) and store write, peak
   memory, and the kernels' launch counters from 0 (all must stay 0). Five
   items of each family under the profiler (idle share, launches an item);
   the path finder on the host against a loop of torch operations on the
   card; five items of each family (and a shifted, stretched copy of each
   acoustic one) on the card against the CPU within the CPU tests'
   tolerances; the card's HDF5 stores (MB on disk, write seconds) read
   back from disk through the datasets into one step of a narrow acoustic
   and variance task with finite losses (``[binarize]`` lines);
12. binarize_ext: the extractors that voicebank makers configure, with
   seeded checkpoints at the published widths (RMVPE ``E2E0(4, 1, (2, 2))``;
   CascadedNet nout 32, nout_lstm 128, stereo, n_fft 2048, hop 512): over
   that whole corpus, acoustic with ``pe: rmvpe`` and ``hnsep: vr`` twice
   (the first pass pays cuDNN's benchmark once for each new length bucket,
   the second is warm: their difference is the one-time cost a bucket),
   variance with the same; over its first 4 phrases, variance with
   ``pe: harvest`` and ``hnsep: world`` on the card twin. Per run: seconds
   a second of audio, items/s, the stage split, peak memory, launch counters
   from 0 (all 0), one item under the profiler (idle share, launches); the
   vocal remover at a length bucket no phrase met (first call, again);
   RMVPE alone on the longest phrase (frontend, U-Net, GRU and head,
   decoding), CascadedNet alone, the WORLD twin against the float64 host golden on one phrase
   (seconds, bounds, two runs equal) and within ``tests/test_world_device.py``'s
   bounds on its fixtures, three items of each run on the card against the
   CPU (``binarize_ext_card_vs_cpu``), one narrow training step from each
   store (``[binarize_ext]`` lines);
12b. pipeline: the commands a voicebank maker runs, through their
   ``main(argv)`` with the default device (the card), under a temporary
   ``DS_CKPT_ROOT`` in chiprun_out/: ``cli.binarize`` of a user config over
   configs/acoustic.yaml and one over configs/variance.yaml (the four
   curves) on [binarize]'s seeded corpus, into HDF5 stores on disk (seconds
   a second of audio with the write, MB, items/s read back through the
   datasets); ``cli.train`` of each at full width in '16-mixed' at its frame
   budget for 8 steps, then resumed to 13, the last 4 under the profiler
   (each step's launches: K1 = K2 = 6 acoustic, K3 = K3-bwd = 4; time to the
   first optimizer step, steps/s, the loop's wait for a batch, the share of
   the run in ``epoch_batches``, the idle share, validation, save and resume
   seconds), the acoustic model at the default prefetch depth and at
   ``DS_PREFETCH_DEPTH=0`` in turns (1, 0, 0, 1; steps/s of each, the same
   losses); ``cli.infer variance`` on samples/09 and ``cli.infer
   acoustic`` on its output (a wav of the score's length; K2 = 6 x the
   sampler's steps a segment) and on samples/00; ``cli.export`` of both
   (``.pt2``) with one segment through the artifact runtimes bit-equal to
   the eager models (``[pipeline]`` lines);
13. times: K1 at the long phrase's shape [1, 4096, 2048], K3 at the long
   shape [16, 2, 512, 128], K2's two GEMMs alone and K3's backward at
   [48, 2, 128, 128] and [16, 2, 512, 128] with each of its kernels alone
   and its bound on the CUDA cores and in 3xTF32, then K3 and its backward
   at the variance training shapes (``[time]`` lines), the whole script's
   seconds, one ``[summary]`` line a phase (its seconds and main numbers,
   where the tail of the output keeps them), the card's name and power
   limit, then the ``kernels`` JSON line (launches of every path, the
   training steps' and the pipeline's included, time, bound, plain and
   library times) and the last line ``{"ok": true, "device": {...}}``.

The models switch TF32 off for their own calls (``utils.no_tf32``), so the
float32 phases run as the entry points do, with no setting of this script's.
The script imports nothing of JAX or the JAX package.
The compiler's messages go to chiprun_out/chip_smoke_build.log and every
number to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32 on the
# CUDA cores, TF32 tensor cores, device memory
PEAK_BF16_TC = 989e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12

STEPS = 50
B, T_TXT, T_MEL = 16, 128, 1024
VOCAB = 62
REQUESTS = 3  # timed requests; the first also warms up


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over ``iters`` launches (CUDA events)."""
    import torch

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


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def seeded_weights(module, seed: int) -> None:
    """Give the zero- or constant-initialised parameters seeded random values,
    so that the denoiser's velocity, the layer scales and the PReLU slopes are
    not trivial."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("output_projection.weight"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.03)
            elif name.endswith(".gamma"):
                p.copy_(0.1 + 0.05 * torch.randn(p.shape, generator=g))
            elif name.endswith("convmodule.net.5.weight"):
                p.copy_(0.1 + 0.3 * torch.rand(p.shape, generator=g))
            elif name.endswith(".bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))


# our kernels by the names nvcc gives them, for the profile's breakdown
KERNEL_GROUPS = (("K2 GEMMs + LN stats", ("gemm_bf16_kernel", "gemm_f32_kernel", "ln_stats_kernel")),
                 ("K1 depthwise", ("dwconv_prelu_",)),
                 ("K3 attention", ("flash_fwd_kernel", "flash_bwd_")),
                 ("NCCL collectives", ("nccl",)))


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def device_activities(events, cuda) -> list:
    """The kernels, copies and sets among a profile's events, as (name, start
    us, end us). The profiler also draws ranges on the device's timeline over
    the kernels they launched (DDP's forward, the optimizer's step, any
    ``record_function``): such a range has the name of a range on the host,
    or holds another event of its stream, which a kernel never does. They are
    left out, else their time counts twice and fills the device's gaps."""
    host_names = {e.name for e in events if e.device_type != cuda}
    streams = {}
    for e in events:
        if e.device_type == cuda and not getattr(e, "is_user_annotation", False) \
                and e.name not in host_names:
            streams.setdefault((e.device_index, getattr(e, "device_resource_id", 0)), []).append(
                (e.time_range.start, e.time_range.end, e.name))
    out = []
    for evs in streams.values():
        evs.sort(key=lambda s: (s[0], -s[1]))
        for i, (start, end, name) in enumerate(evs):
            j = i + 1
            while j < len(evs) and evs[j][0] < end and evs[j][1] > end:
                j += 1
            if j < len(evs) and evs[j][0] < end:  # it holds evs[j]: a range
                continue
            out.append((name, start, end))
    return out


def profile_request(fn, what: str = "one request", table: str = "chip_smoke_profile.txt") -> dict:
    """Run fn under torch.profiler; device time by kernel group and the share
    of the request's wall time in which the device ran no kernel (the union of
    the kernels' intervals over every stream, so that kernels which overlap,
    such as NCCL's beside the backward, count once). ``nccl_exposed_ms`` is
    the time in which NCCL's kernels alone ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    acts = device_activities(prof.events(), torch.autograd.DeviceType.CUDA)
    kernels = {}
    for name, start, end in acts:
        kernels[name] = kernels.get(name, 0.0) + (end - start)
    total = sum(kernels.values())
    if not total:
        log("[profile] the profiler saw no device time: not measured")
        return {"measured": False}
    busy = union_us((s, e) for _, s, e in acts)
    nccl_exposed = busy - union_us((s, e) for n, s, e in acts if "nccl" not in n.lower())
    groups = {name: sum(us for k, us in kernels.items() if any(p in k for p in pats))
              for name, pats in KERNEL_GROUPS}
    groups["stock PyTorch kernels"] = total - sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    log(f"[profile] {what} under the profiler: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f}, {len(acts)} kernel launches")
    for name, us in groups.items():
        log(f"[profile]   {name}: {us / 1e3:.1f} ms ({us / total:.3f} of kernel time)")
    if groups["NCCL collectives"]:
        log(f"[profile]   NCCL alone on the device (not under other kernels): "
            f"{nccl_exposed / 1e3:.2f} ms")
    OUT_DIR.mkdir(exist_ok=True)
    averages = prof.key_averages()
    sort_key = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
                else "self_cuda_time_total")
    (OUT_DIR / table).write_text(averages.table(sort_by=sort_key, row_limit=40))
    return {"measured": True, "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us, "kernel_launches": len(acts),
            "kernel_ms": total / 1e3, "nccl_exposed_ms": nccl_exposed / 1e3,
            "groups_ms": {k: v / 1e3 for k, v in groups.items()},
            "top_kernels_ms": {k: v / 1e3 for k, v in top}}


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls to the plain versions (for comparison only)."""
    from diffsinger_tpu_torch.models import commons
    from diffsinger_tpu_torch.models.backbones import lynxnet
    from diffsinger_tpu_torch.ops import flash_attention, lynx_fused

    saved = lynxnet.fused_conv_module, commons.flash_attention
    lynxnet.fused_conv_module = lynx_fused.fused_conv_module_plain
    commons.flash_attention = flash_attention.flash_attention_plain
    try:
        yield
    finally:
        lynxnet.fused_conv_module, commons.flash_attention = saved


def load_score(name):
    with open(ROOT / "samples" / name, encoding="utf-8") as f:
        return json.load(f)


def quiet(fn, *args, **kwargs):
    """Run fn without its per-segment summaries on standard output."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def loaded(what, fn, *args, **kwargs):
    """Build a runtime; a loader that fell back to random weights warns, and
    that warning is a failure here."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        made = quiet(fn, *args, **kwargs)
    for w in caught:
        if "RANDOM weights" in str(w.message):
            fail(f"{what}: {w.message}")
    return made


SERVE_SCORES = ("09_xing_he.ds", "08_qiu_yu.ds")
SERVE_BATCH = 16
VOCODER_CHANNELS = 512  # upsample_initial_channel of the released full-NSF vocoders


def write_experiment(root: Path, hp: dict) -> str:
    """An experiment folder and a vocoder folder under ``root`` as a user has
    them, with seeded random weights; returns the experiment's name and the two
    saved state dicts (acoustic without the ``model.`` prefix, vocoder)."""
    import torch
    import yaml

    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
    from diffsinger_tpu_torch.utils.ckpt import checkpoint_path
    from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary

    name = "smoke_acoustic"
    work_dir = root / "checkpoints" / name
    work_dir.mkdir(parents=True)
    voc_dir = root / "vocoder"
    voc_dir.mkdir()
    cfg = {k: v for k, v in hp.items() if k not in ("base_config", "dictionaries", "work_dir")}
    cfg.update(infer_precision="bf16", sampling_steps=STEPS,
               dictionary=str(ROOT / "dictionaries" / "opencpop-extension.txt"),
               vocoder_ckpt=str(voc_dir / "model.ckpt"))
    with open(work_dir / "config.yaml", "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    shutil.copy(ROOT / "dictionaries" / "opencpop-extension.txt", work_dir / "dictionary.txt")

    # the acoustic weights as phase 3 makes them, at the dictionary's vocabulary
    vocab = len(load_phoneme_dictionary(dict(cfg, work_dir=str(work_dir))))
    torch.manual_seed(5)
    model = DiffSingerAcoustic(cfg, vocab_size=vocab, out_dims=cfg["audio_num_mel_bins"],
                               dtype=torch.float32)
    seeded_weights(model.module, 6)
    acoustic_state = {k: v.cpu() for k, v in model.module.state_dict().items()}
    torch.save({"state_dict": {"model." + k: v for k, v in acoustic_state.items()},
                "category": "acoustic", "global_step": 1000}, checkpoint_path(work_dir, 1000))

    return name, acoustic_state, write_vocoder(voc_dir, cfg)


def write_vocoder(voc_dir: Path, hp: dict) -> dict:
    """The default full-NSF vocoder (hop 512, 512 channels) for ``hp``'s mels,
    seeded, as ``voc_dir/{config.json,model.ckpt}``; returns its state dict."""
    import torch

    from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import Generator, NsfHifiGanConfig

    voc_cfg = dict(num_mels=hp["audio_num_mel_bins"], sampling_rate=hp["audio_sample_rate"],
                   upsample_rates=[8, 8, 2, 2, 2], upsample_kernel_sizes=[16, 16, 4, 4, 4],
                   upsample_initial_channel=VOCODER_CHANNELS, resblock="1",
                   resblock_kernel_sizes=[3, 7, 11],
                   resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                   mini_nsf=False, noise_sigma=0.0)
    (voc_dir / "config.json").write_text(json.dumps(voc_cfg))
    torch.manual_seed(7)
    gen = Generator(NsfHifiGanConfig.from_json(voc_cfg), dtype=torch.float32)
    vocoder_state = {k: v.cpu() for k, v in gen.state_dict().items()}
    torch.save({"generator": vocoder_state}, voc_dir / "model.ckpt")
    return vocoder_state


def serve_phase(hp, card, reset_counts, read_counts, request_profile):
    """Phase 4: scores through the port's runtime. ``request_profile`` is the
    B=16 request's profile, printed beside the served scores'. Returns the
    phase's report and the launch counts of the timed serving call."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.cli import infer as cli
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.inference.ds_acoustic import DiffSingerAcousticInfer
    from diffsinger_tpu_torch.inference.serving import AcousticServer

    n_layers, n_enc = hp["backbone_args"]["num_layers"], hp["enc_layers"]
    hop, sr = hp["hop_size"], hp["audio_sample_rate"]
    out = {}

    def expect(counts, chunks, what):
        want = {"K1": n_layers * STEPS * chunks, "K2": n_layers * STEPS * chunks,
                "K3": n_enc * chunks}
        log(f"[serve] {what}: launches {counts} (expected {want})")
        if counts != want:
            fail(f"{what}: launch counts {counts} != {want}")

    def holds(what, module, state):
        """The module's parameters are the saved ones (rounded to its dtype)."""
        got = module.state_dict()
        if set(got) != set(state):
            fail(f"{what}: keys differ from the saved checkpoint's")
        for key, saved in state.items():
            if not torch.equal(got[key].cpu(), saved.to(got[key].dtype)):
                fail(f"{what}: {key} is not the saved tensor")

    def typical(wavs):
        flat = np.concatenate([np.asarray(w, np.float64).ravel() for w in wavs])
        return float(np.sqrt(np.mean(flat ** 2))), float(np.median(np.abs(flat)))

    root = Path(tempfile.mkdtemp(prefix="ds_smoke_"))
    saved_root = os.environ.get("DS_CKPT_ROOT")
    try:
        exp, acoustic_state, vocoder_state = write_experiment(root, hp)
        os.environ["DS_CKPT_ROOT"] = str(root / "checkpoints")
        shp = cli.migrate_legacy_hparams(
            load_config(exp_name=cli.find_exp(exp[:5]), infer=True, ckpt_root=cli.ckpt_root_dir()))
        t0 = time.perf_counter()
        server = loaded("server", AcousticServer, shp, max_batch_size=SERVE_BATCH)
        holds("server, acoustic model", server.model.module, acoustic_state)
        holds("server, vocoder", server.vocoder.model, vocoder_state)
        log(f"[serve] server built from the experiment folder in {time.perf_counter() - t0:.2f} s "
            f"(acoustic {next(server.model.module.parameters()).dtype}, vocoder "
            f"{type(server.vocoder).__name__}, mini_nsf={server.vocoder.config.mini_nsf}); "
            f"{len(acoustic_state)} + {len(vocoder_state)} tensors equal the saved files'")
        segments = [seg for name in SERVE_SCORES for seg in load_score(name)]

        # ---- the two scores together: once to warm up, once timed
        quiet(server.synthesize_batch, segments, seed=1)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = quiet(server.synthesize_batch, segments, seed=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        serve_counts = read_counts()
        stats = server.last_stats
        expect(serve_counts, len(stats), f"{len(segments)} segments in {len(stats)} chunks")
        lengths = [quiet(server.preprocess_input, seg)["mel2ph"].shape[1] for seg in segments]
        if len(wavs) != 17 or not (400 <= min(lengths) and max(lengths) <= 800):
            fail(f"served {len(wavs)} segments of {min(lengths)}-{max(lengths)} frames")
        for i, (wav, n) in enumerate(zip(wavs, lengths)):
            if wav.shape != (n * hop,) or not np.isfinite(wav).all():
                fail(f"segment {i}: wav {wav.shape} for {n} frames, or not finite")
            if not np.abs(wav).max() > 1e-3:
                fail(f"segment {i}: silence")
        rms, median = typical(wavs)
        log(f"[serve] served wavs: rms {rms:.4f}, median |value| {median:.4f} (full scale 1)")
        shapes = {(st["batch"], st["t_txt"], st["t_mel"]) for st in stats}
        for st in stats:
            log("[serve]   chunk B=%(batch)d buckets %(t_txt)d x %(t_mel)d: dispatch_s "
                "%(dispatch_s).4f fetch_s %(fetch_s).4f "
                "(%(wire_mb).1f MB)" % st)
        true_frames = sum(lengths)
        padded_frames = sum(st["batch"] * st["t_mel"] for st in stats)
        out["scores"] = {
            "segments": len(segments), "frames": lengths, "chunks": stats, "seconds": seconds,
            "frames_per_s": true_frames / seconds,
            "audio_s_per_s": true_frames * hop / sr / seconds,
            "padded_share": 1 - true_frames / padded_frames, "launches": serve_counts,
            "wav_rms": rms, "wav_median_abs": median}
        log(f"[serve] {len(segments)} segments ({min(lengths)}-{max(lengths)} frames) of "
            f"{' + '.join(SERVE_SCORES)}: {seconds:.3f} s, {true_frames / seconds:.1f} true mel "
            f"frames/s, {true_frames * hop / sr / seconds:.1f} audio s/s, padded share "
            f"{1 - true_frames / padded_frames:.3f} on {card}")

        # ---- the same call under the profiler
        reset_counts()
        out["profile"] = profile_request(
            lambda: quiet(server.synthesize_batch, segments, seed=1),
            what=f"the served scores ({len(segments)} segments)",
            table="chip_smoke_profile_serve.txt")
        expect(read_counts(), len(stats), "profiled serving call")
        if out["profile"]["measured"] and request_profile["measured"]:
            log(f"[serve] idle share: served scores {out['profile']['idle_share']:.3f} (device "
                f"busy {out['profile']['busy_ms']:.1f} of {out['profile']['wall_ms']:.1f} ms), "
                f"B={B} request {request_profile['idle_share']:.3f} "
                f"({request_profile['busy_ms']:.1f} of {request_profile['wall_ms']:.1f} ms)")

        # ---- one score through the entry point, segment by segment
        score = load_score("00_xiao_xing_xing.ds")
        out_dir = root / "out"
        reset_counts()
        t0 = time.perf_counter()
        loaded("entry point", cli.main,
               ["acoustic", str(ROOT / "samples" / "00_xiao_xing_xing.ds"),
                "--exp", exp, "--seed", "1", "--out", str(out_dir)])
        cli_s = time.perf_counter() - t0
        expect(read_counts(), len(score), "entry point, samples/00 segment by segment")
        with wave.open(str(out_dir / "00_xiao_xing_xing.wav")) as f:
            rate, n_samples = f.getframerate(), f.getnframes()
            pcm = np.frombuffer(f.readframes(n_samples), np.int16)
        runner = loaded("runtime", DiffSingerAcousticInfer, shp)
        holds("runtime, acoustic model", runner.model.module, acoustic_state)
        batches = [quiet(runner.preprocess_input, seg) for seg in score]
        for batch in batches:
            padded, _ = runner._pad_batch(batch)
            shapes.add((1, padded["tokens"].shape[1], padded["mel2ph"].shape[1]))
        out["shapes"] = sorted(shapes)
        want_samples = round(score[-1]["offset"] * sr) + batches[-1]["mel2ph"].shape[1] * hop
        if rate != sr or abs(n_samples - want_samples) > hop or not np.abs(pcm).max() > 30:
            fail(f"entry point: wav of {n_samples} samples at {rate} Hz, expected {want_samples}")
        latency = []
        for _ in range(2):  # the second round is warm
            latency = []
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runner.forward_wav(batch, runner._generator(1))
                latency.append(time.perf_counter() - t0)
        out["entry_point"] = {"seconds_with_load": cli_s, "samples": n_samples,
                              "segment_frames": [b["mel2ph"].shape[1] for b in batches],
                              "segment_s": latency}
        log(f"[serve] entry point: {cli_s:.2f} s with loading, wav of {n_samples} samples at "
            f"{rate} Hz; B=1 latency per segment ({batches[0]['mel2ph'].shape[1]} frames, bucket "
            f"512): {['%.3f s' % t for t in latency]} on {card}")

        # ---- float32, reduced: kernels against their plain versions
        hp32 = dict(shp, infer_precision="32")
        server32 = loaded("float32 server", AcousticServer, hp32, max_batch_size=SERVE_BATCH)
        three = load_score("08_qiu_yu.ds")[:3]
        want = {"K1": n_layers * 8, "K2": n_layers * 8, "K3": n_enc}
        none = {"K1": 0, "K2": 0, "K3": 0}
        reset_counts()
        wav_k = quiet(server32.synthesize_batch, three, seed=2, steps=8)
        counts = read_counts()
        if counts != want:
            fail(f"float32 serving: launch counts {counts} != {want}")
        reset_counts()
        with plain_kernels():
            wav_p = quiet(server32.synthesize_batch, three, seed=2, steps=8)
        if read_counts() != none:
            fail("the plain serving run launched a kernel")
        err = max(float(np.abs(a - b).max()) for a, b in zip(wav_k, wav_p))
        # the served wavs went through the 16-bit step: one step of it, and
        # beside that a thousandth of the signal's rms (sums in another order)
        rms, median = typical(wav_p)
        tol = 1 / 32767 + 1e-3 * rms
        log(f"[serve] f32, 3 segments of samples/08 at 8 steps, kernels vs plain: max|wav err| "
            f"{err:.3e} (tolerance {tol:.3e} = one 16-bit step + 1e-3 of the rms {rms:.4f}; "
            f"median |value| {median:.4f})")
        out["f32_vs_plain_wav"] = {"err": err, "tol": tol, "rms": rms, "median_abs": median}
        if not err <= tol:
            fail("the served float32 wavs disagree with their plain-version run")
        # the same three segments before the 16-bit step, one by one
        batches3 = [quiet(server32.preprocess_input, seg) for seg in three]

        def raw_wavs():
            return [server32.forward_wav(b, server32._generator(2), steps=8) for b in batches3]

        reset_counts()
        raw_k = raw_wavs()
        counts = read_counts()
        if counts != {k: 3 * v for k, v in want.items()}:
            fail(f"float32 forward_wav: launch counts {counts}")
        reset_counts()
        with plain_kernels():
            raw_p = raw_wavs()
        if read_counts() != none:
            fail("the plain forward_wav run launched a kernel")
        err = max(float(np.abs(a - b).max()) for a, b in zip(raw_k, raw_p))
        rms, median = typical(raw_p)
        tol = 1e-3 * rms
        log(f"[serve] f32, the same segments through forward_wav (no 16-bit step), kernels vs "
            f"plain: max|wav err| {err:.3e} (tolerance {tol:.3e} = 1e-3 of the rms {rms:.4f}; "
            f"median |value| {median:.4f})")
        out["f32_vs_plain_wav_float"] = {"err": err, "tol": tol, "rms": rms, "median_abs": median}
        if not err <= tol:
            fail("forward_wav in float32 disagrees with its plain-version run")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if saved_root is None:
            os.environ.pop("DS_CKPT_ROOT", None)
        else:
            os.environ["DS_CKPT_ROOT"] = saved_root
    return out, serve_counts



VARIANCE_SCORES = ("01_score_only.ds", "02_chun_feng.ds", "03_ye_se.ds", "04_xiao_niao.ds",
                   "05_yue_liang.ds", "06_lv_ye.ds", "07_dong_xue.ds", "10_shan_lu.ds")
VARIANCES = ("energy", "breathiness", "voicing", "tension")


def write_variance_experiment(root: Path) -> tuple:
    """configs/variance.yaml at full width with all four variances on, float32,
    as an experiment folder under ``root`` with seeded random weights in the
    reference's checkpoint layout; returns its name, hparams and saved state."""
    import torch
    import yaml

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance
    from diffsinger_tpu_torch.utils.ckpt import checkpoint_path
    from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary

    name = "smoke_variance"
    work_dir = root / "checkpoints" / name
    work_dir.mkdir(parents=True)
    hp = load_config(ROOT / "configs" / "variance.yaml")
    cfg = {k: v for k, v in hp.items() if k not in ("base_config", "dictionaries", "work_dir")}
    cfg.update({f"predict_{v}": True for v in VARIANCES})
    cfg["dictionary"] = str(ROOT / "dictionaries" / "opencpop-extension.txt")
    with open(work_dir / "config.yaml", "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    shutil.copy(ROOT / "dictionaries" / "opencpop-extension.txt", work_dir / "dictionary.txt")
    vocab = len(load_phoneme_dictionary(dict(cfg, work_dir=str(work_dir))))
    torch.manual_seed(8)
    model = DiffSingerVariance(cfg, vocab_size=vocab, dtype=torch.float32)
    seeded_weights(model.module, 9)
    state = {k: v.cpu() for k, v in model.module.state_dict().items()}
    blob = {"model." + k: v for k, v in state.items()}
    for wrapper in ("pitch_predictor", "variance_predictor"):  # the reference's buffers
        blob[f"model.{wrapper}.spec_min"] = torch.zeros(1, 1, 1, 1)
        blob[f"model.{wrapper}.spec_max"] = torch.ones(1, 1, 1, 1)
    torch.save({"state_dict": blob, "category": "variance", "global_step": 1000},
               checkpoint_path(work_dir, 1000))
    return name, cfg, state


def variance_phase(acoustic_hp, card, reset_counts, read_counts, check, k3_case):
    """[variance]: the variance model at full width through VarianceServer,
    the chain into AcousticServer, and cli.infer variance. Returns the phase's
    report and the K3 launches of the timed serving call."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.cli import infer as cli
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.inference.serving import AcousticServer, VarianceServer
    from diffsinger_tpu_torch.ops import flash_attention
    from diffsinger_tpu_torch.utils.seq import length_regulator

    out = {}
    root = Path(tempfile.mkdtemp(prefix="ds_smoke_var_"))
    saved_root = os.environ.get("DS_CKPT_ROOT")
    try:
        exp, cfg, state = write_variance_experiment(root)
        os.environ["DS_CKPT_ROOT"] = str(root / "checkpoints")
        vhp = cli.migrate_legacy_hparams(load_config(exp_name=exp, infer=True,
                                                     ckpt_root=cli.ckpt_root_dir()),
                                         infer_acoustic=False)
        t0 = time.perf_counter()
        server = loaded("variance server", VarianceServer, vhp, max_batch_size=SERVE_BATCH)
        got = server.model.module.state_dict()
        if set(got) != set(state) or any(not torch.equal(got[k].cpu(), v) for k, v in state.items()):
            fail("variance server: the loaded tensors are not the saved ones")
        n_enc = cfg["enc_layers"]
        pitch_args = cfg["pitch_prediction_args"]["backbone_args"]
        var_args = cfg["variances_prediction_args"]["backbone_args"]
        log(f"[variance] server built in {time.perf_counter() - t0:.2f} s: encoder "
            f"{n_enc} x {cfg['hidden_size']}, pitch WaveNet {pitch_args['num_layers']} x "
            f"{pitch_args['num_channels']} ({cfg['pitch_prediction_args']['repeat_bins']} bins), "
            f"variance WaveNet {var_args['num_layers']} x {var_args['num_channels']} "
            f"(4 x {cfg['variances_prediction_args']['total_repeat_bins'] // 4} bins), "
            f"{cfg['sampling_algorithm']} {cfg['sampling_steps']} steps, "
            f"{next(server.model.module.parameters()).dtype}; {len(state)} tensors equal the saved")
        segments = [seg for name in VARIANCE_SCORES for seg in load_score(name)]
        flags_list, batches = quiet(server._preprocess_all, segments)
        chunks = server.chunks(batches, flags_list)
        frames = [b["base_pitch"].shape[1] for b in batches]
        for flags, chunk, buckets in chunks:
            log(f"[variance]   chunk B={len(chunk)} flags {flags} buckets (tokens, words, notes, "
                f"frames) {buckets}")

        # once to warm up, once timed, once timed for the host's enqueue alone
        quiet(server.predict_batch, segments, seed=1)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = quiet(server.predict_batch, segments, seed=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        want = {"K1": 0, "K2": 0, "K3": n_enc * len(chunks)}
        log(f"[variance] launches {counts} (expected {want})")
        if counts != want:
            fail(f"variance serving: launch counts {counts} != {want}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, pending = quiet(server.enqueue, segments, seed=1)
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        for (dur, pitch, var), batch, n in zip(preds, batches, frames):
            if (dur is None or dur.shape != (batch["tokens"].shape[1],) or (dur < 0).any()
                    or pitch.shape != (n,) or sorted(var) != sorted(VARIANCES)
                    or any(v.shape != (n,) for v in var.values())):
                fail("variance serving: a segment's predictions have the wrong shapes")
            if not (np.isfinite(pitch).all() and all(np.isfinite(v).all() for v in var.values())):
                fail("variance serving: non-finite predictions")
        padded = sum(len(c[1]) * c[2][3] for c in chunks)
        out["served"] = {"segments": len(segments), "frames": frames, "seconds": seconds,
                         "enqueue_s": enqueue_s, "frames_per_s": sum(frames) / seconds,
                         "padded_share": 1 - sum(frames) / padded, "launches": counts,
                         "chunks": [(len(c[1]), list(c[0]), list(c[2])) for c in chunks]}
        log(f"[variance] {len(segments)} segments ({min(frames)}-{max(frames)} frames, "
            f"{sum(frames)} in all) of samples/{{01-07,10}}: {seconds:.3f} s, "
            f"{sum(frames) / seconds:.1f} predicted frames/s, host's enqueue alone "
            f"{enqueue_s:.3f} s, padded share {1 - sum(frames) / padded:.3f} on {card}")
        reset_counts()
        out["profile"] = profile_request(lambda: quiet(server.predict_batch, segments, seed=1),
                                         what=f"the variance call ({len(segments)} segments)",
                                         table="chip_smoke_profile_variance.txt")
        if read_counts() != want:
            fail("the profiled variance call launched other counts")

        # K3 at every shape the chunks sent (the encoder's [B, 2, T_ph, 128])
        shapes = sorted({(len(c), b[0]) for _, c, b in chunks})
        head = cfg["hidden_size"] // cfg["num_heads"]
        for b_s, t_ph in shapes:
            args = k3_case(b_s, t_ph, head)
            check(f"K3 f32 [{b_s},{cfg['num_heads']},{t_ph},{head}] padded (variance)",
                  flash_attention.flash_attention(*args), flash_attention.flash_attention_plain(*args),
                  1e-4)
        # the melody encoder's width (128, two heads of 64) at the note buckets
        for b_s, t_n in sorted({(len(c), b[2]) for _, c, b in chunks}):
            args = k3_case(b_s, t_n, 64)
            check(f"K3 f32 [{b_s},2,{t_n},64] padded (melody encoder)",
                  flash_attention.flash_attention(*args), flash_attention.flash_attention_plain(*args),
                  1e-4)

        # float32, kernels against plain on the first chunk: durations (before
        # rounding), then pitch and variances on the kernel run's alignment
        flags, chunk, buckets = chunks[0]
        stacked = list(server.stack_chunk(batches, chunk, buckets))
        shapes_noise = server.noise_shapes(len(chunk), buckets[3])
        g = torch.Generator().manual_seed(3)
        noise = {k: torch.randn(s, generator=g) for k, s in shapes_noise.items()}

        def run(kw, flags_run):
            stacked[4] = kw
            return server._run_padded(*stacked, flags_run, None, None, **noise)

        def raw_durations(kw):
            return server.model.forward_infer(
                *(server._to_device(a) for a in stacked[:4]), predict_pitch=False,
                predict_variances=False, **{k: server._to_device(v) for k, v in kw.items()})[0]

        kw = dict(stacked[4])
        raw_k = raw_durations(kw)
        dur_k = run(kw, (True, False, False))[0]
        kw_aligned = dict(kw, mel2ph=length_regulator(dur_k, buckets[3]).cpu().numpy())
        _, pitch_k, var_k = run(kw_aligned, (False, True, True))
        reset_counts()
        with plain_kernels():
            raw_p = raw_durations(kw)
            dur_p = run(kw, (True, False, False))[0]
            _, pitch_p, var_p = run(kw_aligned, (False, True, True))
        if read_counts()["K3"] != 0:
            fail("the plain variance runs launched a kernel")
        errs = {"durations": max_err(raw_k, raw_p), "pitch": max_err(pitch_k, pitch_p),
                **{v: max_err(var_k[v], var_p[v]) for v in VARIANCES}}
        rounded_equal = bool(torch.equal(dur_k, dur_p))
        log(f"[variance] f32 chunk B={len(chunk)}, kernels vs plain: max|err| " + ", ".join(
            f"{k} {e:.3e}" for k, e in errs.items()) + f" (tolerance 1e-3: frames, semitones, "
            f"dB / logit); rounded durations equal: {rounded_equal}")
        out["f32_vs_plain"] = dict(errs, rounded_durations_equal=rounded_equal)
        if not all(e <= 1e-3 for e in errs.values()):
            fail("the variance model disagrees with its plain-version run")

        # the chain: the predicted .ds through AcousticServer to wavs
        name_ac, _, _ = write_experiment(root, acoustic_hp)
        ahp = cli.migrate_legacy_hparams(load_config(exp_name=name_ac, infer=True,
                                                     ckpt_root=cli.ckpt_root_dir()))
        acoustic = loaded("acoustic server", AcousticServer, ahp, max_batch_size=SERVE_BATCH)

        def chain():
            t0 = time.perf_counter()
            ds = [server._apply_predictions(p, *pred) for p, pred in
                  zip(segments, quiet(server.predict_batch, segments, seed=1))]
            t1 = time.perf_counter()
            wavs = quiet(acoustic.synthesize_batch, ds, seed=1)
            return ds, wavs, t1 - t0, time.perf_counter() - t1

        chain()
        ds, wavs, var_s, ac_s = chain()
        hop = ahp["hop_size"]
        mel_frames = [quiet(acoustic.preprocess_input, seg)["mel2ph"].shape[1] for seg in ds]
        for wav, n in zip(wavs, mel_frames):
            if wav.shape != (n * hop,) or not np.isfinite(wav).all() or not np.abs(wav).max() > 1e-3:
                fail("chain: a wav of the wrong length, non-finite or silent")
        out["chain"] = {"variance_s": var_s, "acoustic_s": ac_s, "mel_frames": sum(mel_frames),
                        "frames_per_s": sum(mel_frames) / (var_s + ac_s),
                        "acoustic_chunks": acoustic.last_stats}
        log(f"[variance] chain: {len(ds)} predicted segments -> AcousticServer -> wavs: variance "
            f"{var_s:.3f} s + acoustic {ac_s:.3f} s, {sum(mel_frames) / (var_s + ac_s):.1f} true mel "
            f"frames/s of the chain ({sum(mel_frames)} frames) on {card}")

        # one score through the entry point, segment by segment
        score = "01_score_only.ds"
        out_dir = root / "out"
        reset_counts()
        t0 = time.perf_counter()
        loaded("entry point", cli.main, ["variance", str(ROOT / "samples" / score), "--exp", exp,
                                         "--seed", "1", "--out", str(out_dir)])
        cli_s = time.perf_counter() - t0
        counts = read_counts()
        if counts != {"K1": 0, "K2": 0, "K3": n_enc * len(load_score(score))}:
            fail(f"variance entry point: launch counts {counts}")
        with open(out_dir / "01_score_only.ds", encoding="utf-8") as f:
            written = json.load(f)
        if not all(k in written[0] for k in ("ph_dur", "f0_seq", *VARIANCES)):
            fail("variance entry point: the written .ds lacks a prediction")
        out["entry_point"] = {"seconds_with_load": cli_s, "launches": counts}
        log(f"[variance] entry point: samples/{score} in {cli_s:.2f} s with loading; "
            f"launches {counts}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if saved_root is None:
            os.environ.pop("DS_CKPT_ROOT", None)
        else:
            os.environ["DS_CKPT_ROOT"] = saved_root
    return out, out["served"]["launches"]


DDPM_ACCELERATORS = (("ddim", 0), ("pndm", 1), ("dpm-solver", 0), ("unipc", 0))


def ddpm_phase(hp, card, reset_counts, read_counts, request):
    """[ddpm]: the shipped acoustic config under DDPM (K_step 400, speedup 10:
    40 steps), B=16 T_mel=1024 bf16 under each accelerator, then a float32
    B=2 T_mel=512 request against the plain versions. Returns the report and
    the launch counts by accelerator."""
    import torch

    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic

    hp = dict(hp, diffusion_type="ddpm")
    n_mels, n_layers, n_enc = hp["audio_num_mel_bins"], hp["backbone_args"]["num_layers"], hp["enc_layers"]
    steps = hp["K_step_infer"] // hp["diff_speedup"]
    torch.manual_seed(5)
    model32 = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=n_mels, dtype=torch.float32)
    seeded_weights(model32.module, 6)
    model = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=n_mels, dtype=torch.bfloat16)
    model.module.load_state_dict(model32.module.state_dict())
    inputs = request(B, T_TXT, T_MEL)
    small = request(2, 64, 512, ragged=True)
    out, launches = {}, {}
    for acc, extra in DDPM_ACCELERATORS:
        calls = steps + extra
        want = {"K1": n_layers * calls, "K2": n_layers * calls, "K3": n_enc}
        for m in (model, model32):
            m.hp["diff_accelerator"] = acc
        times = []
        for r in range(3):  # the first warms up
            g = torch.Generator(device=model.device).manual_seed(r)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mel = model.forward_infer(*inputs, generator=g).diff_out
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts = read_counts()
            if counts != want:
                fail(f"ddpm {acc}: launch counts {counts} != {want}")
        if mel.shape != (B, T_MEL, n_mels) or not torch.isfinite(mel).all():
            fail(f"ddpm {acc}: mel {tuple(mel.shape)} or not finite")
        launches[acc] = counts
        fps = B * T_MEL / (sum(times[1:]) / len(times[1:]))
        # float32, reduced: kernels against their plain versions
        noise = torch.randn((2, 512, n_mels), generator=torch.Generator().manual_seed(4))
        noise = noise.to(model32.device)
        mel_k = model32.forward_infer(*small, noise=noise).diff_out
        reset_counts()
        with plain_kernels():
            mel_p = model32.forward_infer(*small, noise=noise).diff_out
        if read_counts() != {"K1": 0, "K2": 0, "K3": 0}:
            fail(f"ddpm {acc}: the plain run launched a kernel")
        err = max_err(mel_k, mel_p)
        out[acc] = {"denoiser_calls": calls, "times_s": times, "frames_per_s": fps,
                    "launches": counts, "f32_vs_plain_mel": err}
        log(f"[ddpm] {acc}: {calls} denoiser calls, request times "
            f"{['%.3f s' % t for t in times]}, {fps:.1f} mel frames/s (acoustic only) at B={B} "
            f"T_mel={T_MEL} bf16 on {card}; launches {counts}; f32 B=2 T_mel=512 kernels vs plain "
            f"max|mel err| {err:.3e} (tolerance 1e-3)")
        if not err <= 1e-3:
            fail(f"ddpm {acc}: the float32 request disagrees with its plain-version run")
    return out, launches


EXPORT_BUCKETS = ((64, 512), (16, 64))  # the exporter's default bucket, and a small one
EXPORT_ONNX_STEPS = 2  # the interpreter's run at the small bucket
SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def count_syncs(fn) -> dict:
    """Host-side waits for the device while ``fn`` runs, from the profiler's
    CUDA runtime events: synchronisations, copies, allocator calls, launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    names = [e.name for e in prof.events()]
    return {"syncs": sum(names.count(n) for n in SYNC_EVENTS),
            "memcpy_calls": sum(1 for n in names if n.startswith("cudaMemcpy")),
            "malloc_free_calls": sum(1 for n in names if n in ("cudaMalloc", "cudaFree")),
            "launches": sum(1 for n in names if n in ("cudaLaunchKernel", "cuLaunchKernel",
                                                      "cudaLaunchKernelExC"))}


def export_inputs(t_txt: int, t_mel: int, seed: int):
    """A seeded [1, t_txt] x [1, t_mel] request with a padded tail (numpy)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 60, (1, t_txt)).astype(np.int32)
    mel2ph = np.repeat(np.arange(1, t_txt + 1), t_mel // t_txt)[None].astype(np.int32)
    mel2ph[0, t_mel - t_mel // 8:] = 0
    f0 = (220.0 * 2 ** (0.2 * np.sin(np.linspace(0, 20, t_mel))))[None].astype(np.float32)
    return tokens, mel2ph, f0


def eager_dynamic(model, tokens, mel2ph, f0, noise, steps, depth):
    """``forward_infer_dynamic`` of a model without conditioning inputs."""
    import torch

    dev = noise.device
    return model.forward_infer_dynamic(
        torch.from_numpy(tokens).to(dev), torch.from_numpy(mel2ph).to(dev),
        torch.from_numpy(f0).to(dev), depth=torch.tensor(depth), steps=torch.tensor(steps),
        noise=noise).diff_out


def timed_requests(fn, n: int = 3) -> list:
    """Seconds of ``n`` requests, each synchronised before and after."""
    import torch

    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return ts


def export_turns(run_eager, run_pt2) -> dict:
    """Synchronised requests in turns: eager, .pt2, .pt2, eager, three each."""
    import numpy as np

    turns = [("eager", timed_requests(run_eager)), ("pt2", timed_requests(run_pt2)),
             ("pt2", timed_requests(run_pt2)), ("eager", timed_requests(run_eager))]
    return {"turns": turns,
            "best": {k: min(min(ts) for kk, ts in turns if kk == k) for k in ("eager", "pt2")},
            "mean": {k: float(np.mean([t for kk, ts in turns if kk == k for t in ts]))
                     for k in ("eager", "pt2")}}


def ddim_dynamic_calls(timesteps: int, k_step: int, depth: float, steps: int,
                       shallow: bool) -> int:
    """Denoiser calls of a deployed DDPM request (DDIM): with the shallow
    source from ``depth * timesteps`` (rounded half to even, capped at
    ``k_step``, cut to a multiple of its speedup ``// steps``) down to 0;
    without it from ``k_step - 1`` at the largest divisor of ``timesteps`` not
    above ``timesteps // steps``."""
    steps = max(steps, 1)
    if not shallow:
        raw = max(timesteps // steps, 1)
        speedup = max(f for f in range(1, raw + 1) if timesteps % f == 0)
        return (k_step - 1) // speedup + 1
    depth_int = min(round(depth * timesteps), k_step)
    speedup = max(depth_int // steps, 1)
    return max(depth_int // speedup, 0)


def ddpm_export_check(root, hp0, card, request, noise, reset_counts, read_counts) -> dict:
    """[export]'s DDPM case: configs/acoustic.yaml at full width under DDPM
    with its shallow source (K_step 400 of 1000 steps), exported to ``.pt2`` on
    the card at the default bucket; a request through the runtime at the
    manifest's depth and steps against eager ``forward_infer_dynamic`` on the
    same noise, float32 within 1e-4, each launching K2 (K1 inside it) once a
    layer and denoiser call and K3 once an encoder layer."""
    import numpy as np

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.exporters import DiffSingerAcousticExporter
    from diffsinger_tpu_torch.deployment.runtime import AcousticArtifactRuntime

    name, _, _ = write_experiment(root, dict(hp0, diffusion_type="ddpm"))
    hp = load_config(exp_name=name, infer=True, ckpt_root=root / "checkpoints")
    exporter = DiffSingerAcousticExporter(hp, root / "acoustic", buckets=EXPORT_BUCKETS[:1],
                                          fmt="pt2", device="cuda")
    t0 = time.perf_counter()
    quiet(exporter.export)
    export_s = time.perf_counter() - t0
    runtime = AcousticArtifactRuntime(root / "acoustic", device="cuda")
    depth, steps = float(runtime.manifest["max_depth"]), int(runtime.manifest["sampling_steps"])
    calls = ddim_dynamic_calls(hp["timesteps"], hp["K_step"], depth, steps, shallow=True)
    n_layers = hp["backbone_args"]["num_layers"]
    want = {"K1": n_layers * calls, "K2": n_layers * calls, "K3": hp["enc_layers"]}
    tokens, mel2ph, f0 = request
    reset_counts()
    mel_pt2 = runtime.synthesize_mel(tokens, mel2ph, f0, noise=noise)
    counts = read_counts()
    reset_counts()
    mel_eager = eager_dynamic(exporter.model, tokens, mel2ph, f0, noise, steps,
                              depth).cpu().numpy()
    eager_counts = read_counts()
    err = float(np.abs(mel_pt2 - mel_eager).max())
    times = timed_requests(lambda: runtime.synthesize_mel(tokens, mel2ph, f0, noise=noise))
    log(f"[export] DDPM (shallow, depth {depth}, {steps} steps: {calls} DDIM calls) exported "
        f"in {export_s:.1f} s; .pt2 request [1,{tokens.shape[1]}] x [1,{mel2ph.shape[1]}]: "
        f"launches {counts} (eager {eager_counts}, expected {want}); max|mel .pt2 - eager| "
        f"{err:.3e} (tolerance 1e-4, float32); {min(times) * 1e3:.1f} ms a request "
        f"({['%.1f' % (t * 1e3) for t in times]} ms) on {card}")
    if counts != want or eager_counts != want:
        fail(f"export: the DDPM .pt2 request launched {counts}, eager {eager_counts}, not {want}")
    if not (np.isfinite(mel_pt2).all() and err <= 1e-4):
        fail("export: the DDPM .pt2 request disagrees with the eager model on the card")
    return {"export_s": export_s, "depth": depth, "steps": steps, "denoiser_calls": calls,
            "launches": counts, "max_abs_err_vs_eager": err, "times_s": times}


def variance_request(t_ph: int, seed: int) -> dict:
    """A seeded score of ``t_ph`` phonemes, two a word, a note a word, with
    frame durations of 4-8 (numpy, unpadded): the variance bundle's inputs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_words = t_ph // 2
    ph_dur = rng.integers(4, 9, (1, t_ph)).astype(np.int32)
    word_dur = ph_dur.reshape(1, n_words, 2).sum(axis=2).astype(np.int32)
    t_mel = int(ph_dur.sum())
    note_midi = rng.uniform(57, 69, (1, n_words)).astype(np.float32)
    return dict(
        tokens=rng.integers(1, 60, (1, t_ph)).astype(np.int32),
        midi=np.repeat(np.round(note_midi).astype(np.int32), 2, axis=1),
        ph2word=np.repeat(np.arange(1, n_words + 1), 2)[None].astype(np.int32),
        word_dur=np.pad(word_dur, [(0, 0), (0, t_ph - n_words)]).astype(np.float32),
        ph_dur=ph_dur, note_midi=note_midi, note_dur=word_dur,
        pitch=np.repeat(note_midi, word_dur[0], axis=1).astype(np.float32)
        + 0.3 * np.sin(np.linspace(0, 30, t_mel, dtype=np.float32))[None])


def variance_view_calls(model, rt, req: dict, bp: int, bm: int) -> dict:
    """The three variance views on the score ``req`` as eager calls of
    ``model`` on inputs padded to the bucket (bp, bm) and as ``.pt2`` calls
    through the runtime ``rt``, with one seeded noise for each sampling view
    that both routes share; eager runs in float32 throughout, as the runtime
    calls its programs."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.utils import no_tf32

    dev = rt.device
    hp = model.hp
    names = rt.variance_names()
    steps = torch.tensor(int(rt.manifest["sampling_steps"]))
    gen = torch.Generator(device=dev).manual_seed(4)
    noise_p = torch.randn((1, bm, hp["pitch_prediction_args"]["repeat_bins"]), generator=gen,
                          device=dev)
    noise_v = torch.randn((1, bm, hp["variances_prediction_args"]["total_repeat_bins"]),
                          generator=gen, device=dev)
    retake = torch.ones((1, bm, len(names)), dtype=torch.bool, device=dev)
    expr = torch.ones((1, bm), device=dev)
    zeros = torch.zeros((1, bm), device=dev)
    t_mel = req["pitch"].shape[1]

    def padded(key, n, value=0):
        a = req[key]
        return torch.from_numpy(np.pad(a, [(0, 0), (0, n - a.shape[1])],
                                       constant_values=value)).to(dev)

    def eager_encode():
        with torch.no_grad(), no_tf32():
            return model.module.encode(padded("tokens", bp), padded("midi", bp),
                                       padded("ph2word", bp), word_dur=padded("word_dur", bp))

    def eager_pitch(enc):
        return model.forward_pitch_deployed(
            enc, padded("ph_dur", bp), padded("note_midi", bp), padded("note_dur", bp),
            padded("pitch", bm), retake[:, :, 0], expr=expr, steps=steps, noise=noise_p)

    def eager_variance(enc, pitch):
        return model.forward_variance_deployed(
            enc, padded("ph_dur", bp), pitch, {v: zeros for v in names}, retake,
            steps=steps, noise=noise_v)

    def pt2_encode():
        return rt.encode(req["tokens"], req["midi"], req["ph2word"], req["word_dur"], t_mel)

    def pt2_pitch(enc, bucket):
        return rt.predict_pitch(enc, req["ph_dur"], req["note_midi"], req["note_dur"],
                                req["pitch"], bucket, noise=noise_p)

    def pt2_variance(enc, pitch, bucket):
        return rt.predict_variances(enc, req["ph_dur"], pitch, bucket, noise=noise_v)

    return dict(eager_encode=eager_encode, eager_pitch=eager_pitch,
                eager_variance=eager_variance, pt2_encode=pt2_encode, pt2_pitch=pt2_pitch,
                pt2_variance=pt2_variance)


def variance_view_turns(calls: dict, bm: int) -> dict:
    """Each view's request timed in turns with eager (``export_turns``), on
    the inputs ``variance_view_calls`` pads: {view: turns}."""
    import numpy as np
    import torch

    enc, _, bucket = calls["pt2_encode"]()
    pitch = calls["pt2_pitch"](enc, bucket)
    enc_e, _ = calls["eager_encode"]()
    pitch_dev = torch.from_numpy(np.pad(pitch, [(0, 0), (0, bm - pitch.shape[1])])).to(
        enc_e.device)
    views = {
        "linguistic": (lambda: calls["pt2_encode"]()[1],
                       lambda: calls["eager_encode"]()[1].cpu()),
        "pitch": (lambda: calls["pt2_pitch"](enc, bucket),
                  lambda: calls["eager_pitch"](enc_e).cpu()),
        "variance": (lambda: calls["pt2_variance"](enc, pitch, bucket),
                     lambda: calls["eager_variance"](enc_e, pitch_dev)[0].cpu()),
    }
    return {view: export_turns(run_eager, run_pt2)
            for view, (run_pt2, run_eager) in views.items()}


def variance_export_check(root, card, reset_counts, read_counts, acoustic_runtime,
                          vocoder_runtime) -> dict:
    """[export]'s variance case: configs/variance.yaml at full width with all
    four variances (seeded weights) exported on the card in both formats at
    (64, 512) and (16, 64); each ``.pt2`` view through VarianceArtifactRuntime
    against the eager view on the same padded inputs and noise (within 1e-6),
    with its launches; each view's request timed in turns with eager; the
    chain variance -> acoustic -> vocoder through the three runtimes; the
    small bucket's ONNX pitch and variance graphs through the interpreter
    against the card (1e-3)."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.exporters import DiffSingerVarianceExporter
    from diffsinger_tpu_torch.deployment.onnx import EMITTED_OPS, run_model
    from diffsinger_tpu_torch.deployment.onnx.checker import check_model
    from diffsinger_tpu_torch.deployment.runtime import VarianceArtifactRuntime
    from diffsinger_tpu_torch.ops import flash_attention

    dev = torch.device("cuda")
    name, cfg, _ = write_variance_experiment(root)
    hp = load_config(exp_name=name, infer=True, ckpt_root=root / "checkpoints")
    exporter = DiffSingerVarianceExporter(hp, root / "variance", buckets=EXPORT_BUCKETS,
                                          fmt="both", device="cuda")
    t0 = time.perf_counter()
    quiet(exporter.export)
    out = {"export_s": time.perf_counter() - t0, "export_split_s": dict(exporter.seconds),
           "sizes_mb": {f: (root / "variance" / f).stat().st_size / 1e6
                        for files in exporter.bucket_files.values() for f in files.values()}}
    log(f"[export] variance exported on the card in {out['export_s']:.1f} s (trace "
        f"{exporter.seconds['trace']:.1f} s, .pt2 {exporter.seconds['pt2']:.1f} s, ONNX "
        f"{exporter.seconds['onnx']:.1f} s); sizes MB "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["sizes_mb"].items()))
    model = exporter.model
    rt = VarianceArtifactRuntime(root / "variance", device="cuda")
    names = rt.variance_names()
    steps = int(rt.manifest["sampling_steps"])
    n_enc = hp["enc_layers"]
    rb = hp["pitch_prediction_args"]["repeat_bins"]
    trb = hp["variances_prediction_args"]["total_repeat_bins"]

    # 1. each view at the default bucket against eager: launches and values
    bp, bm = EXPORT_BUCKETS[0]
    req = variance_request(56, seed=31)
    t_ph, t_mel = req["tokens"].shape[1], req["pitch"].shape[1]
    calls = variance_view_calls(model, rt, req, bp, bm)
    eager_encode, eager_pitch, eager_variance = (calls["eager_encode"], calls["eager_pitch"],
                                                 calls["eager_variance"])
    pt2_encode, pt2_pitch, pt2_variance = (calls["pt2_encode"], calls["pt2_pitch"],
                                           calls["pt2_variance"])
    launches = {}
    reset_counts()
    enc, dur, bucket = pt2_encode()
    torch.cuda.synchronize()
    launches["linguistic"] = read_counts()
    reset_counts()
    pitch = pt2_pitch(enc, bucket)
    launches["pitch"] = read_counts()
    reset_counts()
    curves = pt2_variance(enc, pitch, bucket)
    launches["variance"] = read_counts()
    bwd = flash_attention.bwd_launches
    reset_counts()
    enc_e, dur_e = eager_encode()
    pitch_e = eager_pitch(enc_e)
    curves_e = eager_variance(enc_e, torch.from_numpy(
        np.pad(pitch, [(0, 0), (0, bm - t_mel)])).to(dev))
    torch.cuda.synchronize()
    eager_launches = read_counts()
    errs = {"encoder_out": max_err(enc, enc_e), "ph_dur_pred": max_err(
        torch.from_numpy(dur), dur_e[:, :t_ph].cpu()),
        "pitch": max_err(torch.from_numpy(pitch), pitch_e[:, :t_mel].cpu()),
        **{v: max_err(torch.from_numpy(curves[v]), c[:, :t_mel].cpu())
           for v, c in zip(names, curves_e)}}
    zero = {"K1": 0, "K2": 0, "K3": 0}
    want = {"linguistic": dict(zero, K3=n_enc), "pitch": zero, "variance": zero}
    out.update(launches=launches, eager_launches=eager_launches, max_abs_err_vs_eager=errs,
               request=[t_ph, t_mel])
    log(f"[export] variance .pt2 request [1,{t_ph}] x [1,{t_mel}] in bucket ({bp}, {bm}), "
        f"{steps} steps: launches {launches} (expected {want}; K3-bwd {bwd}), eager "
        f"{eager_launches}; max|.pt2 - eager| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (tolerance 1e-6, float32)")
    if launches != want or bwd or eager_launches != dict(zero, K3=n_enc):
        fail(f"export: the variance .pt2 views launched {launches} (K3-bwd {bwd}), eager "
             f"{eager_launches}, not {want}")
    if not (all(v <= 1e-6 for v in errs.values()) and np.isfinite(pitch).all()
            and all(np.isfinite(c).all() for c in curves.values())):
        fail("export: a variance .pt2 view disagrees with the eager view on the card")

    # 2. each view's request timed in turns with eager
    out["request_s"] = variance_view_turns(calls, bm)
    for view, r in out["request_s"].items():
        log(f"[export] variance {view} request [1,{t_ph}] x [1,{t_mel}], {steps} steps: .pt2 "
            f"{r['mean']['pt2'] * 1e3:.2f} ms mean ({r['best']['pt2'] * 1e3:.2f} best), eager "
            f"{r['mean']['eager'] * 1e3:.2f} ms mean ({r['best']['eager'] * 1e3:.2f} best); "
            f".pt2 / eager {r['mean']['pt2'] / r['mean']['eager']:.3f} on {card}")
    out["profile"] = profile_request(
        lambda: pt2_variance(enc, pt2_pitch(enc, bucket), bucket),
        "one .pt2 pitch + variance request", table="chip_smoke_export_variance_profile.txt")
    out["pitch_waits"] = {"pt2": count_syncs(lambda: pt2_pitch(enc, bucket)),
                          "eager": count_syncs(lambda: eager_pitch(enc_e).cpu())}
    log(f"[export] variance pitch request, device waits and launches (profiler): .pt2 "
        f"{out['pitch_waits']['pt2']}, eager {out['pitch_waits']['eager']}")

    # 3. the chain through the three runtimes alone: score -> pitch, curves ->
    # mel -> waveform
    t0 = time.perf_counter()
    enc_c, _, bucket_c = pt2_encode()
    pitch_c = rt.predict_pitch(enc_c, req["ph_dur"], req["note_midi"], req["note_dur"],
                               req["pitch"], bucket_c, seed=5)
    curves_c = rt.predict_variances(enc_c, req["ph_dur"], pitch_c, bucket_c, seed=5)
    f0 = (440.0 * 2.0 ** ((pitch_c - 69.0) / 12.0)).astype(np.float32)
    mel2ph = np.repeat(np.arange(1, t_ph + 1), req["ph_dur"][0])[None].astype(np.int32)
    extras = {v: curves_c[v] for v in names
              if v in acoustic_runtime.manifest.get("extra_inputs", [])}
    mel = acoustic_runtime.synthesize_mel(req["tokens"], mel2ph, f0, seed=5, **extras)
    wav = vocoder_runtime.vocode(mel, f0, seed=5)
    chain_s = time.perf_counter() - t0
    hop = vocoder_runtime.hop_size
    ok = (wav.shape == (1, t_mel * hop) and np.isfinite(wav).all()
          and float(np.abs(wav).max()) > 0 and np.isfinite(mel).all())
    out["chain"] = {"seconds": chain_s, "wav_samples": int(wav.shape[1]), "ok": bool(ok)}
    log(f"[export] chain variance -> acoustic -> vocoder bundles through the runtimes: "
        f"[1,{t_ph}] phonemes -> pitch [1,{t_mel}] -> mel {tuple(mel.shape)} -> wav "
        f"{tuple(wav.shape)} (want {t_mel * hop} samples) in {chain_s:.2f} s, finite {ok}")
    if not ok:
        fail("export: the variance -> acoustic -> vocoder chain failed")

    # 4. the ONNX: every graph checked; the small bucket's pitch and variance
    # graphs through the interpreter at 2 steps against the card's eager views
    t0 = time.perf_counter()
    for files in exporter.bucket_files.values():
        for kind in ("linguistic_onnx", "pitch_onnx", "variance_onnx"):
            check_model((root / "variance" / files[kind]).read_bytes(), known_ops=EMITTED_OPS)
    sp, sm = EXPORT_BUCKETS[1]
    small = variance_request(8, seed=32)
    small_files = exporter.bucket_files[f"{sp}x{sm}"]
    feed = {k: np.pad(v, [(0, 0), (0, (sp if k != "pitch" else sm) - v.shape[1])],
                      constant_values=0) for k, v in small.items()}
    enc_s = np.random.default_rng(33).standard_normal((1, sp, hp["hidden_size"])).astype(
        np.float32)
    feed.update(encoder_out=enc_s, steps=np.int32(EXPORT_ONNX_STEPS),
                expr=np.ones((1, sm), np.float32), retake=np.ones((1, sm), bool))
    (pitch_onnx,) = run_model((root / "variance" / small_files["pitch_onnx"]).read_bytes(),
                              {k: feed[k] for k in rt.inputs["pitch"]}, rng_seed=8)
    on = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in feed.items()}
    feed.update(pitch=pitch_onnx, retake=np.ones((1, sm, len(names)), bool),
                **{v: np.zeros((1, sm), np.float32) for v in names})
    curves_onnx = run_model((root / "variance" / small_files["variance_onnx"]).read_bytes(),
                            {k: feed[k] for k in rt.inputs["variance"]}, rng_seed=9)
    onnx_s = time.perf_counter() - t0
    draw = lambda seed, width: torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, sm, width)).astype(np.float32)).to(dev)
    pitch_card = model.forward_pitch_deployed(
        on["encoder_out"], on["ph_dur"], on["note_midi"], on["note_dur"], on["pitch"],
        on["retake"], expr=on["expr"], steps=torch.tensor(EXPORT_ONNX_STEPS), noise=draw(8, rb))
    curves_card = model.forward_variance_deployed(
        on["encoder_out"], on["ph_dur"], torch.from_numpy(pitch_onnx).to(dev),
        {v: torch.zeros((1, sm), device=dev) for v in names},
        torch.ones((1, sm, len(names)), dtype=torch.bool, device=dev),
        steps=torch.tensor(EXPORT_ONNX_STEPS), noise=draw(9, trb))
    onnx_errs = {"pitch": max_err(torch.from_numpy(pitch_onnx), pitch_card.cpu()),
                 **{v: max_err(torch.from_numpy(g), c.cpu())
                    for v, g, c in zip(names, curves_onnx, curves_card)}}
    out["onnx"] = {"max_abs_err_vs_card": onnx_errs, "check_and_interpret_s": onnx_s}
    log(f"[export] variance ONNX: every graph passes the checker; the [1,{sp}] x [1,{sm}] "
        f"pitch and variance graphs at {EXPORT_ONNX_STEPS} steps through the interpreter "
        f"against the card's eager views: max|diff| "
        + ", ".join(f"{k} {v:.3e}" for k, v in onnx_errs.items())
        + f" (tolerance 1e-3) in {onnx_s:.1f} s")
    if not all(v <= 1e-3 for v in onnx_errs.values()):
        fail("export: a variance ONNX graph disagrees with the card")
    return out


def export_phase(card, reset_counts, read_counts):
    """[export]: the acoustic model (configs/acoustic.yaml at full width, seeded
    weights, 50 steps) and the full-NSF vocoder exported on the card through
    ``deployment.exporters`` in both formats, the ``.pt2`` programs served by
    the artifact runtimes against the eager card models (timed in turns),
    the config under DDPM as a ``.pt2`` against eager, the ONNX checked and
    interpreted. Returns the report and the launches of one exported
    acoustic request."""
    root = Path(tempfile.mkdtemp(prefix="export_"))  # gigabytes of artifacts: not under OUT_DIR
    try:
        return export_checks(root, card, reset_counts, read_counts)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def export_checks(root, card, reset_counts, read_counts):
    """The body of :func:`export_phase`, writing under ``root``."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.exporters import (
        DiffSingerAcousticExporter, NSFHiFiGANExporter)
    from diffsinger_tpu_torch.deployment.onnx import EMITTED_OPS, run_model
    from diffsinger_tpu_torch.deployment.onnx.checker import check_model
    from diffsinger_tpu_torch.deployment.runtime import (
        AcousticArtifactRuntime, VocoderArtifactRuntime)
    from diffsinger_tpu_torch.ops import flash_attention
    from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import VocoderNoise

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    hp0 = load_config(ROOT / "configs" / "acoustic.yaml")
    name, _, _ = write_experiment(root, hp0)
    hp = load_config(exp_name=name, infer=True, ckpt_root=root / "checkpoints")
    n_layers, n_enc, n_mels = (hp["backbone_args"]["num_layers"], hp["enc_layers"],
                               hp["audio_num_mel_bins"])
    steps = hp["sampling_steps"]
    out = {"steps": steps}

    # 1. export on the card, both formats, two buckets
    exporter = DiffSingerAcousticExporter(hp, root / "acoustic", buckets=EXPORT_BUCKETS,
                                          fmt="both", device="cuda")
    t0 = time.perf_counter()
    quiet(exporter.export)
    out["export_s"] = time.perf_counter() - t0
    out["export_split_s"] = dict(exporter.seconds)
    sizes = {fname: (root / "acoustic" / fname).stat().st_size / 1e6
             for files in exporter.bucket_files.values() for fname in files.values()}
    out["sizes_mb"] = sizes
    log(f"[export] acoustic exported on the card in {out['export_s']:.1f} s (trace "
        f"{exporter.seconds['trace']:.1f} s, .pt2 {exporter.seconds['pt2']:.1f} s, ONNX lowering "
        f"+ check {exporter.seconds['onnx']:.1f} s) at buckets {list(EXPORT_BUCKETS)}; sizes MB "
        + ", ".join(f"{k} {v:.1f}" for k, v in sizes.items()))
    model = exporter.model  # float32 on the card
    runtime = AcousticArtifactRuntime(root / "acoustic", device="cuda")

    def eager(tokens, mel2ph, f0, noise, n_steps, depth):
        return eager_dynamic(model, tokens, mel2ph, f0, noise, n_steps, depth)

    # 2. the .pt2 request at the default bucket against eager, same noise
    t_txt, t_mel = EXPORT_BUCKETS[0]
    tokens, mel2ph, f0 = export_inputs(t_txt, t_mel, seed=21)
    depth = float(runtime.manifest["max_depth"])
    noise = torch.randn((1, t_mel, n_mels), generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev)
    reset_counts()
    mel_pt2 = runtime.synthesize_mel(tokens, mel2ph, f0, noise=noise)
    counts = read_counts()
    bwd_launches = flash_attention.bwd_launches
    reset_counts()
    mel_eager = eager(tokens, mel2ph, f0, noise, steps, depth).cpu().numpy()
    eager_counts = read_counts()
    err = float(np.abs(mel_pt2 - mel_eager).max())
    want = {"K1": n_layers * steps, "K2": n_layers * steps, "K3": n_enc}
    log(f"[export] .pt2 request [1,{t_txt}] x [1,{t_mel}], {steps} steps: launches {counts} "
        f"(eager {eager_counts}, expected {want}); max|mel .pt2 - eager| {err:.3e} "
        f"(tolerance 1e-4, float32)")
    if counts != want or eager_counts != want or bwd_launches:
        fail(f"export: the .pt2 request launched {counts}, eager {eager_counts}, not {want}")
    if not (np.isfinite(mel_pt2).all() and err <= 1e-4):
        fail("export: the .pt2 request disagrees with the eager model on the card")
    if (mel_pt2[mel2ph == 0] != 0).any():
        fail("export: padded frames of the .pt2 request are not zero")
    out.update(launches=counts, max_abs_err_vs_eager=err)
    out["ddpm"] = ddpm_export_check(root / "ddpm", hp0, card, (tokens, mel2ph, f0), noise,
                                    reset_counts, read_counts)

    # 3. times in turns with eager
    run_pt2 = lambda: runtime.synthesize_mel(tokens, mel2ph, f0, noise=noise)
    run_eager = lambda: eager(tokens, mel2ph, f0, noise, steps, depth).cpu()
    out["request_s"] = r = export_turns(run_eager, run_pt2)
    best, mean = r["best"], r["mean"]
    log(f"[export] request at [1,{t_mel}] frames, {steps} steps, float32: .pt2 "
        f"{mean['pt2'] * 1e3:.1f} ms mean ({best['pt2'] * 1e3:.1f} best, "
        f"{t_mel / mean['pt2']:.0f} mel frames/s), eager forward_infer_dynamic "
        f"{mean['eager'] * 1e3:.1f} ms mean ({best['eager'] * 1e3:.1f} best, "
        f"{t_mel / mean['eager']:.0f} mel frames/s); .pt2 / eager "
        f"{mean['pt2'] / mean['eager']:.3f} on {card}")

    out["profile"] = profile_request(run_pt2, "one .pt2 request",
                                     table="chip_smoke_export_profile.txt")

    # 4. waits for the device a request, at two step counts: a wait a step would
    # show as a difference
    syncs = {n: count_syncs(lambda n=n: runtime.synthesize_mel(tokens, mel2ph, f0, steps=n,
                                                               noise=noise))
             for n in (steps, 10)}
    syncs_eager = count_syncs(lambda: eager(tokens, mel2ph, f0, noise, steps, depth).cpu())
    out["syncs"] = {"pt2": syncs, "eager": syncs_eager}
    log(f"[export] device waits a request (profiler): .pt2 at {steps} steps {syncs[steps]}, at "
        f"10 steps {syncs[10]}; eager at {steps} steps {syncs_eager}")
    if syncs[steps]["syncs"] != syncs[10]["syncs"]:
        fail("export: the .pt2 request waits for the device at every step")

    # 5. the vocoder: the shipped full-NSF generator, .pt2 on the card
    voc_exporter = NSFHiFiGANExporter(hp, root / "vocoder", fmt="pt2", device="cuda")
    t0 = time.perf_counter()
    quiet(voc_exporter.export)
    out["vocoder_export_s"] = time.perf_counter() - t0
    voc_runtime = VocoderArtifactRuntime(root / "vocoder", device="cuda")
    bm = voc_exporter.buckets[0]
    mel_in = mel_pt2[:, :t_mel - t_mel // 8]
    f0_in = f0[:, :mel_in.shape[1]]
    wav = voc_runtime.vocode(mel_in, f0_in, seed=5)
    gen = torch.Generator(device=dev).manual_seed(5)
    draws = VocoderNoise(rand_ini=torch.rand((1, 1, 9), generator=gen, device=dev),
                         source=torch.randn((1, bm * voc_runtime.hop_size, 9), generator=gen,
                                            device=dev))
    pad = bm - mel_in.shape[1]
    with torch.no_grad():
        wav_eager = voc_exporter.vocoder.model(
            torch.from_numpy(np.pad(mel_in, [(0, 0), (0, pad), (0, 0)])).to(dev),
            torch.from_numpy(np.pad(f0_in, [(0, 0), (0, pad)], constant_values=220.0)).to(dev),
            noise=draws)[:, :wav.shape[1]].cpu().numpy()
    voc_err = float(np.abs(wav - wav_eager).max())
    voc_ts = timed_requests(lambda: voc_runtime.vocode(mel_in, f0_in, seed=5))
    out["vocoder"] = {"max_abs_err_vs_eager": voc_err, "times_s": voc_ts,
                      "size_mb": (root / "vocoder" / "nsf_hifigan.pt2").stat().st_size / 1e6}
    log(f"[export] vocoder .pt2 (full-NSF, {VOCODER_CHANNELS} channels, bucket {bm} frames) "
        f"exported in {out['vocoder_export_s']:.1f} s, {out['vocoder']['size_mb']:.1f} MB; "
        f"{min(voc_ts) * 1e3:.1f} ms a request ({['%.1f' % (t * 1e3) for t in voc_ts]} ms); "
        f"max|wav .pt2 - eager| {voc_err:.3e} (tolerance 1e-4) on {card}")
    if not (np.isfinite(wav).all() and voc_err <= 1e-4):
        fail("export: the vocoder .pt2 disagrees with the eager generator on the card")

    # 6. the ONNX: every graph checked; the small bucket's through the
    # interpreter at 2 steps against the card's eager output on the same noise
    t0 = time.perf_counter()
    for files in exporter.bucket_files.values():
        for kind in ("fs2_aux_onnx", "acoustic_onnx"):
            check_model((root / "acoustic" / files[kind]).read_bytes(), known_ops=EMITTED_OPS)
    t_txt_s, t_mel_s = EXPORT_BUCKETS[1]
    tokens_s, mel2ph_s, f0_s = export_inputs(t_txt_s, t_mel_s, seed=22)
    feed = {"tokens": tokens_s, "mel2ph": mel2ph_s, "f0": f0_s,
            "steps": np.int32(EXPORT_ONNX_STEPS)}
    if hp.get("use_shallow_diffusion", False):
        feed["depth"] = np.float32(depth)
    data = (root / "acoustic" / exporter.bucket_files[f"{t_txt_s}x{t_mel_s}"]["acoustic_onnx"]
            ).read_bytes()
    (mel_onnx,) = run_model(data, feed, rng_seed=7)
    onnx_s = time.perf_counter() - t0
    noise_s = torch.from_numpy(np.random.default_rng(7).standard_normal((1, t_mel_s, n_mels))
                               .astype(np.float32)).to(dev)
    mel_card = eager(tokens_s, mel2ph_s, f0_s, noise_s, EXPORT_ONNX_STEPS, depth).cpu().numpy()
    onnx_err = float(np.abs(mel_onnx - mel_card).max())
    out["onnx"] = {"max_abs_err_vs_card": onnx_err, "check_and_interpret_s": onnx_s}
    log(f"[export] ONNX: every graph passes the checker; the [1,{t_txt_s}] x [1,{t_mel_s}] "
        f"graph at {EXPORT_ONNX_STEPS} steps through the interpreter against the card's eager "
        f"output: max|diff| {onnx_err:.3e} (tolerance 1e-3) in {onnx_s:.1f} s")
    if not onnx_err <= 1e-3:
        fail("export: the ONNX graph disagrees with the card")

    # 7. the variance model's bundle, and the chain into the two above
    out["variance"] = variance_export_check(root / "variance_exp", card, reset_counts,
                                            read_counts, runtime, voc_runtime)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[export] phase {out['phase_s']:.1f} s")
    return out, dict(counts, K3bwd=bwd_launches)


def card_vs_cpu_step(tag, tasks, batch, draws, what=""):
    """One float32 optimizer step of two tasks with the same weights: the
    card's (kernels) and the CPU's (plain versions), on the same numpy batch
    and draws (tensors, or dicts of them). Gradients within 1e-3 of each
    one's largest entry; parameters after AdamW within 2 lr (its first step
    moves an element by lr g / (|g| + eps), so a gradient near 0 may land on
    either side), all but 1 % of each tensor's elements within 1e-6. Returns
    the report and the K3 launches (forward, backward) of each step."""
    from diffsinger_tpu_torch.ops import flash_attention

    grads, launched = [], []
    for task in tasks:
        on = {k: ({n: m.to(task.device) for n, m in x.items()} if isinstance(x, dict)
                  else x.to(task.device)) for k, x in draws.items()}
        n_fwd, n_bwd = flash_attention.launches, flash_attention.bwd_launches
        task.train_step(task.to_device(batch), **on)
        launched.append((flash_attention.launches - n_fwd, flash_attention.bwd_launches - n_bwd))
        # a copy: apply_update clips the gradients in place (.cpu() of a CPU tensor is itself)
        grads.append({n: p.grad.detach().float().cpu().clone()
                      for n, p in task.module.named_parameters()})
        task.apply_update()
    grad_err = max(max_err(grads[0][n], w) / max(w.abs().max().item(), 1e-8)
                   for n, w in grads[1].items())
    lr = tasks[0].hp["optimizer_args"]["lr"]
    diffs = [(a.cpu() - w).abs() for a, w in zip(tasks[0].module.state_dict().values(),
                                                  tasks[1].module.state_dict().values())]
    param_err = max(d.max().item() for d in diffs)
    param_off = max((d > 1e-6).float().mean().item() for d in diffs)
    log(f"[{tag}] f32 narrow step{what}, card vs CPU: gradients max|err|/max|ref| {grad_err:.3e} "
        f"(tolerance 1e-3) over {len(grads[1])} parameters; parameters after AdamW max|err| "
        f"{param_err:.3e} (tolerance 2 lr = {2 * lr:.1e}), share of elements off by > 1e-6 "
        f"{param_off:.4f} (tolerance 0.01); K3 launches (forward, backward) card {launched[0]}, "
        f"CPU {launched[1]}")
    if not (grad_err <= 1e-3 and param_err <= 2 * lr and param_off <= 0.01):
        fail(f"[{tag}] the float32 training step on the card disagrees with the step on the CPU")
    return {"grad_rel_err": grad_err, "param_err": param_err, "param_share_off": param_off,
            "lr": lr, "k3_launches": launched[0]}, launched


def timed_train_steps(tag, task, batch, per_step, reset_counts, read_counts):
    """The loop's body (its seeding and draws, ``BaseTask.micro_draws``):
    ``TRAIN_WARMUP`` steps, then ``TRAIN_STEPS`` timed ones with the launch
    counters reset before them and checked against ``per_step`` after.
    Returns the seconds, the counts, the peak memory in GiB, the last step's
    metrics and the step function."""
    import torch

    from diffsinger_tpu_torch.ops import flash_attention

    micro, rows = task.global_step, batch["tokens"].shape[0]

    def step():
        nonlocal micro
        metrics = task.train_step(batch, **task.micro_draws(batch, micro, rows, 0))
        metrics["grad_norm"] = task.apply_update()
        micro += 1
        return metrics

    for _ in range(TRAIN_WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics = step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(read_counts(), K3bwd=flash_attention.bwd_launches)
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    values = {k: float(v) for k, v in metrics.items()}
    log(f"[{tag}] launches over {TRAIN_STEPS} steps: {counts} (expected {want})")
    if counts != want:
        fail(f"[{tag}] launch counts {counts} != {want}")
    if not all(math.isfinite(v) for v in values.values()):
        fail(f"[{tag}] non-finite metrics {values}")
    return wall, counts, torch.cuda.max_memory_allocated() / 2**30, values, step


def check_resume(tag, task, task_cls, hp):
    """Save, then resume a new task from the same folder: the weights, the
    AdamW moments, the step and the scheduler must come back."""
    import torch

    task.save()
    resumed = quiet(task_cls, hp)
    resumed.configure_optimizer()
    quiet(resumed.init_or_resume)
    state, state2 = task.module.state_dict(), resumed.module.state_dict()
    opt_a = task.optimizer.state_dict()["state"]
    opt_b = resumed.optimizer.state_dict()["state"]
    same = (resumed.global_step == task.global_step and state.keys() == state2.keys()
            and all(torch.equal(state[k], state2[k].to(state[k].device)) for k in state)
            and opt_a.keys() == opt_b.keys()
            and all(torch.equal(opt_a[i][m], opt_b[i][m].to(opt_a[i][m].device)) for i in opt_a
                    for m in ("exp_avg", "exp_avg_sq"))
            and resumed.scheduler.state_dict()["last_epoch"] == task.global_step)
    log(f"[{tag}] save and resume at step {task.global_step}: weights, AdamW moments and "
        f"the scheduler {'restored' if same else 'DIFFER'}")
    if not same:
        fail(f"[{tag}] the resumed task differs from the saved one")
    return task.global_step


TRAIN_B, TRAIN_T_TXT, TRAIN_T_MEL = 48, 128, 1024
TRAIN_LENGTHS = (600, 1024)  # segment lengths in frames
TRAIN_STEPS, TRAIN_WARMUP = 10, 3  # timed steps, after the warm-ups
TRAIN_PER_STEP = {"K1": 6, "K2": 6, "K3": 4, "K3bwd": 4}


def train_items(rng, n, t_txt, t_mel, n_mels, lo, hi):
    """n acoustic items: lengths in [lo, hi] (the first one hi, so that the
    buckets are t_txt and t_mel), ragged token counts up to t_txt."""
    import numpy as np

    items = []
    for i in range(n):
        length = hi if i == 0 else int(rng.integers(lo, hi + 1))
        n_tok = t_txt if i == 0 else int(rng.integers(t_txt // 2, t_txt + 1))
        dur = rng.multinomial(length - n_tok, np.ones(n_tok) / n_tok) + 1
        f0 = 220.0 * 2 ** (rng.uniform(-1, 1) + 0.2 * np.sin(np.linspace(0, 20, length)))
        items.append(dict(tokens=rng.integers(1, VOCAB, n_tok), mel2ph=np.repeat(np.arange(1, n_tok + 1), dur),
                          mel=rng.uniform(-11, -1, (length, n_mels)).astype(np.float32),
                          f0=f0.astype(np.float32)))
    return items


def acoustic_train_hp(work_dir, **over):
    """configs/acoustic.yaml at full width, writing to ``work_dir``."""
    from diffsinger_tpu_torch.config import load_config

    hp = load_config(ROOT / "configs" / "acoustic.yaml")
    hp.update(work_dir=str(work_dir), val_with_vocoder=False, num_valid_plots=1,
              dictionary=str(ROOT / "dictionaries" / "opencpop-extension.txt"), **over)
    return hp


def memory_acoustic_dataset(items, hp):
    """Acoustic items held in memory, behind ``AcousticDataset``'s collater."""
    from diffsinger_tpu_torch.data.dataset import AcousticDataset

    class MemoryDataset(AcousticDataset):
        def __init__(self):
            self.hp, self.items = hp, items
            self.sizes = [len(it["mel"]) for it in items]
            self.metadata = {"mel": self.sizes, "mel2ph": self.sizes,
                             "tokens": [len(it["tokens"]) for it in items]}
            self.frame_bucket, self.token_bucket = 128, 16
            self.required_variances = []

    return MemoryDataset()


def train_phase(card, reset_counts, read_counts, check):
    """[train]: the acoustic model's training on the card through
    ``AcousticTask`` (the task ``cli.train`` builds): configs/acoustic.yaml at
    full width, '16-mixed' (bf16 autocast over float32 AdamW), an in-memory
    seeded batch of 48 segments of 600-1024 frames (T_mel bucket 1024, 49,152
    frames <= max_batch_frames) with ragged token counts (T_txt 128). K3's
    backward against its plain version; one float32 step of a narrow model on
    the card against the same step on CPU tensors; the loss falling over 20
    steps on the fixed batch with fixed t and noise; 10 timed steps after 3
    warm-ups (steps/s, mel frames/s, peak memory, launches per step); one step
    under the profiler; a validation batch; a save and resume. Returns the
    report and the launch counts of the timed steps."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.ops import flash_attention
    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask

    dev = torch.device("cuda")
    report = {}
    tmp = Path(tempfile.mkdtemp(prefix="train_", dir=OUT_DIR))

    # K3's backward against its plain version, at the training batch's shape
    # and the long shape, with padded rows: max|err| <= 1e-4 of max|reference|
    g = torch.Generator(device=dev).manual_seed(3)
    bwd_cases = {}
    for b, length in ((TRAIN_B, TRAIN_T_TXT), (16, 512)):
        q, k, v, dout = (torch.randn(b, 2, length, 128, generator=g, device=dev) for _ in range(4))
        pad = torch.zeros(b, length, dtype=torch.bool, device=dev)
        for i in range(b):
            pad[i, length - (7 * i) % (length // 2):] = True
        scale = 128 ** -0.5
        lse = torch.empty(b, 2, length, device=dev)
        out = flash_attention._launch_fwd(q, k, v, pad, scale, lse)
        got = flash_attention.flash_attention_bwd(q, k, v, pad, out, lse, dout, sm_scale=scale)
        want_out = flash_attention.flash_attention_plain(q, k, v, pad, sm_scale=scale)
        want_lse = flash_attention.attention_lse_plain(q, k, pad, sm_scale=scale)
        want = flash_attention.flash_attention_bwd_plain(q, k, v, pad, want_out, want_lse, dout,
                                                         sm_scale=scale)
        check(f"K3 f32 lse [{b},2,{length},128] padded", lse, want_lse, 1e-4)
        errs = [check(f"K3-bwd f32 {n} [{b},2,{length},128] padded", a, w,
                      1e-4 * w.abs().max().item()) for n, a, w in zip(("dq", "dk", "dv"), got, want)]
        bwd_cases[(b, length)] = (q, k, v, pad, out, lse, dout, errs)
    torch.cuda.synchronize()

    # one float32 step of a narrow model: the card (kernels) against the CPU
    # (plain versions), same weights, batch, t and noise, dropout off
    narrow = dict(hidden_size=64, enc_layers=2, dropout=0.0, pl_trainer_precision="32-true",
                  backbone_args=dict(num_channels=128, num_layers=2, kernel_size=31,
                                     dropout_rate=0.0, strong_cond=True))
    tasks = []
    for device in ("cuda", "cpu"):
        hp_n = acoustic_train_hp(tmp / f"narrow_{device}", **narrow)
        hp_n["shallow_diffusion_args"] = dict(hp_n["shallow_diffusion_args"], aux_decoder_args=dict(
            num_channels=64, num_layers=2, kernel_size=7, dropout_rate=0.0))
        torch.manual_seed(30)
        tasks.append(quiet(AcousticTask, hp_n, device=device))
        tasks[-1].configure_optimizer()
    seeded_weights(tasks[0].module, 31)
    tasks[1].module.load_state_dict(tasks[0].module.state_dict())
    rng = np.random.default_rng(32)
    small_ds = memory_acoustic_dataset(train_items(rng, 4, 32, 256, 128, 150, 256), tasks[0].hp)
    small = {k: v for k, v in small_ds.collater([small_ds[i] for i in range(4)]).items()
             if isinstance(v, np.ndarray) and k != "indices"}
    t_small = torch.from_numpy(rng.uniform(0.4, 1, 4).astype(np.float32))
    noise_small = torch.from_numpy(rng.standard_normal((4, 256, 128)).astype(np.float32))
    report["f32_step_vs_cpu"], launched = card_vs_cpu_step(
        "train", tasks, small, dict(t=t_small, noise=noise_small))
    if launched != [(2, 2), (0, 0)]:  # a layer of the encoder each, on the card only
        fail(f"[train] the narrow step's K3 launches {launched} != [(2, 2), (0, 0)]")
    del tasks

    # the full-width task, bf16 autocast over float32 parameters and AdamW
    hp = acoustic_train_hp(tmp / "exp")
    torch.manual_seed(33)
    task = quiet(AcousticTask, hp)
    task.configure_optimizer()
    seeded_weights(task.module, 34)
    if task.amp_dtype != torch.bfloat16:
        fail(f"pl_trainer_precision {hp['pl_trainer_precision']} did not give bf16 autocast")
    n_params = sum(p.numel() for p in task.params)
    rng = np.random.default_rng(35)
    ds = memory_acoustic_dataset(train_items(rng, TRAIN_B, TRAIN_T_TXT, TRAIN_T_MEL,
                                   hp["audio_num_mel_bins"], *TRAIN_LENGTHS), hp)
    collated = ds.collater([ds[i] for i in range(TRAIN_B)])
    batch = task.to_device({k: v for k, v in collated.items() if isinstance(v, np.ndarray)
                            and k != "indices"})
    if tuple(batch["mel"].shape[:2]) != (TRAIN_B, TRAIN_T_MEL) or \
            tuple(batch["tokens"].shape) != (TRAIN_B, TRAIN_T_TXT):
        fail(f"[train] batch shapes {tuple(batch['mel'].shape)} {tuple(batch['tokens'].shape)}")
    true_frames = int((batch["mel2ph"] > 0).sum().item())
    gen = torch.Generator(device=dev).manual_seed(36)
    t_fix = 0.4 + 0.6 * torch.rand(TRAIN_B, generator=gen, device=dev)
    noise_fix = torch.randn(batch["mel"].shape, generator=gen, device=dev)

    # the loss on one fixed batch with fixed t and noise falls
    losses = []
    for _ in range(20):
        m = task.train_step(batch, t=t_fix, noise=noise_fix)
        task.apply_update()
        losses.append(float(m["total_loss"]))
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"[train] loss on a fixed batch over 20 steps: {['%.4f' % x for x in losses]}; mean of "
        f"the first 5 {first:.4f}, of the last 5 {last:.4f}")
    report["fixed_batch_losses"] = losses
    if not (all(math.isfinite(x) for x in losses) and last < first):
        fail("[train] the loss did not fall on a fixed batch")

    # steady steps, as the loop runs them
    wall, counts, peak, values, step = timed_train_steps("train", task, batch, TRAIN_PER_STEP,
                                                         reset_counts, read_counts)
    sps = TRAIN_STEPS / wall
    log(f"[train] {TRAIN_STEPS} steps of B={TRAIN_B} T_mel={TRAIN_T_MEL} ({true_frames} true "
        f"frames) in {wall:.3f} s: {sps:.3f} optimizer steps/s, {sps * true_frames:.1f} mel "
        f"frames/s ({sps * TRAIN_B * TRAIN_T_MEL:.1f} padded), peak memory {peak:.2f} GiB, "
        f"{n_params} parameters, bf16 autocast over float32 AdamW, on {card}; last step "
        + " ".join(f"{k}={v:.4f}" for k, v in values.items()))
    report.update(steps_per_s=sps, mel_frames_per_s=sps * true_frames,
                  padded_frames_per_s=sps * TRAIN_B * TRAIN_T_MEL, true_frames=true_frames,
                  step_s=wall / TRAIN_STEPS, peak_mem_gib=peak, parameters=n_params,
                  launches=counts, last_metrics=values)
    report["profile"] = profile_request(lambda: step(), "one training step",
                                        table="chip_smoke_train_profile.txt")

    # one validation batch (float32, the kernels, forward_infer and its figures)
    val = quiet(task.run_validation, memory_acoustic_dataset(ds.items[:1], hp))
    log(f"[train] validation batch: {val}")
    if not val or not all(math.isfinite(v) for v in val.values()):
        fail(f"[train] validation losses {val}")
    report["validation"] = val

    report["resume_step"] = check_resume("train", task, AcousticTask, hp)
    del task
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return report, counts, bwd_cases


VAR_TRAIN_B = 48
VAR_TRAIN_LENGTHS = (1000, 1664)  # segment lengths in frames
VAR_TRAIN_PER_STEP = {"K1": 0, "K2": 0, "K3": 4, "K3bwd": 4}


def variance_train_items(rng, n, lo, hi, n_ph_first):
    """n variance items of lo-hi frames (the first one hi frames and
    ``n_ph_first`` phonemes, so that it sets the buckets): about a phoneme per
    10 frames, words of 1-3 phonemes, one note per word, a base pitch from the
    notes, a pitch with vibrato around it, 10 % unvoiced frames, and the four
    curves (dB, tension as a logit)."""
    import numpy as np

    items = []
    for i in range(n):
        length = hi if i == 0 else int(rng.integers(lo, hi + 1))
        n_ph = n_ph_first if i == 0 else int(round(length / rng.uniform(9.5, 11.5)))
        ph_num = []
        while sum(ph_num) < n_ph:
            ph_num.append(min(int(rng.integers(1, 4)), n_ph - sum(ph_num)))
        ph_num = np.asarray(ph_num)
        n_word = len(ph_num)
        ph_dur = rng.multinomial(length - n_ph, np.ones(n_ph) / n_ph) + 1
        note_dur = np.add.reduceat(ph_dur, np.r_[0, np.cumsum(ph_num)[:-1]])
        note_midi = rng.uniform(52, 72, n_word).astype(np.float32)
        base_pitch = np.repeat(note_midi, note_dur).astype(np.float32)
        vibrato = 0.3 * np.sin(np.linspace(0, length / 15, length))
        items.append(dict(
            tokens=rng.integers(1, VOCAB, n_ph), ph_dur=ph_dur,
            ph2word=np.repeat(np.arange(1, n_word + 1), ph_num),
            midi=np.repeat(np.round(note_midi), ph_num).astype(np.int64),
            mel2ph=np.repeat(np.arange(1, n_ph + 1), ph_dur),
            note_midi=note_midi, note_rest=rng.random(n_word) < 0.1, note_dur=note_dur,
            note_glide=rng.integers(0, 3, n_word),
            mel2note=np.repeat(np.arange(1, n_word + 1), note_dur), base_pitch=base_pitch,
            pitch=(base_pitch + vibrato + rng.normal(0, 0.1, length)).astype(np.float32),
            uv=rng.random(length) < 0.1,
            energy=rng.uniform(-60, -20, length).astype(np.float32),
            breathiness=rng.uniform(-80, -40, length).astype(np.float32),
            voicing=rng.uniform(-40, -12, length).astype(np.float32),
            tension=rng.uniform(-4, 4, length).astype(np.float32)))
    return items


def variance_hp(work_dir, **over):
    """configs/variance.yaml with the four variances on, writing to work_dir."""
    from diffsinger_tpu_torch.config import load_config

    hp = load_config(ROOT / "configs" / "variance.yaml")
    hp.update({f"predict_{v}": True for v in VARIANCES})
    hp.update(work_dir=str(work_dir), num_valid_plots=1,
              dictionary=str(ROOT / "dictionaries" / "opencpop-extension.txt"), **over)
    return hp


def memory_variance_dataset(items, hp):
    """Variance items held in memory, behind ``VarianceDataset``'s collater."""
    from diffsinger_tpu_torch.data.dataset import VarianceDataset

    class MemoryDataset(VarianceDataset):
        def __init__(self):
            self.hp, self.items = hp, items
            self.sizes = [len(it["mel2ph"]) for it in items]
            self.metadata = {k: [len(it[k]) for it in items]
                             for k in ("tokens", "mel2ph", "note_midi", "pitch", *VARIANCES)}
            self.frame_bucket, self.token_bucket = 128, 16
            self.var_list = [v for v in VARIANCES if hp.get(f"predict_{v}", False)]

    return MemoryDataset()


def narrow_variance_overrides(base):
    """A narrow float32 variance model with the melody encoder and glides,
    dropout off: encoder 2 x 64 (two heads of 32), melody encoder 2 x 128
    (two heads of 64, as at full width)."""
    return dict(hidden_size=64, enc_layers=2, dropout=0.0, pl_trainer_precision="32-true",
                use_melody_encoder=True, use_glide_embed=True,
                melody_encoder_args=dict(hidden_size=128, enc_layers=2),
                dur_prediction_args=dict(base["dur_prediction_args"], hidden_size=64,
                                         num_layers=2, dropout=0.0),
                pitch_prediction_args=dict(base["pitch_prediction_args"], backbone_args=dict(
                    num_layers=4, num_channels=64, dilation_cycle_length=2)),
                variances_prediction_args=dict(
                    base["variances_prediction_args"],
                    backbone_args=dict(num_layers=2, num_channels=64, dilation_cycle_length=2)))


def narrow_variance_step(work_dir):
    """One float32 step of a narrow variance model with the melody encoder and
    glides: the card (kernels) against the CPU (plain versions), same
    weights, batch of 4 segments, t, noise and retake masks, dropout off,
    within ``card_vs_cpu_step``'s tolerances. The encoder has two heads of
    32, the melody encoder two heads of 64 (as at full width), two layers
    each: K3 and its backward launch 4 times on the card and never on the
    CPU. Returns ``card_vs_cpu_step``'s report."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.training.variance_task import VarianceTask, random_retake_masks

    narrow = narrow_variance_overrides(variance_hp(work_dir))
    tasks = []
    for device in ("cuda", "cpu"):
        torch.manual_seed(42)
        tasks.append(quiet(VarianceTask, variance_hp(Path(work_dir) / f"narrow_{device}", **narrow),
                           device=device))
        tasks[-1].configure_optimizer()
    seeded_weights(tasks[0].module, 43)
    tasks[1].module.load_state_dict(tasks[0].module.state_dict())
    ds = memory_variance_dataset(variance_train_items(np.random.default_rng(44), 4, 150, 256, 30),
                                 tasks[0].hp)
    small = {k: v for k, v in ds.collater([ds[i] for i in range(4)]).items()
             if isinstance(v, np.ndarray) and k != "indices"}
    b_s, t_s = small["mel2ph"].shape
    gen = torch.Generator().manual_seed(45)
    draws = dict(t_pitch=torch.rand(b_s, generator=gen), t_var=torch.rand(b_s, generator=gen),
                 noise_pitch=torch.randn(b_s, t_s, 64, generator=gen),
                 noise_var=torch.randn(b_s, t_s, 48, generator=gen),
                 pitch_retake=random_retake_masks(b_s, t_s, generator=gen),
                 variance_retake={v: random_retake_masks(b_s, t_s, generator=gen)
                                  for v in VARIANCES})
    report, launched = card_vs_cpu_step("train_variance", tasks, small, draws,
                                        " with the melody encoder")
    if launched != [(4, 4), (0, 0)]:
        fail(f"[train_variance] the narrow step's K3 launches {launched} != [(4, 4), (0, 0)]")
    return report


def train_variance_phase(card, reset_counts, read_counts, check):
    """[train_variance]: the variance model's training on the card through
    ``VarianceTask`` (the task ``cli.train`` builds for configs/variance.yaml):
    full width with the four variances on, '16-mixed' (bf16 autocast over
    float32 AdamW), an in-memory seeded batch of 48 segments of 1000-1664
    frames (T_mel bucket 1664: 79,872 frames <= max_batch_frames 80,000) with
    about a phoneme per 10 frames (T_txt bucket 176) through
    ``VarianceDataset.collater``. K3 and its backward against their plain
    versions at the encoder's shape and at the melody encoder's head width 64;
    one float32 step of a narrow model with the melody encoder and glides on
    the card against the same step on CPU tensors; the full-width melody
    encoder's forward and backward (its launches); the loss falling over 20
    steps on the fixed batch with fixed t, noise and retake masks; 10 timed
    steps after 3 warm-ups (steps/s, true frames/s, peak memory, launches per
    step); one step under the profiler; a validation batch (losses and
    metrics); a save and resume. Returns the report, the launch counts of the
    timed steps and the kernel cases for the timings."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.models.variance_encoder import MelodyEncoder
    from diffsinger_tpu_torch.ops import flash_attention
    from diffsinger_tpu_torch.training.variance_task import VarianceTask, random_retake_masks

    def batch_of(task, ds, n):
        collated = ds.collater([ds[i] for i in range(n)])
        return task.to_device({k: v for k, v in collated.items()
                               if isinstance(v, np.ndarray) and k != "indices"})

    dev = torch.device("cuda")
    report = {}
    tmp = Path(tempfile.mkdtemp(prefix="train_variance_", dir=OUT_DIR))

    # the full-width batch first: its buckets are the kernels' shapes
    hp = variance_hp(tmp / "exp")
    rng = np.random.default_rng(40)
    ds = memory_variance_dataset(variance_train_items(rng, VAR_TRAIN_B, *VAR_TRAIN_LENGTHS, 170),
                                 hp)
    collated = ds.collater([ds[i] for i in range(VAR_TRAIN_B)])
    b_, t_txt = collated["tokens"].shape
    t_mel, t_note = collated["mel2ph"].shape[1], collated["note_midi"].shape[1]
    if (b_, t_mel) != (VAR_TRAIN_B, VAR_TRAIN_LENGTHS[1]) or b_ * t_mel > hp["max_batch_frames"]:
        fail(f"[train_variance] batch shapes {collated['tokens'].shape} {collated['mel2ph'].shape}")
    log(f"[train_variance] batch: B={b_}, T_txt bucket {t_txt}, T_note bucket {t_note}, T_mel "
        f"bucket {t_mel} ({b_ * t_mel} frames, max_batch_frames {hp['max_batch_frames']})")

    # K3 and its backward against their plain versions at the variance
    # encoder's shape (2 heads of 128 over the batch's token padding) and the
    # melody encoder's (2 heads of 64 over its note padding)
    g = torch.Generator(device=dev).manual_seed(41)
    cases = {}
    for what, length, d, pad_np in (
            ("encoder", t_txt, 128, collated["tokens"] == 0),
            ("melody encoder", t_note, 64, collated["note_midi"] < 0)):
        q, k, v, dout = (torch.randn(b_, 2, length, d, generator=g, device=dev) for _ in range(4))
        pad = torch.from_numpy(pad_np).to(dev)
        scale = d ** -0.5
        lse = torch.empty(b_, 2, length, device=dev)
        out = flash_attention._launch_fwd(q, k, v, pad, scale, lse)
        got = flash_attention.flash_attention_bwd(q, k, v, pad, out, lse, dout, sm_scale=scale)
        want_out = flash_attention.flash_attention_plain(q, k, v, pad, sm_scale=scale)
        want_lse = flash_attention.attention_lse_plain(q, k, pad, sm_scale=scale)
        want = flash_attention.flash_attention_bwd_plain(q, k, v, pad, want_out, want_lse, dout,
                                                         sm_scale=scale)
        name = f"[{b_},2,{length},{d}] padded ({what}, variance training)"
        fwd_err = check(f"K3 f32 {name}", out, want_out, 1e-4)
        check(f"K3 f32 lse {name}", lse, want_lse, 1e-4)
        errs = [check(f"K3-bwd f32 {n} {name}", a, w, 1e-4 * w.abs().max().item())
                for n, a, w in zip(("dq", "dk", "dv"), got, want)]
        cases[what] = dict(q=q, k=k, v=v, pad=pad, out=out, lse=lse, dout=dout,
                           fwd_err=fwd_err, bwd_errs=errs)
    torch.cuda.synchronize()

    report["f32_step_vs_cpu"] = narrow_variance_step(tmp)

    # the full-width melody encoder (4 layers of two heads of 64) forward and
    # backward under the step's bf16 autocast at the batch's note shape,
    # its launches counted from 0: the shipped config has it off, so this
    # is the one run of K3 and its backward at that shape
    torch.manual_seed(49)
    melody = MelodyEncoder.from_hparams(hp).to(dev)
    seeded_weights(melody, 50)
    notes = [torch.from_numpy(collated[k]).to(dev) for k in ("note_midi", "note_rest", "note_dur")]
    reset_counts()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        mel_out = melody(*notes)
    mel_out.float().square().mean().backward()
    torch.cuda.synchronize()
    melody_counts = dict(read_counts(), K3bwd=flash_attention.bwd_launches)
    n_layers = len(melody.encoder.layers)
    log(f"[train_variance] the full-width melody encoder, forward and backward at B={b_}, "
        f"T_note={t_note}: launches {melody_counts}")
    if melody_counts != {"K1": 0, "K2": 0, "K3": n_layers, "K3bwd": n_layers} or \
            not torch.isfinite(mel_out).all():
        fail(f"[train_variance] the melody encoder's launches {melody_counts} are not "
             f"{n_layers} K3 and {n_layers} K3-bwd, or its output is not finite")
    report["melody_encoder_launches"] = melody_counts
    del melody, mel_out, notes

    # the full-width task, bf16 autocast over float32 parameters and AdamW
    torch.manual_seed(46)
    task = quiet(VarianceTask, hp)
    task.configure_optimizer()
    seeded_weights(task.module, 47)
    if task.amp_dtype != torch.bfloat16:
        fail(f"pl_trainer_precision {hp['pl_trainer_precision']} did not give bf16 autocast")
    n_params = sum(p.numel() for p in task.params)
    batch = batch_of(task, ds, VAR_TRAIN_B)
    true_frames = int((batch["mel2ph"] > 0).sum().item())
    true_tokens = int((batch["tokens"] > 0).sum().item())
    gen = torch.Generator(device=dev).manual_seed(48)
    fixed = dict(t_pitch=torch.rand(b_, generator=gen, device=dev),
                 t_var=torch.rand(b_, generator=gen, device=dev),
                 noise_pitch=torch.randn(b_, t_mel, hp["pitch_prediction_args"]["repeat_bins"],
                                         generator=gen, device=dev),
                 noise_var=torch.randn(b_, t_mel,
                                       hp["variances_prediction_args"]["total_repeat_bins"],
                                       generator=gen, device=dev),
                 pitch_retake=random_retake_masks(b_, t_mel, generator=gen, device=dev),
                 variance_retake={v: random_retake_masks(b_, t_mel, generator=gen, device=dev)
                                  for v in VARIANCES})

    # the loss on one fixed batch with fixed t, noise and retake masks falls
    losses = []
    for _ in range(20):
        m = task.train_step(batch, **fixed)
        task.apply_update()
        losses.append({k: float(v) for k, v in m.items()})
    totals = [x["total_loss"] for x in losses]
    first, last = sum(totals[:5]) / 5, sum(totals[-5:]) / 5
    log(f"[train_variance] loss on a fixed batch over 20 steps: {['%.4f' % x for x in totals]}; "
        f"mean of the first 5 {first:.4f}, of the last 5 {last:.4f}; last step "
        + " ".join(f"{k}={v:.4f}" for k, v in losses[-1].items()))
    report["fixed_batch_losses"] = losses
    if not (all(math.isfinite(x) for x in totals) and last < first):
        fail("[train_variance] the loss did not fall on a fixed batch")

    # steady steps, as the loop runs them
    wall, counts, peak, values, step = timed_train_steps(
        "train_variance", task, batch, VAR_TRAIN_PER_STEP, reset_counts, read_counts)
    sps = TRAIN_STEPS / wall
    log(f"[train_variance] {TRAIN_STEPS} steps of B={b_} T_mel={t_mel} T_txt={t_txt} "
        f"({true_frames} true frames, {true_tokens} true tokens) in {wall:.3f} s: {sps:.3f} "
        f"optimizer steps/s, {sps * true_frames:.1f} true frames/s ({sps * b_ * t_mel:.1f} "
        f"padded), peak memory {peak:.2f} GiB, {n_params} parameters, bf16 autocast over float32 "
        f"AdamW, on {card}; last step " + " ".join(f"{k}={v:.4f}" for k, v in values.items()))
    report.update(steps_per_s=sps, frames_per_s=sps * true_frames,
                  padded_frames_per_s=sps * b_ * t_mel, true_frames=true_frames,
                  true_tokens=true_tokens, shapes={"B": b_, "T_txt": t_txt, "T_note": t_note,
                                                   "T_mel": t_mel},
                  step_s=wall / TRAIN_STEPS, peak_mem_gib=peak, parameters=n_params,
                  launches=counts, last_metrics=values)
    prof = profile_request(lambda: step(), "one variance training step",
                           table="chip_smoke_train_variance_profile.txt")
    report["profile"] = prof
    if prof.get("measured"):
        log("[train_variance] top device operations: " + "; ".join(
            f"{k[:60]} {ms:.1f} ms" for k, ms in list(prof["top_kernels_ms"].items())[:8]))

    # one validation batch (float32, the kernels, forward_infer, metrics, figures)
    val = quiet(task.run_validation, memory_variance_dataset(ds.items[:4], hp))
    log(f"[train_variance] validation batch: {val}")
    want_keys = {"dur_loss", "pitch_loss", "var_loss", "metrics/rhythm_corr",
                 "metrics/ph_dur_acc", "metrics/pitch_acc", "metrics/pitch_r2",
                 *(f"metrics/{v}_r2" for v in VARIANCES)}
    shares = ("metrics/rhythm_corr", "metrics/ph_dur_acc", "metrics/pitch_acc")
    if not (want_keys <= set(val) and all(math.isfinite(v) for v in val.values())
            and all(0.0 <= val[k] <= 1.0 for k in shares)
            and all(val[k] <= 1.0 for k in want_keys if k.endswith("_r2"))):
        fail(f"[train_variance] validation losses or metrics {val}")
    report["validation"] = val

    report["resume_step"] = check_resume("train_variance", task, VarianceTask, hp)
    del task, batch, fixed
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return report, counts, cases


REMAT_POLICIES = (False, "full", "dots", "dots_no_batch")  # recompute_grads


def train_remat_phase(card, reset_counts, read_counts):
    """[train_remat]: ``recompute_grads`` on [train]'s task and batch
    (configs/acoustic.yaml at full width, '16-mixed', the same seeded batch of
    48 x 1024): for each policy, the peak memory, steps/s over 10 steps after
    3 warm-ups and the kernels' launches a step (under recomputation K2, with
    K1 inside it, runs again in the backward of each LYNXNet layer); one
    float32 step under each policy against the step without, the loss and
    every gradient (the same kernels on the same inputs: expected equal);
    [train_variance]'s model and batch with 'full' against off (peak memory,
    steps/s); and one step of a batch sent as ``train_wire_dtype: float16``
    through the trainer's upload stage against the float32 batch (bytes
    uploaded, the loss). Returns the report and the launches a step by
    policy."""
    import gc

    import numpy as np
    import torch

    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask
    from diffsinger_tpu_torch.training.base_task import to_wire
    from diffsinger_tpu_torch.training.variance_task import VarianceTask

    tag = "[train_remat]"
    dev = torch.device("cuda")
    tmp = Path(tempfile.mkdtemp(prefix="train_remat_", dir=OUT_DIR))
    report = {"acoustic": {}, "float32": {}, "variance": {}}
    hp0 = acoustic_train_hp(tmp / "data")
    rng = np.random.default_rng(35)  # [train]'s batch
    ds = memory_acoustic_dataset(train_items(rng, TRAIN_B, TRAIN_T_TXT, TRAIN_T_MEL,
                                             hp0["audio_num_mel_bins"], *TRAIN_LENGTHS), hp0)
    host = {k: v for k, v in ds.collater([ds[i] for i in range(TRAIN_B)]).items()
            if isinstance(v, np.ndarray) and k != "indices"}
    n_layers = hp0["backbone_args"]["num_layers"]
    gen = torch.Generator(device=dev).manual_seed(36)
    t_fix = 0.4 + 0.6 * torch.rand(TRAIN_B, generator=gen, device=dev)
    noise_fix = torch.randn(host["mel"].shape, generator=gen, device=dev)

    def task_of(cls, hp):
        torch.manual_seed(33)
        task = quiet(cls, hp)
        task.configure_optimizer()
        seeded_weights(task.module, 34)
        return task

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # each policy: peak memory, steps/s, launches a step
    per_step = {}
    for remat in REMAT_POLICIES:
        task = task_of(AcousticTask, acoustic_train_hp(tmp / f"exp_{remat}",
                                                       recompute_grads=remat))
        batch = task.to_device(host)
        want = dict(TRAIN_PER_STEP)
        if remat:
            want.update(K1=2 * n_layers, K2=2 * n_layers)
        log(f"{tag} recompute_grads={remat!r}: 10 timed steps")
        wall, counts, peak, values, _ = timed_train_steps("train_remat", task, batch, want,
                                                          reset_counts, read_counts)
        per_step[str(remat)] = {k: v // TRAIN_STEPS for k, v in counts.items()}
        rec = {"steps_per_s": TRAIN_STEPS / wall, "step_ms": 1e3 * wall / TRAIN_STEPS,
               "peak_mem_gib": peak, "launches_per_step": per_step[str(remat)],
               "last_metrics": values}
        report["acoustic"][str(remat)] = rec
        log(f"{tag} recompute_grads={remat!r}: {rec['steps_per_s']:.3f} steps/s "
            f"({rec['step_ms']:.1f} ms a step), peak memory {peak:.2f} GiB, launches a step "
            f"{per_step[str(remat)]}, last step "
            + " ".join(f"{k}={v:.4f}" for k, v in values.items()) + f" on {card}")
        if remat is False:
            # the wire format: one step of the float16 batch through the
            # trainer's upload stage and next_batch, against the float32 one
            wire = to_wire(host)
            sent = {n: sum(v.nbytes for v in b.values()) for n, b in
                    (("float32", host), ("float16", wire))}
            losses = {}
            for name, arrays in (("float32", host), ("float16", wire)):
                staged = task.upload_batch((arrays, TRAIN_B, 0, (0, 1)))
                on, _, _ = task.next_batch(iter([staged]))
                losses[name] = float(task.train_step(on, t=t_fix, noise=noise_fix)["total_loss"])
                task.optimizer.zero_grad(set_to_none=True)
            report["wire"] = {"bytes": sent, "losses": losses,
                              "loss_delta": abs(losses["float16"] - losses["float32"])}
            log(f"{tag} train_wire_dtype float16 against float32: {sent['float16']:,} against "
                f"{sent['float32']:,} bytes uploaded a batch, the step's loss "
                f"{losses['float16']:.6f} against {losses['float32']:.6f} (|delta| "
                f"{report['wire']['loss_delta']:.2e}) on {card}")
            if not (sent["float16"] < sent["float32"] and math.isfinite(losses["float16"])
                    and report["wire"]["loss_delta"] <= 1e-2 * abs(losses["float32"])):
                fail(f"{tag} the float16 wire format: {report['wire']}")
        del task, batch
        release()

    # one float32 step under each policy against the step without
    ref = None
    for remat in REMAT_POLICIES:
        task = task_of(AcousticTask, acoustic_train_hp(
            tmp / f"f32_{remat}", recompute_grads=remat, pl_trainer_precision="32-true"))
        reset_counts()
        loss = float(task.train_step(task.to_device(host), t=t_fix, noise=noise_fix)["total_loss"])
        counts = read_counts()
        grads = {n: p.grad.detach().clone() for n, p in task.module.named_parameters()
                 if p.grad is not None}
        del task
        release()
        if ref is None:
            ref = (loss, grads)
            continue
        loss_d = abs(loss - ref[0])
        grad_d = max((grads[n] - g).abs().max().item() for n, g in ref[1].items())
        grad_rel = max((grads[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-12)
                       for n, g in ref[1].items())
        same = grads.keys() == ref[1].keys()
        report["float32"][str(remat)] = {"loss": loss, "loss_delta": loss_d,
                                         "grad_max_abs_delta": grad_d,
                                         "grad_max_rel_delta": grad_rel, "launches": counts}
        log(f"{tag} float32 step, recompute_grads={remat!r} against off: loss {loss:.6f}, "
            f"|delta| {loss_d:.3e}; every gradient max |delta| {grad_d:.3e} ({grad_rel:.3e} of "
            f"its largest entry) over {len(grads)} parameters (expected 0); launches {counts}")
        if not same or loss_d > 1e-6 * abs(ref[0]) or grad_rel > 1e-5:
            fail(f"{tag} the float32 step under recompute_grads={remat!r} differs from the "
                 f"step without")
    del ref
    release()

    # the variance model (WaveNet 20 x 256 and 10 x 192) with full against off
    vrng = np.random.default_rng(40)  # [train_variance]'s batch
    vhp0 = variance_hp(tmp / "vdata")
    vds = memory_variance_dataset(variance_train_items(vrng, VAR_TRAIN_B, *VAR_TRAIN_LENGTHS, 170),
                                  vhp0)
    vhost = {k: v for k, v in vds.collater([vds[i] for i in range(VAR_TRAIN_B)]).items()
             if isinstance(v, np.ndarray) and k != "indices"}
    for remat in (False, "full"):
        task = task_of(VarianceTask, variance_hp(tmp / f"var_{remat}", recompute_grads=remat))
        batch = task.to_device(vhost)
        wall, counts, peak, values, _ = timed_train_steps(
            "train_remat", task, batch, VAR_TRAIN_PER_STEP, reset_counts, read_counts)
        rec = {"steps_per_s": TRAIN_STEPS / wall, "step_ms": 1e3 * wall / TRAIN_STEPS,
               "peak_mem_gib": peak, "launches_per_step": {k: v // TRAIN_STEPS
                                                           for k, v in counts.items()}}
        report["variance"][str(remat)] = rec
        log(f"{tag} variance model, recompute_grads={remat!r}: {rec['steps_per_s']:.3f} "
            f"steps/s ({rec['step_ms']:.1f} ms a step), peak memory {peak:.2f} GiB on {card}")
        del task, batch
        release()
    shutil.rmtree(tmp, ignore_errors=True)
    return report, per_step


DIST_RANK_ROWS, DIST_STEPS = 4, 3  # (a): rows of a rank's batch, optimizer steps
DIST_TIMEOUT = 300  # seconds for (a)'s two ranks to start, train and end
DIST_SERVE_TOL = 1e-3  # wavs and curves, one device against two replicas


def dist_variance_hp(work_dir):
    """(a)'s config: the narrow float32 variance model with the melody
    encoder, accumulation 2, batches of 4 rows, a seed."""
    return variance_hp(work_dir, **narrow_variance_overrides(variance_hp(work_dir)),
                       accumulate_grad_batches=2, max_batch_size=DIST_RANK_ROWS,
                       max_batch_frames=DIST_RANK_ROWS * 256, max_val_batch_size=2,
                       val_check_interval=100, log_interval=1, seed=46)


def dist_variance_task(hp, items, device):
    """A ``VarianceTask`` over ``items`` held in memory (its first two validate)."""
    from diffsinger_tpu_torch.training.variance_task import VarianceTask

    class Task(VarianceTask):
        def build_datasets(self):
            return (memory_variance_dataset(items, self.hp),
                    memory_variance_dataset(items[:2], self.hp))

    return Task(hp, device=device)


def stitched_steps(task, train_ds, world: int, steps: int) -> None:
    """``steps`` updates of one process on the stitched rows of ``world``
    ranks: at each batch position the batches that every rank forms
    (``BaseTask.epoch_batches``), joined in rank order, with the loop's draws
    and accumulation."""
    import numpy as np

    micro, epoch = task.global_step * task.accum, task.epoch
    while task.global_step < steps:
        parts = []
        for rank in range(world):
            task.rank, task.world_size = rank, world
            parts.append(list(task.epoch_batches(train_ds, epoch)))
        task.rank, task.world_size = 0, 1
        for local in zip(*parts):
            if task.global_step >= steps:
                break
            batch = task.to_device({k: np.concatenate([b[k] for b, _, _ in local])
                                    for k in local[0][0]})
            task.train_step(batch, **task.micro_draws(batch, micro, local[0][1], 0))
            micro += 1
            if micro % task.accum == 0:
                task.apply_update()
        epoch += 1


def train_dist_rank(rank: int, world: int, init_method: str, blob_path: str, out: str) -> None:
    """One rank of [train_dist] (a), started with ``spawn``: joins a gloo
    group through the launch contract, trains ``DIST_STEPS`` updates with
    ``BaseTask.start`` from the blob's weights, and saves its parameters,
    the checkpoints it wrote and its K3 launches."""
    import torch

    sys.path.insert(0, str(ROOT))
    os.environ.update(DS_COORDINATOR_ADDRESS=init_method, DS_NUM_PROCESSES=str(world),
                      DS_PROCESS_ID=str(rank), DS_LOCAL_RANK="0",
                      DS_DIST_TIMEOUT=str(DIST_TIMEOUT))
    from diffsinger_tpu_torch.ops import flash_attention
    from diffsinger_tpu_torch.parallel import dist
    from diffsinger_tpu_torch.utils import ckpt as ckpt_utils

    blob = torch.load(blob_path, weights_only=False)
    dev = dist.maybe_initialize_distributed(blob["device"], backend="gloo")
    saves, save = [], ckpt_utils.save_checkpoint

    def counted_save(path, *args, **kwargs):
        saves.append(Path(path).name)
        save(path, *args, **kwargs)

    ckpt_utils.save_checkpoint = counted_save
    task = quiet(dist_variance_task, blob["hp"], blob["items"], dev)
    task.module.load_state_dict(blob["state"])
    flash_attention.launches = flash_attention.bwd_launches = 0
    quiet(task.start, max_steps=DIST_STEPS)
    torch.save({"state": {k: v.detach().cpu() for k, v in task.module.state_dict().items()},
                "saves": saves, "k3": (flash_attention.launches, flash_attention.bwd_launches),
                "backend": torch.distributed.get_backend(), "device": str(dev)},
               Path(out) / f"rank{rank}.pt")
    dist.destroy()


def two_rank_variance_check(work_dir, device: str = "cuda") -> dict:
    """[train_dist] (a): two gloo ranks on one device train the narrow float32
    variance model with the melody encoder through ``BaseTask.start``
    (batches of 4 rows each, accumulation 2, so ``no_sync`` runs, 3 updates)
    from the same seeded weights; then one process on the 8 stitched rows of
    every step (``stitched_steps``). Returns the largest difference between
    the ranks' parameters, between rank 0's and the one process's, the
    largest update of the one process, the checkpoints each rank wrote and
    the files in the work folder, each rank's K3 launches, and the seconds."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.parallel import dist

    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    hp = dist_variance_hp(work / "ranks")
    items = variance_train_items(np.random.default_rng(47), 2 * DIST_RANK_ROWS, 150, 256, 30)
    one = quiet(dist_variance_task, dict(hp, work_dir=str(work / "one")), items, device)
    seeded_weights(one.module, 48)
    init = {k: v.detach().cpu().clone() for k, v in one.module.state_dict().items()}
    torch.save({"hp": hp, "items": items, "state": init, "device": device}, work / "blob.pt")
    t0 = time.perf_counter()
    dist.spawn(train_dist_rank, 2, (2, f"file://{work / 'rendezvous'}", str(work / "blob.pt"),
                                    str(work)), timeout=DIST_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    r0, r1 = (torch.load(work / f"rank{r}.pt", weights_only=False) for r in (0, 1))
    one.configure_optimizer()
    train_ds, _ = one.build_datasets()
    t0 = time.perf_counter()
    stitched_steps(one, train_ds, 2, DIST_STEPS)
    one_s = time.perf_counter() - t0
    want = {k: v.detach().cpu() for k, v in one.module.state_dict().items()}

    def largest(a, b):
        return max((a[k].float() - b[k].float()).abs().max().item() for k in want)

    update = largest(want, init)
    over = sum(int(((r0["state"][k].float() - want[k].float()).abs() > 1e-4 * update).sum())
               for k in want)
    return {"rank_err": largest(r0["state"], r1["state"]), "err": largest(r0["state"], want),
            "largest_update": update, "share_over": over / sum(v.numel() for v in want.values()),
            "saves": [r0["saves"], r1["saves"]],
            "files": sorted(p.name for p in (work / "ranks").iterdir()),
            "metrics_lines": len((work / "ranks" / "lightning_logs" / "tb" / "metrics.jsonl")
                                 .read_text().splitlines()),
            "k3": [r0["k3"], r1["k3"]], "backend": r0["backend"], "devices": [r0["device"],
                                                                             r1["device"]],
            "ranks_s": ranks_s, "one_process_s": one_s, "lr": hp["optimizer_args"]["lr"]}


def train_dist_phase(hp, card, reset_counts, read_counts):
    """[train_dist]: training over ranks and serving over replicas, on one
    card. (a) ``two_rank_variance_check``: the ranks' parameters equal each
    other exactly, and the one process's within 1e-4 of its largest update
    but for at most a 1e-4 share of the elements (none beyond 2 lr); rank 0
    alone wrote the checkpoint. (b) one NCCL rank, DDP around
    [train]'s task, batch and steps at full width: steps/s with and without
    DDP in turns (plain, DDP, DDP, plain), peak memory, and K2, K3 and K3's
    backward launches per step equal to [train]'s. (c) ``AcousticServer``
    with ``devices=[cuda:0, cuda:0]`` against the one-device server on
    [serve]'s scores: bf16 as served (enqueue seconds a chunk, true frames/s,
    in turns), float32 and bf16 wavs within ``DIST_SERVE_TOL`` (each chunk
    runs whole on a replica: they should be equal; bf16's own error against
    float32 on the same request is printed beside them); ``VarianceServer``
    likewise over [variance]'s segments.
    Returns the report and the launches of (b)'s DDP steps."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.cli import infer as cli
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.inference.serving import AcousticServer, VarianceServer
    from diffsinger_tpu_torch.parallel import dist
    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask

    report = {}
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="train_dist_"))  # weights: not under OUT_DIR
    dev = torch.device("cuda", 0)

    # ---- (a) two gloo ranks on the one card against one process
    a = two_rank_variance_check(tmp / "a")
    report["two_ranks"] = a
    bound = 1e-4 * a["largest_update"]
    log(f"[train_dist] (a) two {a['backend']} ranks on {a['devices']}, narrow float32 variance "
        f"model with the melody encoder, rows {DIST_RANK_ROWS} + {DIST_RANK_ROWS}, accumulation "
        f"2, {DIST_STEPS} updates: ranks' parameters max|diff| {a['rank_err']:.3e} (must be 0); "
        f"against one process on the {2 * DIST_RANK_ROWS} stitched rows max|diff| "
        f"{a['err']:.3e}, share of elements beyond 1e-4 of the largest update "
        f"{a['largest_update']:.3e} ({bound:.3e}) {a['share_over']:.2e} (tolerance: that share "
        f"<= 1e-4 and max|diff| <= 2 lr = {2 * a['lr']:.1e}: AdamW moves an element whose "
        f"gradient sums to near 0 by up to lr whatever its sign, and the ranks sum the rows in "
        f"another order); checkpoints written by rank 0 {a['saves'][0]}, by rank 1 "
        f"{a['saves'][1]}; K3 launches (forward, backward) by rank {a['k3']}; the ranks took "
        f"{a['ranks_s']:.1f} s with their start, the one process {a['one_process_s']:.1f} s; "
        f"on {card}")
    if not (a["rank_err"] == 0.0 and a["share_over"] <= 1e-4 and a["err"] <= 2 * a["lr"]):
        fail("[train_dist] two ranks do not update as one process on the stitched rows")
    # rank 0 alone runs the validation's forward_infer: more K3 forwards
    (fwd0, bwd0), (fwd1, bwd1) = a["k3"]
    if a["saves"] != [[f"model_ckpt_steps_{DIST_STEPS}.ckpt"], []] or not (
            bwd0 == bwd1 > 0 and fwd0 > fwd1 > 0):
        fail(f"[train_dist] rank 0 alone must write, both launch K3: {a['saves']} {a['k3']}")

    # ---- (b) one NCCL rank: DDP around [train]'s step
    os.environ.update(DS_COORDINATOR_ADDRESS=f"file://{tmp / 'rendezvous_b'}",
                      DS_NUM_PROCESSES="1", DS_PROCESS_ID="0", DS_LOCAL_RANK="0")
    try:
        dist.maybe_initialize_distributed("cuda")
        backend = torch.distributed.get_backend()
        thp = acoustic_train_hp(tmp / "b")
        task = quiet(AcousticTask, thp, device=dev)
        task.configure_optimizer()
        seeded_weights(task.module, 34)
        ds = memory_acoustic_dataset(train_items(np.random.default_rng(35), TRAIN_B,
                                                 TRAIN_T_TXT, TRAIN_T_MEL,
                                                 thp["audio_num_mel_bins"], *TRAIN_LENGTHS), thp)
        collated = ds.collater([ds[i] for i in range(TRAIN_B)])
        batch = task.to_device({k: v for k, v in collated.items()
                                if isinstance(v, np.ndarray) and k != "indices"})
        true_frames = int((batch["mel2ph"] > 0).sum().item())
        task.wrap_ddp()
        ddp, windows = task.ddp, []
        for use in (False, True, True, False):
            task.ddp = ddp if use else None
            wall, counts, peak, values, _ = timed_train_steps(
                "train_dist", task, batch, TRAIN_PER_STEP, reset_counts, read_counts)
            windows.append({"ddp": use, "steps_per_s": TRAIN_STEPS / wall, "peak_mem_gib": peak,
                            "launches_per_step": {k: n // TRAIN_STEPS for k, n in counts.items()},
                            "loss": values["total_loss"]})
            if use:  # the kernels line reports the launches of a DDP window
                ddp_counts = counts
    finally:
        dist.destroy()
        for k in ("DS_COORDINATOR_ADDRESS", "DS_NUM_PROCESSES", "DS_PROCESS_ID", "DS_LOCAL_RANK"):
            os.environ.pop(k, None)
    plain = [w["steps_per_s"] for w in windows if not w["ddp"]]
    with_ddp = [w["steps_per_s"] for w in windows if w["ddp"]]
    report["ddp_one_rank"] = {"backend": backend, "windows": windows,
                              "plain_steps_per_s": plain, "ddp_steps_per_s": with_ddp,
                              "ddp_over_plain": sum(with_ddp) / sum(plain),
                              "true_frames": true_frames}
    log(f"[train_dist] (b) one {backend} rank, DDP around [train]'s step (B={TRAIN_B} "
        f"T_mel={TRAIN_T_MEL}, {sum(p.numel() for p in task.params)} parameters, bf16 autocast): "
        f"steps/s in turns plain {plain[0]:.3f}, DDP {with_ddp[0]:.3f}, DDP {with_ddp[1]:.3f}, "
        f"plain {plain[1]:.3f} (DDP / plain {sum(with_ddp) / sum(plain):.4f}); peak memory "
        + ", ".join(f"{'DDP' if w['ddp'] else 'plain'} {w['peak_mem_gib']:.2f} GiB"
                    for w in windows)
        + f"; launches per step {windows[1]['launches_per_step']} (as [train]'s) on {card}")
    del task, ddp, batch
    torch.cuda.empty_cache()

    # ---- (c) servers over two replicas on the one card
    root = tmp / "serve"
    root.mkdir()
    exp, _, _ = write_experiment(root, hp)
    shp = cli.migrate_legacy_hparams(load_config(exp_name=exp, infer=True,
                                                 ckpt_root=root / "checkpoints"))
    segments = [seg for name in SERVE_SCORES for seg in load_score(name)]
    one_server = loaded("server", AcousticServer, shp, max_batch_size=SERVE_BATCH)
    two_server = loaded("server", AcousticServer, shp, max_batch_size=SERVE_BATCH,
                        devices=[dev, dev])
    frames = sum(quiet(one_server.preprocess_input, seg)["mel2ph"].shape[1] for seg in segments)
    servers = {"one": one_server, "two": two_server}
    wavs, seconds, stats = {}, {"one": [], "two": []}, {}
    for name in ("one", "two"):
        quiet(servers[name].synthesize_batch, segments, seed=1)  # warm-up
    for name in ("one", "two", "two", "one"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs[name] = quiet(servers[name].synthesize_batch, segments, seed=1)
        torch.cuda.synchronize()
        seconds[name].append(time.perf_counter() - t0)
        stats[name] = servers[name].last_stats
    chunk_devices = two_server.last_chunk_devices
    replica_bf16 = max(float(np.abs(x - y).max()) for x, y in zip(wavs["one"], wavs["two"]))
    f32 = dict(shp, infer_precision="float32")
    one32 = loaded("server", AcousticServer, f32, max_batch_size=SERVE_BATCH)
    two32 = loaded("server", AcousticServer, f32, max_batch_size=SERVE_BATCH, devices=[dev, dev])
    w1, w2 = (quiet(s.synthesize_batch, segments, seed=1) for s in (one32, two32))
    replica_f32 = max(float(np.abs(x - y).max()) for x, y in zip(w1, w2))
    bf16_cost = max(float(np.abs(x - y).max()) for x, y in zip(wavs["one"], w1))
    del one_server, two_server, servers, one32, two32
    torch.cuda.empty_cache()
    enqueue = {name: [st["dispatch_s"] for st in stats[name]] for name in stats}
    report["acoustic_server"] = {
        "segments": len(segments), "true_frames": frames, "seconds": seconds,
        "frames_per_s": {k: frames * len(v) / sum(v) for k, v in seconds.items()},
        "enqueue_s_per_chunk": enqueue, "chunk_devices": chunk_devices,
        "replica_bf16_max_diff": replica_bf16, "replica_f32_max_diff": replica_f32,
        "bf16_vs_f32_max_diff": bf16_cost}
    r = report["acoustic_server"]
    log(f"[train_dist] (c) AcousticServer over [cuda:0, cuda:0] against one device, "
        f"{len(segments)} segments ({frames} frames) of {' + '.join(SERVE_SCORES)}: true frames/s "
        f"one {r['frames_per_s']['one']:.1f}, two replicas {r['frames_per_s']['two']:.1f} "
        f"(seconds in turns one, two, two, one: {seconds['one'][0]:.3f}, "
        f"{seconds['two'][0]:.3f}, {seconds['two'][1]:.3f}, {seconds['one'][1]:.3f}); "
        f"enqueue a chunk (stacking and the enqueue on its replica) one "
        f"{['%.3f' % x for x in enqueue['one']]} s, two {['%.3f' % x for x in enqueue['two']]} s "
        f"on replicas {chunk_devices}; wavs max|diff| float32 {replica_f32:.3e}, bf16 as served "
        f"{replica_bf16:.3e} (tolerance {DIST_SERVE_TOL:.0e}: a chunk runs whole on a replica "
        f"that holds the runtime's parameters in their dtypes; bf16's own error against float32 "
        f"on the same request {bf16_cost:.3e}) on {card}")
    if not (replica_f32 <= DIST_SERVE_TOL and replica_bf16 <= DIST_SERVE_TOL):
        fail("[train_dist] the two-replica server's wavs differ from the one-device server's")

    vroot = tmp / "variance"
    vroot.mkdir()
    vexp, _, _ = write_variance_experiment(vroot)
    vhp = cli.migrate_legacy_hparams(load_config(exp_name=vexp, infer=True,
                                                 ckpt_root=vroot / "checkpoints"),
                                     infer_acoustic=False)
    vsegments = [seg for name in VARIANCE_SCORES for seg in load_score(name)]
    vservers = {"one": loaded("variance server", VarianceServer, vhp, max_batch_size=SERVE_BATCH),
                "two": loaded("variance server", VarianceServer, vhp, max_batch_size=SERVE_BATCH,
                              devices=[dev, dev])}
    preds, vseconds = {}, {}
    for name in ("one", "two"):
        quiet(vservers[name].predict_batch, vsegments, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds[name] = quiet(vservers[name].predict_batch, vsegments, seed=1)
        torch.cuda.synchronize()
        vseconds[name] = time.perf_counter() - t0
    dur_same = all(np.array_equal(a[0], b[0]) for a, b in zip(preds["one"], preds["two"]))
    curve_err = max(max(float(np.abs(a[1] - b[1]).max()),
                        *(float(np.abs(a[2][v] - b[2][v]).max()) for v in a[2]))
                    for a, b in zip(preds["one"], preds["two"]))
    report["variance_server"] = {"segments": len(vsegments), "seconds": vseconds,
                                 "durations_equal": dur_same, "curves_max_diff": curve_err}
    log(f"[train_dist] (c) VarianceServer over [cuda:0, cuda:0], {len(vsegments)} segments: "
        f"seconds one {vseconds['one']:.3f}, two replicas {vseconds['two']:.3f}; durations "
        f"{'equal' if dur_same else 'DIFFER'}, pitch and curves max|diff| {curve_err:.3e} "
        f"(tolerance {DIST_SERVE_TOL:.0e}, float32) on {card}")
    if not (dur_same and curve_err <= DIST_SERVE_TOL):
        fail("[train_dist] the two-replica variance server differs from the one-device server")
    del vservers
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[train_dist] the phase took {report['phase_s']:.1f} s on {card}")
    return report, ddp_counts


BIN_ITEMS = 120
BIN_SECONDS = (3.0, 12.0)
BIN_CHECK_ITEMS = 5  # items binarized on the card and on the CPU
BIN_PROFILE_ITEMS = 5
BIN_AUGMENTATION = {  # random and fixed pitch shifting exclude each other: two runs
    "random pitch shift + time stretch": ("random_pitch_shifting", "random_time_stretching"),
    "fixed pitch shift": ("fixed_pitch_shifting",),
}


def synth_corpus(root: Path, n_items: int, seed: int, lo: float, hi: float,
                 dictionary: Path) -> float:
    """A sung corpus made from a seed: ``n_items`` phrases of lo-hi seconds at
    44.1 kHz as 16-bit wavs, their transcriptions.csv (both families'
    columns) and a .ds file of the same labels each. A phrase is a breath,
    then syllables of the dictionary (taken in a seeded order, so that every
    phoneme occurs) of 0.25-0.6 s on a note each, a breath after some, and a
    silence: harmonic voice (8 partials) on the vowels with glides between
    notes and vibrato, noise on the consonants and breaths, a noise floor.
    Returns the seconds of audio."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sr, ctl = 44100, 64  # control curves every 64 samples
    syllables = [line.split("\t")[1].split()
                 for line in dictionary.read_text().splitlines() if line.strip()]
    # one syllable for each phoneme first, so that a short corpus covers them all
    first = {}
    for phones in syllables:
        for p in phones:
            first.setdefault(p, phones)
    order = list({tuple(ph): ph for ph in first.values()}.values())
    raw = root / "raw"
    (raw / "wavs").mkdir(parents=True)
    (raw / "ds").mkdir()
    rows = ["name,ph_seq,ph_dur,ph_num,note_seq,note_dur,note_glide"]
    total = 0.0
    for i in range(n_items):
        n = int(sr * rng.uniform(lo, hi))
        seconds = n / sr
        # words: (phonemes, their seconds, midi or None)
        words = [(["AP"], [rng.uniform(0.15, 0.4)], None)]
        tail = rng.uniform(0.15, 0.4)
        t, midi = words[0][1][0], int(rng.integers(57, 69))
        while t < seconds - tail - 0.3:
            if len(words) % 7 == 0 and rng.random() < 0.6:
                words.append((["AP"], [rng.uniform(0.2, 0.35)], None))
            else:
                if not order:
                    order = [syllables[j] for j in rng.permutation(len(syllables))]
                phones = order.pop(0)
                dur = min(rng.uniform(0.25, 0.6), seconds - tail - t)
                durs = ([dur * rng.uniform(0.15, 0.3)] if len(phones) > 1 else []) + [0.0]
                durs[-1] = dur - sum(durs)
                midi = int(np.clip(midi + rng.integers(-4, 5), 52, 74))
                words.append((phones, durs, midi))
            t += sum(words[-1][1])
        words.append((["SP"], [seconds - t], None))
        # control curves: midi, voiced and noise amplitude per 64 samples
        n_ctl = n // ctl + 1
        midi_c = np.zeros(n_ctl)
        voiced_c = np.zeros(n_ctl)
        noise_c = np.full(n_ctl, 0.002)
        pos = 0.0
        for phones, durs, note in words:
            for ph, d in zip(phones, durs):
                a, b = int(pos * sr / ctl), int((pos + d) * sr / ctl)
                if note is not None:
                    midi_c[a:b] = note
                    if ph == phones[-1]:
                        voiced_c[a:b] = rng.uniform(0.5, 1.0)
                    else:
                        noise_c[a:b] = rng.uniform(0.02, 0.06)
                elif ph == "AP":
                    noise_c[a:b] = rng.uniform(0.01, 0.03)
                pos += d
        sung_c = midi_c > 0  # carry the notes through breaths for a continuous f0
        idx = np.arange(n_ctl)
        midi_c = np.interp(idx, idx[sung_c], midi_c[sung_c])
        k = np.hanning(int(0.06 * sr / ctl)) + 1e-6  # 60 ms glides between notes
        midi_c = np.convolve(midi_c, k / k.sum(), mode="same")
        edge = len(k) // 2
        midi_c[:edge], midi_c[-edge:] = midi_c[edge], midi_c[-edge - 1]
        midi_c += 0.3 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * idx * ctl / sr)
        k = np.hanning(int(0.02 * sr / ctl)) + 1e-6  # 20 ms fades
        voiced_c = np.convolve(voiced_c, k / k.sum(), mode="same")
        ts = np.arange(n) / ctl
        f0 = 440.0 * 2 ** ((np.interp(ts, idx, midi_c) - 69) / 12)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        y = np.interp(ts, idx, voiced_c) * sum(
            (0.25 / h) * np.sin(h * phase + h) for h in range(1, 9))
        y += np.interp(ts, idx, noise_c) * rng.standard_normal(n)
        name = f"song{i:03d}"
        data = np.clip(y * 32767, -32768, 32767).astype(np.int16)
        with wave.open(str(raw / "wavs" / f"{name}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sr)
            f.writeframes(data.tobytes())
        labels = {
            "ph_seq": " ".join(p for w in words for p in w[0]),
            "ph_dur": " ".join(f"{d:.6f}" for w in words for d in w[1]),
            "ph_num": " ".join(str(len(w[0])) for w in words),
            "note_seq": " ".join("rest" if w[2] is None else
                                 ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#",
                                  "B"][w[2] % 12] + str(w[2] // 12 - 1) for w in words),
            "note_dur": " ".join(f"{sum(w[1]):.6f}" for w in words),
            "note_glide": " ".join("none" for _ in words),
        }
        rows.append(",".join([name, *labels.values()]))
        (raw / "ds" / f"{name}.ds").write_text(json.dumps([dict(offset=0.0, **labels)]))
        total += seconds
    (raw / "transcriptions.csv").write_text("\n".join(rows) + "\n")
    return total


def binarize_hp(family: str, raw: Path, out: Path, augmentation=()) -> dict:
    """The shipped config of a family (``vr`` harmonic split without a
    checkpoint, so ``comb``) over the synthetic corpus: the acoustic one
    with every embed on and the named augmentations at the config's ranges
    and scales, the variance one with the four curves and its labels read
    from the .ds files."""
    from diffsinger_tpu_torch.config import load_config

    hp = load_config(ROOT / "configs" / f"{family}.yaml")
    hp.update(binary_data_dir=str(out), work_dir="",
              dictionary=str(ROOT / "dictionaries" / "opencpop-extension.txt"),
              datasets=[{"raw_data_dir": str(raw), "speaker": "synth", "language": "zh",
                         "test_prefixes": ["song000", "song001"]}])
    if family == "acoustic":
        hp.update({f"use_{v}_embed": True for v in (*VARIANCES, "key_shift", "speed")})
        hp.update(use_spk_id=True, num_spk=3)
        hp["augmentation_args"] = {k: dict(v, enabled=k in augmentation)
                                   for k, v in hp["augmentation_args"].items()}
    else:
        hp.update({f"predict_{v}": True for v in VARIANCES})
        hp["binarization_args"] = dict(hp["binarization_args"], prefer_ds=True)
    return hp


# Breathiness is the energy of the aperiodic part, the waveform less the
# comb's harmonic part: a residual 40-60 dB under the voice. An f0 one float32
# step away (the card's FFTs against the CPU's) moves a bin at the comb's edge
# (3.5 bins from a harmonic, still on the Nuttall window's main lobe) in or
# out, and the residual's energy by up to about 0.02 dB (a one-step jitter of
# f0 on the CPU moves it by up to 0.0096 dB on this corpus). The card is held
# to 0.05 dB there; every other curve to 1e-4.
BREATHINESS_CARD_TOL = 0.05


def binarized_item_errors(got: dict, want: dict, breathiness_tol: float = 1e-4,
                          curve_tol: dict | None = None) -> tuple:
    """Two binarizations of one item, attribute by attribute: tokens, frame
    maps, lengths, ids, key shift and speed exact; the mel within mean |diff|
    2e-4 and max 5e-3; uv exact and f0 within 1e-3 relative (pitch within
    12 log2(1.001) semitones) on 99.5 % of frames; curves (dB, semitones,
    tension's logit) within 1e-4, breathiness within ``breathiness_tol``,
    any curve named in ``curve_tol`` within its value there.
    Returns (worst error by attribute, list of failures)."""
    curve_tol = dict({"breathiness": breathiness_tol}, **(curve_tol or {}))
    import numpy as np

    exact = {"tokens", "languages", "mel2ph", "spk_id", "key_shift", "speed", "ph_dur", "midi",
             "ph2word", "note_midi", "note_rest", "note_dur", "note_glide", "mel2note", "uv",
             "length", "seconds", "name", "wav_fn", "spk_name", "ph_text"}
    curves = {"energy", "breathiness", "voicing", "tension", "base_pitch"}
    worst, failures = {}, []
    if set(got) != set(want):
        return worst, [f"attributes {sorted(set(got) ^ set(want))} differ"]
    for k, w in want.items():
        g = got[k]
        if np.shape(g) != np.shape(w) or np.asarray(g).dtype != np.asarray(w).dtype:
            failures.append(f"{k}: {np.shape(g)} {np.asarray(g).dtype} against "
                            f"{np.shape(w)} {np.asarray(w).dtype}")
            continue
        if k in exact:
            ok = np.array_equal(g, w)
            worst[k] = 0.0 if ok else float("inf")
        elif k == "mel":
            diff = np.abs(g - w)
            worst[k] = float(diff.max())
            ok = diff.mean() <= 2e-4 and diff.max() <= 5e-3
        elif k in ("f0", "pitch"):
            close = (np.isclose(g, w, rtol=1e-3, atol=0) if k == "f0"
                     else np.abs(g - w) <= 12 * np.log2(1.001))
            worst[k] = float(1 - close.mean())  # the share of frames off
            ok = close.mean() >= 0.995
        elif k in curves:
            worst[k] = float(np.abs(g - w).max())
            ok = worst[k] <= curve_tol.get(k, 1e-4)
        else:
            ok = False
            failures.append(f"{k}: no tolerance")
        if not ok:
            failures.append(f"{k}: off by {worst.get(k)}")
    return worst, failures


def binarize_card_vs_cpu(raw: Path, work: Path, n_items: int) -> dict:
    """The first ``n_items`` of the corpus through both binarizers' items on
    the card and on the CPU (float32), with a pitch-shifted and time-stretched
    copy of each acoustic item (key shift 3, speed 1.2), compared by
    ``binarized_item_errors`` (breathiness within ``BREATHINESS_CARD_TOL``).
    Returns the worst error by attribute and the failures."""
    from diffsinger_tpu_torch.cli.binarize import binarizer_class
    from diffsinger_tpu_torch.data.augmentation import SpectrogramStretchAugmentation

    worst, failures = {}, []
    for family in ("acoustic", "variance"):
        hp = binarize_hp(family, raw, work / f"check_{family}")
        outs = []
        for device in ("cuda", "cpu"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                b = quiet(binarizer_class(hp["binarizer_cls"]), hp, device=device)
                meta = b.load_meta_data(raw, 0, "synth", "zh")
                items = []
                for name in sorted(meta)[:n_items]:
                    item = b.process_item(name, meta[name], b.binarization_args)
                    items.append(item)
                    if family == "acoustic":
                        aug = SpectrogramStretchAugmentation(b, {})
                        items.append(aug.process_item(item, key_shift=3.0, speed=1.2))
            outs.append(items)
        for i, (g, w) in enumerate(zip(*outs)):
            errs, fails = binarized_item_errors(g, w, BREATHINESS_CARD_TOL)
            for k, e in errs.items():
                worst[f"{family}.{k}"] = max(worst.get(f"{family}.{k}", 0.0), e)
            failures += [f"{family} item {i}: {f}" for f in fails]
    return {"worst": worst, "failures": failures}


def store_mb(out: Path) -> float:
    """The MB of a binarized folder's item stores (``*.data``) on disk."""
    return sum(f.stat().st_size for f in out.glob("*.data")) / 1e6


def narrow_store_steps(tag: str, stores: dict, tmp: Path, n_batch: int = 8) -> dict:
    """Each store ({name: (folder, hp)}) read back from disk through its
    family's dataset and collater into one optimizer step of a narrow task
    on the card; fails on a store whose item count is not its .meta's or on
    a loss that is not finite. Returns the steps' losses by store."""
    import pickle

    import numpy as np
    import torch

    from diffsinger_tpu_torch.data.dataset import AcousticDataset, VarianceDataset
    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask
    from diffsinger_tpu_torch.training.variance_task import VarianceTask

    steps = {}
    for name, (out, hp) in stores.items():
        if hp["binarizer_cls"].endswith("AcousticBinarizer"):
            cls, task_cls, narrow = AcousticDataset, AcousticTask, dict(
                hidden_size=64, enc_layers=2, backbone_args=dict(
                    num_channels=128, num_layers=2, kernel_size=31, dropout_rate=0.0,
                    strong_cond=True), val_with_vocoder=False)
        else:
            cls, task_cls, narrow = VarianceDataset, VarianceTask, dict(
                hidden_size=64, enc_layers=2,
                dur_prediction_args=dict(hp["dur_prediction_args"], hidden_size=64, num_layers=2),
                pitch_prediction_args=dict(hp["pitch_prediction_args"], backbone_args=dict(
                    num_layers=4, num_channels=64, dilation_cycle_length=2)),
                variances_prediction_args=dict(hp["variances_prediction_args"], backbone_args=dict(
                    num_layers=2, num_channels=64, dilation_cycle_length=2)))
        hp = dict(hp, **narrow, work_dir=str(tmp / f"task_{name}".replace(" ", "_")))
        ds = cls(out, hp, "train")
        with open(out / "train.meta", "rb") as f:
            n_meta = len(pickle.load(f)["lengths"])
        n = min(n_batch, len(ds))
        collated = ds.collater([ds[i] for i in range(n)])
        torch.manual_seed(80)
        task = quiet(task_cls, hp)
        task.configure_optimizer()
        batch = task.to_device({k: v for k, v in collated.items()
                                if isinstance(v, np.ndarray) and k != "indices"})
        losses = task.train_step(batch)
        norm = task.apply_update()
        losses = {k: float(v) for k, v in losses.items()}
        steps[name] = {"items": len(ds), "meta_items": n_meta, "losses": losses,
                       "grad_norm": float(norm)}
        log(f"{tag} {name} store ({store_mb(out):.1f} MB on disk): {len(ds)} items read back, "
            f"a batch of {n} ({', '.join(f'{k} {list(v.shape)}' for k, v in batch.items())}), one "
            f"step of a narrow {task_cls.__name__}: " + " ".join(
                f"{k}={v:.4f}" for k, v in losses.items()))
        if len(ds) != n_meta or not all(math.isfinite(v) for v in losses.values()):
            fail(f"{tag} the {name} store did not train: {steps[name]}")
        del task, batch
    return steps


def binarize_phase(card, reset_counts, read_counts):
    """[binarize]: both families' binarization on the card through
    ``cli.binarize.binarize`` (what ``python -m diffsinger_tpu_torch.cli.binarize``
    runs) over a synthetic corpus of ``BIN_ITEMS`` sung phrases of 3-12 s:
    configs/acoustic.yaml with every embed on, without augmentation, then
    with random pitch shifting and time stretching, then with fixed pitch
    shifting (the two pitch shifts exclude each other); configs/variance.yaml
    with the four curves. Each run: seconds of binarization per second of
    audio, items/s, the stages' split, peak memory, launch counters from 0
    (K1, K2, K3 and K3-bwd must stay at 0). Then five items of each family
    under the profiler (idle share, launches an item), the path finder on the
    host against a loop of torch operations on the card, five items of each
    family on the card against the CPU (``binarize_card_vs_cpu``), and the
    card's stores read back through the datasets and collaters into one
    optimizer step of a narrow acoustic and variance task (finite losses).
    The stores are HDF5 files written and read by the port's own codec.
    Returns the report and the launch counts."""
    import random

    import numpy as np
    import torch

    from diffsinger_tpu_torch.cli.binarize import binarize, binarizer_class
    from diffsinger_tpu_torch.dsp import pe
    from diffsinger_tpu_torch.ops import flash_attention

    report = {}
    tmp = Path(tempfile.mkdtemp(prefix="binarize_", dir=OUT_DIR))
    t0 = time.perf_counter()
    audio_s = synth_corpus(tmp, BIN_ITEMS, 60, *BIN_SECONDS,
                           ROOT / "dictionaries" / "opencpop-extension.txt")
    raw = tmp / "raw"
    log(f"[binarize] corpus: {BIN_ITEMS} phrases, {audio_s:.1f} s of audio at 44.1 kHz, made in "
        f"{time.perf_counter() - t0:.1f} s")
    report["corpus_audio_s"] = audio_s

    runs = [("acoustic", "no augmentation", ())]
    runs += [("acoustic", what, names) for what, names in BIN_AUGMENTATION.items()]
    runs += [("variance", "no augmentation (the family has none)", ())]
    stores = {}
    counts = {"K1": 0, "K2": 0, "K3": 0, "K3bwd": 0}
    report["runs"] = []
    for i, (family, what, aug) in enumerate(runs):
        out = tmp / f"{family}_{i}"
        hp = binarize_hp(family, raw, out, aug)
        random.seed(70 + i)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by the earlier phases
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # vr without a checkpoint: comb
            b = quiet(binarize, hp)
        wall = time.perf_counter() - t0
        run_counts = dict(read_counts(), K3bwd=flash_attention.bwd_launches)
        counts = {k: counts[k] + v for k, v in run_counts.items()}
        stores[family] = (out, hp)
        mb = store_mb(out)
        audio = sum(t["seconds"] for t in b.totals.values())
        items = sum(t["items"] for t in b.totals.values())
        split = dict(b.timer.seconds, **{f"pitch {k}": v for k, v in b.pe.seconds.items()})
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        rec = {"family": family, "augmentation": what, "items": items, "audio_s": audio,
               "wall_s": wall, "s_per_audio_s": wall / audio, "items_per_s": items / wall,
               "split_s": split, "peak_mem_gib": peak, "launches": run_counts, "store_mb": mb,
               "write_s": b.timer.seconds["write"]}
        report["runs"].append(rec)
        log(f"[binarize] {family}, {what}: {items} items ({audio:.1f} s of audio) in {wall:.2f} "
            f"s: {wall / audio:.5f} s of binarization a second of audio, {items / wall:.2f} "
            f"items/s, peak memory {peak:.3f} GiB above what the earlier phases hold, store "
            f"{mb:.1f} MB on disk written in {b.timer.seconds['write']:.3f} s, on {card}")
        log(f"[binarize]   split: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
            + f"; unaccounted {wall - sum(b.timer.seconds.values()):.3f} s; launches {run_counts}")
        if any(run_counts.values()):
            fail(f"[binarize] the binarization launched a model kernel: {run_counts}")

    # cuFFT makes a plan for each new (length, batch) of an FFT and keeps it:
    # the mel of one item at a key shift no run used (FFT length 2092), twice
    from diffsinger_tpu_torch.dsp.common import as_signal
    from diffsinger_tpu_torch.dsp.mel import MelSpectrogram
    from diffsinger_tpu_torch.utils.infer_utils import load_wav

    first_wav = as_signal(load_wav(raw / "wavs" / "song000.wav")[0], "cuda")
    plan_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MelSpectrogram().bucketed(first_wav, keyshift=0.37)
        plan_s.append(time.perf_counter() - t0)
    report["mel_new_fft_length"] = {"first_s": plan_s[0], "again_s": plan_s[1],
                                    "plans_cached": torch.backends.cuda.cufft_plan_cache[0].size}
    log(f"[binarize] one mel at a new FFT length (key shift 0.37, {len(first_wav) / 44100:.2f} s): "
        f"first call {plan_s[0] * 1e3:.2f} ms, again {plan_s[1] * 1e3:.2f} ms; cuFFT plans cached "
        f"after the runs: {torch.backends.cuda.cufft_plan_cache[0].size}")

    # five items of each family under the profiler
    for family in ("acoustic", "variance"):
        out, hp = stores[family]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            b = quiet(binarizer_class(hp["binarizer_cls"]), hp)
            meta = b.load_meta_data(raw, 0, "synth", "zh")
            names = sorted(meta)[2:2 + BIN_PROFILE_ITEMS]
            b.process_item(names[0], meta[names[0]], b.binarization_args)  # warm-up
            prof = profile_request(
                lambda: [b.process_item(n, meta[n], b.binarization_args) for n in names],
                f"{BIN_PROFILE_ITEMS} {family} items", table=f"chip_smoke_binarize_{family}.txt")
        if prof.get("measured"):
            prof["launches_per_item"] = prof["kernel_launches"] / BIN_PROFILE_ITEMS
            log(f"[binarize] {family}: {prof['launches_per_item']:.0f} kernel launches an item, "
                f"idle share {prof['idle_share']:.3f}; top device operations: " + "; ".join(
                    f"{k[:50]} {ms:.2f} ms" for k, ms in list(prof["top_kernels_ms"].items())[:5]))
        report[f"profile_{family}"] = prof

    # the path finder: on the host over arrays fetched once (the design) against
    # a loop of torch operations on the card, on the longest item's trellis
    longest = max(raw.glob("wavs/*.wav"), key=lambda p: p.stat().st_size)
    y, _ = load_wav(longest)
    # AcfPE.get_pitch's window, padding and lags for the configs' hop and 65-1100 Hz
    hop, win, lag_min, lag_max = 512, 2048, 40, 679
    yp = torch.nn.functional.pad(torch.from_numpy(y).cuda(), (win // 2, win // 2 + hop))
    strength, f0c, voiced = pe.acf_candidates(yp, 44100.0, win_size=win, hop=hop,
                                              lag_min=lag_min, lag_max=lag_max)
    cost = pe.transition_costs(f0c, voiced, hop=hop, sr=44100.0)
    torch.cuda.synchronize()

    def host_path():
        return pe.viterbi_path(strength.cpu().numpy(), cost.cpu().numpy())

    def device_path():
        n_frames, n_states = strength.shape
        cols = torch.arange(n_states, device=strength.device)
        delta, back = strength[0], []
        for t in range(1, n_frames):
            total = delta[:, None] - cost[t - 1]
            best = total.argmax(dim=0)
            back.append(best)
            delta = strength[t] + total[best, cols]
        back = torch.stack(back).cpu().numpy()
        path = np.empty(n_frames, np.int64)
        path[-1] = int(delta.argmax())
        for t in range(n_frames - 2, -1, -1):
            path[t] = back[t, path[t + 1]]
        return path

    timed = {}
    for name, fn in (("host", host_path), ("device", device_path), ("host", host_path),
                     ("device", device_path)):
        t0 = time.perf_counter()
        path = fn()
        timed.setdefault(name, []).append(time.perf_counter() - t0)
        timed[name + "_path"] = path
    same = float((timed["host_path"] == timed["device_path"]).mean())
    report["path_finder"] = {"frames": int(strength.shape[0]), "host_s": min(timed["host"]),
                             "device_loop_s": min(timed["device"]), "paths_agree": same}
    log(f"[binarize] path finder over {strength.shape[0]} frames ({len(y) / 44100:.2f} s): host "
        f"{min(timed['host']) * 1e3:.2f} ms (the design: one fetch, a numpy loop), a loop of "
        f"torch operations on the card {min(timed['device']) * 1e3:.2f} ms; paths agree on "
        f"{same:.4f} of frames")

    # five items of each family on the card against the CPU
    t0 = time.perf_counter()
    check = binarize_card_vs_cpu(raw, tmp, BIN_CHECK_ITEMS)
    report["card_vs_cpu"] = check
    log(f"[binarize] {BIN_CHECK_ITEMS} items of each family (and a shifted, stretched copy of each "
        f"acoustic one) on the card against the CPU in {time.perf_counter() - t0:.1f} s: every "
        f"exact attribute equal; worst " + ", ".join(
            f"{k} {v:.3g}" for k, v in check["worst"].items()
            if k.split(".")[1] in ("mel", "f0", "pitch", *VARIANCES, "base_pitch"))
        + " (mel, curves: max |diff|; f0, pitch: share of frames off)")
    if check["failures"]:
        fail("[binarize] the card's features disagree with the CPU's: "
             + "; ".join(check["failures"][:10]))

    # the card's stores through the datasets and collaters into one narrow step each
    report["train_steps"] = narrow_store_steps("[binarize]", stores, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return report, counts


EXT_ITEMS = BIN_ITEMS  # rmvpe + vr: [binarize]'s whole corpus (same seed)
EXT_WORLD_ITEMS = 4  # harvest + world: its first phrases (Harvest is float64 numpy on the host)
EXT_CHECK_ITEMS = 3  # items of each run binarized on the card and on the CPU
EXT_RUNS = (  # (family, pe, hnsep)
    ("acoustic", "rmvpe", "vr"),
    ("variance", "rmvpe", "vr"),
    ("variance", "harvest", "world"),
)
# Card against CPU in [binarize_ext]: exact attributes equal, the mel, f0 and
# pitch as in [binarize]; the curves that come from a harmonic split within
# 0.05 (dB; tension's logit), [binarize]'s bound for the comb's breathiness.
# The split's float32 rounding differs between cuDNN/cuFFT and the CPU's
# kernels: the vocal remover's mask moves the harmonic part, the WORLD twin's
# D4C rounds the group delay of a clean harmonic spectrum differently on each
# (the port's and the JAX twin differ by up to 1e-2 in aperiodicity on tones,
# tests/test_torch_world.py), and tension's kth-harmonic mask keeps or drops
# a bin at its edge. Measured on an H100 (PERF.md), the twin carrying
# float32: breathiness 0.0040, voicing 1.1e-4, tension 0.038.
EXT_CARD_TOL = {"breathiness": 0.05, "voicing": 0.05, "tension": 0.05}


def ext_checkpoints(folder: Path) -> dict:
    """Seeded checkpoints of RMVPE and the vocal remover at their published
    widths in the reference's formats: ``E2E0(4, 1, (2, 2))`` (5 levels, 4
    intermediate layers, 16 channels, BiGRU 256) as ``{"model": state dict}``;
    CascadedNet at its class defaults (nout 32, nout_lstm 128, complex,
    stereo) with a ``config.yaml`` of n_fft 2048 and hop_length 512 (the
    published config is not in the repository). BatchNorm statistics moved
    off their defaults. Returns the two paths and the parameter counts."""
    import torch
    import yaml

    from diffsinger_tpu_torch.models.hnsep import CascadedNet
    from diffsinger_tpu_torch.models.rmvpe import E2E0

    torch.manual_seed(90)
    nets = {"rmvpe": E2E0(4, 1, (2, 2)),
            "vr": CascadedNet(2048, 512, nout=32, nout_lstm=128, is_complex=True, is_mono=False)}
    with torch.no_grad():
        for net in nets.values():
            for m in net.modules():
                if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                    m.running_mean.normal_(0, 0.3)
                    m.running_var.uniform_(0.5, 2.0)
    for name in nets:
        (folder / name).mkdir(parents=True, exist_ok=True)
    torch.save({"model": nets["rmvpe"].state_dict()}, folder / "rmvpe" / "model.pt")
    torch.save(nets["vr"].state_dict(), folder / "vr" / "model.pt")
    (folder / "vr" / "config.yaml").write_text(yaml.safe_dump(
        {"n_fft": 2048, "hop_length": 512, "n_out": 32, "n_out_lstm": 128, "is_mono": False}))
    return {"pe_ckpt": str(folder / "rmvpe" / "model.pt"),
            "hnsep_ckpt": str(folder / "vr" / "model.pt"),
            "parameters": {k: sum(p.numel() for p in v.parameters()) for k, v in nets.items()}}


def binarize_ext_hp(family: str, pe: str, hnsep: str, raw: Path, out: Path, ckpts: dict) -> dict:
    """``binarize_hp``'s config (no augmentation) with the named extractors."""
    hp = binarize_hp(family, raw, out)
    hp.update(pe=pe, hnsep=hnsep, pe_ckpt=ckpts["pe_ckpt"], hnsep_ckpt=ckpts["hnsep_ckpt"])
    return hp


def binarize_ext_card_vs_cpu(raw: Path, work: Path, ckpts: dict, n_items: int) -> dict:
    """The first ``n_items`` of the corpus through each [binarize_ext] run's
    binarizer on the card and on the CPU (float32; WORLD on the twin on both,
    DS_WORLD_BACKEND=device, with the same noise), compared by
    ``binarized_item_errors`` within ``EXT_CARD_TOL``. Returns the worst
    error by attribute and the failures."""
    from unittest import mock

    from diffsinger_tpu_torch.cli.binarize import binarizer_class

    worst, failures = {}, []
    with mock.patch.dict(os.environ, {"DS_WORLD_BACKEND": "device"}):
        for family, pe, hnsep in EXT_RUNS:
            run = f"{family} {pe}+{hnsep}"
            hp = binarize_ext_hp(family, pe, hnsep, raw, work / "check", ckpts)
            outs = []
            for device in ("cuda", "cpu"):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    b = quiet(binarizer_class(hp["binarizer_cls"]), hp, device=device)
                    meta = b.load_meta_data(raw, 0, "synth", "zh")
                    outs.append([b.process_item(n, meta[n], b.binarization_args)
                                 for n in sorted(meta)[:n_items]])
            for i, (g, w) in enumerate(zip(*outs)):
                errs, fails = binarized_item_errors(g, w, curve_tol=EXT_CARD_TOL)
                for k, e in errs.items():
                    worst[f"{run}.{k}"] = max(worst.get(f"{run}.{k}", 0.0), e)
                failures += [f"{run} item {i}: {f}" for f in fails]
    return {"worst": worst, "failures": failures}


def world_twin_checks(dev) -> dict:
    """tests/test_world_device.py's bounds with the port's twin on ``dev``
    against the float64 goldens: on a WORLD-synthesized fixture (f0 220 Hz
    after 6 unvoiced frames, a speech-like envelope, aperiodicity 0.3 under
    4 kHz and 0.8 above) the twin's D4C keeps the golden's voicing on 97 % of
    frames with a voiced-frame MAE <= 0.05 and recovers the two bands within
    0.25; its synthesis with ap 0 within 2e-3 of the golden's peak, with the
    constructed ap within 1.5 dB in every third-octave band; the split of the
    vowel fixture correlates >= 0.98 with the golden's harmonic part, its
    aperiodic energy within 2 dB; pure noise leaves at most 10 % of its
    energy harmonic, a clean tone at most 15 % aperiodic. Returns the values
    and the failures."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.dsp import golden_signals as gs
    from diffsinger_tpu_torch.dsp.d4c import d4c
    from diffsinger_tpu_torch.dsp.world import synthesize_world, world_harmonic_aperiodic
    from diffsinger_tpu_torch.dsp.world_device import d4c_device, synthesize_world_device

    fs, hop, fft = gs.FS, 512, 2048
    freqs = np.arange(fft // 2 + 1) * fs / fft
    env = np.tile(10 ** ((-10.0 - 20 * np.log10(1 + (freqs / 1200.0) ** 2)) / 10.0), (128, 1))
    ap_true = np.tile(np.where(freqs < 4000.0, 0.3, 0.8), (128, 1))
    f0 = np.full(128, 220.0)
    f0[:6] = 0.0
    y = synthesize_world(f0, env, ap_true, fs, hop, seed=3)
    out, failures = {}, []

    def bound(name, value, ok):
        out[name] = float(value)
        if not ok:
            failures.append(f"{name} {value:.4g}")

    ap_host = d4c(y, f0, np.arange(128) * (hop / fs), fs, fft)
    ap_dev = d4c_device(torch.from_numpy(y.astype(np.float32)).to(dev),
                        torch.from_numpy(f0.astype(np.float32)).to(dev),
                        fs=fs, fft_size=fft, hop=hop).cpu().numpy()
    host_uv, dev_uv = ap_host[:, 0] > 0.99, ap_dev[:, 0] > 0.99
    same = (host_uv == dev_uv).mean()
    bound("d4c_voicing_agreement", same, same >= 0.97)
    mae = np.abs(ap_dev - ap_host)[~host_uv & ~dev_uv].mean()
    bound("d4c_voiced_mae", mae, mae <= 0.05)
    mid = ap_dev[20:-20]
    at = {hz: float(mid[:, int(round(hz * fft / fs))].mean()) for hz in (3000, 9000)}
    bound("d4c_3k_minus_0.3", at[3000] - 0.3, abs(at[3000] - 0.3) <= 0.25)
    bound("d4c_9k_minus_0.8", at[9000] - 0.8, abs(at[9000] - 0.8) <= 0.25 and at[9000] > at[3000])

    f0_v = np.where(f0 > 0, f0, 220.0)
    y_host = synthesize_world(f0_v, env, np.zeros_like(env), fs, hop, seed=0)
    y_dev = synthesize_world_device(f0_v, env, np.zeros_like(env), fs, hop, device=dev)
    err = np.abs(y_dev.cpu().numpy() - y_host).max() / np.abs(y_host).max()
    bound("synthesis_ap0_rel_err", err, err <= 2e-3)
    y_host = synthesize_world(f0, env, ap_true, fs, hop, seed=0)[10 * hop:120 * hop]
    y_dev = synthesize_world_device(f0, env, ap_true, fs, hop, device=dev).cpu().numpy()
    ph, pd = (np.abs(np.fft.rfft(v)) ** 2 for v in (y_host, y_dev[10 * hop:120 * hop]))
    band_hz = np.fft.rfftfreq(len(y_host), 1 / fs)
    edges = np.geomspace(100, 16000, 16)
    worst_db = max(abs(10 * np.log10(pd[(band_hz >= lo) & (band_hz < hi)].sum()
                                     / ph[(band_hz >= lo) & (band_hz < hi)].sum()))
                   for lo, hi in zip(edges[:-1], edges[1:]))
    bound("synthesis_band_db", worst_db, worst_db <= 1.5)

    bank = gs.signal_bank()
    wave, f0_true = bank["vowel_pulse"]
    f0_b = np.full(int(np.ceil((len(wave) + 1) / hop)), f0_true, np.float32)
    h_host, a_host = (v.numpy() for v in world_harmonic_aperiodic(
        wave, f0_b, fs=fs, fft_size=fft, hop=hop, backend="host", device="cpu"))
    h_dev, a_dev = (v.cpu().numpy() for v in world_harmonic_aperiodic(
        wave, f0_b, fs=fs, fft_size=fft, hop=hop, backend="device", device=dev))
    corr = np.dot(h_dev, h_host) / (np.linalg.norm(h_dev) * np.linalg.norm(h_host) + 1e-12)
    bound("split_harmonic_correlation", corr, corr >= 0.98)
    ratio_db = 10 * np.log10((np.mean(a_dev ** 2) + 1e-12) / (np.mean(a_host ** 2) + 1e-12))
    bound("split_aperiodic_db", ratio_db, abs(ratio_db) <= 2.0)
    for name, limit in (("noise", 0.1), ("steady_mid", 0.15)):
        wave, f0_true = bank[name]
        f0_b = np.full(int(np.ceil((len(wave) + 1) / hop)), f0_true, np.float32)
        h, a = world_harmonic_aperiodic(wave, f0_b, fs=fs, fft_size=fft, hop=hop,
                                        backend="device", device=dev)
        eh, ea = float((h ** 2).mean()), float((a ** 2).mean())
        share = eh / (eh + ea) if name == "noise" else ea / (eh + ea)
        bound(f"split_{name}_leak_share", share, share <= limit)
    return {"values": out, "failures": failures}


def binarize_ext_phase(card, reset_counts, read_counts):
    """[binarize_ext]: the extractors that voicebank makers configure, on the
    card through ``cli.binarize.binarize``, with seeded checkpoints of both
    networks at their published widths (``ext_checkpoints``), over
    [binarize]'s corpus (same seed): (a) acoustic with RMVPE and the vocal
    remover over ``EXT_ITEMS`` phrases, twice (the first pass meets each
    length bucket of the vocal remover, 32 frames of its hop, for the first
    time and pays cuDNN's benchmark there; the second runs warm), (b)
    variance with the same over the same phrases, (c) variance with Harvest
    and WORLD on the card twin over the first ``EXT_WORLD_ITEMS``. Each run:
    seconds of binarization a second of audio, items/s, the stage split,
    peak memory, launch counters from 0 (all must stay 0), one item under
    the profiler (idle share, launches). Then the one-time cost a length
    bucket (the two passes' difference over the buckets met, and the vocal
    remover at a bucket no phrase met: first call, again), RMVPE alone on
    the longest phrase (frontend, U-Net, GRU and head, decoding), the vocal
    remover alone, the WORLD twin against the float64 golden on one phrase
    (seconds, the bounds, two runs of the twin), ``world_twin_checks``,
    ``EXT_CHECK_ITEMS`` items of each run on the card against the CPU
    (``binarize_ext_card_vs_cpu``) and one narrow training step from each
    store. Returns the report and the launch counts."""
    import random

    import numpy as np
    import torch

    from diffsinger_tpu_torch.cli.binarize import binarize
    from diffsinger_tpu_torch.dsp.common import as_signal
    from diffsinger_tpu_torch.dsp.pe import HarvestPE
    from diffsinger_tpu_torch.dsp.resample import resample
    from diffsinger_tpu_torch.dsp.world import world_harmonic_aperiodic
    from diffsinger_tpu_torch.models import rmvpe as rmvpe_mod
    from diffsinger_tpu_torch.models.hnsep import predict_harmonic
    from diffsinger_tpu_torch.ops import flash_attention
    from diffsinger_tpu_torch.utils import no_tf32
    from diffsinger_tpu_torch.utils.infer_utils import load_wav

    tag = "[binarize_ext]"
    report = {}
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    peaks = []  # the allocator's peak at the end of each run (runs reset it)
    tmp = Path(tempfile.mkdtemp(prefix="binarize_ext_", dir=OUT_DIR))
    t0 = time.perf_counter()
    dictionary = ROOT / "dictionaries" / "opencpop-extension.txt"
    audio_s = synth_corpus(tmp / "all", EXT_ITEMS, 60, *BIN_SECONDS, dictionary)
    world_s = synth_corpus(tmp / "first", min(EXT_WORLD_ITEMS, EXT_ITEMS), 60, *BIN_SECONDS,
                           dictionary)
    raw, raw_w = tmp / "all" / "raw", tmp / "first" / "raw"
    ckpts = ext_checkpoints(tmp / "ckpt")
    log(f"{tag} corpus: [binarize]'s {EXT_ITEMS} phrases ({audio_s:.1f} s of audio) and its first "
        f"{EXT_WORLD_ITEMS} ({world_s:.1f} s); seeded checkpoints: RMVPE "
        f"{ckpts['parameters']['rmvpe']:,} parameters, CascadedNet {ckpts['parameters']['vr']:,}; "
        f"made in {time.perf_counter() - t0:.1f} s")
    report["corpus_audio_s"] = {"rmvpe_vr": audio_s, "harvest_world": world_s}
    report["parameters"] = ckpts["parameters"]
    # the vocal remover's length buckets: 32 k - 1 frames of its hop (models/hnsep.py)
    vr_hop = 512
    lengths = {}
    for wav_fn in raw.glob("wavs/*.wav"):
        with wave.open(str(wav_fn)) as f:
            lengths[wav_fn.stem] = f.getnframes()
    buckets = sorted({(n // vr_hop + 1) // 32 for n in lengths.values()})
    stores, counts, report["runs"] = {}, {"K1": 0, "K2": 0, "K3": 0, "K3bwd": 0}, []
    shortest = min(raw_w.glob("wavs/*.wav"), key=lambda p: p.stat().st_size).stem
    runs = [(*EXT_RUNS[0], raw, "first pass"), (*EXT_RUNS[0], raw, "again"),
            (*EXT_RUNS[1], raw, ""), (*EXT_RUNS[2], raw_w, "")]
    for i, (family, pe, hnsep, corpus, what) in enumerate(runs):
        run = f"{family} {pe}+{hnsep}" + (f", {what}" if what else "")
        out = tmp / f"run{i}"
        hp = binarize_ext_hp(family, pe, hnsep, corpus, out, ckpts)
        random.seed(90 + i)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        b = quiet(binarize, hp)
        wall = time.perf_counter() - t0
        run_counts = dict(read_counts(), K3bwd=flash_attention.bwd_launches)
        counts = {k: counts[k] + v for k, v in run_counts.items()}
        stores[run] = (out, hp)
        audio = sum(t["seconds"] for t in b.totals.values())
        items = sum(t["items"] for t in b.totals.values())
        split = dict(b.timer.seconds, **{f"pitch {k}": v
                                         for k, v in getattr(b.pe, "seconds", {}).items()})
        peaks.append(torch.cuda.max_memory_allocated())
        peak = (peaks[-1] - held) / 2**30
        provenance = b.feature_provenance()
        rec = {"run": run, "items": items, "audio_s": audio, "wall_s": wall,
               "s_per_audio_s": wall / audio, "items_per_s": items / wall, "split_s": split,
               "peak_mem_gib": peak, "launches": run_counts, "provenance": provenance,
               "store_mb": store_mb(out), "write_s": b.timer.seconds["write"]}
        log(f"{tag} {run}: {items} items ({audio:.1f} s of audio) in {wall:.2f} s: "
            f"{wall / audio:.5f} s of binarization a second of audio, {items / wall:.2f} items/s, "
            f"peak memory {peak:.3f} GiB, store {rec['store_mb']:.1f} MB on disk written in "
            f"{rec['write_s']:.3f} s, provenance {provenance['pe']} / "
            f"{provenance['hnsep']}, on {card}")
        log(f"{tag}   split: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
            + f"; unaccounted {wall - sum(b.timer.seconds.values()):.3f} s; launches {run_counts}")
        if any(run_counts.values()):
            fail(f"{tag} the binarization launched a model kernel: {run_counts}")
        if hnsep == "world" and not provenance["hnsep"].endswith(",device)"):
            fail(f"{tag} hnsep: world on the card did not resolve to the twin: {provenance}")
        # one item (the shortest of the first phrases) under the profiler, after the run's warm-up
        meta = b.load_meta_data(corpus, 0, "synth", "zh")
        name = next(n for n in meta if n.endswith(shortest))
        prof = profile_request(lambda: b.process_item(name, meta[name], b.binarization_args),
                               f"{run}, one item ({shortest})",
                               table=f"chip_smoke_binarize_ext_{i}.txt")
        if prof.get("measured"):
            log(f"{tag} {run}: {prof['kernel_launches']} kernel launches an item, idle share "
                f"{prof['idle_share']:.3f}; top device operations: " + "; ".join(
                    f"{k[:50]} {ms:.2f} ms" for k, ms in list(prof["top_kernels_ms"].items())[:5]))
        rec["profile"] = prof
        report["runs"].append(rec)
        del b

    # the one-time cost of a length bucket: the two passes' difference over
    # the buckets the first met, and the vocal remover at a bucket no phrase met
    first, again = report["runs"][0], report["runs"][1]
    longest = max(lengths, key=lengths.get)
    y, sr = load_wav(raw / "wavs" / f"{longest}.wav")
    x = as_signal(y, "cuda")
    x_new = torch.nn.functional.pad(x, (0, (buckets[-1] + 1) * 32 * vr_hop - x.shape[0]))
    new_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        predict_harmonic(ckpts["hnsep_ckpt"], x_new)
        torch.cuda.synchronize()
        new_s.append(time.perf_counter() - t)
    report["vr_length_buckets"] = {
        "buckets": len(buckets), "first_pass_s": first["wall_s"], "again_s": again["wall_s"],
        "one_time_s_per_bucket": (first["wall_s"] - again["wall_s"]) / len(buckets),
        "warm_s_per_audio_s": again["s_per_audio_s"],
        "new_bucket_audio_s": x_new.shape[0] / sr, "new_bucket_first_s": new_s[0],
        "new_bucket_again_s": new_s[1]}
    log(f"{tag} the vocal remover's length buckets (32 frames of {vr_hop}): the corpus meets "
        f"{len(buckets)}; the first pass took {first['wall_s']:.2f} s, the warm one "
        f"{again['wall_s']:.2f} s ({again['s_per_audio_s']:.5f} s a second of audio): "
        f"{report['vr_length_buckets']['one_time_s_per_bucket']:.3f} s once a bucket; at a bucket "
        f"no phrase met ({x_new.shape[0] / sr:.2f} s) the first call {new_s[0]:.3f} s, again "
        f"{new_s[1] * 1e3:.2f} ms, on {card}")

    # RMVPE alone on the longest phrase, stage by stage (synchronised)
    pe = rmvpe_mod.RMVPE(ckpts["pe_ckpt"])
    model = pe.model

    def stages():
        ms = {}
        t = time.perf_counter()
        with torch.no_grad(), no_tf32():
            mel = pe.mel(resample(x[None], sr, rmvpe_mod.SAMPLE_RATE))
            n_frames = mel.shape[1]
            mel = torch.nn.functional.pad(mel, (0, 0, 0, 32 * ((n_frames - 1) // 32 + 1) - n_frames))
            torch.cuda.synchronize()
            ms["frontend"], t = (time.perf_counter() - t) * 1e3, time.perf_counter()
            h = model.cnn(model.unet(mel.unsqueeze(1))).transpose(1, 2).flatten(-2)
            torch.cuda.synchronize()
            ms["unet"], t = (time.perf_counter() - t) * 1e3, time.perf_counter()
            hidden = model.fc(h)[0, :n_frames]
            torch.cuda.synchronize()
            ms["gru_and_head"], t = (time.perf_counter() - t) * 1e3, time.perf_counter()
        rmvpe_mod.to_local_average_f0(hidden.cpu().numpy())
        ms["decode"] = (time.perf_counter() - t) * 1e3
        return ms, n_frames

    stages()
    runs = [stages()[0] for _ in range(3)]
    rm = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    rm["frames"] = stages()[1]
    report["rmvpe_alone"] = rm
    log(f"{tag} RMVPE alone on the longest phrase ({len(y) / sr:.2f} s, {rm['frames']} frames of "
        f"10 ms): frontend {rm['frontend']:.2f} ms, U-Net {rm['unet']:.2f} ms, GRU and head "
        f"{rm['gru_and_head']:.2f} ms, decoding {rm['decode']:.2f} ms (medians of 3) on {card}")

    # the vocal remover alone on the longest phrase
    predict_harmonic(ckpts["hnsep_ckpt"], x)
    vr_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        predict_harmonic(ckpts["hnsep_ckpt"], x)
        torch.cuda.synchronize()
        vr_ms.append((time.perf_counter() - t) * 1e3)
    report["cascaded_net_alone"] = {"ms": float(np.median(vr_ms))}
    log(f"{tag} CascadedNet alone on the longest phrase (STFT, mask, iSTFT): "
        f"{np.median(vr_ms):.2f} ms (median of 3) on {card}")
    del pe, model

    # the WORLD twin against the float64 host golden on the shortest phrase
    y, sr = load_wav(raw_w / "wavs" / f"{shortest}.wav")
    hp = binarize_ext_hp("variance", "harvest", "world", raw_w, tmp / "unused", ckpts)
    f0, _ = HarvestPE().get_pitch(y, sr, len(y) // hp["hop_size"] + 1, hop_size=hp["hop_size"],
                                  f0_min=hp["f0_min"], f0_max=hp["f0_max"])
    kw = dict(fs=sr, fft_size=hp["fft_size"], hop=hp["hop_size"])
    x = as_signal(y, "cuda")
    world_harmonic_aperiodic(x, f0, backend="device", **kw)
    twin_s, twin = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        twin.append(world_harmonic_aperiodic(x, f0, backend="device", **kw))
        torch.cuda.synchronize()
        twin_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    h_host, a_host = (v.numpy() for v in world_harmonic_aperiodic(y, f0, backend="host",
                                                                  device="cpu", **kw))
    host_s = time.perf_counter() - t
    h_dev, a_dev = (v.cpu().numpy() for v in twin[0])
    spread = max(float((p - q).abs().max()) for p, q in zip(*twin))
    corr = float(np.dot(h_dev, h_host) / (np.linalg.norm(h_dev) * np.linalg.norm(h_host) + 1e-12))
    ap_db = float(10 * np.log10((np.mean(a_dev ** 2) + 1e-12) / (np.mean(a_host ** 2) + 1e-12)))
    report["world_twin_vs_host"] = {"audio_s": len(y) / sr, "twin_s": min(twin_s), "host_s": host_s,
                                    "speed_up": host_s / min(twin_s), "run_to_run_max_abs": spread,
                                    "harmonic_correlation": corr, "aperiodic_db": ap_db}
    log(f"{tag} WORLD split of {shortest} ({len(y) / sr:.2f} s, Harvest f0): the card twin "
        f"{min(twin_s):.3f} s, the float64 host golden {host_s:.3f} s ({host_s / min(twin_s):.1f}x); "
        f"harmonic correlation {corr:.4f} (>= 0.98), aperiodic energy {ap_db:+.3f} dB (within 2); "
        f"two runs of the twin differ by at most {spread:.3g}")
    if corr < 0.98 or abs(ap_db) > 2.0:
        fail(f"{tag} the WORLD twin left the host golden's bounds: {report['world_twin_vs_host']}")
    checks = world_twin_checks(torch.device("cuda"))
    report["world_twin_checks"] = checks
    log(f"{tag} the WORLD twin on the card within tests/test_world_device.py's bounds: " + ", ".join(
        f"{k} {v:.4g}" for k, v in checks["values"].items()))
    if checks["failures"]:
        fail(f"{tag} the WORLD twin on the card left its bounds: {checks['failures']}")

    # items of each run on the card against the CPU
    t0 = time.perf_counter()
    check = binarize_ext_card_vs_cpu(raw_w, tmp, ckpts, EXT_CHECK_ITEMS)
    report["card_vs_cpu"] = check
    log(f"{tag} {EXT_CHECK_ITEMS} items of each run on the card against the CPU in "
        f"{time.perf_counter() - t0:.1f} s: every exact attribute equal; worst " + ", ".join(
            f"{k} {v:.3g}" for k, v in check["worst"].items()
            if k.split(".")[1] in ("mel", "f0", "pitch", *VARIANCES))
        + f" (mel, curves: max |diff|, curves within {EXT_CARD_TOL} and 1e-4; f0, pitch: share "
          "of frames off)")
    if check["failures"]:
        fail(f"{tag} the card's features disagree with the CPU's: " + "; ".join(check["failures"][:10]))

    report["train_steps"] = narrow_store_steps(tag, stores, tmp)
    report["phase_peak_mem_gib"] = (max(peaks + [torch.cuda.max_memory_allocated()])
                                    - held0) / 2**30
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag} the phase's peak memory: {report['phase_peak_mem_gib']:.3f} GiB above what the "
        f"earlier phases hold; the phase took {report['phase_s']:.1f} s")
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return report, counts


PIPE_ITEMS = BIN_ITEMS  # [binarize]'s corpus (same seed)
PIPE_STEPS = (8, 13)  # optimizer steps of cli.train's first call, then of the resumed one
PIPE_PROFILE_STEPS = 4  # the resumed call's last steps, under the profiler
# (family, experiment, DS_PREFETCH_DEPTH or None for the config's, report key,
# resumed): the acoustic model at the default depth (1) and inline, in turns
# 1, 0, 0, 1, the first two resumed
PIPE_TRAINS = (("acoustic", "pipe_ac", None, "train_acoustic", True),
               ("acoustic", "pipe_ac_inline", 0, "train_acoustic_inline", True),
               ("acoustic", "pipe_ac_inline_2", 0, "train_acoustic_inline_2", False),
               ("acoustic", "pipe_ac_2", None, "train_acoustic_2", False),
               ("variance", "pipe_var", None, "train_variance", True))
PIPE_SCORE = "09_xing_he.ds"  # cli.infer variance, then acoustic on its output
PIPE_PLAIN_SCORE = "00_xiao_xing_xing.ds"  # straight through cli.infer acoustic
# more keys of a family's config: none on the card (the CPU rehearsal narrows the models)
PIPE_CONFIG = {"acoustic": {}, "variance": {}}


def pipeline_config(family: str, raw: Path, out: Path, vocoder_ckpt: Path) -> dict:
    """A user's config for the seeded corpus: the shipped config of the family
    with its data paths set (corpus, dictionary, binary folder, vocoder) and,
    for the variance model, the four curves predicted (labels from the .ds
    files)."""
    cfg = {"base_config": [str(ROOT / "configs" / f"{family}.yaml")],
           "binary_data_dir": str(out),
           "dictionary": str(ROOT / "dictionaries" / "opencpop-extension.txt"),
           "datasets": [{"raw_data_dir": str(raw), "speaker": "synth", "language": "zh",
                         "test_prefixes": ["song000", "song001"]}]}
    if family == "acoustic":
        cfg["vocoder_ckpt"] = str(vocoder_ckpt)
    else:
        cfg.update({f"predict_{v}": True for v in VARIANCES})
        cfg["binarization_args"] = {"prefer_ds": True}
    return dict(cfg, **PIPE_CONFIG[family])


class TrainProbe:
    """Wrappers around ``BaseTask``'s methods while a ``cli.train`` call runs
    (restored on exit): the seconds to the first optimizer step (synchronised),
    each step's host end, the kernels' launches of each step (reset when the
    step's forward starts, read after its update), each step's losses, the
    training thread's wait for its next batch (``next_batch``: the read and
    collation too at depth 0, else only what the pipeline's threads have not
    staged yet), the seconds of each ``epoch_batches`` fetch (read and collate
    from disk, on the collate thread at depths above 0), and the seconds of
    each save, resume and validation (each synchronised at its start). With
    ``profile_last``, the run's last steps under ``torch.profiler``: the share
    of their wall time in which the card ran nothing."""

    NAMES = ("train_step", "apply_update", "epoch_batches", "next_batch", "save",
             "init_or_resume", "run_validation")

    def __init__(self, reset_counts, read_counts, profile_last: int = 0, last_step: int = 0):
        self.reset_counts, self.read_counts = reset_counts, read_counts
        self.profile_from = last_step - profile_last if profile_last else None
        self.profile_last = profile_last

    def __enter__(self):
        import torch

        from diffsinger_tpu_torch.ops import flash_attention
        from diffsinger_tpu_torch.training.base_task import BaseTask

        self.t0 = time.perf_counter()
        self.first_step_s = None
        self.first_step_no = None
        self.step_ends, self.step_counts, self.losses, self.fetch_s = [], [], [], []
        self.wait_s, self.save_s, self.resume_s, self.validations = [], [], [], []
        self.shapes = []
        self.profile = None
        self.saved = {n: getattr(BaseTask, n) for n in self.NAMES}
        orig, probe = self.saved, self
        prof = {}

        def timed(name, out):
            def wrapper(task, *args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = orig[name](task, *args, **kwargs)
                torch.cuda.synchronize()
                out.append((t0, time.perf_counter() - t0))
                return result
            return wrapper

        def train_step(task, *args, **kwargs):
            if task.global_step == probe.profile_from and not prof:
                torch.cuda.synchronize()
                prof["p"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof["p"].__enter__()
                prof["t0"] = time.perf_counter()
            probe.reset_counts()
            losses = orig["train_step"](task, *args, **kwargs)
            probe.losses.append(losses)
            return losses

        def apply_update(task):
            norm = orig["apply_update"](task)
            if probe.first_step_s is None:
                torch.cuda.synchronize()
                probe.first_step_s = time.perf_counter() - probe.t0
                probe.first_step_no = task.global_step
            probe.step_ends.append(time.perf_counter())
            probe.step_counts.append(dict(probe.read_counts(),
                                          K3bwd=flash_attention.bwd_launches))
            if prof and probe.profile is None and \
                    task.global_step == probe.profile_from + probe.profile_last:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - prof["t0"]) * 1e6
                prof["p"].__exit__(None, None, None)
                acts = device_activities(prof["p"].events(), torch.autograd.DeviceType.CUDA)
                busy = union_us((s, e) for _, s, e in acts)
                probe.profile = {"steps": probe.profile_last, "wall_ms": wall_us / 1e3,
                                 "busy_ms": busy / 1e3, "kernel_launches": len(acts),
                                 "idle_share": 1 - busy / wall_us if busy else None}
            return norm

        def epoch_batches(task, *args, **kwargs):
            batches = orig["epoch_batches"](task, *args, **kwargs)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(batches)
                except StopIteration:
                    return
                probe.fetch_s.append(time.perf_counter() - t0)
                yield batch

        def next_batch(task, batches):
            t0 = time.perf_counter()
            out = orig["next_batch"](task, batches)
            probe.wait_s.append(time.perf_counter() - t0)
            probe.shapes.append(tuple(out[0]["mel2ph"].shape))
            return out

        for name, fn in (("train_step", train_step), ("apply_update", apply_update),
                         ("epoch_batches", epoch_batches), ("next_batch", next_batch),
                         ("save", timed("save", self.save_s)),
                         ("init_or_resume", timed("init_or_resume", self.resume_s)),
                         ("run_validation", timed("run_validation", self.validations))):
            setattr(BaseTask, name, fn)
        return self

    def __exit__(self, *exc):
        from diffsinger_tpu_torch.training.base_task import BaseTask

        for name, fn in self.saved.items():
            setattr(BaseTask, name, fn)

    def summary(self) -> dict:
        """Steps/s, the fetch share and the wait share over the window from
        the first step's end to the first validation after the last step (the
        end of training); the first step's fetch and wait happen before the
        window and are left out. None of them for a run with profiled steps."""
        n = len(self.step_ends)
        end = min(t for t, _ in self.validations if t >= self.step_ends[-1])
        window = end - self.step_ends[0]
        waits = self.wait_s[1:]
        rates = n > 1 and self.profile is None  # the profiler's cost is not the run's
        return {"steps": n, "first_global_step": self.first_step_no,
                "time_to_first_step_s": self.first_step_s,
                "steps_per_s": (n - 1) / window if rates else None,
                "fetch_share": sum(self.fetch_s[1:]) / window if rates else None,
                "fetch_ms": [1e3 * t for t in self.fetch_s],
                "wait_ms": [1e3 * t for t in self.wait_s],
                "wait_mean_ms": 1e3 * sum(waits) / len(waits) if waits else None,
                "wait_max_ms": 1e3 * max(waits) if waits else None,
                "wait_share": sum(waits) / window if rates else None,
                "profile": self.profile,
                "batch_shapes": self.shapes,
                "save_s": [d for _, d in self.save_s], "resume_s": [d for _, d in self.resume_s],
                "validation_s": [d for _, d in self.validations],
                "launches_per_step": self.step_counts,
                "losses": [{k: float(v) for k, v in m.items()} for m in self.losses],
                "last_losses": {k: float(v) for k, v in self.losses[-1].items()}}


def score_samples(score: list, sr: int, hop: int) -> int:
    """The samples of a rendered score: its last segment's offset, then that
    segment's frames (``preprocess_input``'s rounding of the durations)."""
    import numpy as np

    ph_dur = np.asarray(score[-1]["ph_dur"].split(), np.float64)
    frames = int(np.round(np.cumsum(ph_dur) / (hop / sr) + 0.5)[-1])
    return round(score[-1]["offset"] * sr) + frames * hop


def pipeline_phase(card, reset_counts, read_counts):
    """[pipeline]: the commands a voicebank maker runs, from files, through
    their ``main(argv)`` in this process (the card by default, no
    ``--device``): ``cli.binarize`` of both families over [binarize]'s seeded
    corpus into HDF5 stores on disk, the stores read back through the
    datasets; ``cli.train`` of each family at full width in '16-mixed' at its
    frame budget (the steps' launches, time to the first optimizer step,
    steps/s, the share of the run in ``epoch_batches``, validation, save),
    then resumed for more steps; ``cli.infer variance`` on a shipped score
    and ``cli.infer acoustic`` on its output (a wav of the score's length),
    and a shipped score straight through ``cli.infer acoustic``;
    ``cli.export`` of both families (``.pt2``) and the programs through the
    artifact runtimes against the eager models, bit for bit. Everything is
    written under a temporary ``DS_CKPT_ROOT`` in chiprun_out/ and removed at
    the end. Returns the report and the launches by command."""
    tmp = Path(tempfile.mkdtemp(prefix="pipeline_", dir=OUT_DIR))
    saved_root = os.environ.get("DS_CKPT_ROOT")
    os.environ["DS_CKPT_ROOT"] = str(tmp / "checkpoints")
    try:
        return pipeline_checks(tmp, card, reset_counts, read_counts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if saved_root is None:
            os.environ.pop("DS_CKPT_ROOT", None)
        else:
            os.environ["DS_CKPT_ROOT"] = saved_root


def pipeline_checks(tmp: Path, card, reset_counts, read_counts):
    """The body of :func:`pipeline_phase`, writing under ``tmp``."""
    import gc
    import pickle

    import numpy as np
    import torch
    import yaml

    from diffsinger_tpu_torch.cli import binarize as cli_binarize
    from diffsinger_tpu_torch.cli import export as cli_export
    from diffsinger_tpu_torch.cli import infer as cli_infer
    from diffsinger_tpu_torch.cli import train as cli_train
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.data.dataset import AcousticDataset, VarianceDataset
    from diffsinger_tpu_torch.deployment.exporters import (
        DiffSingerAcousticExporter, DiffSingerVarianceExporter)
    from diffsinger_tpu_torch.deployment.runtime import (
        AcousticArtifactRuntime, VarianceArtifactRuntime)
    from diffsinger_tpu_torch.ops import flash_attention

    tag = "[pipeline]"
    t_phase = time.perf_counter()
    report, launches = {}, {}
    ckpt_root = tmp / "checkpoints"

    def counts():
        return dict(read_counts(), K3bwd=flash_attention.bwd_launches)

    t0 = time.perf_counter()
    audio_s = synth_corpus(tmp, PIPE_ITEMS, 60, *BIN_SECONDS,
                           ROOT / "dictionaries" / "opencpop-extension.txt")
    (tmp / "vocoder").mkdir()
    configs = {}
    for family in ("acoustic", "variance"):
        configs[family] = tmp / f"{family}.yaml"
        configs[family].write_text(yaml.safe_dump(pipeline_config(
            family, tmp / "raw", tmp / f"binary_{family}", tmp / "vocoder" / "model.ckpt")))
    write_vocoder(tmp / "vocoder", load_config(configs["acoustic"]))
    log(f"{tag} corpus: {PIPE_ITEMS} phrases, {audio_s:.1f} s of audio; configs "
        f"{[str(p.name) for p in configs.values()]} over configs/acoustic.yaml and "
        f"configs/variance.yaml; made in {time.perf_counter() - t0:.1f} s")

    # 1. binarize, each family to HDF5 files, then the stores read back from disk
    for family, cfg in configs.items():
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # vr without a checkpoint: comb
            quiet(cli_binarize.main, ["--config", str(cfg)])
        wall = time.perf_counter() - t0
        launches[f"binarize {family}"] = c = counts()
        hp = load_config(cfg)
        out = Path(hp["binary_data_dir"])
        meta = {}
        for prefix in ("train", "valid"):
            with open(out / f"{prefix}.meta", "rb") as f:
                meta[prefix] = len(pickle.load(f)["lengths"])
        ds_cls = AcousticDataset if family == "acoustic" else VarianceDataset
        t0 = time.perf_counter()
        ds = ds_cls(out, hp, "train")
        items = [ds[i] for i in range(len(ds))]
        read_s = time.perf_counter() - t0
        read_mb = sum(v.nbytes for it in items for v in it.values()
                      if isinstance(v, np.ndarray)) / 1e6
        mb = store_mb(out)
        rec = {"wall_s": wall, "s_per_audio_s": wall / audio_s, "store_mb": mb,
               "items": meta, "launches": c, "read_items_per_s": len(items) / read_s,
               "read_mb_per_s": read_mb / read_s}
        report[f"binarize_{family}"] = rec
        log(f"{tag} cli.binarize {family}: {sum(meta.values())} items in {wall:.2f} s with the "
            f"file write: {wall / audio_s:.5f} s a second of audio; store {mb:.1f} MB on disk; "
            f"read back through {ds_cls.__name__}: {len(items)} items in {read_s:.3f} s, "
            f"{len(items) / read_s:.0f} items/s, {read_mb / read_s:.0f} MB/s of arrays; "
            f"launches {c} on {card}")
        if any(c.values()):
            fail(f"{tag} cli.binarize {family} launched a model kernel: {c}")
        if len(items) != meta["train"] or not meta["valid"]:
            fail(f"{tag} the {family} store holds {len(items)} items, its .meta {meta}")
        del ds, items

    # 2. train at full width, then resume: the acoustic model at the default
    # prefetch depth and inline (DS_PREFETCH_DEPTH=0) from the same store, then
    # the variance model; each resumed run's last steps under the profiler
    per_step = {"acoustic": TRAIN_PER_STEP, "variance": VAR_TRAIN_PER_STEP}
    saved_depth = os.environ.get("DS_PREFETCH_DEPTH")
    for family, exp, depth, key, resumed in PIPE_TRAINS:
        hp = load_config(configs[family])
        n_layers = hp["backbone_args"]["num_layers"] if family == "acoustic" else 0
        want = {"K1": n_layers, "K2": n_layers, "K3": hp["enc_layers"], "K3bwd": hp["enc_layers"]}
        runs = []
        if depth is None:
            os.environ.pop("DS_PREFETCH_DEPTH", None)
        else:
            os.environ["DS_PREFETCH_DEPTH"] = str(depth)
        try:
            for steps in PIPE_STEPS if resumed else PIPE_STEPS[:1]:
                argv = ["--config", str(configs[family]), "--exp_name", exp, "--ckpt_root",
                        str(ckpt_root), "--max_steps", str(steps)]
                last = PIPE_PROFILE_STEPS if steps == PIPE_STEPS[-1] else 0
                with TrainProbe(reset_counts, read_counts, last, steps) as probe:
                    task = quiet(cli_train.main, argv)
                run = probe.summary()
                run["global_step"] = task.global_step
                run["parameters"] = sum(p.numel() for p in task.module.parameters())
                run["checkpoint"] = (task.work_dir / f"model_ckpt_steps_{steps}.ckpt").is_file()
                run["prefetch_depth"] = int(os.environ.get(
                    "DS_PREFETCH_DEPTH", hp.get("train_prefetch_depth", 1)))
                runs.append(run)
                del task
                gc.collect()
                torch.cuda.empty_cache()
                per = run["launches_per_step"]
                prof = run["profile"] or {}
                where = "inline" if run["prefetch_depth"] == 0 else "on the collate thread"
                log(f"{tag} cli.train {family} ({run['parameters']:,} parameters, "
                    f"{hp['pl_trainer_precision']}, max_batch_frames {hp['max_batch_frames']}, "
                    f"prefetch depth {run['prefetch_depth']}) to step {steps} from step "
                    f"{run['first_global_step'] - 1}: first optimizer step "
                    f"{run['time_to_first_step_s']:.2f} s after the call, "
                    + (f"{run['steps_per_s']:.3f} steps/s" if run["steps_per_s"] else
                       "steps/s not measured (profiled steps)")
                    + f"; the loop's wait for a batch {run['wait_mean_ms'] or 0:.2f} ms mean, "
                    f"{run['wait_max_ms'] or 0:.2f} ms largest"
                    + (f", share of the run {run['wait_share']:.4f}; epoch_batches (read and "
                       f"collate, {where}) {run['fetch_share']:.4f} of the run"
                       if run["wait_share"] is not None else "")
                    + f" (fetches {np.median(run['fetch_ms']):.1f} ms median); batches (rows, "
                    f"frames) {dict(collections.Counter(run['batch_shapes']))}"
                    + (f"; idle share of the last {prof['steps']} steps under the profiler "
                       f"{prof['idle_share']:.3f} (wall {prof['wall_ms']:.1f} ms, device busy "
                       f"{prof['busy_ms']:.1f} ms)" if prof.get("idle_share") is not None else "")
                    + f"; save {sum(run['save_s']):.2f} s, resume {sum(run['resume_s']):.2f} s, "
                    f"validations {[round(v, 2) for v in run['validation_s']]} s, last losses "
                    + " ".join(f"{k}={v:.4f}" for k, v in run["last_losses"].items())
                    + f"; launches a step {per[0]} (every step alike: "
                    f"{all(p == per[0] for p in per)}) on {card}")
                if any(p != want for p in per):
                    fail(f"{tag} cli.train {family}: a step launched {per}, not {want} "
                         f"(expected {per_step[family]} at the shipped widths)")
                if (run["global_step"] != steps or not run["checkpoint"]
                        or len(run["validation_s"]) < 2 or not all(
                            math.isfinite(v) for v in run["last_losses"].values())):
                    fail(f"{tag} cli.train {family} to step {steps}: {run}")
                if last and (run["profile"] or {}).get("idle_share") is None:
                    fail(f"{tag} cli.train {family}: the profiler saw no device time")
        finally:
            if saved_depth is None:
                os.environ.pop("DS_PREFETCH_DEPTH", None)
            else:
                os.environ["DS_PREFETCH_DEPTH"] = saved_depth
        if resumed and (runs[1]["first_global_step"] != PIPE_STEPS[0] + 1
                        or not runs[1]["resume_s"]):
            fail(f"{tag} cli.train {family} did not resume from step {PIPE_STEPS[0]}: {runs[1]}")
        report[key] = runs
        if depth is None:
            launches[f"train {family} step"] = runs[0]["launches_per_step"][0]

    # steps/s at each depth, the first runs in turns
    turns = {depth: [report[k][0]["steps_per_s"] for k in keys] for depth, keys in (
        (1, ("train_acoustic", "train_acoustic_2")),
        (0, ("train_acoustic_inline", "train_acoustic_inline_2")))}
    report["depth_steps_per_s"] = {
        "depth_1": turns[1], "depth_0": turns[0],
        "ratio_1_over_0": sum(turns[1]) / sum(turns[0])}
    log(f"{tag} cli.train acoustic from disk in turns (depth 1, 0, 0, 1): depth 1 "
        f"{', '.join('%.3f' % v for v in turns[1])} steps/s, depth 0 "
        f"{', '.join('%.3f' % v for v in turns[0])}; depth 1 / depth 0 "
        f"{report['depth_steps_per_s']['ratio_1_over_0']:.3f} on {card}")

    # the same steps at every depth: the losses of every step, the first step
    # bit for bit (the same weights and batch); later steps start from
    # weights that the card's atomic adds may round apart
    pairs = [(report["train_acoustic"], report[k]) for k in (
        "train_acoustic_inline", "train_acoustic_inline_2", "train_acoustic_2")]
    deltas = [max(abs(a[k] - b[k]) for k in a) for runs_a, runs_b in pairs
              for run_a, run_b in zip(runs_a, runs_b)
              for a, b in zip(run_a["losses"], run_b["losses"])]
    first_equal = all(a[0]["losses"][0] == b[0]["losses"][0] for a, b in pairs)
    report["depth_loss_delta"] = {"first_step_bit_equal": first_equal, "max_abs": max(deltas),
                                  "per_step": deltas}
    log(f"{tag} cli.train acoustic, the losses of the same steps at depths 0 and 1 against the "
        f"first run's ({len(deltas)} steps): the first step's bit-equal {first_equal}, max |delta| "
        f"{max(deltas):.3e} over the steps ({', '.join('%.1e' % d for d in deltas)})")
    if not first_equal or max(deltas) > 1e-2:
        fail(f"{tag} the acoustic losses differ between the prefetch depths: {deltas}")

    # 3. infer: the variance model on a shipped score, the acoustic model on its output,
    # and a shipped score straight through the acoustic model
    ac_hp = load_config(exp_name="pipe_ac", infer=True, ckpt_root=ckpt_root)
    sr, hop = ac_hp["audio_sample_rate"], ac_hp["hop_size"]
    steps = ac_hp["sampling_steps"]
    n_layers, n_enc = ac_hp["backbone_args"]["num_layers"], ac_hp["enc_layers"]
    var_enc = load_config(exp_name="pipe_var", infer=True, ckpt_root=ckpt_root)["enc_layers"]
    chain = tmp / "chain"
    calls = [("variance", ROOT / "samples" / PIPE_SCORE, "pipe_var", chain / "ds"),
             ("acoustic", chain / "ds" / PIPE_SCORE, "pipe_ac", chain / "wav"),
             ("acoustic", ROOT / "samples" / PIPE_PLAIN_SCORE, "pipe_ac", chain / "wav")]
    report["infer"] = []
    for kind, score_path, exp, out_dir in calls:
        reset_counts()
        t0 = time.perf_counter()
        loaded(f"cli.infer {kind}", cli_infer.main,
               [kind, str(score_path), "--exp", exp, "--seed", "1", "--out", str(out_dir)])
        wall = time.perf_counter() - t0
        c = counts()
        with open(score_path, encoding="utf-8") as f:
            score = json.load(f)
        n_seg = len(score)
        if kind == "variance":
            want = {"K1": 0, "K2": 0, "K3": var_enc * n_seg, "K3bwd": 0}
            with open(out_dir / score_path.name, encoding="utf-8") as f:
                written = json.load(f)
            values = [np.asarray(seg[k].split(), np.float64) for seg in written
                      for k in ("ph_dur", "f0_seq", *VARIANCES)]
            ok = len(written) == n_seg and all(np.isfinite(v).all() and v.size for v in values)
            what = f"{len(written)} segments with ph_dur, f0_seq and the four curves, finite"
        else:
            want = {"K1": n_layers * steps * n_seg, "K2": n_layers * steps * n_seg,
                    "K3": n_enc * n_seg, "K3bwd": 0}
            with wave.open(str(out_dir / (score_path.stem + ".wav"))) as f:
                rate, n_samples = f.getframerate(), f.getnframes()
                pcm = np.frombuffer(f.readframes(n_samples), np.int16)
            expected = score_samples(score, sr, hop)
            # save_wav casts NaN to -32768: a non-finite wav sits at the rail
            ok = (rate == sr and abs(n_samples - expected) <= hop and np.abs(pcm).max() > 30
                  and (pcm == -32768).mean() < 0.01)
            what = (f"a wav of {n_samples} samples at {rate} Hz (the score: {expected}), peak "
                    f"{np.abs(pcm).max()}, share at the negative rail {(pcm == -32768).mean():.4f}")
        report["infer"].append({"command": kind, "score": score_path.name, "segments": n_seg,
                                "seconds_with_load": wall, "launches": c})
        log(f"{tag} cli.infer {kind} {score_path.name} --exp {exp}: {n_seg} segments in "
            f"{wall:.2f} s with loading; {what}; launches {c} (expected {want}: per segment "
            + (f"K2 = {n_layers} x {steps} steps" if kind == "acoustic" else f"K3 {var_enc}")
            + f") on {card}")
        if c != want:
            fail(f"{tag} cli.infer {kind} launched {c}, not {want}")
        if not ok:
            fail(f"{tag} cli.infer {kind} wrote {what}")
    launches["infer acoustic segment"] = {k: v // len(load_score(PIPE_PLAIN_SCORE))
                                          for k, v in report["infer"][-1]["launches"].items()}

    # 4. export both families (.pt2 on the card), then the programs against eager
    for family, exp in (("acoustic", "pipe_ac"), ("variance", "pipe_var")):
        art = tmp / "artifacts" / family
        reset_counts()
        t0 = time.perf_counter()
        quiet(cli_export.main, [family, "--exp", exp, "--out", str(art)])
        wall = time.perf_counter() - t0
        c = counts()
        mb = sum(f.stat().st_size for f in art.iterdir()) / 1e6
        hp = load_config(exp_name=exp, infer=True, ckpt_root=ckpt_root)
        if family == "acoustic":
            model = quiet(DiffSingerAcousticExporter, hp, tmp / "unused").model
            rt = AcousticArtifactRuntime(art)
            dev = rt.device
            tokens, mel2ph, f0 = export_inputs(*DiffSingerAcousticExporter.DEFAULT_BUCKETS[0], 21)
            noise = torch.randn((1, mel2ph.shape[1], hp["audio_num_mel_bins"]), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(3))
            reset_counts()
            got = {"mel": rt.synthesize_mel(tokens, mel2ph, f0, noise=noise)}
            run_counts = counts()
            want_eager = {"mel": eager_dynamic(model, tokens, mel2ph, f0, noise,
                                               int(rt.manifest["sampling_steps"]),
                                               float(rt.manifest["max_depth"])).cpu().numpy()}
            n = hp["backbone_args"]["num_layers"] * int(rt.manifest["sampling_steps"])
            want = {"K1": n, "K2": n, "K3": hp["enc_layers"], "K3bwd": 0}
        else:
            model = quiet(DiffSingerVarianceExporter, hp, tmp / "unused").model
            rt = VarianceArtifactRuntime(art)
            bp, bm = DiffSingerVarianceExporter.DEFAULT_BUCKETS[0]
            req = variance_request(56, seed=31)
            t_ph, t_mel = req["tokens"].shape[1], req["pitch"].shape[1]
            views = variance_view_calls(model, rt, req, bp, bm)
            reset_counts()
            enc, dur, bucket = views["pt2_encode"]()
            pitch = views["pt2_pitch"](enc, bucket)
            curves = views["pt2_variance"](enc, pitch, bucket)
            run_counts = counts()
            got = {"encoder_out": enc.cpu().numpy(), "ph_dur": dur, "pitch": pitch,
                   **{v: curves[v] for v in rt.variance_names()}}
            enc_e, dur_e = views["eager_encode"]()
            pitch_e = views["eager_pitch"](enc_e)
            curves_e = views["eager_variance"](enc_e, torch.from_numpy(
                np.pad(pitch, [(0, 0), (0, bm - t_mel)])).to(enc_e.device))
            want_eager = {"encoder_out": enc_e.cpu().numpy(),
                          "ph_dur": dur_e[:, :t_ph].cpu().numpy(),
                          "pitch": pitch_e[:, :t_mel].cpu().numpy(),
                          **{v: ce[:, :t_mel].cpu().numpy()
                             for v, ce in zip(rt.variance_names(), curves_e)}}
            want = {"K1": 0, "K2": 0, "K3": hp["enc_layers"], "K3bwd": 0}
        equal = {k: bool(np.array_equal(got[k], want_eager[k])) for k in got}
        report[f"export_{family}"] = {"seconds": wall, "artifact_mb": mb, "export_launches": c,
                                      "request_launches": run_counts, "bit_equal": equal}
        log(f"{tag} cli.export {family} --exp {exp}: {wall:.1f} s, {mb:.1f} MB of artifacts "
            f"({', '.join(sorted(p.name for p in art.iterdir()))}); launches while exporting {c}; "
            f"one segment through {type(rt).__name__}: launches {run_counts} (expected {want}), "
            f"bit-equal to the eager model: {equal} on {card}")
        if run_counts != want or not all(equal.values()):
            fail(f"{tag} the exported {family} program: launches {run_counts}, equal {equal}")
        del model, rt
        gc.collect()
        torch.cuda.empty_cache()

    report["launches"] = launches
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag} the phase took {report['phase_s']:.1f} s on {card}")
    return report, launches


LYNX_ACTIVATIONS = ("SiLU", "ReLU")
LYNX_ACT_CPU = dict(b=1, t_txt=16, t_mel=128, steps=8)  # the float32 request on the CPU too
LYNX_ACT_BUCKET = (16, 64)  # the SiLU .pt2's bucket


def lynx_act_phase(hp, card, reset_counts, read_counts, check, request, run, vocoder):
    """[lynx_act]: LYNXNet with ``activation: SiLU`` or ``ReLU``. K1 and K2
    with each activation against their plain versions (the main path's
    shapes, ragged ones, float32); configs/acoustic.yaml with SiLU at full
    width and bench.py's request (B=16, T_mel 1024, 50 steps, bf16, with
    [e2e]'s mini-NSF vocoder): mel frames/s and launches (K1 = K2 = 6 x 50,
    K3 4 a request); the same weights under ReLU for its launches; a float32
    SiLU request on the card against the CPU on the same weights and noise;
    one float32 training step of a narrow SiLU model on the card against the
    CPU's; the SiLU experiment exported as a ``.pt2`` at (16, 64) on the card,
    launching K2 and bit-equal to eager. Returns the report, the SiLU
    request's launches and the kernel line's entries."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.exporters import DiffSingerAcousticExporter
    from diffsinger_tpu_torch.deployment.runtime import AcousticArtifactRuntime
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
    from diffsinger_tpu_torch.ops import depthwise_conv, lynx_fused
    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask

    t_phase = time.perf_counter()
    dev, bf = torch.device("cuda"), torch.bfloat16
    report = {}
    gen = torch.Generator(device=dev).manual_seed(40)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (shift + torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    missed = []

    def held(name, got, want, tol):
        err = check(f"{name} (lynx_act)", got, want, tol)
        if not (math.isfinite(err) and err <= tol):
            missed.append(name)
        return err

    # 1. the kernels with each activation (alpha is not passed: no slopes)
    inner, c = 2048, 1024
    s = randn(B, T_MEL, inner, dtype=bf)
    dw_w, dw_b = randn(inner, 31, dtype=bf, scale=0.2), randn(inner, dtype=bf, scale=0.1)
    x = randn(B, T_MEL, c, dtype=bf)

    def k2_params(cc, ii, k, dtype):
        return dict(ln_scale=randn(cc, dtype=dtype, scale=0.2, shift=1.0),
                    ln_bias=randn(cc, dtype=dtype, scale=0.1),
                    w1=randn(2 * ii, cc, dtype=dtype, scale=cc ** -0.5),
                    b1=randn(2 * ii, dtype=dtype, scale=0.1),
                    dw_w=randn(ii, k, dtype=dtype, scale=0.2), dw_b=randn(ii, dtype=dtype, scale=0.1),
                    alpha=None, w2=randn(cc, ii, dtype=dtype, scale=ii ** -0.5),
                    b2=randn(cc, dtype=dtype, scale=0.1))

    p2 = k2_params(c, inner, 31, bf)
    errs = {}
    for act in LYNX_ACTIVATIONS:
        want = depthwise_conv.depthwise_conv1d_prelu_plain(s, dw_w, None, dw_b, act)
        errs["K1", act] = held(f"K1 bf16 [16,1024,2048] k=31 {act}",
                               depthwise_conv.depthwise_conv1d_prelu(s, dw_w, None, dw_b, act),
                               want, 2 ** -7 * want.float().abs().max().item())
        for dtype, b, t, cc, k in ((bf, 3, 333, 2048, 31), (bf, 1, 17, 64, 31),
                                   (bf, 5, 77, 160, 7), (torch.float32, 2, 100, 100, 4)):
            xk = randn(b, t, cc, dtype=dtype)
            xk[0, -1] = 100.0  # must not reach sequence 1
            args = (xk, randn(cc, k, dtype=dtype, scale=0.2), None, randn(cc, dtype=dtype, scale=0.1))
            want_k = depthwise_conv.depthwise_conv1d_prelu_plain(*args, act)
            f32 = dtype == torch.float32
            held("K1 %s [%d,%d,%d] k=%d %s" % ("f32" if f32 else "bf16", b, t, cc, k, act),
                 depthwise_conv.depthwise_conv1d_prelu(*args, act), want_k,
                 1e-3 if f32 else 2 ** -7 * want_k.float().abs().max().item())
        want = lynx_fused.fused_conv_module_plain(x, **p2, activation=act)
        errs["K2", act] = held(f"K2 bf16 [16,1024,1024] I=2048 k=31 {act}",
                               lynx_fused.fused_conv_module(x, **p2, activation=act), want,
                               2 ** -6 * want.float().abs().max().item())
        for b, t, cc, ii, k, dtype in ((3, 333, 1024, 2048, 31, bf), (2, 100, 64, 128, 31,
                                                                       torch.float32)):
            xr, pr = randn(b, t, cc, dtype=dtype), k2_params(cc, ii, k, dtype)
            want_r = lynx_fused.fused_conv_module_plain(xr, **pr, activation=act)
            f32 = dtype == torch.float32
            held("K2 %s x [%d,%d,%d] I=%d k=%d %s" % ("f32" if f32 else "bf16", b, t, cc, ii, k, act),
                 lynx_fused.fused_conv_module(xr, **pr, activation=act), want_r,
                 1e-3 if f32 else 2 ** -6 * want_r.float().abs().max().item())
    torch.cuda.synchronize()
    if missed:
        fail(f"[lynx_act] kernels disagree with their plain versions: {missed}")

    # 2. the SiLU model at bench.py's request, then the same weights under ReLU
    hp_act = {act: dict(hp, backbone_args=dict(hp["backbone_args"], activation=act))
              for act in LYNX_ACTIVATIONS}
    n_mels, n_layers, n_enc = hp["audio_num_mel_bins"], hp["backbone_args"]["num_layers"], hp["enc_layers"]
    torch.manual_seed(41)
    model32 = DiffSingerAcoustic(hp_act["SiLU"], vocab_size=VOCAB, out_dims=n_mels,
                                 dtype=torch.float32)
    seeded_weights(model32.module, 42)
    if not isinstance(model32.module.denoiser.residual_layers[0].convmodule.net[5], torch.nn.SiLU):
        fail("[lynx_act] the SiLU config did not build nn.SiLU into the conv module")
    inputs = request(B, T_TXT, T_MEL)
    per_request = {"K1": n_layers * STEPS, "K2": n_layers * STEPS, "K3": n_enc}
    launches = {}
    for act in LYNX_ACTIVATIONS:
        model = DiffSingerAcoustic(hp_act[act], vocab_size=VOCAB, out_dims=n_mels, dtype=bf)
        model.module.load_state_dict(model32.module.state_dict())
        n_req = REQUESTS if act == "SiLU" else 2
        reset_counts()
        times = []
        for r in range(n_req):  # the first warms up
            mel, wav, t_ac, t_voc = run(model, vocoder, *inputs, noise_seed=r)
            times.append(t_ac + t_voc)
        counts = read_counts()
        want = {k: v * n_req for k, v in per_request.items()}
        if counts != want:
            fail(f"[lynx_act] {act} requests: launch counts {counts} != {want}")
        if not (mel.shape == (B, T_MEL, n_mels) and torch.isfinite(mel).all()
                and wav.shape == (B, T_MEL * vocoder.config.hop_size)
                and torch.isfinite(wav).all()):
            fail(f"[lynx_act] {act} request: mel {tuple(mel.shape)}, wav {tuple(wav.shape)} "
                 "or not finite")
        if (mel[inputs[1] == 0] != 0).any():
            fail(f"[lynx_act] {act} request: padded frames are not zero")
        fps = B * T_MEL / (sum(times[1:]) / len(times[1:]))
        launches[act] = counts
        report[f"{act}_request"] = {"times_s": times, "frames_per_s": fps, "launches": counts}
        log(f"[lynx_act] {act} request B={B} T_mel={T_MEL} {STEPS} steps bf16 (+ mini-NSF): "
            f"times {['%.3f s' % t for t in times]}, {fps:.1f} mel frames/s on {card}; "
            f"launches {counts} over {n_req} requests (expected {want})")
        del model

    # 3. a float32 SiLU request on the card against the CPU, same weights and noise
    cpu32 = DiffSingerAcoustic(hp_act["SiLU"], vocab_size=VOCAB, out_dims=n_mels,
                               dtype=torch.float32, device="cpu")
    cpu32.module.load_state_dict(model32.module.state_dict())
    a = LYNX_ACT_CPU
    small = request(a["b"], a["t_txt"], a["t_mel"])
    noise = torch.randn((a["b"], a["t_mel"], n_mels), generator=torch.Generator().manual_seed(43))
    reset_counts()
    mel_card = model32.forward_infer(*small, steps=a["steps"], noise=noise.to(dev)).diff_out
    card_counts = read_counts()
    mel_cpu = cpu32.forward_infer(*(t.cpu() for t in small), steps=a["steps"], noise=noise).diff_out
    err = max_err(mel_card.cpu(), mel_cpu)
    want = {"K1": n_layers * a["steps"], "K2": n_layers * a["steps"], "K3": n_enc}
    log(f"[lynx_act] SiLU f32 request B={a['b']} T_mel={a['t_mel']} {a['steps']} steps, card vs "
        f"CPU: max|mel err| {err:.3e} (tolerance 1e-3); card launches {card_counts} "
        f"(expected {want})")
    if not err <= 1e-3 or card_counts != want:
        fail("[lynx_act] the float32 SiLU request on the card disagrees with the CPU")
    report["f32_card_vs_cpu_mel"] = err
    del cpu32, model32

    # 4. one float32 training step of a narrow SiLU model, card against CPU
    tmp = Path(tempfile.mkdtemp(prefix="lynx_act_", dir=OUT_DIR))
    try:
        narrow = dict(hidden_size=64, enc_layers=2, dropout=0.0, pl_trainer_precision="32-true",
                      backbone_args=dict(num_channels=128, num_layers=2, kernel_size=31,
                                         dropout_rate=0.0, strong_cond=True, activation="SiLU"))
        tasks = []
        for device in ("cuda", "cpu"):
            hp_n = acoustic_train_hp(tmp / f"narrow_{device}", **narrow)
            hp_n["shallow_diffusion_args"] = dict(
                hp_n["shallow_diffusion_args"], aux_decoder_args=dict(
                    num_channels=64, num_layers=2, kernel_size=7, dropout_rate=0.0))
            torch.manual_seed(44)
            tasks.append(quiet(AcousticTask, hp_n, device=device))
            tasks[-1].configure_optimizer()
        seeded_weights(tasks[0].module, 45)
        tasks[1].module.load_state_dict(tasks[0].module.state_dict())
        rng = np.random.default_rng(46)
        ds = memory_acoustic_dataset(train_items(rng, 4, 32, 256, 128, 150, 256), tasks[0].hp)
        batch = {k: v for k, v in ds.collater([ds[i] for i in range(4)]).items()
                 if isinstance(v, np.ndarray) and k != "indices"}
        draws = dict(t=torch.from_numpy(rng.uniform(0.4, 1, 4).astype(np.float32)),
                     noise=torch.from_numpy(rng.standard_normal((4, 256, 128)).astype(np.float32)))
        reset_counts()
        report["f32_step_vs_cpu"], launched = card_vs_cpu_step("lynx_act", tasks, batch, draws,
                                                               " (SiLU)")
        counts = read_counts()
        if launched != [(2, 2), (0, 0)] or counts["K2"] != 2 or counts["K1"] != 2:
            fail(f"[lynx_act] the narrow SiLU step launched K3 {launched}, K1/K2 {counts}: "
                 "expected K3 (2, 2) on the card and K1 = K2 = 2")
        del tasks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 5. the SiLU experiment as a .pt2 at a small bucket, on the card
    root = Path(tempfile.mkdtemp(prefix="lynx_act_export_"))
    try:
        name, _, _ = write_experiment(root, hp_act["SiLU"])
        hp_e = load_config(exp_name=name, infer=True, ckpt_root=root / "checkpoints")
        exporter = DiffSingerAcousticExporter(hp_e, root / "acoustic", buckets=[LYNX_ACT_BUCKET],
                                              fmt="pt2", device="cuda")
        t0 = time.perf_counter()
        quiet(exporter.export)
        export_s = time.perf_counter() - t0
        runtime = AcousticArtifactRuntime(root / "acoustic", device="cuda")
        t_txt, t_mel = LYNX_ACT_BUCKET
        tokens, mel2ph, f0 = export_inputs(t_txt, t_mel, seed=47)
        depth, steps = float(runtime.manifest["max_depth"]), hp_e["sampling_steps"]
        noise = torch.randn((1, t_mel, n_mels), generator=torch.Generator(device=dev).manual_seed(48),
                            device=dev)
        reset_counts()
        mel_pt2 = runtime.synthesize_mel(tokens, mel2ph, f0, noise=noise)
        pt2_counts = read_counts()
        reset_counts()
        mel_eager = eager_dynamic(exporter.model, tokens, mel2ph, f0, noise, steps,
                                  depth).cpu().numpy()
        eager_counts = read_counts()
        want = {"K1": n_layers * steps, "K2": n_layers * steps, "K3": n_enc}
        equal = bool(np.array_equal(mel_pt2, mel_eager))
        log(f"[lynx_act] SiLU .pt2 at {LYNX_ACT_BUCKET} exported on the card in {export_s:.1f} s; "
            f"a request ({steps} steps, float32): launches {pt2_counts} (eager {eager_counts}, "
            f"expected {want}); bit-equal to eager: {equal} (max|diff| "
            f"{float(np.abs(mel_pt2 - mel_eager).max()):.3e})")
        if pt2_counts != want or eager_counts != want or not equal:
            fail("[lynx_act] the SiLU .pt2 request disagrees with eager or launched otherwise")
        report["pt2"] = {"export_s": export_s, "launches": pt2_counts, "bit_equal": equal}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the kernel line's entries: the PReLU rows' bounds (the same bytes and
    # products), the library call F.conv1d(groups=C) then the activation
    bt = B * T_MEL
    k1_bound = max((2 * (2 * bt * inner) + 2 * (inner * 31 + 2 * inner)) / PEAK_BYTES,
                   2 * 31 * bt * inner / PEAK_F32)
    k2_bytes = 2 * (2 * bt * c) + 2 * (2 * inner * c + inner * c + 31 * inner + 4 * inner + 4 * c)
    k2_bound = max(k2_bytes / PEAK_BYTES, (2 * bt * c * 2 * inner + 2 * bt * inner * c) / PEAK_BF16_TC,
                   2 * 31 * bt * inner / PEAK_F32)
    s_t = s.transpose(1, 2).contiguous()
    w_conv = dw_w[:, None, :].contiguous()
    library = {"SiLU": F.silu, "ReLU": F.relu}
    entries = []
    for act in LYNX_ACTIVATIONS:
        n_req = REQUESTS if act == "SiLU" else 2
        for key, name, src, replaces, fn, plain, lib, bound, by in (
            ("K1", f"depthwise_conv1d_prelu ({act})",
             "diffsinger_tpu_torch/ops/csrc/depthwise_conv.cu", "diffsinger_tpu/ops/depthwise_conv.py:83",
             lambda: depthwise_conv.depthwise_conv1d_prelu(s, dw_w, None, dw_b, act),
             lambda: depthwise_conv.depthwise_conv1d_prelu_plain(s, dw_w, None, dw_b, act),
             lambda: library[act](F.conv1d(s_t, w_conv, dw_b, padding=15, groups=inner)),
             k1_bound, "bytes"),
            ("K2", f"fused_conv_module ({act})", "diffsinger_tpu_torch/ops/csrc/lynx_fused.cu",
             "diffsinger_tpu/ops/lynx_fused.py:153",
             lambda: lynx_fused.fused_conv_module(x, **p2, activation=act),
             lambda: lynx_fused.fused_conv_module_plain(x, **p2, activation=act),
             None, k2_bound, "operations"),
        ):
            entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[act][key],
                     "launches_per_request": launches[act][key] // n_req,
                     "launches_from": f"[lynx_act]'s {n_req} {act} requests at B={B}, "
                                      f"T_mel={T_MEL}, {STEPS} steps",
                     "max_abs_err": errs[key, act], "ms": time_ms(fn),
                     "plain_ms": time_ms(plain, iters=5, warmup=1), "bound_ms": bound * 1e3,
                     "bound_by": by, "library_ms": time_ms(lib) if lib is not None else None}
            entries.append(entry)
            log(f"[time] {key} {name}: {entry['ms']:.4f} ms (bound {entry['bound_ms']:.4f} ms by "
                f"{by}; plain {entry['plain_ms']:.4f} ms; library "
                f"{'null' if lib is None else '%.4f ms' % entry['library_ms']}) on {card}")
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[lynx_act] phase {report['phase_s']:.1f} s")
    return report, launches["SiLU"], entries


# card against CPU. The DDSP vocoders sum their sources' phases in float64
# (a float32 sum's drift over the request, printed for each device, moves
# the pulses by fractions of a sample), so the two devices agree to float32
# rounding: their samples are held directly and against a float64 run of the
# same vocoder on the CPU. Griffin-Lim's phase recovery divides by
# magnitudes near zero, which amplifies rounding round after round: its
# samples are held on the request's first frames, and its whole log-mel.
VOCODER_TOL = {
    "controls": 1e-3,  # the control networks' outputs, whole request, max|err| / max|CPU|
    "samples": 1e-3,  # DDSP vocoders: the whole request's samples, max|err| / peak
    "vs_float64": 2.0,  # DDSP vocoders: card's max|err| against float64 / the CPU float32 run's
    "short": 1e-2,  # Griffin-Lim: samples of the first VOCODER_SHORT frames, max|err| / peak
    "log_mel": 2e-3,  # Griffin-Lim: the whole waveform's log-mel, mean |err| (natural log)
}
VOCODER_SHORT = 64  # frames (0.74 s)


def ddsp_bundle(folder: Path) -> Path:
    """A pc-ddsp CombSub bundle at its published widths (44.1 kHz, block 512,
    window 2048, 128 mels, 512 harmonic and 256 noise bands, so that the
    vocoder resamples its bands to the window's 1025 bins): Mel2Control's
    parameters under pc-ddsp's names, weight norm on the last layer, seeded,
    traced with ``torch.jit.trace`` on the host, with its ``config.yaml``."""
    import torch
    import yaml

    n_mels, n_harm, n_noise = 128, 512, 256

    class Mel2Control(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.stack = torch.nn.Sequential(
                torch.nn.Conv1d(n_mels, 64, 3, 1, 1), torch.nn.GroupNorm(4, 64),
                torch.nn.LeakyReLU(), torch.nn.Conv1d(64, 64, 3, 1, 1))
            self.decoder = torch.nn.LSTM(64, 128, batch_first=True, bidirectional=True)
            self.norm = torch.nn.LayerNorm(256)
            self.dense_out = torch.nn.utils.parametrizations.weight_norm(
                torch.nn.Linear(256, 2 * n_harm + n_noise))

        def forward(self, mel):
            x = self.stack(mel.transpose(1, 2)).transpose(1, 2)
            return self.dense_out(self.norm(self.decoder(x)[0]))

    class Bundle(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mel2ctrl = Mel2Control()

        def forward(self, mel):
            return self.mel2ctrl(mel)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(50)
        model = Bundle().eval()
        with torch.no_grad():  # biases and norms off their inits
            for name, p in model.named_parameters():
                if name.endswith("bias") or name.startswith(("mel2ctrl.stack.1", "mel2ctrl.norm")):
                    p.add_(0.1 * torch.randn(p.shape))
        path = folder / "combsub.jit"
        torch.jit.trace(model, (torch.randn(1, 12, n_mels),)).save(str(path))
    (folder / "config.yaml").write_text(yaml.safe_dump({
        "model": {"type": "CombSub", "n_mag_harmonic": n_harm, "n_mag_noise": n_noise},
        "data": {"sampling_rate": 44100, "block_size": 512, "win_length": 2048,
                 "n_mels": n_mels}}))
    return path


def read_wav(path) -> "tuple":
    import numpy as np

    with wave.open(str(path), "rb") as f:
        return f.getframerate(), np.frombuffer(f.readframes(f.getnframes()), np.int16)


def vocoders_phase(card, reset_counts, read_counts, hp, mel, f0):
    """[vocoders]: DDSP (a bundle traced at pc-ddsp's CombSub widths),
    DDSPNative at its defaults and Griffin-Lim (32 rounds) on the 11.9 s
    request's mel [1, 1024, 128] (natural log) and f0, each on the card
    against the CPU on the same noise (``VOCODER_TOL``: the control
    networks, the samples, and the samples against a float64 run for the
    DDSP vocoders; Griffin-Lim's first 64 frames and whole log-mel), its
    seconds a second of
    audio, its kernel launches under the profiler and the port's kernel
    counters (0); then ``cli.vocode`` and ``cli.val_nsf_hifigan`` once on the
    card with a full-NSF experiment folder. Returns the report."""
    root = Path(tempfile.mkdtemp(prefix="vocoders_"))
    try:
        return vocoder_checks(root, card, reset_counts, read_counts, hp, mel, f0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def vocoder_checks(root, card, reset_counts, read_counts, hp, mel, f0):
    """The body of :func:`vocoders_phase`, writing under ``root``."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.cli import val_nsf_hifigan, vocode
    from diffsinger_tpu_torch.dsp.griffin_lim import GriffinLimVocoder
    from diffsinger_tpu_torch.dsp.mel import MelSpectrogram
    from diffsinger_tpu_torch.utils.infer_utils import save_wav
    from diffsinger_tpu_torch.vocoders.ddsp import DDSP
    from diffsinger_tpu_torch.vocoders.ddsp_native import DDSPNative

    t_phase = time.perf_counter()
    sr, hop = hp["audio_sample_rate"], hp["hop_size"]
    audio_s = mel.shape[1] * hop / sr
    mel, f0 = mel.float().contiguous(), f0.float().contiguous()
    mel_cpu, f0_cpu = mel.cpu(), f0.cpu()
    base = {"audio_sample_rate": sr, "audio_num_mel_bins": hp["audio_num_mel_bins"],
            "hop_size": hop, "win_size": hp["win_size"], "mel_base": hp["mel_base"]}
    ddsp_hp = dict(base, vocoder_ckpt=str(ddsp_bundle(root)))
    with warnings.catch_warnings():  # DDSPNative has no checkpoint: seeded random weights
        warnings.simplefilter("ignore")
        native = [DDSPNative(dict(base), device=d) for d in ("cuda", "cpu")]
    made = {
        "DDSP": [quiet(DDSP, ddsp_hp, device=d) for d in ("cuda", "cpu")],
        "DDSPNative": native,
        "GriffinLim": [GriffinLimVocoder.from_hparams(hp, n_iter=32, device=d)
                       for d in ("cuda", "cpu")],
    }
    log_mel = MelSpectrogram(sr=sr, n_mels=hp["audio_num_mel_bins"], n_fft=hp["fft_size"],
                             win_size=hp["win_size"], hop_size=hop, fmin=hp["fmin"],
                             fmax=hp["fmax"])
    # the DDSP vocoders' noise, drawn once on the host for both devices (a
    # generator of one seed gives other numbers on the card than on the CPU)
    noise = torch.rand((1, mel.shape[1] * hop), generator=torch.Generator().manual_seed(0)) * 2 - 1
    out = {"audio_s": audio_s, "tolerances": VOCODER_TOL}
    # why the DDSP sources sum their phases in float64: the request's phase
    # (the f0 upsampled as CombSub does) summed in float32 on each device,
    # against the float64 sum, in cycles
    from diffsinger_tpu_torch.vocoders.ddsp_combsub import upsample_align_corners

    f0_up = upsample_align_corners(f0, hop)
    exact = torch.cumsum(f0_up.cpu().double() / sr, dim=1)
    out["float32_phase_drift_cycles"] = drift = {
        name: (torch.cumsum(f0_up.to(where) / sr, dim=1).cpu().double() - exact).abs().max().item()
        for name, where in (("card", f0.device), ("cpu", "cpu"))}
    log(f"[vocoders] the request's phase ({exact[0, -1].item():.1f} cycles) summed in float32 "
        f"against float64: max drift {drift['card']:.3e} cycles on the card, {drift['cpu']:.3e} "
        f"on the CPU (the vocoders sum in float64)")
    for name, (card_voc, cpu_voc) in made.items():
        if name == "GriffinLim":
            call = lambda v, m, _f: v.spec2wav_torch(m)  # noqa: E731
        else:
            call = lambda v, m, f: v.spec2wav_torch(  # noqa: E731
                m, f, noise=noise[:, :m.shape[1] * hop].to(m.device))
        reset_counts()
        wav = call(card_voc, mel, f0)  # warms up
        times = timed_requests(lambda: call(card_voc, mel, f0))
        counts = read_counts()
        prof = profile_request(lambda: call(card_voc, mel, f0), f"{name} vocoding 11.9 s",
                               table=f"chip_smoke_profile_{name.lower()}.txt")
        want = call(cpu_voc, mel_cpu, f0_cpu)
        got = wav.cpu()
        if got.shape != (1, mel.shape[1] * hop) or not torch.isfinite(got).all():
            fail(f"[vocoders] {name}: wav {tuple(got.shape)} or not finite")
        peak = want.abs().max().item()
        mel_mae = (log_mel(got) - log_mel(want)).abs().mean().item()
        if name == "GriffinLim":
            short = (mel[:, :VOCODER_SHORT], f0[:, :VOCODER_SHORT])
            want_short = call(cpu_voc, *(t.cpu() for t in short))
            errs = {"short": max_err(call(card_voc, *short).cpu(), want_short)
                    / want_short.abs().max().item(), "log_mel": mel_mae}
        else:
            # the control frames, then the samples against a float64 run
            with torch.no_grad():
                if name == "DDSP":
                    net_in = card_voc.mel_to_log10(mel)
                    ctrl_card = list(card_voc.model.mel2ctrl(net_in).values())
                    ctrl_cpu = list(cpu_voc.model.mel2ctrl(net_in.cpu()).values())
                else:
                    net_in = mel if hp["mel_base"] == "e" else 2.30259 * mel
                    ctrl_card = card_voc.model.control(net_in)
                    ctrl_cpu = cpu_voc.model.control(net_in.cpu())
                model64 = copy.deepcopy(cpu_voc.model).double()
                truth = model64(net_in.cpu().double(), f0_cpu.double(), noise=noise.double())
            cpu_err = max_err(want, truth) / peak
            errs = {"controls": max(max_err(a.cpu(), w) / w.abs().max().item()
                                    for a, w in zip(ctrl_card, ctrl_cpu)),
                    "samples": max_err(got, want) / peak,
                    "vs_float64": max_err(got, truth) / peak / max(cpu_err, 1e-7)}
            log(f"[vocoders] {name}: max|err| / peak against float64: card {errs['vs_float64'] * max(cpu_err, 1e-7):.3e}, "
                f"CPU {cpu_err:.3e}; card vs CPU log-mel mean |err| {mel_mae:.3e}")
        ok = all(v <= VOCODER_TOL[k] for k, v in errs.items()) and counts == {"K1": 0, "K2": 0,
                                                                             "K3": 0}
        mean_s = sum(times) / len(times)
        out[name] = {"times_s": times, "s_per_audio_s": mean_s / audio_s, "errors": errs,
                     "log_mel_mae": mel_mae, "kernel_counters": counts, "profile": prof,
                     "peak": peak}
        log(f"[vocoders] {name}: {mean_s * 1e3:.1f} ms for {audio_s:.2f} s of audio "
            f"({['%.1f' % (t * 1e3) for t in times]} ms), {mean_s / audio_s:.5f} s a second of "
            f"audio on {card}; {prof.get('kernel_launches', 'not measured')} kernel launches, idle "
            f"share {prof.get('idle_share', float('nan')):.3f}; the port's kernels {counts}; card "
            f"vs CPU " + ", ".join(f"{k} {v:.3e} (tolerance {VOCODER_TOL[k]:.0e})"
                                   for k, v in errs.items()))
        if not ok:
            fail(f"[vocoders] {name} on the card disagrees with the CPU or launched a kernel")
        torch.cuda.synchronize()
    del made

    # the two commands, once each on the card (no --device: the default)
    name, _, _ = write_experiment(root / "exp", hp)
    exp_dir = root / "exp" / "checkpoints" / name
    # two segments of the request's mel (frames 0-600 and 500-1024 of 1024):
    # the second starts before the first ends, so the command cross-fades
    t = mel.shape[1]
    end0, start1 = t * 600 // 1024, t * 500 // 1024
    mel_np, f0_np = mel_cpu[0].numpy(), f0_cpu[0].numpy()
    np.savez(root / "song.mel.npz", num_segments=2, mel_0=mel_np[:end0], f0_0=f0_np[:end0],
             offset_0=0.0, mel_1=mel_np[start1:], f0_1=f0_np[start1:], offset_1=start1 * hop / sr)
    saved = os.environ.get("DS_CKPT_ROOT")
    os.environ["DS_CKPT_ROOT"] = str(root / "exp" / "checkpoints")
    try:
        t0 = time.perf_counter()
        path = quiet(vocode.main, [str(root / "song.mel.npz"), "--exp", name,
                                   "--out", str(root / "out")])
        vocode_s = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("DS_CKPT_ROOT")
        else:
            os.environ["DS_CKPT_ROOT"] = saved
    rate, samples = read_wav(path)
    if rate != sr or samples.size != mel.shape[1] * hop or not np.abs(samples).max() > 0:
        fail(f"[vocoders] cli.vocode wrote {samples.size} samples at {rate} Hz")
    n = np.arange(int(3.0 * sr))
    take = 0.5 * np.sin(2 * np.pi * np.cumsum(220 * 2 ** (0.5 * np.sin(2 * np.pi * n / sr))) / sr)
    save_wav(take, root / "take.wav", sr)
    t0 = time.perf_counter()
    path = quiet(val_nsf_hifigan.main, [str(root / "take.wav"), "--config",
                                        str(exp_dir / "config.yaml"), "--out", str(root / "out")])
    val_s = time.perf_counter() - t0
    rate, resynth = read_wav(path)
    frames = log_mel.num_frames(n.size)
    if rate != sr or resynth.size != frames * hop or not np.abs(resynth).max() > 0:
        fail(f"[vocoders] cli.val_nsf_hifigan wrote {resynth.size} samples at {rate} Hz")
    out["cli"] = {"vocode_s": vocode_s, "val_nsf_hifigan_s": val_s}
    log(f"[vocoders] cli.vocode (2 segments, {samples.size / sr:.2f} s, full-NSF bf16) "
        f"{vocode_s:.2f} s with loading; cli.val_nsf_hifigan (3 s take) {val_s:.2f} s with "
        f"loading, on {card}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[vocoders] phase {out['phase_s']:.1f} s")
    return out


def phase_summaries(report: dict, seconds: dict) -> list:
    """One compact line a phase (its seconds and its main numbers), printed
    just before the script's last lines, where the tool's tail of the output
    keeps them."""
    p = report["phases"]

    def f(x, digits=4):
        return "not measured" if x is None else f"{x:.{digits}g}"

    runs = lambda runs, key: " ".join(f"{f(r[key])}" for r in runs)  # noqa: E731
    req, prof = p["requests"], p["profile"]
    lines = {
        "build": f"{f(report['build']['seconds'], 3)} s for the kernel libraries",
        "kernels": f"{len(p['kernels'])} checks against the plain versions, worst err/tol "
                   + f(max(c["max_abs_err"] / c["tol"] for c in p["kernels"] if c["tol"]), 3),
        "e2e": f"{f(req['frames_per_s'], 6)} mel frames/s, idle share {f(prof['idle_share'], 3)}, "
               f"launches {req['launches']}",
        "serve": f"{f(p['serve']['scores']['frames_per_s'], 6)} true mel frames/s, padded "
                 f"{f(p['serve']['scores']['padded_share'], 3)}, idle share "
                 f"{f(p['serve']['profile']['idle_share'], 3)}, cli.infer "
                 f"{f(p['serve']['entry_point']['seconds_with_load'], 3)} s",
        "variance": f"{f(p['variance']['served']['frames_per_s'], 6)} frames/s, idle share "
                    f"{f(p['variance']['profile']['idle_share'], 3)}, chain "
                    f"{f(p['variance']['chain']['frames_per_s'], 5)} mel frames/s",
        "ddpm": " ".join(f"{acc} {f(v['frames_per_s'], 6)}" for acc, v in p["ddpm"].items())
                + " mel frames/s",
        "lynx_act": f"SiLU {f(p['lynx_act']['SiLU_request']['frames_per_s'], 6)}, ReLU "
                    f"{f(p['lynx_act']['ReLU_request']['frames_per_s'], 6)} mel frames/s, .pt2 "
                    f"bit-equal {p['lynx_act']['pt2']['bit_equal']}",
        "vocoders": " ".join(f"{k} {f(p['vocoders'][k]['s_per_audio_s'], 3)}"
                             for k in ("DDSP", "DDSPNative", "GriffinLim")) + " s a second of audio",
        "export": f"acoustic {f(p['export']['export_s'], 3)} s, .pt2 / eager "
                  f"{f(p['export']['request_s']['mean']['pt2'] / p['export']['request_s']['mean']['eager'], 3)}"
                  f", max err {f(p['export']['max_abs_err_vs_eager'], 3)}; variance "
                  f"{f(p['export']['variance']['export_s'], 3)} s",
        "train": f"{f(p['train']['steps_per_s'], 4)} steps/s, {f(p['train']['mel_frames_per_s'], 6)} "
                 f"mel frames/s, peak {f(p['train']['peak_mem_gib'], 3)} GiB, launches "
                 f"{p['train']['launches']}",
        "train_variance": f"{f(p['train_variance']['steps_per_s'], 4)} steps/s, "
                          f"{f(p['train_variance']['frames_per_s'], 6)} frames/s, peak "
                          f"{f(p['train_variance']['peak_mem_gib'], 3)} GiB",
        "train_remat": " ".join(
            f"{k} {f(v['steps_per_s'], 4)} steps/s {f(v['peak_mem_gib'], 4)} GiB K2 "
            f"{v['launches_per_step']['K2']};" for k, v in p["train_remat"]["acoustic"].items())
                       + " variance " + " ".join(
            f"{k} {f(v['steps_per_s'], 4)} steps/s {f(v['peak_mem_gib'], 4)} GiB;"
            for k, v in p["train_remat"]["variance"].items())
                       + " f32 grad delta " + f(max(v["grad_max_abs_delta"] for v in
                                                    p["train_remat"]["float32"].values()), 3)
                       + f"; wire f16 loss delta {p['train_remat']['wire']['loss_delta']:.3g}",
        "train_dist": f"two gloo ranks vs one process {f(p['train_dist']['two_ranks']['err'], 3)}, "
                      f"DDP / plain {f(p['train_dist']['ddp_one_rank']['ddp_over_plain'], 4)}",
        "binarize": "s a second of audio " + runs(p["binarize"]["runs"], "s_per_audio_s")
                    + "; store MB " + runs(p["binarize"]["runs"], "store_mb") + "; write s "
                    + runs(p["binarize"]["runs"], "write_s"),
        "binarize_ext": "s a second of audio " + runs(p["binarize_ext"]["runs"], "s_per_audio_s")
                        + "; store MB " + runs(p["binarize_ext"]["runs"], "store_mb"),
    }
    pipe = p["pipeline"]
    lines["pipeline"] = "; ".join(
        [f"binarize {fam} {f(pipe[f'binarize_{fam}']['s_per_audio_s'], 3)} s a second of audio, "
         f"{f(pipe[f'binarize_{fam}']['store_mb'], 4)} MB, read "
         f"{f(pipe[f'binarize_{fam}']['read_items_per_s'], 4)} items/s"
         for fam in ("acoustic", "variance")]
        + [f"train {fam} depth {r[0]['prefetch_depth']} first step "
           f"{f(r[0]['time_to_first_step_s'], 3)} s, {f(r[0]['steps_per_s'], 4)} steps/s, wait "
           f"{f(r[0]['wait_mean_ms'], 3)} ms mean {f(r[0]['wait_max_ms'], 3)} max share "
           f"{f(r[0]['wait_share'], 3)}, fetch share {f(r[0]['fetch_share'], 3)}, idle share "
           f"{f((r[1]['profile'] or {}).get('idle_share'), 3)}, save "
           f"{f(sum(r[0]['save_s']), 3)} s, resume "
           f"{f(sum(r[1]['resume_s']), 3)} s, launches a step {r[0]['launches_per_step'][0]}"
           for fam, r in (("acoustic", pipe["train_acoustic"]),
                          ("acoustic", pipe["train_acoustic_inline"]),
                          ("variance", pipe["train_variance"]))]
        + [f"depth 1 / depth 0 steps/s {f(pipe['depth_steps_per_s']['ratio_1_over_0'], 4)}, "
           f"loss max |delta| between depths {f(pipe['depth_loss_delta']['max_abs'], 3)}"]
        + [f"infer {c['command']} {c['score']} {f(c['seconds_with_load'], 3)} s"
           for c in pipe["infer"]]
        + [f"export {fam} {f(pipe[f'export_{fam}']['seconds'], 3)} s, "
           f"{f(pipe[f'export_{fam}']['artifact_mb'], 4)} MB, bit-equal "
           f"{all(pipe[f'export_{fam}']['bit_equal'].values())}" for fam in ("acoustic", "variance")])
    return [f"[summary] {name} {f(seconds.get(name, float('nan')), 4)} s: {line}"
            for name, line in lines.items()]


def main() -> None:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not (ROOT / "diffsinger_tpu_torch" / "ops" / "csrc").is_dir():
        fail("the diffsinger_tpu_torch package is not beside this script")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.models.backbones.lynxnet import LYNXConvModule
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
    from diffsinger_tpu_torch.ops import depthwise_conv, flash_attention, lynx_fused, native
    from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import Generator, NsfHifiGanConfig

    dev = torch.device("cuda")
    report = {"phases": {}}
    counters = {"K1": depthwise_conv, "K2": lynx_fused, "K3": flash_attention}

    def reset_counts():
        for m in counters.values():
            m.launches = 0
        flash_attention.bwd_launches = 0

    def read_counts():
        return {k: m.launches for k, m in counters.items()}

    marks = []  # (phase, its start on the host clock)

    def mark(phase):
        marks.append((phase, time.perf_counter()))

    # ------------------------------------------------------------ 1. card + build
    mark("build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else "nvidia-smi unavailable"
    log(card)
    report["card"] = card
    t0 = time.perf_counter()
    built = native.build()
    build_s = time.perf_counter() - t0
    for name in native.KERNEL_SOURCES:
        native.load(name)
    log(f"[build] {len(built)} kernel libraries built in {build_s:.1f} s "
        f"({', '.join(f'{n} {s:.1f} s' for n, (s, _) in built.items())})")
    report["build"] = {"seconds": build_s}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text(
        "".join(f"--- {n}: {sec:.1f} s\n{msg}\n" for n, (sec, msg) in built.items()))

    # ------------------------------------------------------------ 2. kernels
    mark("kernels")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    bf = torch.bfloat16
    checks = []

    def check(name, got, want, tol):
        err = max_err(got, want)
        ok = math.isfinite(err) and err <= tol
        checks.append({"name": name, "max_abs_err": err, "tol": tol, "ok": ok})
        log(f"[kernels] {name}: max|err| {err:.3e} (tolerance {tol:.3e}) {'ok' if ok else 'MISS'}")
        return err

    # K1 at K2's middle stage: s [16, 1024, 2048] bf16, k = 31
    I = 2048
    s = randn(B, T_MEL, I, dtype=bf)
    dw_w, dw_b = randn(I, 31, dtype=bf, scale=0.2), randn(I, dtype=bf, scale=0.1)
    alpha = (0.1 + 0.3 * torch.rand(I, generator=gen, device=dev)).to(bf)
    k1_args = (s, dw_w, alpha, dw_b)
    want = depthwise_conv.depthwise_conv1d_prelu_plain(*k1_args)
    # bf16 outputs: one bf16 ulp of the largest output (both sum in float32)
    k1_err = check("K1 bf16 [16,1024,2048] k=31", depthwise_conv.depthwise_conv1d_prelu(*k1_args),
                   want, 2 ** -7 * want.float().abs().max().item())

    # K1 where its tiles break: T ragged against every tile, T under the halo,
    # an even k (padding 2 left, 1 right), k = 1 and 61, C = 100 (not a multiple
    # of 8: the generic kernel). A large value in the last row of sequence 0
    # must not reach sequence 1, whose rows are held to a tolerance of their own.
    def k1_case(dtype, b, t, c, k, with_bias=True):
        xk = randn(b, t, c, dtype=dtype)
        xk[0, -1] = 100.0
        args = (xk, randn(c, k, dtype=dtype, scale=0.2),
                (0.1 + 0.3 * torch.rand(c, generator=gen, device=dev)).to(dtype),
                randn(c, dtype=dtype, scale=0.1) if with_bias else None)
        before = depthwise_conv.launches
        got = depthwise_conv.depthwise_conv1d_prelu(*args)
        if depthwise_conv.launches != before + 1:
            fail("K1's launch counter did not move")
        want_k = depthwise_conv.depthwise_conv1d_prelu_plain(*args)

        def tol(ref):  # float32: summation order; bf16: one ulp of the largest output
            return 1e-4 if dtype == torch.float32 else 2 ** -7 * ref.float().abs().max().item()

        name = "K1 %s [%d,%d,%d] k=%d%s" % ("f32" if dtype == torch.float32 else "bf16", b, t, c, k,
                                           "" if with_bias else " no bias")
        check(name, got, want_k, tol(want_k))
        if b > 1:
            check(name + ", sequences after the first", got[1:], want_k[1:], tol(want_k[1:]))

    for case in ((bf, 3, 333, 2048, 31), (bf, 5, 77, 160, 7), (bf, 1, 17, 64, 31),
                 (torch.float32, 2, 100, 100, 4, False), (bf, 2, 50, 64, 61), (bf, 2, 50, 64, 1)):
        k1_case(*case)

    # K2 at the main path: x [16, 1024, 1024] bf16, C=1024, I=2048, k=31
    torch.manual_seed(1)
    conv_mod = LYNXConvModule(1024, 2, 31).to(dev)
    seeded_weights(conv_mod, 2)
    with torch.no_grad():
        conv_mod.net[0].weight.add_(0.2 * torch.randn(1024, generator=gen, device=dev))
    conv_bf = LYNXConvModule(1024, 2, 31).to(dev, bf)
    conv_bf.load_state_dict(conv_mod.state_dict())
    x = randn(B, T_MEL, 1024, dtype=bf)
    k2_params = {n: p.detach() for n, p in lynx_fused.conv_module_params_from_module(conv_bf).items()}
    want = lynx_fused.fused_conv_module_plain(x, **k2_params)
    # bf16: two bf16 ulps of the largest output; intermediates rounded to bf16
    # on both sides may land one ulp apart where float32 sums differ in order
    k2_err = check("K2 bf16 [16,1024,1024] I=2048 k=31",
                   lynx_fused.fused_conv_module(x, **k2_params), want,
                   2 ** -6 * want.float().abs().max().item())
    # K2 bf16 where the tiles are ragged: M = 999 rows, and widths C = 96, I = 160
    def k2_case(b, t, c, inner, k):
        def rnd(*shape, scale=1.0):
            return randn(*shape, dtype=bf, scale=scale)

        params = dict(ln_scale=1 + rnd(c, scale=0.2), ln_bias=rnd(c, scale=0.1),
                      w1=rnd(2 * inner, c, scale=c ** -0.5), b1=rnd(2 * inner, scale=0.1),
                      dw_w=rnd(inner, k, scale=0.2), dw_b=rnd(inner, scale=0.1),
                      alpha=0.25 + rnd(inner, scale=0.1),
                      w2=rnd(c, inner, scale=inner ** -0.5), b2=rnd(c, scale=0.1))
        return rnd(b, t, c), params

    for shape in ((3, 333, 1024, 2048, 31), (5, 77, 96, 160, 7)):
        xr, params_r = k2_case(*shape)
        want_r = lynx_fused.fused_conv_module_plain(xr, **params_r)
        check("K2 bf16 ragged x [%d,%d,%d] I=%d k=%d" % shape,
              lynx_fused.fused_conv_module(xr, **params_r), want_r,
              2 ** -6 * want_r.float().abs().max().item())
    # K2 float32 at a small, ragged shape
    torch.manual_seed(3)
    small = LYNXConvModule(64, 2, 31).to(dev)
    seeded_weights(small, 4)
    xs = randn(2, 100, 64)
    sp = {n: p.detach() for n, p in lynx_fused.conv_module_params_from_module(small).items()}
    check("K2 f32 [2,100,64] I=128 k=31", lynx_fused.fused_conv_module(xs, **sp),
          lynx_fused.fused_conv_module_plain(xs, **sp), 1e-4)

    # K3 at the encoder's shapes, with key padding in two rows
    def attn_case(b, length):
        q, k, v = (randn(b, 2, length, 128) for _ in range(3))
        pad = torch.zeros(b, length, dtype=torch.bool, device=dev)
        pad[1, length - length // 4:] = True
        pad[3, length // 2:] = True
        return q, k, v, pad

    k3_args = attn_case(B, T_TXT)
    k3_err = check("K3 f32 [16,2,128,128] padded", flash_attention.flash_attention(*k3_args),
                   flash_attention.flash_attention_plain(*k3_args), 1e-4)
    long_args = attn_case(B, 512)
    check("K3 f32 [16,2,512,128] padded", flash_attention.flash_attention(*long_args),
          flash_attention.flash_attention_plain(*long_args), 1e-4)
    q2, k2, v2, _ = attn_case(4, 200)  # ragged against every tile, no mask
    check("K3 f32 [4,2,200,128] no mask", flash_attention.flash_attention(q2, k2, v2),
          flash_attention.flash_attention_plain(q2, k2, v2), 1e-4)
    # K3 at a token bucket of 48, the third length a server's chunks can have
    # (the scores of phase 4 give 16 and 32), with every row's tail padded
    def k3_served_case(b, length, d=128):
        q_s, k_s, v_s = (randn(b, 2, length, d) for _ in range(3))
        pad_s = torch.zeros(b, length, dtype=torch.bool, device=dev)
        for i in range(b):  # every row's tail padded, by another amount
            pad_s[i, length - (3 + 5 * i) % 16:] = True
        return q_s, k_s, v_s, pad_s

    for b_s in (1, 16):
        served_args = k3_served_case(b_s, 48)
        check(f"K3 f32 [{b_s},2,48,128] padded", flash_attention.flash_attention(*served_args),
              flash_attention.flash_attention_plain(*served_args), 1e-4)
    torch.cuda.synchronize()
    report["phases"]["kernels"] = checks
    if not all(c["ok"] for c in checks):
        fail("a kernel disagrees with its plain version")

    # ------------------------------------------------------------ 3. e2e
    mark("e2e")
    hp = load_config(ROOT / "configs" / "acoustic.yaml", "sampling_steps=50")
    n_mels = hp["audio_num_mel_bins"]
    n_layers = hp["backbone_args"]["num_layers"]
    n_enc = hp["enc_layers"]
    torch.manual_seed(5)
    model32 = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=n_mels, dtype=torch.float32)
    seeded_weights(model32.module, 6)
    model = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=n_mels, dtype=bf)
    model.module.load_state_dict(model32.module.state_dict())
    voc_cfg = NsfHifiGanConfig(num_mels=n_mels, sampling_rate=hp["audio_sample_rate"],
                               mini_nsf=True)
    torch.manual_seed(7)
    vocoder32 = Generator(voc_cfg, dtype=torch.float32).eval()
    vocoder = Generator(voc_cfg, dtype=bf).eval()
    vocoder.load_state_dict(vocoder32.state_dict())
    hop = voc_cfg.hop_size

    rng = np.random.default_rng(0)

    def request(b, t_txt, t_mel, ragged=False):
        tokens = rng.integers(1, VOCAB, (b, t_txt))
        mel2ph = np.tile(np.repeat(np.arange(1, t_txt + 1), t_mel // t_txt)[None], (b, 1))
        if ragged:  # later rows: fewer tokens, and frames past their end padded
            for i in range(b):
                n_tok = t_txt - 5 * i
                tokens[i, n_tok:] = 0
                mel2ph[i][mel2ph[i] > n_tok] = 0
        f0 = 220.0 * 2 ** (rng.uniform(-1, 1, (b, 1)) + 0.2 * np.sin(
            np.linspace(0, 20, t_mel))[None])
        return (torch.from_numpy(tokens).to(dev), torch.from_numpy(mel2ph).to(dev),
                torch.from_numpy(f0.astype(np.float32)).to(dev))

    enqueue_s = []  # per request: the host's own time in forward_infer

    def run(m, voc, tokens, mel2ph, f0, noise_seed):
        """One request; returns mel, wav and the acoustic and vocoder seconds."""
        g = torch.Generator(device=dev).manual_seed(noise_seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m.forward_infer(tokens, mel2ph, f0, steps=STEPS, generator=g)
        enqueue_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            wav = voc(out.diff_out, f0)
        torch.cuda.synchronize()
        return out.diff_out, wav, t1 - t0, time.perf_counter() - t1

    def expect_counts(counts, n_req, phase):
        want = {"K1": n_layers * STEPS * n_req, "K2": n_layers * STEPS * n_req,
                "K3": n_enc * n_req}
        log(f"[e2e] {phase}: launches {counts} (expected {want})")
        if counts != want:
            fail(f"{phase}: launch counts {counts} != {want}")

    def check_out(mel, wav, mel2ph, phase):
        b, t_mel = mel2ph.shape
        if mel.shape != (b, t_mel, n_mels) or wav.shape != (b, t_mel * hop):
            fail(f"{phase}: shapes mel {tuple(mel.shape)} wav {tuple(wav.shape)}")
        if not (torch.isfinite(mel).all() and torch.isfinite(wav).all()):
            fail(f"{phase}: non-finite output")
        if (mel[mel2ph == 0] != 0).any():
            fail(f"{phase}: padded frames are not zero")

    # timed requests at the bench shape
    inputs = request(B, T_TXT, T_MEL)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, split = [], []
    for r in range(REQUESTS):
        mel, wav, t_ac, t_voc = run(model, vocoder, *inputs, noise_seed=r)
        times.append(t_ac + t_voc)
        split.append((t_ac, t_voc))
    counts = read_counts()
    main_counts = counts
    expect_counts(counts, REQUESTS, f"{REQUESTS} requests B={B} T_mel={T_MEL}")
    check_out(mel, wav, inputs[1], "requests")
    bench_mel, bench_f0 = mel[:1].float(), inputs[2][:1]  # the vocoders' 11.9 s request
    steady = times[1:]
    fps = B * T_MEL / (sum(steady) / len(steady))
    log(f"[e2e] request times {['%.3f s' % t for t in times]}; steady {fps:.1f} mel frames/s "
        f"({B * T_MEL / min(steady):.1f} best) on {card}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[e2e] split of the steady requests: acoustic "
        f"{['%.3f s' % a for a, _ in split[1:]]}, vocoder {['%.3f s' % v for _, v in split[1:]]}")
    # how long the host needs for the acoustic part when it does not wait for
    # the device at its end: forward_infer from its call to its return
    host = enqueue_s[-REQUESTS:][1:]
    log(f"[e2e] host's own time in forward_infer, steady requests: {['%.3f s' % h for h in host]} "
        f"(acoustic with the wait for the device: {['%.3f s' % a for a, _ in split[1:]]})")
    report["phases"]["requests"] = {
        "times_s": times, "acoustic_vocoder_s": split, "forward_infer_host_s": host,
        "frames_per_s": fps,
        "frames_per_s_best": B * T_MEL / min(steady),
        "launches": counts, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}

    # one profiled request: device time by kernel and the device's idle share
    reset_counts()
    report["phases"]["profile"] = profile_request(lambda: run(model, vocoder, *inputs, 3))
    expect_counts(read_counts(), 1, "profiled request")

    # one request with padding: ragged mel2ph and pad tokens
    padded = request(B, T_TXT, T_MEL, ragged=True)
    reset_counts()
    mel, wav, _, _ = run(model, vocoder, *padded, noise_seed=11)
    torch.cuda.synchronize()
    expect_counts(read_counts(), 1, "padded request")
    check_out(mel, wav, padded[1], "padded request")

    # one long phrase
    long_req = request(1, 512, 4096)
    reset_counts()
    t0 = time.perf_counter()
    mel, wav, _, _ = run(model, vocoder, *long_req, noise_seed=12)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    expect_counts(read_counts(), 1, "long phrase T_txt=512 T_mel=4096")
    check_out(mel, wav, long_req[1], "long phrase")
    log(f"[e2e] long phrase: {long_s:.3f} s, wav {tuple(wav.shape)}; host's own time in "
        f"forward_infer {enqueue_s[-1]:.3f} s")
    report["phases"]["long_phrase_s"] = long_s
    report["phases"]["long_phrase_forward_infer_host_s"] = enqueue_s[-1]

    # reduced-batch float32: kernels against every kernel's plain version
    small_req = request(2, 64, 512, ragged=True)
    reset_counts()
    mel_k, wav_k, _, _ = run(model32, vocoder32, *small_req, noise_seed=13)
    torch.cuda.synchronize()
    expect_counts(read_counts(), 1, "f32 reduced batch")
    reset_counts()
    with plain_kernels():
        mel_p, wav_p, _, _ = run(model32, vocoder32, *small_req, noise_seed=13)
    torch.cuda.synchronize()
    if read_counts() != {"K1": 0, "K2": 0, "K3": 0}:
        fail("the plain run launched a kernel")
    mel_err, wav_err = max_err(mel_k, mel_p), max_err(wav_k, wav_p)
    # float32 throughout, sums in another order over 50 steps: the fidelity
    # bound of BASELINE.md (mel MAE <= 1e-3) as a max, for mel and wav
    log(f"[e2e] f32 B=2 T_mel=512 kernels vs plain: max|mel err| {mel_err:.3e}, "
        f"max|wav err| {wav_err:.3e} (tolerance 1e-3)")
    report["phases"]["f32_vs_plain"] = {"mel": mel_err, "wav": wav_err}
    if not (mel_err <= 1e-3 and wav_err <= 1e-3):
        fail("the float32 slice disagrees with its plain-version run")
    # what bf16 costs in fidelity: the main path's dtype against float32 on the
    # same weights and noise (reported, not held to a bound)
    mel_b, _, _, _ = run(model, vocoder, *small_req, noise_seed=13)
    diff = (mel_b.float() - mel_k).abs()
    log(f"[e2e] bf16 vs f32, same request: mel MAE {diff.mean().item():.3e}, "
        f"max {diff.max().item():.3e} (log-mel units)")
    report["phases"]["bf16_vs_f32_mel"] = {"mae": diff.mean().item(), "max": diff.max().item()}

    # ------------------------------------------------------------ 4. serve
    mark("serve")
    report["phases"]["serve"], serve_counts = serve_phase(
        hp, card, reset_counts, read_counts, report["phases"]["profile"])

    # every kernel once more, at the shapes that the served chunks and the
    # entry point's segments gave it, in the dtype they ran in
    n_before = len(checks)
    for b_s, t_txt_s, t_mel_s in report["phases"]["serve"]["shapes"]:
        before = read_counts()
        s_s = randn(b_s, t_mel_s, I, dtype=bf)
        want_s = depthwise_conv.depthwise_conv1d_prelu_plain(s_s, dw_w, alpha, dw_b)
        check(f"K1 bf16 [{b_s},{t_mel_s},{I}] k=31 (served)",
              depthwise_conv.depthwise_conv1d_prelu(s_s, dw_w, alpha, dw_b), want_s,
              2 ** -7 * want_s.float().abs().max().item())
        x_s = randn(b_s, t_mel_s, 1024, dtype=bf)
        want_s = lynx_fused.fused_conv_module_plain(x_s, **k2_params)
        check(f"K2 bf16 [{b_s},{t_mel_s},1024] I={I} k=31 (served)",
              lynx_fused.fused_conv_module(x_s, **k2_params), want_s,
              2 ** -6 * want_s.float().abs().max().item())
        served_args = k3_served_case(b_s, t_txt_s)
        check(f"K3 f32 [{b_s},2,{t_txt_s},128] padded (served)",
              flash_attention.flash_attention(*served_args),
              flash_attention.flash_attention_plain(*served_args), 1e-4)
        # K2's wrapper launches K1 as its middle stage
        if read_counts() != {"K1": before["K1"] + 2, "K2": before["K2"] + 1,
                             "K3": before["K3"] + 1}:
            fail(f"a launch counter did not move at the served shape {(b_s, t_txt_s, t_mel_s)}")
    if len(checks) == n_before:
        fail("the serve phase reported no chunk shape")
    if not all(c["ok"] for c in checks):
        fail("a kernel disagrees with its plain version at a served shape")

    # ------------------------------------------------------------ 5. variance, ddpm
    mark("variance")
    report["phases"]["variance"], var_counts = variance_phase(
        hp, card, reset_counts, read_counts, check, k3_served_case)
    if not all(c["ok"] for c in checks):
        fail("K3 disagrees with its plain version at a variance shape")
    mark("ddpm")
    report["phases"]["ddpm"], ddpm_counts = ddpm_phase(hp, card, reset_counts, read_counts, request)
    mark("lynx_act")
    report["phases"]["lynx_act"], act_counts, act_kernels = lynx_act_phase(
        hp, card, reset_counts, read_counts, check, request, run, vocoder)
    mark("vocoders")
    report["phases"]["vocoders"] = vocoders_phase(card, reset_counts, read_counts, hp,
                                                  bench_mel, bench_f0)
    mark("export")
    report["phases"]["export"], export_counts = export_phase(card, reset_counts, read_counts)
    mark("train")
    report["phases"]["train"], train_counts, bwd_cases = train_phase(
        card, reset_counts, read_counts, check)
    if not all(c["ok"] for c in checks):
        fail("K3's backward disagrees with its plain version")
    mark("train_variance")
    report["phases"]["train_variance"], var_train_counts, var_cases = train_variance_phase(
        card, reset_counts, read_counts, check)
    if not all(c["ok"] for c in checks):
        fail("K3 or its backward disagrees with its plain version at a variance training shape")
    mark("train_remat")
    report["phases"]["train_remat"], remat_counts = train_remat_phase(card, reset_counts,
                                                                      read_counts)
    mark("train_dist")
    report["phases"]["train_dist"], dist_counts = train_dist_phase(hp, card, reset_counts,
                                                                   read_counts)
    mark("binarize")
    report["phases"]["binarize"], bin_counts = binarize_phase(card, reset_counts, read_counts)
    mark("binarize_ext")
    report["phases"]["binarize_ext"], ext_counts = binarize_ext_phase(card, reset_counts,
                                                                      read_counts)
    mark("pipeline")
    report["phases"]["pipeline"], pipe_counts = pipeline_phase(card, reset_counts, read_counts)

    # ------------------------------------------------------------ 6. kernel line
    mark("times")
    x_t = s.transpose(1, 2).contiguous()
    w_conv = dw_w[:, None, :].contiguous()
    q, k, v, pad = k3_args
    visible = pad[:, None, :, None] == pad[:, None, None, :]
    bt = B * T_MEL
    c_enc, i_enc = 1024, I
    # K1: 2k float32 operations per output; bytes: s in, out, taps, bias, alpha
    k1_ops = 2 * 31 * bt * I
    k1_bytes = 2 * (2 * bt * I) + 2 * (I * 31 + 2 * I)
    # K2: the two products on the tensor cores, the taps on the CUDA cores;
    # bytes: x in, y out, weights once
    k2_tc = 2 * bt * c_enc * 2 * i_enc + 2 * bt * i_enc * c_enc
    k2_simt = 2 * 31 * bt * i_enc
    k2_bytes = 2 * (2 * bt * c_enc) + 2 * (2 * i_enc * c_enc + i_enc * c_enc + 31 * i_enc
                                          + 4 * i_enc + 4 * c_enc)
    # K3: only the visible (query, key) pairs are needed: QK^T and PV
    def k3_bound(q, pad):
        pairs = int((pad[:, None, :, None] == pad[:, None, None, :]).sum().item()) * q.shape[1]
        return 4 * pairs * q.shape[-1], 4 * 4 * q.numel() + pad.numel()

    k3_ops, k3_bytes = k3_bound(q, pad)

    # K1 at the long phrase's shape (B=1, T_mel=4096), where the grid is thinnest
    s_l = randn(1, 4096, I, dtype=bf)
    k1_long_args = (s_l, dw_w, alpha, dw_b)
    want_l = depthwise_conv.depthwise_conv1d_prelu_plain(*k1_long_args)
    check("K1 bf16 [1,4096,2048] k=31", depthwise_conv.depthwise_conv1d_prelu(*k1_long_args),
          want_l, 2 ** -7 * want_l.float().abs().max().item())
    if not checks[-1]["ok"]:
        fail("K1 disagrees with its plain version at the long phrase's shape")
    x_tl = s_l.transpose(1, 2).contiguous()
    k1_long = {
        "ms": time_ms(lambda: depthwise_conv.depthwise_conv1d_prelu(*k1_long_args)),
        "bound_ms": max((2 * (2 * s_l.numel()) + 2 * (I * 31 + 2 * I)) / PEAK_BYTES,
                        2 * 31 * s_l.numel() / PEAK_F32) * 1e3,
        "plain_ms": time_ms(lambda: depthwise_conv.depthwise_conv1d_prelu_plain(*k1_long_args), 5, 1),
        "library_ms": time_ms(lambda: F.conv1d(x_tl, w_conv, dw_b, padding=15, groups=I)),
    }
    log("[time] K1 depthwise_conv1d_prelu at [1,4096,2048] k=31: %(ms).4f ms (bound %(bound_ms).4f "
        "ms by bytes; plain %(plain_ms).4f ms; library %(library_ms).4f ms)" % k1_long
        + " (tile %d x %d)" % depthwise_conv.choose_tile(1, 4096, I, 31) + f" on {card}")
    report["k1_long"] = k1_long

    # K3 at the long shape, where arithmetic and not the launch bounds it
    ql, kl, vl, padl = long_args
    visible_l = padl[:, None, :, None] == padl[:, None, None, :]
    ops_l, bytes_l = k3_bound(ql, padl)
    k3_long = {
        "ms": time_ms(lambda: flash_attention.flash_attention(*long_args)),
        "bound_ms": max(ops_l / PEAK_F32, bytes_l / PEAK_BYTES) * 1e3,
        "plain_ms": time_ms(lambda: flash_attention.flash_attention_plain(*long_args), 5, 1),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=visible_l)),
    }
    log("[time] K3 flash_attention at [16,2,512,128]: %(ms).4f ms (bound %(bound_ms).4f ms by "
        "operations; plain %(plain_ms).4f ms; library %(library_ms).4f ms)" % k3_long + f" on {card}")
    report["k3_long"] = k3_long

    # K2's two GEMMs alone, through the library's C interface
    lib = native.load("lynx_fused")
    stream = native.stream_ptr(x)
    mean = torch.empty(bt, device=dev)
    rstd = torch.empty(bt, device=dev)
    native.check(lib.ds_lynx_ln_stats(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), bt, c_enc,
                                      lynx_fused.LN_EPS, 1, stream), "ln_stats")
    s_buf, y_buf = torch.empty_like(s), torch.empty_like(x)
    p2 = k2_params
    gemms = {}
    for name, flop, fn in (
        ("pw1", 2 * bt * c_enc * 2 * i_enc, lambda: native.check(lib.ds_lynx_pw1_swiglu(
            x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), p2["ln_scale"].data_ptr(),
            p2["ln_bias"].data_ptr(), p2["w1"].data_ptr(), p2["b1"].data_ptr(),
            s_buf.data_ptr(), bt, c_enc, i_enc, 1, stream), "pw1")),
        ("pw2", 2 * bt * i_enc * c_enc, lambda: native.check(lib.ds_lynx_pw2(
            s.data_ptr(), p2["w2"].data_ptr(), p2["b2"].data_ptr(), y_buf.data_ptr(),
            bt, i_enc, c_enc, 1, stream), "pw2")),
    ):
        ms = time_ms(fn)
        gemms[name] = {"ms": ms, "tflops": flop / ms / 1e9}
        log(f"[time] K2 {name} alone: {ms:.4f} ms, {flop / ms / 1e9:.1f} TFLOP/s bf16 on {card}")
    log(f"[time] K2 pw1 + pw2: {gemms['pw1']['ms'] + gemms['pw2']['ms']:.4f} ms")
    report["k2_gemms"] = gemms
    lines = [
        ("K1", "depthwise_conv1d_prelu", "diffsinger_tpu_torch/ops/csrc/depthwise_conv.cu",
         "diffsinger_tpu/ops/depthwise_conv.py:83", k1_err,
         lambda: depthwise_conv.depthwise_conv1d_prelu(*k1_args),
         lambda: depthwise_conv.depthwise_conv1d_prelu_plain(*k1_args),
         lambda: F.conv1d(x_t, w_conv, dw_b, padding=15, groups=I),
         max(k1_bytes / PEAK_BYTES, k1_ops / PEAK_F32), k1_bytes / PEAK_BYTES >= k1_ops / PEAK_F32),
        ("K2", "fused_conv_module", "diffsinger_tpu_torch/ops/csrc/lynx_fused.cu",
         "diffsinger_tpu/ops/lynx_fused.py:153", k2_err,
         lambda: lynx_fused.fused_conv_module(x, **k2_params),
         lambda: lynx_fused.fused_conv_module_plain(x, **k2_params),
         None,
         max(k2_bytes / PEAK_BYTES, k2_tc / PEAK_BF16_TC, k2_simt / PEAK_F32),
         k2_bytes / PEAK_BYTES >= max(k2_tc / PEAK_BF16_TC, k2_simt / PEAK_F32)),
        ("K3", "flash_attention", "diffsinger_tpu_torch/ops/csrc/flash_attention.cu",
         "diffsinger_tpu/models/commons.py:206", k3_err,
         lambda: flash_attention.flash_attention(*k3_args),
         lambda: flash_attention.flash_attention_plain(*k3_args),
         lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=visible),
         max(k3_bytes / PEAK_BYTES, k3_ops / PEAK_F32), k3_bytes / PEAK_BYTES >= k3_ops / PEAK_F32),
    ]
    kernels = []
    for key, name, src, replaces, err, fn, plain, lib, bound_s, by_bytes in lines:
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_counts[key],
            "launches_per_request": main_counts[key] // REQUESTS,
            "launches_served_score": serve_counts[key],
            "launches_variance_score": var_counts[key],
            "launches_ddpm_request": {acc: c[key] for acc, c in ddpm_counts.items()},
            "launches_silu_requests": act_counts[key],
            "launches_export_request": export_counts[key],
            "launches_train_steps": train_counts[key],
            "launches_train_variance_steps": var_train_counts[key],
            "launches_train_dist_ddp_steps": dist_counts[key],
            "launches_train_remat_step": {p: c[key] for p, c in remat_counts.items()},
            "launches_pipeline": {cmd: c[key] for cmd, c in pipe_counts.items()},
            "launches_binarize": bin_counts[key],
            "launches_binarize_ext": ext_counts[key],
            "max_abs_err": err,
            "ms": time_ms(fn),
            "plain_ms": time_ms(plain, iters=5, warmup=1),
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": time_ms(lib) if lib is not None else None,
        }
        kernels.append(entry)
        log(f"[time] {key} {name}: {entry['ms']:.4f} ms (bound {entry['bound_ms']:.4f} ms by "
            f"{entry['bound_by']}; plain {entry['plain_ms']:.4f} ms; library "
            f"{entry['library_ms'] if entry['library_ms'] is None else '%.4f ms' % entry['library_ms']}) "
            f"on {card}")
    kernels += act_kernels  # K1 and K2 with SiLU and ReLU, timed in [lynx_act]
    # K3's backward at the training batch's shape and the long shape: the
    # wrapper (dK/dV with delta and dS, then dQ), each kernel alone, the plain
    # backward and SDPA's backward; the bound of the route the kernel takes
    # (3xTF32: three TF32 products for each), and beside it the bound of the
    # same work in float32 on the CUDA cores
    lib = native.load("flash_attention")

    def k3_bwd_times(qb, kb, vb, padb, outb, lseb, doutb, bwd_errs):
        b_ = qb.shape[0]
        scale = qb.shape[-1] ** -0.5
        visible_b = padb[:, None, :, None] == padb[:, None, None, :]
        pairs_b = int(visible_b.sum().item()) * qb.shape[1]
        bwd_ops = 10 * pairs_b * qb.shape[-1]  # five products over the visible pairs
        # q k v o dO in, dq dk dv out
        bwd_bytes = 4 * 8 * qb.numel() + 4 * lseb.numel() + padb.numel()
        _, h_, l_, d_ = qb.shape
        ds = flash_attention.bwd_scratch(b_ * h_, l_, dev)
        grads = [torch.empty_like(qb) for _ in range(3)]
        args = [t.data_ptr() for t in (qb, kb, vb, padb.view(torch.uint8), outb, doutb, lseb, ds,
                                       *grads)]
        stream = native.stream_ptr(qb)

        def part(bits):
            return lambda: native.check(lib.ds_flash_attn_bwd(*args, b_, h_, l_, d_, scale, bits,
                                                              stream), "flash_attention bwd")

        alone = {name: time_ms(part(bits)) for name, bits in
                 (("dkv_ms", 1), ("dq_ms", 2), ("both_ms", 3))}
        qs_, ks_, vs_ = (t.clone().requires_grad_() for t in (qb, kb, vb))
        sdpa_out = F.scaled_dot_product_attention(qs_, ks_, vs_, attn_mask=visible_b)
        f32_s, route_s = bwd_ops / PEAK_F32, 3 * bwd_ops / PEAK_TF32
        bytes_s = bwd_bytes / PEAK_BYTES
        times = {
            "max_abs_err": max(bwd_errs),
            "ms": time_ms(lambda: flash_attention.flash_attention_bwd(
                qb, kb, vb, padb, outb, lseb, doutb, sm_scale=scale)),
            "plain_ms": time_ms(lambda: flash_attention.flash_attention_bwd_plain(
                qb, kb, vb, padb, outb, lseb, doutb, sm_scale=scale), iters=5, warmup=1),
            # the route taken: 3xTF32 on the tensor cores
            "bound_ms": max(bytes_s, route_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= route_s else "operations",
            # the same work in float32 on the CUDA cores, the earlier design's route
            "bound_f32_cores_ms": max(bytes_s, f32_s) * 1e3,
            "bound_f32_cores_by": "bytes" if bytes_s >= f32_s else "operations",
            "flop": bwd_ops, "bytes": bwd_bytes,
            "library_ms": time_ms(lambda: torch.autograd.grad(sdpa_out, (qs_, ks_, vs_), doutb,
                                                              retain_graph=True)),
            **alone,
        }
        log(f"[time] K3-bwd flash_attention_bwd at [{b_},{h_},{l_},{d_}] padded: "
            f"{times['ms']:.4f} ms a wrapper call (dK/dV with delta {times['dkv_ms']:.4f}, dQ "
            f"{times['dq_ms']:.4f}, both {times['both_ms']:.4f} ms alone; bound "
            f"{times['bound_ms']:.4f} ms by {times['bound_by']} in 3xTF32, "
            f"{times['bound_f32_cores_ms']:.4f} ms by {times['bound_f32_cores_by']} in float32 on "
            f"the CUDA cores; plain "
            f"{times['plain_ms']:.4f} ms; SDPA backward {times['library_ms']:.4f} ms) on {card}")
        return times

    train_times = k3_bwd_times(*bwd_cases[(TRAIN_B, TRAIN_T_TXT)])
    report["k3_bwd_long"] = k3_bwd_times(*bwd_cases[(16, 512)])
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "diffsinger_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
                    "(_flash_attention_bwd_dkv) and :1456 (_flash_attention_bwd_dq), jax 0.9.0, "
                    "under jax.grad of diffsinger_tpu/models/commons.py:206",
        "launches": train_counts["K3bwd"],
        "launches_per_train_step": train_counts["K3bwd"] // TRAIN_STEPS,
        "launches_export_request": export_counts["K3bwd"],
        "launches_train_variance_steps": var_train_counts["K3bwd"],
        "launches_train_dist_ddp_steps": dist_counts["K3bwd"],
        "launches_train_remat_step": {p: c["K3bwd"] for p, c in remat_counts.items()},
        "launches_pipeline": {cmd: c["K3bwd"] for cmd, c in pipe_counts.items()},
        "launches_binarize": bin_counts["K3bwd"],
        "launches_binarize_ext": ext_counts["K3bwd"],
        **train_times,
    })

    # K3 and its backward at the variance model's training shapes: the
    # encoder's (launched in [train_variance]'s timed steps) and the melody
    # encoder's head width 64 (launched by its full-width forward and backward)
    melody_counts = report["phases"]["train_variance"]["melody_encoder_launches"]
    bwd_replaces = kernels[-1]["replaces"]
    for what, case in var_cases.items():
        qv, kv, vv, padv = case["q"], case["k"], case["v"], case["pad"]
        shape = "[%d,%d,%d,%d]" % tuple(qv.shape)
        ops_v, bytes_v = k3_bound(qv, padv)
        visible_v = padv[:, None, :, None] == padv[:, None, None, :]
        scale_v = qv.shape[-1] ** -0.5
        if what == "encoder":
            fwd_n, bwd_n = var_train_counts["K3"], var_train_counts["K3bwd"]
            origin = f"[train_variance]'s {TRAIN_STEPS} timed steps"
        else:
            fwd_n, bwd_n = melody_counts["K3"], melody_counts["K3bwd"]
            origin = ("[train_variance]'s full-width melody encoder (4 layers of two heads of "
                      "64), one forward and backward at this shape")
        fwd = {
            "name": f"flash_attention at {shape} ({what}, variance training)", "route": "cuda",
            "source": "diffsinger_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "diffsinger_tpu/models/commons.py:206",
            "launches": fwd_n, "launches_from": origin, "max_abs_err": case["fwd_err"],
            "ms": time_ms(lambda: flash_attention.flash_attention(qv, kv, vv, padv,
                                                                  sm_scale=scale_v)),
            "plain_ms": time_ms(lambda: flash_attention.flash_attention_plain(
                qv, kv, vv, padv, sm_scale=scale_v), 5, 1),
            "bound_ms": max(ops_v / PEAK_F32, bytes_v / PEAK_BYTES) * 1e3,
            "bound_by": "bytes" if bytes_v / PEAK_BYTES >= ops_v / PEAK_F32 else "operations",
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qv, kv, vv,
                                                                         attn_mask=visible_v)),
        }
        log(f"[time] K3 flash_attention at {shape} ({what}, variance training): "
            f"{fwd['ms']:.4f} ms (bound {fwd['bound_ms']:.4f} ms by {fwd['bound_by']}; plain "
            f"{fwd['plain_ms']:.4f} ms; SDPA {fwd['library_ms']:.4f} ms) on {card}")
        bwd = {
            "name": f"flash_attention_bwd at {shape} ({what}, variance training)",
            "route": "cuda", "source": "diffsinger_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": bwd_replaces,
            "launches": bwd_n, "launches_from": origin,
            **k3_bwd_times(qv, kv, vv, padv, case["out"], case["lse"], case["dout"],
                           case["bwd_errs"]),
        }
        kernels += [fwd, bwd]
    report["kernels"] = kernels

    report["script_s"] = time.perf_counter() - t_script
    log(f"[time] the whole script: {report['script_s']:.1f} s")
    mark("end")
    report["phase_s"] = {name: end - start for (name, start), (_, end) in zip(marks, marks[1:])}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    for line in phase_summaries(report, report["phase_s"]):
        log(line)
    log(f"[summary] {report['script_s']:.1f} s in all on {card}")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
