"""Songs rendered by the WaveNet-DDPM acoustic model through
``AcousticServer.synthesize_batch``: ``serve_acoustic``'s closed loop, server,
noise, requests and comparison, with this model's reference, work and
instrumentation.

The server is built as ``serve_acoustic`` builds it, from an experiment
folder whose config is ``acoustic_wavenet``'s (a 20 x 512 WaveNet under
shallow DDPM, DDIM at speedup 10: 40 denoiser calls a chunk). The chunk's
noise starts the shallow diffusion from the draft.

In a traced run ``instrument`` turns the program's spans and counters on
(``utils/tracing.py``) and the window's device time is charged to them
(``RANGES``: every name of ``tracing.NAMES``, innermost first, then the
benchmark's ``server.request``); the residual stacks' least time comes from
the counter ``wavenet.stack_frames`` and the blocks' counters
(``work_wavenet.stack_least_seconds``).
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark import generator, serving, weights, work, work_wavenet
from benchmark.drivers.serve_acoustic import (ACOUSTIC_KEY, VOCODER_KEY, Noise,  # noqa: F401
                                              build_server, compare, frames, request, serve,
                                              weight_values)
from benchmark.reference import preprocess as pp
from benchmark.reference.acoustic_wavenet import AcousticWaveNetReference
from benchmark.reference.vocoder import VocoderReference
from diffsinger_tpu_torch.utils import tracing

RANGES = tuple(tracing.NAMES) + ("server.request",)  # innermost first
STACK = "ds.wavenet.stack"


def instrument(run, server) -> Dict:
    """The program's spans and counters on, from zero; the padded and true
    frames of every chunk stacked (traced runs only)."""
    tracing.enable(True)
    program = tracing.counters()
    program.clear()
    counts = {"padded_frames": 0, "true_frames": 0, "program": program}
    stack = server._stack

    def counted_stack(batches, idxs, t_txt, t_mel):
        out = stack(batches, idxs, t_txt, t_mel)
        counts["padded_frames"] += out["mel2ph"].size
        counts["true_frames"] += int((out["mel2ph"] > 0).sum())
        return out
    server._stack = counted_stack
    return counts


def stack_least_seconds(run, program: Dict) -> float:
    """The least time for the window's residual stacks, from the counters;
    0 where the program has no frame counter."""
    bb = run.config["hparams"]["backbone_args"]
    frames = program.get("wavenet.stack_frames", 0)
    blocks = program.get("wavenet.fused_blocks", 0) + program.get("wavenet.stock_blocks", 0)
    if not frames:
        return 0.0
    return work_wavenet.stack_least_seconds(frames, blocks / bb["num_layers"],
                                            bb["num_channels"], bb["num_layers"])


def reference(run, pool, picks, lowp=None) -> Dict[Tuple[int, int], np.ndarray]:
    """The picked phrases rendered by the plain reference (``lowp``: the
    control's precision), each alone at its chunk's padded sizes with its
    chunk row's noise, cut and rounded to 16 bits as the server ships them."""
    hp, dev = run.config["hparams"], run.device
    ts = serving.timestep(hp)
    ids = pp.phoneme_ids(generator.DICTIONARY)
    ref = AcousticWaveNetReference(hp, max(ids.values()) + 1, lowp=lowp).to(dev)
    weights.fill(ref, weight_values(run, ref, ACOUSTIC_KEY))
    voc = VocoderReference(run.config["vocoder"], lowp=lowp).to(dev)
    weights.fill(voc, weight_values(run, voc, VOCODER_KEY))
    hop, m = hp["hop_size"], hp["audio_num_mel_bins"]

    def row(x, length, dtype):
        return torch.as_tensor(pp.pad(x, length)[None], dtype=dtype, device=dev)

    out = {}
    for k in sorted({k for k, _ in picks}):
        arrays = [pp.acoustic_arrays(seg, ids, ts) for seg in pool[k % len(pool)]]
        noise = Noise(run.seed, k, dev, hop)
        for n, (chunk, t_txt, t_mel) in enumerate(pp.acoustic_chunks(
                arrays, run.mix["max_batch_size"])):
            rows = [(j, i) for j, i in enumerate(chunk) if (k, i) in picks]
            if not rows:
                continue
            z = noise.sampler(n, (len(chunk), t_mel, m))
            rand_ini, source = noise.vocoder(n, len(chunk), t_mel)
            for j, i in rows:
                a = arrays[i]
                f0 = row(a["f0"], t_mel, torch.float32)
                mel = ref(row(a["tokens"], t_txt, torch.long), row(a["mel2ph"], t_mel, torch.long),
                          f0, z[j:j + 1])
                wav = (torch.clamp(voc(mel, f0, rand_ini, source[j:j + 1]), -1, 1)
                       * 32767.0).to(torch.int16)
                out[(k, i)] = wav[0, :len(a["mel2ph"]) * hop].cpu().numpy()
            del z, source
    return out


def flops(run, seg: dict, n_frames: int) -> float:
    """The products of one phrase at its true lengths: the acoustic model
    (40 WaveNet calls) and the vocoder."""
    hp = run.config["hparams"]
    return (work_wavenet.acoustic(1, len(seg["ph_seq"].split()), n_frames, hp)
            + work.vocoder(1, n_frames, run.config["vocoder"]))


def run(run) -> None:
    try:
        serving.run_cell(run, sys.modules[__name__])
    finally:
        tracing.enable(False)
    counts = run.layer.get("counts") or {}
    if "program" in counts:
        counts["program"] = dict(counts["program"])
        run.layer["wavenet_least_s"] = stack_least_seconds(run, counts["program"])
