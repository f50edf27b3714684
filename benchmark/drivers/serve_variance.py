"""Score-only songs through ``VarianceServer.predict_batch``: a closed loop
with one client, each request one song, as ``cli.infer variance
--batch_size 16`` completes a score: phoneme durations, then the pitch
curve, then the curves among energy, breathiness, voicing and tension that
the configuration predicts (the published one: none).

Set-up, window and check as in ``serve_acoustic``: the server built from an
experiment folder and given weights made on the card, every song served
once to warm up, songs served until ``--seconds`` have passed. ``song_s_per_s`` is
the seconds of score predicted (frames x hop / sample rate) over the
window's seconds. The samplers' first draws are handed in (``noise_fn``).
After the window the sampled phrases are predicted again by the plain
reference in float32 at their chunk's padded sizes, and compared: the
durations in frames, the pitch in semitones, each curve as a share of its
range where there are curves, each by its largest gap.
"""

from __future__ import annotations

import sys
import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import generator, serving, weights, work
from benchmark.harness import Check
from benchmark.reference import preprocess as pp
from benchmark.reference.variance import VarianceReference

RANGES = ("wavenet", "encoder", "server.preprocess", "server.enqueue", "server.fetch",
          "server.request")  # innermost first
WEIGHTS_KEY = 1 << 41


def build_server(run):
    from diffsinger_tpu_torch.inference.serving import VarianceServer

    exp = run.scratch / "variance"
    exp.mkdir(parents=True, exist_ok=True)
    hp = dict(run.config["hparams"], work_dir=str(exp), dictionary=str(generator.DICTIONARY))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*RANDOM weights.*")
        server = VarianceServer(hp, max_batch_size=run.mix["max_batch_size"], device=run.device)
    weights.fill(server.model.module, weight_values(run, server.model.module))
    return server


def weight_values(run, module) -> Dict[str, torch.Tensor]:
    return weights.make(weights.shapes_of(module), serving.stream(run.seed, WEIGHTS_KEY),
                        run.device, torch.float32)


def noise_fn(run, k: int):
    """Request ``k``'s first draws of the pitch and the variance sampler, by chunk."""
    def draw(chunk: int, name: str, shape):
        g = torch.Generator(device=run.device).manual_seed(
            serving.stream(run.seed, k, chunk, 0 if name == "noise_pitch" else 1))
        return torch.randn(shape, generator=g, device=run.device)
    return draw


def instrument(run, server) -> Dict:
    tr = run.tracer
    counts = {"padded_frames": 0, "true_frames": 0}
    serving.wrap(tr, server, "_preprocess_all", "server.preprocess")
    serving.wrap(tr, server, "_run_padded", "server.enqueue")
    serving.wrap(tr, server, "collect", "server.fetch")
    stack = server.stack_chunk

    def counted(batches, chunk, buckets):
        counts["padded_frames"] += len(chunk) * buckets[3]
        counts["true_frames"] += sum(batches[i]["base_pitch"].shape[1] for i in chunk)
        return stack(batches, chunk, buckets)
    server.stack_chunk = counted
    m = server.model.module
    serving.ranged(tr, m.pitch_denoiser, "wavenet")
    if m.var_list:
        serving.ranged(tr, m.variance_denoiser, "wavenet")
    serving.ranged(tr, m.fs2, "encoder")
    return counts


def reference(run, pool, picks, lowp=None) -> Dict[Tuple[int, int], tuple]:
    """The picked phrases predicted by the plain reference (``lowp``: the
    control's precision), each alone at its chunk's padded sizes with its
    chunk row's draws, cut to the phrase."""
    hp, dev = run.config["hparams"], run.device
    ts = serving.timestep(hp)
    ids = pp.phoneme_ids(generator.DICTIONARY)
    ref = VarianceReference(hp, max(ids.values()) + 1, lowp=lowp).to(dev)
    weights.fill(ref, weight_values(run, ref))
    smooth = max(1, round(hp["midi_smooth_width"] / ts))

    def row(x, length, dtype):
        return torch.as_tensor(pp.pad(x, length)[None], dtype=dtype, device=dev)

    out = {}
    for k in sorted({k for k, _ in picks}):
        arrays = [pp.variance_arrays(seg, ids, ts, smooth) for seg in pool[k % len(pool)]]
        draw = noise_fn(run, k)
        for n, (chunk, (t_ph, t_w, _t_n, t_s)) in enumerate(pp.variance_chunks(
                arrays, run.mix["max_batch_size"])):
            rows = [(j, i) for j, i in enumerate(chunk) if (k, i) in picks]
            if not rows:
                continue
            b = len(chunk)
            z_pitch = draw(n, "noise_pitch", (b, t_s, hp["pitch_prediction_args"]["repeat_bins"]))
            z_var = (draw(n, "noise_variances",
                          (b, t_s, hp["variances_prediction_args"]["total_repeat_bins"]))
                     if ref.var_list else None)
            for j, i in rows:
                a = arrays[i]
                dur, pitch, curves = ref(
                    row(a["tokens"], t_ph, torch.long), row(a["midi"], t_ph, torch.long),
                    row(a["ph2word"], t_ph, torch.long), row(a["word_dur"], t_w, torch.long),
                    row(a["base_pitch"], t_s, torch.float32), row(a["expr"], t_s, torch.float32),
                    z_pitch[j:j + 1], None if z_var is None else z_var[j:j + 1])
                n_ph, n_s = len(a["tokens"]), len(a["base_pitch"])
                out[(k, i)] = (dur[0, :n_ph].cpu().numpy(), pitch[0, :n_s].cpu().numpy(),
                               {v: c[0, :n_s].cpu().numpy() for v, c in curves.items()})
    return out


def curve_range(hp: dict, name: str) -> float:
    if name == "tension":
        return hp["tension_logit_max"] - hp["tension_logit_min"]
    return hp[f"{name}_db_max"] - hp[f"{name}_db_min"]


def compare(run, got: Dict, want: Dict) -> List[Check]:
    hp, limits = run.config["hparams"], run.config["limits"]
    dur = pitch = curve = 0.0
    for key, (w_dur, w_pitch, w_curves) in want.items():
        g_dur, g_pitch, g_curves = got[key]
        dur = max(dur, float(np.abs(np.asarray(g_dur, np.int64) - w_dur).max()))
        pitch = max(pitch, float(np.abs(np.asarray(g_pitch, np.float64) - w_pitch).max()))
        for v, w in w_curves.items():
            curve = max(curve, float(np.abs(np.asarray(g_curves[v], np.float64) - w).max())
                        / curve_range(hp, v))
    gaps = [("dur_gap_frames", dur), ("pitch_gap_semitones", pitch)]
    if any(w_curves for _, _, w_curves in want.values()):  # curves only where the config predicts them
        gaps.append(("curve_gap_of_range", curve))
    return [Check(name, value, limits[name]) for name, value in gaps]


def request(run, server):
    return lambda song, k: server.predict_batch(song, seed=0, noise_fn=noise_fn(run, k))


def frames(run, answer: tuple) -> int:
    return len(answer[1])


def flops(run, seg: dict, n_frames: int) -> float:
    return work.variance(1, len(seg["ph_seq"].split()), n_frames, run.config["hparams"])



def run(run) -> None:
    serving.run_cell(run, sys.modules[__name__])
