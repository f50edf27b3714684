"""Songs rendered through ``AcousticServer.synthesize_batch``: a closed loop
with one client, each request one song of ``.ds`` phrases, as
``cli.infer acoustic --batch_size 16`` serves a score.

Set-up builds the server from an experiment folder (config only: the
weights are made on the card from the seed and copied into the loaded
modules), makes the traffic, and serves each of its songs once, which warms
up every chunk shape the window uses. The window then serves songs in the
plan's order until ``--seconds`` have passed; the last song ends it.
``song_s_per_s`` is the audio seconds of every song returned over the
window's seconds.

The sampler's noise and the vocoder's draws are handed in (``noise_fn`` /
``vocoder_noise_fn``), drawn on the card from (seed, song, chunk), so that
the reference can draw them again. After the window the server is freed and
a sample of the returned phrases (the longest among them) is rendered again
by the plain reference, in float32, from the same ``.ds`` text, padding,
weights and noise; each phrase's waveform is compared by its relative RMS
error.
"""

from __future__ import annotations

import json
import sys
import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import generator, serving, weights, work
from benchmark.harness import Check, rel_rms
from benchmark.reference import preprocess as pp
from benchmark.reference.acoustic import AcousticReference
from benchmark.reference.vocoder import VocoderReference

RANGES = ("lynxnet.convmodule", "vocoder", "encoder", "server.preprocess", "server.enqueue",
          "server.request")  # innermost first
ACOUSTIC_KEY, VOCODER_KEY = 1 << 40, (1 << 40) + 1  # the weights' draws


class Noise:
    """The draws of request ``song``: the sampler's [B, T, M] and the vocoder's
    source (``rand_ini`` [1, 1, 9], ``source`` [B, T * hop, 9])."""

    def __init__(self, seed: int, song: int, device, hop: int):
        self.seed, self.song, self.device, self.hop = seed, song, device, hop

    def gen(self, chunk: int, kind: int):
        return torch.Generator(device=self.device).manual_seed(
            serving.stream(self.seed, self.song, chunk, kind))

    def sampler(self, chunk: int, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen(chunk, 0), device=self.device)

    def vocoder(self, chunk: int, b: int, t_mel: int):
        g = self.gen(chunk, 1)
        rand_ini = torch.rand((1, 1, 9), generator=g, device=self.device)
        source = torch.randn((b, t_mel * self.hop, 9), generator=g, device=self.device)
        return rand_ini, source


def build_server(run):
    """The server, built as ``cli.infer`` builds it from an experiment folder
    (a config and the vocoder's ``config.json``, no checkpoint), then given
    the seeded weights."""
    from diffsinger_tpu_torch.inference.serving import AcousticServer

    exp = run.scratch / "acoustic"
    voc = exp / "vocoder"
    voc.mkdir(parents=True, exist_ok=True)
    (voc / "config.json").write_text(json.dumps(run.config["vocoder"]))
    hp = dict(run.config["hparams"], work_dir=str(exp), dictionary=str(generator.DICTIONARY),
              vocoder_ckpt=str(voc / "model.ckpt"))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*RANDOM weights.*")
        server = AcousticServer(hp, max_batch_size=run.mix["max_batch_size"], device=run.device)
    weights.fill(server.model.module, weight_values(run, server.model.module, ACOUSTIC_KEY))
    weights.fill(server.vocoder.model, weight_values(run, server.vocoder.model, VOCODER_KEY))
    return server


def weight_values(run, module: torch.nn.Module, key: int) -> Dict[str, torch.Tensor]:
    dtype = torch.bfloat16 if run.config["precision"] == "bf16" else torch.float32
    return weights.make(weights.shapes_of(module), serving.stream(run.seed, key), run.device,
                        dtype)


def serve(run, server, song: List[dict], k: int) -> List[np.ndarray]:
    """One request: song ``k``'s phrases -> int16 waveforms, in input order."""
    from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import VocoderNoise

    noise = Noise(run.seed, k, run.device, run.config["hparams"]["hop_size"])

    def vocoder_noise(n, b, t_mel):
        rand_ini, source = noise.vocoder(n, b, t_mel)
        return VocoderNoise(rand_ini=rand_ini, source=source)

    wavs = server.synthesize_batch(song, seed=0, noise_fn=noise.sampler,
                                   vocoder_noise_fn=vocoder_noise)
    return [np.round(w * 32767.0).astype(np.int16) for w in wavs]


def instrument(run, server) -> Dict:
    """Host ranges around the server's stages and the networks, and the
    counts the per-layer metrics read (traced runs only)."""
    tr = run.tracer
    counts = {"padded_frames": 0, "true_frames": 0, "lynx_least_s": 0.0}
    bb = run.config["hparams"]["backbone_args"]
    inner = bb["num_channels"] * bb.get("expansion_factor", 2)
    serving.wrap(tr, server, "preprocess_input", "server.preprocess")
    serving.wrap(tr, server, "_enqueue_wav", "server.enqueue")
    stack = server._stack

    def counted_stack(batches, idxs, t_txt, t_mel):
        out = stack(batches, idxs, t_txt, t_mel)
        counts["padded_frames"] += out["mel2ph"].size
        counts["true_frames"] += int((out["mel2ph"] > 0).sum())
        return out
    server._stack = counted_stack

    def lynx_call(args):
        b, t, c = args[0].shape
        counts["lynx_least_s"] += work.least_seconds(
            work.lynx_convmodule(b, t, c, inner, bb["kernel_size"]), work.PEAKS["bf16"])

    for layer in server.model.module.diffusion.backbone.residual_layers:
        serving.ranged(tr, layer.convmodule, "lynxnet.convmodule", lynx_call)
    serving.ranged(tr, server.vocoder.model, "vocoder")
    serving.ranged(tr, server.model.module.fs2, "encoder")
    return counts


def reference(run, pool, picks, lowp=None) -> Dict[Tuple[int, int], np.ndarray]:
    """The picked phrases rendered by the plain reference (``lowp``: the
    control's precision), each alone at its chunk's padded sizes with its
    chunk row's noise, cut and rounded to 16 bits as the server ships them."""
    hp, dev = run.config["hparams"], run.device
    ts = serving.timestep(hp)
    ids = pp.phoneme_ids(generator.DICTIONARY)
    ref = AcousticReference(hp, max(ids.values()) + 1, lowp=lowp).to(dev)
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


def request(run, server):
    return lambda song, k: serve(run, server, song, k)


def frames(run, wav: np.ndarray) -> int:
    return wav.size // run.config["hparams"]["hop_size"]


def flops(run, seg: dict, n_frames: int) -> float:
    """The products of one phrase at its true lengths: the acoustic model and the vocoder."""
    hp = run.config["hparams"]
    return (work.acoustic(1, len(seg["ph_seq"].split()), n_frames, hp)
            + work.vocoder(1, n_frames, run.config["vocoder"]))


def compare(run, got: Dict, want: Dict) -> List[Check]:
    """The relative RMS error of the sampled phrases' waveforms together: the
    seeded weights set the program's error, alike in every phrase, so the
    largest phrase's error says no more than the pooled one. Each phrase's
    own goes to ``run.layer`` for the calibration's record."""
    keys = sorted(want)
    run.layer["phrase_wav_rel_rms"] = [rel_rms(got[k], want[k]) for k in keys]
    pooled = rel_rms(np.concatenate([got[k] for k in keys]),
                     np.concatenate([want[k] for k in keys]))
    return [Check("wav_rel_rms", pooled, run.config["limits"]["wav_rel_rms"])]


def run(run) -> None:
    serving.run_cell(run, sys.modules[__name__])
