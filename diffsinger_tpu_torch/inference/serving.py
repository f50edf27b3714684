"""Batched serving of .ds segments (counterpart of
diffsinger_tpu/inference/serving.py): ``AcousticServer`` and ``VarianceServer``.

The segments of a request are grouped (the variance server: by predictor
flags, present inputs and speaker-mix widths), sorted by their buckets and
packed into chunks of at most ``max_batch_size``; each chunk is padded to its
largest buckets and runs as one batch.

Several devices (``devices=[...]``, where the JAX package takes ``mesh=``):
each device holds a replica of the weights (the vocoder's too), and chunk n
runs whole on replica n mod the device count. The one host thread enqueues
every chunk once, as on one device, and the devices run their chunks at
once. (A thread a device cost more than it gave: under one GIL the threads
enqueue more slowly together than one thread alone.) A chunk draws from its
own generator seeded with ``seed``, as on one device, so the outputs are the
one-device server's, gathered back in input order. (The JAX server instead
shards a chunk's rows over its mesh; its padded rows leave the real rows'
draws as they are.)
"""

from __future__ import annotations

import contextlib
import pathlib
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from diffsinger_tpu_torch.inference.base_svs_infer import bucket_length
from diffsinger_tpu_torch.inference.ds_acoustic import (
    DiffSingerAcousticInfer, NoiseFn, VocoderNoiseFn)
from diffsinger_tpu_torch.inference import ds_variance
from diffsinger_tpu_torch.inference.ds_variance import DiffSingerVarianceInfer
from diffsinger_tpu_torch.utils import pad_to, resolve_precision, tracing
from diffsinger_tpu_torch.utils.infer_utils import save_wav


class _Replicas:
    """Replicas of a runtime on several devices; chunk n runs on replica n
    mod the device count."""

    def _init_devices(self, devices: Optional[Sequence]) -> None:
        devices = [torch.device(d) for d in devices] if devices else [self.device]
        if devices[0] != self.device:
            raise ValueError(f"devices[0] is {devices[0]} but the runtime is on {self.device}")
        self.devices = devices
        self.replicas = [self] + [self._replica(d) for d in devices[1:]]

    def _replica(self, device: torch.device):
        raise NotImplementedError()

    def _on_replica(self, n: int, run):
        """``run(replica)`` for chunk ``n``, with its replica's device current."""
        replica = self.replicas[n % len(self.replicas)]
        dev = replica.device
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            return run(replica)


class AcousticServer(_Replicas, DiffSingerAcousticInfer):
    """Batch-of-segments acoustic synthesis.

    ``synthesize_batch(segments)`` preprocesses all segments, packs them into
    chunks, runs sampler + vocoder per chunk and returns per-segment waveforms
    in input order. ``last_stats`` holds one dict per chunk of the last call
    (the JAX server's keys but ``compute_s``), ``last_chunk_devices`` the
    index of the device each chunk ran on. ``devices`` (the first one the
    runtime's ``device``) runs the chunks in turn on replicas on those devices.
    """

    def __init__(self, hparams: dict, max_batch_size: int = 8,
                 devices: Optional[Sequence] = None, **kwargs):
        if devices:
            kwargs["device"] = devices[0]
        super().__init__(hparams, **kwargs)
        self.max_batch_size = max_batch_size
        self.last_stats: List[dict] = []
        self.last_chunk_devices: List[int] = []
        self._init_devices(devices)

    def _replica(self, device: torch.device):
        import copy

        from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
        from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import Generator

        # built as the runtime builds its own: under bf16 some parameters stay float32
        dtype = resolve_precision(self.hparams.get("infer_precision"))
        r = copy.copy(self)
        r.device = device
        r.model = DiffSingerAcoustic(self.hparams, vocab_size=len(self.phoneme_dictionary),
                                     out_dims=self.hparams["audio_num_mel_bins"],
                                     dtype=dtype, device=device)
        r.model.module.load_state_dict(self.model.module.state_dict())
        r.model.module.eval()
        if getattr(self, "vocoder", None) is not None:
            r.vocoder = copy.copy(self.vocoder)
            r.vocoder.device = device
            r.vocoder.model = Generator(self.vocoder.config, dtype=dtype, device=device).eval()
            r.vocoder.model.load_state_dict(self.vocoder.model.state_dict())
        return r

    @staticmethod
    def _enqueue_wav(replica, stacked, seed, steps, noise, vocoder_noise, depth):
        """Enqueue a chunk on ``replica``: its wav, int16 on the replica's device."""
        wav = replica._run_wav(stacked, replica._generator(max(seed, 0)), steps, noise,
                               vocoder_noise, depth)
        # the deliverable is a 16-bit wav: ship int16, half the bytes of float32
        return (torch.clamp(wav.float(), -1.0, 1.0) * 32767.0).to(torch.int16)

    def _group_key(self, batch: Dict[str, np.ndarray]):
        t_txt = bucket_length(batch["tokens"].shape[1], step=16, minimum=16)
        t_mel = bucket_length(batch["mel2ph"].shape[1])
        # speaker-mix width AND static/dynamic-ness must match within a
        # stacked group: a static [1, 1, N] value row cannot be concatenated
        # with (or zero-padded against) a dynamic [1, T, N] row
        spk = ((batch["spk_mix_id"].shape[-1],
                batch["spk_mix_value"].shape[1] > 1)
               if "spk_mix_id" in batch else None)
        return (t_txt, t_mel, spk)

    def _chunks(self, keys: List[tuple]) -> List[List[int]]:
        """Sort-and-pack: per speaker-mix group, segment indices sorted by
        (frame bucket, token bucket) and cut into chunks of ``max_batch_size``.
        A chunk pads to its own largest buckets, which trades bounded padding
        for far fewer, larger batches than exact-shape grouping would give."""
        groups: Dict[tuple, List[int]] = defaultdict(list)
        for i, (_t_txt, _t_mel, spk) in enumerate(keys):
            groups[spk].append(i)
        chunks = []
        for idxs in groups.values():
            idxs = sorted(idxs, key=lambda i: (keys[i][1], keys[i][0]))
            chunks += [idxs[s: s + self.max_batch_size]
                       for s in range(0, len(idxs), self.max_batch_size)]
        return chunks

    def _stack(self, batches, idxs, t_txt, t_mel) -> Dict[str, np.ndarray]:
        def cat(key, length):
            return np.concatenate([pad_to(batches[i][key], length, axis=1) for i in idxs], axis=0)

        first = batches[idxs[0]]
        out = {
            "tokens": cat("tokens", t_txt),
            "mel2ph": cat("mel2ph", t_mel),
            "f0": cat("f0", t_mel),
        }
        for key in ("key_shift", "speed", *self.variances_to_embed):
            if key in first:
                out[key] = cat(key, t_mel)
        if "languages" in first:
            out["languages"] = cat("languages", t_txt)
        if "spk_mix_id" in first:
            out["spk_mix_id"] = cat("spk_mix_id", first["spk_mix_id"].shape[1])
            out["spk_mix_value"] = cat(
                "spk_mix_value", t_mel if first["spk_mix_value"].shape[1] > 1 else 1)
        return out

    def synthesize_batch(
        self, segments: List[dict], seed: int = -1, steps: Optional[int] = None,
        depth: Optional[int] = None, *, noise_fn: Optional[NoiseFn] = None,
        vocoder_noise_fn: Optional[VocoderNoiseFn] = None,
    ) -> List[np.ndarray]:
        """Waveforms [T_i * hop] float32 of all segments, in input order.

        Each chunk draws its sampler noise from one generator seeded with
        ``seed`` (0 if negative); ``noise_fn`` and ``vocoder_noise_fn`` are
        called with the chunk's index and supply the noise instead.
        """
        with tracing.span("ds.server.preprocess"):
            batches = [self.preprocess_input(p, idx=i) for i, p in enumerate(segments)]
        keys = [self._group_key(b) for b in batches]
        hop = self.hparams["hop_size"]
        n_mels = self.hparams["audio_num_mel_bins"]

        # Phase 1: enqueue every chunk without waiting for the device, so that
        # chunk k+1's host work overlaps chunk k's kernels. Phase 2: copy the
        # waveforms back in the same order, one transfer per chunk.
        pending = []
        for n, chunk in enumerate(self._chunks(keys)):
            t_txt = max(keys[i][0] for i in chunk)
            t_mel = max(keys[i][1] for i in chunk)
            t0 = time.perf_counter()
            with tracing.span("ds.server.stack"):
                stacked = self._stack(batches, chunk, t_txt, t_mel)
                noise = (noise_fn(n, (len(chunk), t_mel, n_mels)) if noise_fn is not None
                         else None)
                vocoder_noise = (vocoder_noise_fn(n, len(chunk), t_mel)
                                 if vocoder_noise_fn is not None else None)
            with tracing.span("ds.server.enqueue"):
                wav_dev = self._on_replica(n, lambda r: self._enqueue_wav(
                    r, stacked, seed, steps, noise, vocoder_noise, depth))
            pending.append((chunk, t_txt, t_mel, wav_dev, time.perf_counter() - t0))

        results: List[Optional[np.ndarray]] = [None] * len(segments)
        stats = []
        for chunk, t_txt, t_mel, wav_dev, dispatch_s in pending:
            t1 = time.perf_counter()
            with tracing.span("ds.server.fetch"):
                wavs = wav_dev.cpu().numpy().astype(np.float32) / 32767.0
            stats.append({
                "batch": len(chunk), "t_txt": t_txt, "t_mel": t_mel,
                "dispatch_s": dispatch_s,
                "fetch_s": time.perf_counter() - t1,  # the wait for the device included
                "wire_mb": wav_dev.numel() * wav_dev.element_size() / 1e6,
            })
            for j, seg_idx in enumerate(chunk):
                length = batches[seg_idx]["mel2ph"].shape[1]
                results[seg_idx] = wavs[j, : length * hop]
        self.last_stats = stats
        self.last_chunk_devices = [n % len(self.replicas) for n in range(len(pending))]
        return results

    def run_inference(
        self,
        params: List[dict],
        out_dir: pathlib.Path = None,
        title: str = None,
        num_runs: int = 1,
        spk_mix: Dict[str, float] = None,
        seed: int = -1,
        save_mel: bool = False,
        steps: Optional[int] = None,
        depth: Optional[int] = None,
        *,
        noise_fn: Optional[NoiseFn] = None,
        vocoder_noise_fn: Optional[VocoderNoiseFn] = None,
    ):
        """Batched drop-in for the segment-by-segment runtime.

        Noise semantics differ from sequential mode: one generator per chunk
        (seeded from ``seed``, or from a hash of title and run) instead of one
        per segment; per-segment ``seed`` fields are ignored with a warning.
        Output is still deterministic given ``seed``.
        """
        if save_mel:  # mel export stays sequential (per-segment npz rows)
            return super().run_inference(
                params, out_dir=out_dir, title=title, num_runs=num_runs, spk_mix=spk_mix,
                seed=seed, save_mel=True, steps=steps, depth=depth, noise_fn=noise_fn)
        if any("seed" in p for p in params):
            warnings.warn("batched serving ignores per-segment 'seed' fields; "
                          "use --seed for deterministic output")
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for run in range(num_runs):
            run_seed = (seed if seed >= 0 else hash((title, run))) & 0xFFFF_FFFF
            wavs = self.synthesize_batch(params, seed=run_seed, steps=steps, depth=depth,
                                         noise_fn=noise_fn, vocoder_noise_fn=vocoder_noise_fn)
            result = self._concat_segments(params, wavs)
            filename = (f"{title}-{str(run).zfill(3)}.wav" if num_runs > 1
                        else f"{title}.wav")
            save_path = out_dir / filename
            print(f"| save audio: {save_path}")
            save_wav(result, save_path, self.hparams["audio_sample_rate"])


class VarianceServer(_Replicas, DiffSingerVarianceInfer):
    """Batch-of-segments variance prediction.

    ``predict_batch(segments)`` groups the segments by (predictor flags,
    present inputs, speaker-mix widths), sorts each group by its buckets, cuts
    it into chunks of ``max_batch_size`` and runs each chunk as one forward;
    it returns per-segment (dur_pred, pitch_pred, variances) in input order.
    One generator per chunk, seeded with ``seed`` (0 if negative); per-segment
    ``seed`` fields are ignored with a warning. Unlike ``AcousticServer`` it
    keeps no per-chunk statistics, as the JAX package's does not. ``devices``
    (the first one the runtime's ``device``) runs the chunks in turn on
    replicas on those devices.
    """

    def __init__(self, hparams: dict, max_batch_size: int = 8,
                 devices: Optional[Sequence] = None, **kwargs):
        if devices:
            kwargs["device"] = devices[0]
        super().__init__(hparams, **kwargs)
        self.max_batch_size = max_batch_size
        self._init_devices(devices)

    def _replica(self, device: torch.device):
        import copy

        from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance

        r = copy.copy(self)
        r.device = device
        r.model = DiffSingerVariance(self.hparams, vocab_size=len(self.phoneme_dictionary),
                                     dtype=resolve_precision(self.hparams.get("infer_precision")),
                                     device=device)
        r.model.module.load_state_dict(self.model.module.state_dict())
        r.model.module.eval()
        return r

    def _group_key(self, batch: Dict[str, np.ndarray], flags):
        present = tuple(sorted(
            k for k in ("ph_dur", "word_dur", "mel2ph", "pitch", "expr", "note_glide",
                        "languages")
            if k in batch and batch[k] is not None))
        # both mix levels' speaker counts and static/dynamic-ness must match
        # within a stacked group (a [1, 1, N] row cannot stack with [1, T, N])
        spk = (batch["ph_spk_mix_id"].shape[-1], batch["spk_mix_id"].shape[-1],
               batch["ph_spk_mix_value"].shape[1] > 1,
               batch["spk_mix_value"].shape[1] > 1) if "ph_spk_mix_id" in batch else None
        return (flags, present, spk)

    @staticmethod
    def _stack_rows(rows):
        if rows[0] is None:
            return None
        return np.concatenate([np.asarray(r) for r in rows], axis=0)

    def chunks(self, batches: List[Dict[str, np.ndarray]], flags_list) -> List[tuple]:
        """(flags, segment indices, buckets) of every chunk, in dispatch order."""
        groups: Dict[tuple, List[int]] = defaultdict(list)
        for i, (b, f) in enumerate(zip(batches, flags_list)):
            groups[self._group_key(b, f)].append(i)
        shapes = [self.bucket_shapes(b) for b in batches]
        out = []
        for (flags, _present, _spk), idxs in groups.items():
            # sort-and-pack: a chunk pads to its own largest bucket of each axis
            idxs = sorted(idxs, key=lambda i: shapes[i][::-1])
            for start in range(0, len(idxs), self.max_batch_size):
                chunk = idxs[start: start + self.max_batch_size]
                out.append((flags, chunk, tuple(max(shapes[i][d] for i in chunk)
                                                for d in range(4))))
        return out

    def stack_chunk(self, batches, chunk: List[int], buckets: tuple) -> tuple:
        """The chunk's segments padded to ``buckets`` and stacked: the
        positional arrays and kwargs of ``_run_padded``."""
        rows = [self.padded_arrays(batches[i], buckets) for i in chunk]
        tokens, midi, ph2word, base_pitch = (
            self._stack_rows([r[k] for r in rows]) for k in range(4))
        array_kwargs = {k: self._stack_rows([r[4][k] for r in rows]) for k in rows[0][4]}
        spk_mix = None
        if rows[0][5] is not None:
            spk_mix = {k: self._stack_rows([r[5][k] for r in rows]) for k in rows[0][5]}
        return tokens, midi, ph2word, base_pitch, array_kwargs, spk_mix

    def enqueue(self, params_list: List[dict], seed: int = -1, steps: Optional[int] = None, *,
                noise_fn: Optional[ds_variance.NoiseFn] = None):
        """Preprocess and enqueue every chunk without waiting for the device.
        Returns (batches, [(flags, chunk, device outputs)]) for :meth:`collect`."""
        with tracing.span("ds.server.preprocess"):
            flags_list, batches = self._preprocess_all(params_list)
        pending = []
        for n, (flags, chunk, buckets) in enumerate(self.chunks(batches, flags_list)):
            with tracing.span("ds.server.stack"):
                stacked = self.stack_chunk(batches, chunk, buckets)
                noise = self.injected_noise(noise_fn, n, len(chunk), buckets[3])
            with tracing.span("ds.server.enqueue"):
                pending.append((flags, chunk, self._on_replica(n, lambda r: r._run_padded(
                    *stacked, flags, r._generator(max(seed, 0)), steps, **noise))))
        return batches, pending

    @staticmethod
    def collect(batches, pending, n_segments: int) -> List[tuple]:
        """Copy the enqueued chunks' outputs back, one segment a row, cut to
        each segment's length."""
        preds: List[Optional[tuple]] = [None] * n_segments
        for flags, chunk, (dur_b, pitch_b, vars_b) in pending:
            with tracing.span("ds.server.fetch"):
                dur_np = dur_b.cpu().numpy() if dur_b is not None and flags[0] else None
                pitch_np = pitch_b.float().cpu().numpy() if pitch_b is not None else None
                vars_np = {k: v.float().cpu().numpy() for k, v in vars_b.items()}
            for j, seg_idx in enumerate(chunk):
                t_ph = batches[seg_idx]["tokens"].shape[1]
                t_s = batches[seg_idx]["base_pitch"].shape[1]
                preds[seg_idx] = (None if dur_np is None else dur_np[j, :t_ph],
                                  None if pitch_np is None else pitch_np[j, :t_s],
                                  {k: v[j, :t_s] for k, v in vars_np.items()})
        return preds

    def predict_batch(self, params_list: List[dict], seed: int = -1,
                      steps: Optional[int] = None, *,
                      noise_fn: Optional[ds_variance.NoiseFn] = None):
        """Per-segment (dur_pred | None, pitch_pred | None, {variance: curve})
        as numpy, in input order. Every chunk is enqueued before any result is
        copied back. ``noise_fn`` is called with the chunk's index and supplies
        the samplers' first draws instead of the generator."""
        batches, pending = self.enqueue(params_list, seed, steps, noise_fn=noise_fn)
        return self.collect(batches, pending, len(params_list))

    def run_inference(self, params: List[dict], out_dir: pathlib.Path = None,
                      title: str = None, num_runs: int = 1, seed: int = -1,
                      steps: Optional[int] = None, *,
                      noise_fn: Optional[ds_variance.NoiseFn] = None):
        """Batched drop-in for the segment-by-segment runtime: writes
        ``<title>.ds``; deterministic given ``seed``."""
        if any("seed" in p for p in params):
            warnings.warn("batched serving ignores per-segment 'seed' fields; "
                          "use --seed for deterministic output")
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for run in range(num_runs):
            run_seed = (seed if seed >= 0 else hash((title, run))) & 0xFFFF_FFFF
            preds = self.predict_batch(params, seed=run_seed, steps=steps, noise_fn=noise_fn)
            results = [self._apply_predictions(p, *pred) for p, pred in zip(params, preds)]
            self._save(results, out_dir, title, run, num_runs)
