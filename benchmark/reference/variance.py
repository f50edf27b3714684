"""Plain reference of the variance model's inference: float32 PyTorch.

A frozen copy of the math of the port's ``models/variance_encoder.py``
(FastSpeech2Variance in word mode, the fs2 duration predictor),
``models/backbones/wavenet.py``, ``core/spec_transform.py``'s repeat-bin
transforms and ``models/toplevel.py::DiffSingerVariance.forward_infer`` for a
score-only request: durations predicted and fitted to the words (rhythm
regulator), the frames aligned to them, then the pitch delta and the
variance curves, each sampled by euler steps from ``noise``. Without the
melody encoder, speakers or languages; ``expr`` blends the retake embedding.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import (Encoder, Ops, curve, euler, gather_frames, length_regulator, pointwise,
                     rhythm_regulator, step_embedding)

VARIANCES = ("energy", "breathiness", "voicing", "tension")


class DurSlot(nn.Module):
    """``conv.{i}``: slot 1 the conv, slot 3 the LayerNorm."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.add_module("1", nn.Conv1d(cin, cout, k, padding=k // 2))
        self.add_module("3", nn.LayerNorm(cout, eps=1e-12))


class DurationPredictor(nn.Module):
    def __init__(self, dim: int, args: dict):
        super().__init__()
        n = args["hidden_size"]
        self.offset = args["log_offset"]
        self.conv = nn.ModuleList([DurSlot(dim if i == 0 else n, n, args["kernel_size"])
                                   for i in range(args["num_layers"])])
        self.linear = nn.Linear(n, 1)

    def forward(self, ops: Ops, x, pad):
        keep = (~pad).float()[:, :, None]
        for slot in self.conv:
            conv, norm = getattr(slot, "1"), getattr(slot, "3")
            y = ops.conv1d(x.transpose(1, 2), conv.weight, conv.bias, padding=conv.padding)
            x = norm(F.relu(y.transpose(1, 2))) * keep
        log = (ops.linear(x, self.linear.weight, self.linear.bias) * keep)[:, :, 0]
        return torch.clamp(torch.exp(log) - self.offset, min=0.0)


class FS2Variance(nn.Module):
    def __init__(self, hp: dict, vocab: int):
        super().__init__()
        h = hp["hidden_size"]
        self.txt_embed = nn.Embedding(vocab, h)
        self.onset_embed = nn.Embedding(2, h)
        self.word_dur_embed = nn.Linear(1, h)
        self.encoder = Encoder(h, hp["enc_layers"], hp["num_heads"], hp["enc_ffn_kernel_size"])
        self.midi_embed = nn.Embedding(128, h)
        self.dur_predictor = DurationPredictor(h, hp["dur_prediction_args"])

    def forward(self, ops: Ops, tokens, midi, ph2word, word_dur):
        onset = (ph2word - F.pad(ph2word[:, :-1], (1, 0))) > 0
        word_dur_ph = torch.gather(F.pad(word_dur.float(), (1, 0)), 1, ph2word.long())
        extra = self.onset_embed(onset.long()) + curve(self.word_dur_embed, word_dur_ph)
        pad = tokens == 0
        enc = self.encoder(ops, self.txt_embed(tokens.long()), extra, pad)
        return enc, self.dur_predictor(ops, enc + self.midi_embed(midi.long()), pad)


class WaveNetBlock(nn.Module):
    def __init__(self, cond: int, c: int, dilation: int):
        super().__init__()
        self.dilated_conv = nn.Conv1d(c, 2 * c, 3, padding=dilation, dilation=dilation)
        self.diffusion_projection = nn.Linear(c, c)
        self.conditioner_projection = nn.Conv1d(cond, 2 * c, 1)
        self.output_projection = nn.Conv1d(c, 2 * c, 1)

    def forward(self, ops: Ops, x, proj, step):
        y = x + ops.linear(step, self.diffusion_projection.weight,
                           self.diffusion_projection.bias)[:, None, :]
        conv = self.dilated_conv
        y = ops.conv1d(y.transpose(1, 2), conv.weight, conv.bias, padding=conv.padding,
                       dilation=conv.dilation).transpose(1, 2)
        gate, filt = (y + proj).chunk(2, dim=-1)
        y = pointwise(ops, self.output_projection, torch.sigmoid(gate) * torch.tanh(filt))
        residual, skip = y.chunk(2, dim=-1)
        return (x + residual) / math.sqrt(2.0), skip


class WaveNet(nn.Module):
    def __init__(self, cond: int, width: int, args: dict):
        super().__init__()
        c = args["num_channels"]
        self.channels = c
        self.input_projection = nn.Conv1d(width, c, 1)
        self.mlp = nn.ModuleList([nn.Linear(c, 4 * c), nn.Identity(), nn.Linear(4 * c, c)])
        self.residual_layers = nn.ModuleList([
            WaveNetBlock(cond, c, 2 ** (i % args["dilation_cycle_length"]))
            for i in range(args["num_layers"])])
        self.skip_projection = nn.Conv1d(c, c, 1)
        self.output_projection = nn.Conv1d(c, width, 1)

    def forward(self, ops: Ops, spec, t, projs):
        x = F.relu(pointwise(ops, self.input_projection, spec))
        step = ops.linear(step_embedding(t, self.channels), self.mlp[0].weight, self.mlp[0].bias)
        step = step * torch.tanh(F.softplus(step))
        step = ops.linear(step, self.mlp[2].weight, self.mlp[2].bias)
        skips = torch.zeros_like(x)
        for layer, proj in zip(self.residual_layers, projs):
            x, skip = layer(ops, x, proj, step)
            skips = skips + skip
        x = F.relu(pointwise(ops, self.skip_projection, skips / math.sqrt(len(self.residual_layers))))
        return pointwise(ops, self.output_projection, x)


class Predictor(nn.Module):
    """``pitch_predictor`` / ``variance_predictor``: the backbone as ``velocity_fn``."""

    def __init__(self, cond: int, width: int, args: dict):
        super().__init__()
        self.velocity_fn = WaveNet(cond, width, args)


class VarianceReference(nn.Module):
    """``forward(tokens, midi, ph2word, word_dur, base_pitch, expr, noise_pitch,
    noise_variances)`` -> (durations [B, T_ph] int, pitch [B, T] midi,
    {variance: [B, T]}), at the padded frame count of ``base_pitch``."""

    def __init__(self, hp: dict, vocab: int, lowp=None):
        super().__init__()
        var_list = [v for v in VARIANCES if hp.get(f"predict_{v}")]
        if (hp.get("use_spk_id") or hp.get("use_lang_id") or hp.get("use_melody_encoder")
                or not hp.get("use_rope") or hp["diffusion_type"] != "reflow"
                or not (hp["predict_dur"] and hp["predict_pitch"])
                or hp.get("sampling_algorithm", "euler") != "euler"
                or hp["dur_prediction_args"].get("arch", "fs2") != "fs2"):
            raise ValueError("the reference covers the benchmark's variance config only")
        self.hp = hp
        self.ops = Ops(lowp)
        self.var_list = var_list
        h = hp["hidden_size"]
        self.fs2 = FS2Variance(hp, vocab)
        self.base_pitch_embed = nn.Linear(1, h)
        self.pitch_retake_embed = nn.Embedding(2, h)
        p = hp["pitch_prediction_args"]
        self.pitch_predictor = Predictor(h, p["repeat_bins"], p["backbone_args"])
        if var_list:
            self.pitch_embed = nn.Linear(1, h)
            self.variance_embeds = nn.ModuleDict({v: nn.Linear(1, h) for v in var_list})
            v = hp["variances_prediction_args"]
            self.var_bins = v["total_repeat_bins"] // len(var_list)
            self.variance_predictor = Predictor(h, self.var_bins * len(var_list),
                                                v["backbone_args"])

    def _sample(self, predictor, cond, noise):
        hp, ops, net = self.hp, self.ops, predictor.velocity_fn
        projs = [pointwise(ops, layer.conditioner_projection, cond)
                 for layer in net.residual_layers]  # the condition's, once a request
        return euler(lambda x, t: net(ops, x, t, projs), noise.float(), 0.0,
                     hp["sampling_steps"], hp["time_scale_factor"])

    @torch.no_grad()
    def forward(self, tokens, midi, ph2word, word_dur, base_pitch, expr, noise_pitch,
                noise_variances):
        hp, ops = self.hp, self.ops
        with ops.backend():
            enc, dur_pred = self.fs2(ops, tokens, midi, ph2word, word_dur)
            dur = rhythm_regulator(dur_pred, ph2word, word_dur)
            mel2ph = length_regulator(dur, base_pitch.shape[1])
            cond = gather_frames(enc, mel2ph)

            table = self.pitch_retake_embed.weight
            e = expr.float()[:, :, None]
            pitch_cond = (cond + e * table[1] + (1 - e) * table[0]
                          + curve(self.base_pitch_embed, base_pitch))
            p = hp["pitch_prediction_args"]
            x = self._sample(self.pitch_predictor, pitch_cond, noise_pitch)
            delta = (x + 1) / 2 * (p["pitd_norm_max"] - p["pitd_norm_min"]) + p["pitd_norm_min"]
            delta = torch.clamp(delta.mean(-1), p["pitd_clip_min"], p["pitd_clip_max"])
            pitch = base_pitch.float() + delta
            curves = {}
            if not self.var_list:
                return dur, pitch, curves

            x = self._sample(self.variance_predictor, cond + curve(self.pitch_embed, pitch),
                             noise_variances)
            b, t, _ = x.shape
            x = x.reshape(b, t, len(self.var_list), self.var_bins)
            for i, name in enumerate(self.var_list):
                if name == "tension":
                    lo, hi = hp["tension_logit_min"], hp["tension_logit_max"]
                    clamp = (lo, hi)
                else:
                    lo, hi = hp[f"{name}_db_min"], hp[f"{name}_db_max"]
                    clamp = (lo, 0.0)
                values = ((x[:, :, i] + 1) / 2 * (hi - lo) + lo).mean(-1)
                curves[name] = torch.clamp(values, *clamp)
        return dur, pitch, curves
