"""FastSpeech2 variance encoder, duration predictor and melody encoder
(counterpart of diffsinger_tpu/models/variance_encoder.py).

Channel-last [B, T, C]; the parameters carry the reference torch names that
``torch_model_convert.py::convert_variance`` reads (``fs2.txt_embed``,
``fs2.onset_embed``, ``fs2.word_dur_embed``, ``fs2.midi_embed``,
``fs2.dur_predictor.conv.{i}.1`` (conv) / ``.3`` (LayerNorm),
``fs2.dur_predictor.linear``, ``melody_encoder.{note_midi_embed,
note_dur_embed,note_glide_embed,encoder,out_proj}``). Both encoders are
``FastSpeech2Encoder``, with or without RoPE; either way their attention is
K3. Both take the config's ``dropout`` (the melody encoder its own
``melody_encoder_args.dropout`` first), which acts in training mode only.
The conv-stack ``VariancePredictor`` and ``PitchPredictor`` keep the
reference's names (``conv.{i}.0`` conv, ``.2`` LayerNorm, ``linear``,
``pos_embed_alpha``, ``base_pitch_embed``); no path of either package uses
them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.models.commons import (
    MAX_POSITIONS, CurveEmbed, Embedding, FastSpeech2Encoder, Linear, sinusoidal_positional_table)


class DurationPredictor(nn.Module):
    """Conv stack predicting log-domain durations. ``conv.{i}`` keeps the
    reference's slots: 0 (padding) is a placeholder, 1 the conv, 2 the ReLU, 3
    the LayerNorm (eps 1e-12), 4 the dropout. The LayerNorms and the last
    Linear run in float32 whatever the module's dtype, as the JAX module
    computes them."""

    def __init__(self, in_dims: int, n_layers: int = 5, n_chans: int = 512,
                 kernel_size: int = 3, dropout: float = 0.1, offset: float = 1.0):
        super().__init__()
        self.offset = offset
        self.conv = nn.ModuleList([
            nn.Sequential(
                nn.Identity(),
                nn.Conv1d(in_dims if i == 0 else n_chans, n_chans, kernel_size,
                          padding=kernel_size // 2),
                nn.ReLU(),
                nn.LayerNorm(n_chans, eps=1e-12),
                nn.Dropout(dropout),
            )
            for i in range(n_layers)
        ])
        self.linear = Linear(n_chans, 1)

    def forward(self, xs: torch.Tensor, x_masks: torch.Tensor, infer: bool = True) -> torch.Tensor:
        """xs [B, T, H]; x_masks [B, T] bool, True = padding -> [B, T] float32:
        linear durations clamped at 0, or with ``infer=False`` the raw
        log-domain output that ``dur_loss`` takes."""
        nonpadding = (~x_masks).float()[:, :, None]
        for block in self.conv:
            conv, norm, dropout = block[1], block[3], block[4]
            w = conv.weight
            xs = F.relu(conv(xs.to(w.dtype).transpose(1, 2)).transpose(1, 2))
            xs = F.layer_norm(xs.float(), norm.normalized_shape, norm.weight.float(),
                              norm.bias.float(), norm.eps)
            xs = dropout(xs) * nonpadding
        dur_log = (F.linear(xs, self.linear.weight.float(), self.linear.bias.float())
                   * nonpadding)[:, :, 0]
        if not infer:
            return dur_log
        return torch.clamp(torch.exp(dur_log) - self.offset, min=0.0)


class _ConvStack(nn.Module):
    """The conv stack of the two curve predictors: a scaled absolute
    position embedding (positions 1..T), then ``conv.{i}`` = Conv1d, ReLU,
    LayerNorm (eps 1e-12), Dropout, channel-last."""

    def __init__(self, in_dims: int, n_layers: int, n_chans: int, kernel_size: int,
                 dropout_rate: float):
        super().__init__()
        self.conv = nn.ModuleList([
            nn.Sequential(
                nn.Conv1d(in_dims if i == 0 else n_chans, n_chans, kernel_size,
                          padding=kernel_size // 2),
                nn.ReLU(),
                nn.LayerNorm(n_chans, eps=1e-12),
                nn.Dropout(dropout_rate),
            )
            for i in range(n_layers)
        ])
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        self.register_buffer("pos_table", torch.from_numpy(
            sinusoidal_positional_table(MAX_POSITIONS, in_dims)), persistent=False)

    def convs(self, xs: torch.Tensor) -> torch.Tensor:
        xs = xs + self.pos_embed_alpha * self.pos_table[1:xs.shape[1] + 1]
        for conv, relu, norm, dropout in self.conv:
            xs = dropout(norm(relu(conv(xs.transpose(1, 2)).transpose(1, 2))))
        return xs


class VariancePredictor(_ConvStack):
    """Conv-stack scalar-curve predictor: xs [B, T, H] -> [B, T], mapped from
    [-1, 1] to [vmin, vmax] when ``infer``."""

    def __init__(self, vmin: float, vmax: float, in_dims: int, n_layers: int = 5,
                 n_chans: int = 512, kernel_size: int = 5, dropout_rate: float = 0.1):
        super().__init__(in_dims, n_layers, n_chans, kernel_size, dropout_rate)
        self.vmin, self.vmax = vmin, vmax
        self.linear = Linear(n_chans, 1)

    def forward(self, xs: torch.Tensor, infer: bool = True) -> torch.Tensor:
        xs = self.linear(self.convs(xs))[:, :, 0]
        if infer:
            xs = (xs + 1) / 2 * (self.vmax - self.vmin) + self.vmin
        return xs


class PitchPredictor(_ConvStack):
    """Binned sigmoid pitch predictor: xs [B, T, H], base [B, T] -> (pitch
    [B, T], logits [B, T, num_bins]); the pitch is the sigmoid-weighted mean
    bin over [vmin, vmax], added to ``base``."""

    def __init__(self, vmin: float, vmax: float, num_bins: int, deviation: float, in_dims: int,
                 n_layers: int = 5, n_chans: int = 384, kernel_size: int = 5,
                 dropout_rate: float = 0.1):
        super().__init__(in_dims, n_layers, n_chans, kernel_size, dropout_rate)
        self.vmin, self.vmax, self.num_bins, self.deviation = vmin, vmax, num_bins, deviation
        self.interval = (vmax - vmin) / (num_bins - 1)
        self.base_pitch_embed = Linear(1, in_dims)
        self.linear = Linear(n_chans, num_bins)

    def forward(self, xs: torch.Tensor, base: torch.Tensor):
        xs = xs + self.base_pitch_embed(base[:, :, None])
        logits = self.linear(self.convs(xs))
        probs = torch.sigmoid(logits)
        bins = (torch.sum(torch.arange(self.num_bins, device=xs.device) * probs, dim=2)
                / torch.clamp(torch.sum(probs, dim=2), min=1e-8))
        return bins * self.interval + self.vmin + base, logits


class FastSpeech2Variance(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int = 256, enc_layers: int = 4,
                 enc_ffn_kernel_size: int = 9, ffn_act: str = "gelu", dropout: float = 0.1,
                 num_heads: int = 2, use_rope: bool = True, use_pos_embed: bool = True,
                 rel_pos: bool = True, use_lang_id: bool = False,
                 num_lang: int = 1, predict_dur: bool = True, dur_args: Optional[dict] = None):
        super().__init__()
        h = hidden_size
        self.predict_dur = predict_dur
        self.txt_embed = Embedding(vocab_size, h, padding_idx=0)
        if predict_dur:
            self.onset_embed = Embedding(2, h)
            self.word_dur_embed = CurveEmbed(h)
        else:
            self.ph_dur_embed = CurveEmbed(h)
        self.lang_embed = Embedding(num_lang + 1, h, padding_idx=0) if use_lang_id else None
        self.encoder = FastSpeech2Encoder(
            h, enc_layers, ffn_kernel_size=enc_ffn_kernel_size, ffn_act=ffn_act,
            num_heads=num_heads, use_rope=use_rope, dropout=dropout,
            use_pos_embed=use_pos_embed, rel_pos=rel_pos)
        if predict_dur:
            dur_args = dur_args or {}
            self.midi_embed = Embedding(128, h)
            self.dur_predictor = DurationPredictor(
                h, n_layers=dur_args.get("num_layers", 5), n_chans=dur_args.get("hidden_size", 512),
                kernel_size=dur_args.get("kernel_size", 3), dropout=dur_args.get("dropout", 0.1),
                offset=dur_args.get("log_offset", 1.0))

    def forward(self, txt_tokens: torch.Tensor, midi: torch.Tensor, ph2word: torch.Tensor,
                ph_dur: Optional[torch.Tensor] = None, word_dur: Optional[torch.Tensor] = None,
                spk_embed: Optional[torch.Tensor] = None,
                languages: Optional[torch.Tensor] = None, infer: bool = True):
        """Returns (encoder_out [B, T_ph, H], dur_pred [B, T_ph] | None).

        In word mode (``predict_dur``) the word durations come from
        ``word_dur``, or are summed from ``ph_dur`` at ``ph2word`` (index 0 is
        the padding slot) when there is none or in training (``infer=False``,
        where ``dur_pred`` is the predictor's log-domain output).
        """
        txt_embed = self.txt_embed(txt_tokens)
        if self.predict_dur:
            prev = F.pad(ph2word[:, :-1], (1, 0))
            onset = (ph2word - prev) > 0
            extra_embed = self.onset_embed(onset.long())
            idx = ph2word.long()
            if word_dur is None or not infer:
                b, t_w = ph2word.shape  # an upper bound on the word count
                wd = torch.zeros((b, t_w + 1), dtype=torch.float32, device=ph2word.device)
                word_dur = wd.scatter_add(1, idx, ph_dur.float())[:, 1:]
            word_dur_ph = torch.gather(F.pad(word_dur.float(), (1, 0)), 1, idx)
            extra_embed = extra_embed + self.word_dur_embed(word_dur_ph)
        else:
            extra_embed = self.ph_dur_embed(ph_dur)
        if self.lang_embed is not None:
            extra_embed = extra_embed + self.lang_embed(languages)

        encoder_out = self.encoder(txt_embed, extra_embed.to(txt_embed.dtype), txt_tokens == 0)
        if not self.predict_dur:
            return encoder_out, None
        dur_cond = encoder_out + self.midi_embed(midi.long())
        if spk_embed is not None:
            dur_cond = dur_cond + spk_embed
        return encoder_out, self.dur_predictor(dur_cond, txt_tokens == 0, infer=infer)

    @classmethod
    def from_hparams(cls, hp: dict, vocab_size: int) -> "FastSpeech2Variance":
        return cls(
            vocab_size=vocab_size,
            hidden_size=hp["hidden_size"],
            enc_layers=hp["enc_layers"],
            enc_ffn_kernel_size=hp["enc_ffn_kernel_size"],
            ffn_act=hp["ffn_act"],
            dropout=hp["dropout"],
            num_heads=hp["num_heads"],
            use_rope=hp.get("use_rope", False),
            use_pos_embed=hp.get("use_pos_embed", True),
            rel_pos=hp.get("rel_pos", False),
            use_lang_id=hp.get("use_lang_id", False),
            num_lang=hp.get("num_lang", 1),
            predict_dur=hp["predict_dur"],
            dur_args=dict(hp.get("dur_prediction_args", {})),
        )


class MelodyEncoder(nn.Module):
    """Note-level encoder: note pitch, duration and (optionally) glide type ->
    [B, T_note, out_size]."""

    def __init__(self, hidden_size: int = 128, out_size: int = 256, enc_layers: int = 4,
                 enc_ffn_kernel_size: int = 9, ffn_act: str = "gelu", dropout: float = 0.1,
                 num_heads: int = 2, use_rope: bool = True, use_pos_embed: bool = True,
                 rel_pos: bool = True, use_glide_embed: bool = False,
                 glide_types: tuple = ("up", "down"),
                 glide_embed_scale: float = 11.313708498984760):
        super().__init__()
        h = hidden_size
        self.note_midi_embed = CurveEmbed(h)
        self.note_dur_embed = CurveEmbed(h)
        self.glide_embed_scale = glide_embed_scale
        self.note_glide_embed = (Embedding(len(glide_types) + 1, h, padding_idx=0)
                                 if use_glide_embed else None)
        self.encoder = FastSpeech2Encoder(
            h, enc_layers, ffn_kernel_size=enc_ffn_kernel_size, ffn_act=ffn_act,
            num_heads=num_heads, use_rope=use_rope, dropout=dropout,
            use_pos_embed=use_pos_embed, rel_pos=rel_pos)
        self.out_proj = Linear(h, out_size)

    def forward(self, note_midi: torch.Tensor, note_rest: torch.Tensor, note_dur: torch.Tensor,
                glide: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.out_proj.weight.dtype
        midi_embed = self.note_midi_embed(note_midi) * (~note_rest)[:, :, None]
        extra = self.note_dur_embed(note_dur)
        if self.note_glide_embed is not None:
            extra = extra + self.note_glide_embed(glide.long()) * self.glide_embed_scale
        out = self.encoder(midi_embed.to(dtype), extra.to(dtype), note_midi < 0)
        return self.out_proj(out)

    @classmethod
    def from_hparams(cls, hp: dict) -> "MelodyEncoder":
        enc = dict(hp.get("melody_encoder_args", {}))

        def get(key, default=None):
            return enc.get(key, hp.get(key, default))

        return cls(
            hidden_size=get("hidden_size"),
            out_size=hp["hidden_size"],
            enc_layers=get("enc_layers"),
            enc_ffn_kernel_size=get("enc_ffn_kernel_size"),
            ffn_act=get("ffn_act"),
            dropout=get("dropout"),
            num_heads=get("num_heads"),
            use_rope=get("use_rope", False),
            use_pos_embed=get("use_pos_embed", True),
            rel_pos=get("rel_pos", False),
            use_glide_embed=hp.get("use_glide_embed", False),
            glide_types=tuple(hp.get("glide_types", ("up", "down"))),
            glide_embed_scale=hp.get("glide_embed_scale", 11.313708498984760),
        )
