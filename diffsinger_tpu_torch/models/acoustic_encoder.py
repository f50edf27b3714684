"""FastSpeech2 acoustic encoder (counterpart of diffsinger_tpu/models/acoustic_encoder.py).

Token embeddings -> transformer -> frame-level gather, plus the additive
frame conditioning: pitch, and the optional speaker, variance, key-shift and
speed embeds. Everything is [B, T, H] channel-last.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from diffsinger_tpu_torch.models.commons import CurveEmbed, Embedding, FastSpeech2Encoder
from diffsinger_tpu_torch.utils.seq import gather_frames, mel2ph_to_dur

VARIANCE_CHECKLIST = ("energy", "breathiness", "voicing", "tension")


class FastSpeech2Acoustic(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int = 256, enc_layers: int = 4,
                 enc_ffn_kernel_size: int = 9, ffn_act: str = "gelu", dropout: float = 0.1,
                 num_heads: int = 2,
                 use_rope: bool = True, use_lang_id: bool = False, num_lang: int = 1,
                 use_spk_id: bool = False, num_spk: int = 1, variance_embed_list: tuple = (),
                 use_key_shift_embed: bool = False, use_speed_embed: bool = False):
        super().__init__()
        h = hidden_size
        self.txt_embed = Embedding(vocab_size, h, padding_idx=0)
        self.dur_embed = CurveEmbed(h)
        self.encoder = FastSpeech2Encoder(
            h, enc_layers, ffn_kernel_size=enc_ffn_kernel_size, ffn_act=ffn_act,
            num_heads=num_heads, use_rope=use_rope, dropout=dropout)
        self.pitch_embed = CurveEmbed(h)
        self.lang_embed = Embedding(num_lang + 1, h, padding_idx=0) if use_lang_id else None
        self.spk_embed = Embedding(num_spk, h) if use_spk_id else None
        self.variance_embed_list = tuple(variance_embed_list)
        self.variance_embeds = nn.ModuleDict({v: CurveEmbed(h) for v in self.variance_embed_list})
        self.key_shift_embed = CurveEmbed(h) if use_key_shift_embed else None
        self.speed_embed = CurveEmbed(h) if use_speed_embed else None

    def forward(self, txt_tokens: torch.Tensor, mel2ph: torch.Tensor, f0: torch.Tensor,
                key_shift: Optional[torch.Tensor] = None, speed: Optional[torch.Tensor] = None,
                spk_embed_id: Optional[torch.Tensor] = None,
                spk_mix_embed: Optional[torch.Tensor] = None,
                languages: Optional[torch.Tensor] = None,
                variances: Optional[dict] = None) -> torch.Tensor:
        """Returns the frame-level condition [B, T_mel, H]. The curve embeds
        (durations, f0, variances, key shift, speed) are float32; each sum they
        enter is cast into the model's dtype once."""
        txt_embed = self.txt_embed(txt_tokens)
        dur = mel2ph_to_dur(mel2ph, txt_tokens.shape[1])
        extra_embed = self.dur_embed(dur)
        if self.lang_embed is not None:
            extra_embed = extra_embed + self.lang_embed(languages)

        encoder_out = self.encoder(txt_embed, extra_embed.to(txt_embed.dtype), txt_tokens == 0)
        condition = gather_frames(encoder_out, mel2ph)

        if self.spk_embed is not None:
            spk = spk_mix_embed if spk_mix_embed is not None else self.spk_embed(spk_embed_id)[:, None, :]
            condition = condition + spk

        curves = self.pitch_embed(torch.log(1 + f0.float() / 700))
        variances = variances or {}
        for v_name in self.variance_embed_list:
            curves = curves + self.variance_embeds[v_name](variances[v_name])
        if self.key_shift_embed is not None:
            curves = curves + self.key_shift_embed(key_shift)
        if self.speed_embed is not None:
            curves = curves + self.speed_embed(speed)
        return (condition.float() + curves).to(condition.dtype)

    @classmethod
    def from_hparams(cls, hp: dict, vocab_size: int) -> "FastSpeech2Acoustic":
        return cls(
            vocab_size=vocab_size,
            hidden_size=hp["hidden_size"],
            enc_layers=hp["enc_layers"],
            enc_ffn_kernel_size=hp["enc_ffn_kernel_size"],
            ffn_act=hp["ffn_act"],
            dropout=hp.get("dropout", 0.1),
            num_heads=hp["num_heads"],
            use_rope=hp.get("use_rope", False),
            use_lang_id=hp.get("use_lang_id", False),
            num_lang=hp.get("num_lang", 1),
            use_spk_id=hp.get("use_spk_id", False),
            num_spk=hp.get("num_spk", 1),
            variance_embed_list=tuple(v for v in VARIANCE_CHECKLIST
                                      if hp.get(f"use_{v}_embed", False)),
            use_key_shift_embed=hp.get("use_key_shift_embed", False),
            use_speed_embed=hp.get("use_speed_embed", False),
        )
