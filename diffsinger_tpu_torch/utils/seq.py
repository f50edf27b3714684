"""Frame alignment helpers (counterpart of diffsinger_tpu/utils/seq.py).

``mel2ph`` is 1-based: frame -> token index + 1, and 0 marks a padded frame.
``ph2word`` is 1-based too: phoneme -> word index, and 0 marks a padded phoneme.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def length_regulator(dur: torch.Tensor, out_length: int) -> torch.Tensor:
    """Expand durations into a frame->token map: [B, T_txt] int durations ->
    [B, out_length] int32 mel2ph (frames past the total are 0)."""
    csum = torch.cumsum(dur.long(), dim=1)  # [B, T_txt]
    pos = torch.arange(out_length, device=dur.device)[None, :].expand(dur.shape[0], -1)
    idx = torch.searchsorted(csum.contiguous(), pos.contiguous(), right=True)
    return torch.where(pos < csum[:, -1:], idx + 1, 0).to(torch.int32)


def rhythm_regulator(ph_dur: torch.Tensor, ph2word: torch.Tensor, word_dur: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Rescale phoneme durations so that each word's phonemes sum to the word's
    duration: ph_dur [B, T_ph] float, ph2word [B, T_ph], word_dur [B, T_w] ->
    [B, T_ph] int32 (rounded half to even)."""
    ph_dur = ph_dur.float() * (ph2word > 0)
    word_dur = word_dur.float()
    b, t_w = word_dur.shape
    idx = ph2word.long()
    word_dur_in = torch.zeros((b, t_w + 1), dtype=torch.float32, device=ph_dur.device)
    word_dur_in = word_dur_in.scatter_add(1, idx, ph_dur)[:, 1:]
    alpha_w = word_dur / torch.clamp(word_dur_in, min=eps)
    alpha_ph = torch.gather(F.pad(alpha_w, (1, 0)), 1, idx)
    return torch.round(ph_dur * alpha_ph).to(torch.int32)


def mel2ph_to_dur(mel2ph: torch.Tensor, t_txt: int, max_dur: Optional[int] = None) -> torch.Tensor:
    """Frame->token map back to durations: [B, T_mel] -> [B, t_txt] (scatter-add)."""
    b = mel2ph.shape[0]
    dur = torch.zeros((b, t_txt + 1), dtype=torch.int64, device=mel2ph.device)
    dur.scatter_add_(1, mel2ph.long(), torch.ones_like(mel2ph, dtype=torch.int64))
    dur = dur[:, 1:]
    if max_dur is not None:
        dur = dur.clamp(max=max_dur)
    return dur


def gather_frames(token_feats: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
    """Broadcast token features to frames: [B, T_txt, H], [B, T_mel] -> [B, T_mel, H].

    ``mel2ph == 0`` selects a zero row, as the reference's pad-then-gather does.
    """
    padded = F.pad(token_feats, (0, 0, 1, 0))
    idx = mel2ph.long()[:, :, None].expand(-1, -1, token_feats.shape[-1])
    return torch.gather(padded, 1, idx)
