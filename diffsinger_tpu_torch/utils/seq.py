"""Frame alignment helpers (counterpart of diffsinger_tpu/utils/seq.py).

``mel2ph`` is 1-based: frame -> token index + 1, and 0 marks a padded frame.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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
