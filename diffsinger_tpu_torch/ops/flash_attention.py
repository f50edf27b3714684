"""K3: float32 flash-attention forward with key-padding segments.

Counterpart of the TPU library kernel that diffsinger_tpu/models/commons.py
(SelfAttentionRoPE) calls with ``SegmentIds(q=seg, kv=seg)``: a valid query
sees only valid keys and a padded query only padded keys. The CUDA kernel is
``csrc/flash_attention.cu`` (its header note gives the bound and the design);
:func:`flash_attention_plain` is the plain PyTorch version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from diffsinger_tpu_torch.ops import native

# launches of the CUDA kernel in this process
launches = 0

# query rows per block that the kernel is built for, largest first
BQ_CHOICES = (128, 64, 32, 16)
# a grid of at least this many blocks counts as filling the card's 132 SMs
MIN_BLOCKS = 120


def choose_bq(length: int, batch_heads: int) -> int:
    """Query rows per block for q [.., length, D] over ``batch_heads`` (B * H).

    The largest tile whose grid ``ceil(length / bq) * batch_heads`` still has
    about a block for every SM, so that K and V are re-read as rarely as a full
    card allows; the smallest tile where no tile fills the card.
    """
    for bq in BQ_CHOICES:
        if -(-length // bq) * batch_heads >= MIN_BLOCKS:
            return bq
    return BQ_CHOICES[-1]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_padding_mask: Optional[torch.Tensor] = None, *,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K3. q, k, v [B, H, L, D]; key_padding_mask [B, L], True = pad."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    if key_padding_mask is not None:
        seg = key_padding_mask
        visible = seg[:, None, :, None] == seg[:, None, None, :]  # [B, 1, Lq, Lk]
        scores = scores.masked_fill(~visible, float("-inf"))
    return torch.softmax(scores, dim=-1) @ v.float()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of float32 q, k, v [B, H, L, D] (D in 32, 64, 128).

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the kernel or raises.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_padding_mask, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    b, h, l, d = q.shape
    if d not in (32, 64, 128):
        raise ValueError(f"head dim {d} is not 32, 64 or 128")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    like = dict(device=q.device, dtype=torch.float32, shape=(b, h, l, d))
    native.require(q, "q", **like)
    native.require(k, "k", **like)
    native.require(v, "v", **like)
    pad = None
    if key_padding_mask is not None:
        native.require(key_padding_mask, "key_padding_mask", device=q.device,
                       dtype=torch.bool, shape=(b, l))
        pad = key_padding_mask.view(torch.uint8)
    out = torch.empty_like(q)
    lib = native.load("flash_attention")
    rc = lib.ds_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if pad is None else pad.data_ptr(),
        out.data_ptr(), b, h, l, d, float(sm_scale), choose_bq(l, b * h), native.stream_ptr(q))
    native.check(rc, "flash_attention")
    global launches
    launches += 1
    return out
