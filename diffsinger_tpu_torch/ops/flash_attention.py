"""K3: float32 flash attention with key-padding segments, forward and backward.

Counterpart of the TPU library kernel that diffsinger_tpu/models/commons.py
(SelfAttentionRoPE) calls with ``SegmentIds(q=seg, kv=seg)``: a valid query
sees only valid keys and a padded query only padded keys. Under ``jax.grad``
the library's custom_vjp runs two more TPU kernels, ``_flash_attention_bwd_dkv``
and ``_flash_attention_bwd_dq``; the port's counterpart is the backward of
:class:`FlashAttentionFn`. The CUDA kernels are ``csrc/flash_attention.cu``
(its header note gives the bounds and the design);
:func:`flash_attention_plain` and :func:`flash_attention_bwd_plain` are the
plain PyTorch versions, the latter the same backward formulas (not autograd of
the plain forward).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from diffsinger_tpu_torch.ops import native

# launches of the CUDA forward kernel, and of the backward (two kernels a
# call), in this process
launches = 0
bwd_launches = 0

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


def _masked_scores(q, k, key_padding_mask, sm_scale):
    scores = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    if key_padding_mask is not None:
        seg = key_padding_mask
        visible = seg[:, None, :, None] == seg[:, None, None, :]  # [B, 1, Lq, Lk]
        scores = scores.masked_fill(~visible, float("-inf"))
    return scores


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_padding_mask: Optional[torch.Tensor] = None, *,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K3. q, k, v [B, H, L, D]; key_padding_mask [B, L], True = pad."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.softmax(_masked_scores(q, k, key_padding_mask, sm_scale), dim=-1) @ v.float()


def attention_lse_plain(q, k, key_padding_mask=None, *, sm_scale: float) -> torch.Tensor:
    """Plain version of the forward's second output: the log-sum-exp of each
    row's visible scaled scores, [B, H, L] float32."""
    return torch.logsumexp(_masked_scores(q, k, key_padding_mask, sm_scale), dim=-1)


def flash_attention_bwd_plain(q, k, v, key_padding_mask, out, lse, dout, *,
                              sm_scale: float):
    """Plain version of K3's backward: (dq, dk, dv) of the segment-masked
    attention from the forward's output and row log-sum-exp, by the kernel's
    formulas: P = exp(S * scale - lse) on visible pairs, dV = P^T dO,
    dS = P (dO V^T - rowsum(dO O)), dQ = dS K scale, dK = dS^T Q scale."""
    s = q.float() @ k.float().transpose(-1, -2)
    p = torch.exp(s * sm_scale - lse[..., None])
    if key_padding_mask is not None:
        seg = key_padding_mask
        p = p.masked_fill(seg[:, None, :, None] != seg[:, None, None, :], 0.0)
    dout = dout.float()
    dv = p.transpose(-1, -2) @ dout
    delta = (dout * out.float()).sum(-1, keepdim=True)
    ds = p * (dout @ v.float().transpose(-1, -2) - delta)
    return ds @ k.float() * sm_scale, ds.transpose(-1, -2) @ q.float() * sm_scale, dv


def _checked(q, k, v, key_padding_mask):
    """Raise unless the kernels take these inputs; the mask as bytes (or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    b, h, l, d = q.shape
    if d not in (32, 64, 128):
        raise ValueError(f"head dim {d} is not 32, 64 or 128")
    like = dict(device=q.device, dtype=torch.float32, shape=(b, h, l, d))
    native.require(q, "q", **like)
    native.require(k, "k", **like)
    native.require(v, "v", **like)
    if key_padding_mask is None:
        return None
    native.require(key_padding_mask, "key_padding_mask", device=q.device,
                   dtype=torch.bool, shape=(b, l))
    return key_padding_mask.view(torch.uint8)


def _launch_fwd(q, k, v, key_padding_mask, sm_scale, lse=None):
    pad = _checked(q, k, v, key_padding_mask)
    b, h, l, d = q.shape
    if lse is not None:
        native.require(lse, "lse", device=q.device, dtype=torch.float32, shape=(b, h, l))
    out = torch.empty_like(q)
    lib = native.load("flash_attention")
    rc = lib.ds_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if pad is None else pad.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, h, l, d, float(sm_scale),
        choose_bq(l, b * h), native.stream_ptr(q))
    native.check(rc, "flash_attention")
    global launches
    launches += 1
    return out


def bwd_scratch(batch_heads: int, length: int, device) -> torch.Tensor:
    """The backward's dS, float32 [batch_heads, LP, LP] (LP = length rounded
    up to 64): the dK/dV kernel writes it where a tile pair is visible, and
    the dQ kernel reads back only those.

    It takes 4 * batch_heads * LP^2 bytes, quadratic in the length: 6.3 MB at
    [48 x 2 heads, 128], 33.5 MB at [16 x 2, 512], 0.54 GB at [16 x 2, 2048].
    Under a batch sampler's frame budget F (B * L <= F, a token lasting at
    least one frame) it is at most 4 * H * F * LP bytes: 0.33 GB at H = 2,
    F = 80,000 and LP = 512, 1.3 GB at LP = 2048."""
    lp = -(-length // 64) * 64
    return torch.empty(batch_heads, lp, lp, device=device, dtype=torch.float32)


def flash_attention_bwd(q, k, v, key_padding_mask, out, lse, dout, *, sm_scale: float):
    """(dq, dk, dv) of K3 from the forward's output and log-sum-exp.

    On CPU tensors this is the plain version; on CUDA tensors it launches the
    two backward kernels (dK/dV with delta and dS, then dQ) or raises.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, key_padding_mask, out, lse, dout,
                                         sm_scale=sm_scale)
    pad = _checked(q, k, v, key_padding_mask)
    b, h, l, d = q.shape
    native.require(out, "out", device=q.device, dtype=torch.float32, shape=q.shape)
    native.require(dout, "dout", device=q.device, dtype=torch.float32, shape=q.shape)
    native.require(lse, "lse", device=q.device, dtype=torch.float32, shape=(b, h, l))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ds = bwd_scratch(b * h, l, q.device)
    native.check(native.load("flash_attention").ds_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if pad is None else pad.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), ds.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, l, d, float(sm_scale), 3, native.stream_ptr(q)),
        "flash_attention bwd")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """K3 under autograd: the forward also keeps the row log-sum-exp, and the
    backward is :func:`flash_attention_bwd`. Inputs and gradients are float32,
    whatever autocast is doing around the call."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.float32)
    def forward(ctx, q, k, v, key_padding_mask, sm_scale):
        if q.device.type == "cpu":
            out = flash_attention_plain(q, k, v, key_padding_mask, sm_scale=sm_scale)
            lse = attention_lse_plain(q, k, key_padding_mask, sm_scale=sm_scale)
        else:
            lse = torch.empty(q.shape[:3], device=q.device, dtype=torch.float32)
            out = _launch_fwd(q, k, v, key_padding_mask, sm_scale, lse)
        ctx.save_for_backward(q, k, v, key_padding_mask, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        q, k, v, key_padding_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, key_padding_mask, out, lse,
                                         dout.float().contiguous(), sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of float32 q, k, v [B, H, L, D] (D in 32, 64, 128).

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the kernel or raises. Where a gradient is wanted it goes through
    :class:`FlashAttentionFn` (whose forward also writes the log-sum-exp);
    the inference call does not pay for that.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, key_padding_mask, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_padding_mask, sm_scale=sm_scale)
    return _launch_fwd(q, k, v, key_padding_mask, sm_scale)
