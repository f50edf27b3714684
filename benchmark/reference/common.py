"""Building blocks of the plain reference: float32 PyTorch, no kernels.

Frozen copies of the math of ``diffsinger_tpu_torch/models/commons.py``
(embeddings, RoPE attention, the conv FFN, the FastSpeech2 encoder, the
sinusoidal step embedding) and ``utils/seq.py`` (frame gather, durations,
length and rhythm regulators), written from the same equations with plain
``torch`` operations. The parameter names are the port's ``state_dict``
names, so one seeded weight maker fills both.

Every product goes through an :class:`Ops`. ``Ops()`` computes in float32
with TF32 off; ``Ops("fp8")`` rounds both operands of every product to float8
e4m3 with a per-tensor scale first and its output to bf16 (the control one
precision step below bf16: fp8 products in a bf16 model); ``Ops("tf32")`` lets cuBLAS and cuDNN round float32 products to TF32
(the control one step below float32 with TF32 off).

In training, :meth:`Ops.drop` applies the dropout masks that the program
drew, handed in by the port's module names (:func:`name_sites`) in the
order of the calls; without masks it is the identity, as in inference.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class Ops:
    """Products in float32, or with fp8-rounded operands (``lowp="fp8"``)."""

    def __init__(self, lowp: Optional[str] = None):
        if lowp not in (None, "fp8", "tf32"):
            raise ValueError(f"unknown precision {lowp!r}")
        self.lowp = lowp
        self.masks = None  # {module name: [(keep mask, p), ...]} in training

    def drop(self, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """``module``'s dropout on x: the next of its masks, scaled by 1 / (1 - p)."""
        if self.masks is None:
            return x
        queue = self.masks.get(module.site + ".dropout")
        if not queue:
            return x
        keep, p = queue.pop(0)
        return x * keep / (1.0 - p)

    @contextlib.contextmanager
    def backend(self):
        """TF32 on for ``"tf32"``, off otherwise, for the products inside."""
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        on = self.lowp == "tf32"
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.lowp != "fp8":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        # the gradient passes straight through the rounding, in float32
        return rounded if not x.requires_grad else x + (rounded - x).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """fp8 products write bf16, as fp8 GEMMs in a bf16 model do."""
        return y.to(torch.bfloat16).float() if self.lowp == "fp8" else y

    def linear(self, x, w, b=None):
        return self.out(F.linear(self.q(x), self.q(w), b))

    def conv1d(self, x, w, b=None, **kw):
        return self.out(F.conv1d(self.q(x), self.q(w), b, **kw))

    def conv_transpose1d(self, x, w, b=None, **kw):
        return self.out(F.conv_transpose1d(self.q(x), self.q(w), b, **kw))

    def matmul(self, a, b):
        return self.out(self.q(a) @ self.q(b))


def name_sites(root: nn.Module) -> nn.Module:
    """Give every module of ``root`` its name as ``site`` (the port's names)."""
    for name, module in root.named_modules():
        module.site = name
    return root


def pointwise(ops: Ops, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv1d on channel-last x [B, T, C]."""
    return ops.linear(x, conv.weight[:, :, 0], conv.bias)


def conv_tc(ops: Ops, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d on channel-last x [B, T, C] (stride 1, its own padding)."""
    return ops.conv1d(x.transpose(1, 2), conv.weight, conv.bias, padding=conv.padding,
                      dilation=conv.dilation, groups=conv.groups).transpose(1, 2)


def step_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] float steps -> [B, dim]: sin block then cos block."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def rope(x: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over [..., L, D], interleaved pairs, theta 10000."""
    d, length = x.shape[-1], x.shape[-2]
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2)[: d // 2].astype(np.float32) / d))
    angles = (torch.arange(length, dtype=torch.float32, device=x.device)[:, None]
              * torch.from_numpy(inv).to(x.device)[None, :])
    angles = torch.repeat_interleave(angles, 2, dim=-1)
    pairs = x.reshape(*x.shape[:-1], d // 2, 2)
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)
    return x * torch.cos(angles) + rotated * torch.sin(angles)


class Attention(nn.Module):
    """RoPE self-attention: ``in_proj`` (no bias) -> heads -> masked softmax
    over the valid keys -> ``out_proj``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = nn.Linear(dim, 3 * dim, bias=False)
        self.out_proj = nn.Linear(dim, dim, bias=False)

    def forward(self, ops: Ops, x: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
        b, length, c = x.shape
        d = c // self.heads
        q, k, v = (z.reshape(b, length, self.heads, d).transpose(1, 2)
                   for z in ops.linear(x, self.in_proj.weight).chunk(3, dim=-1))
        q, k = rope(q), rope(k)
        scores = ops.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        # the lowest finite score, not -inf: a row of padding only (a batch's
        # padded rows) then reads a finite mean that the padding mask zeroes
        scores = scores.masked_fill(pad[:, None, None, :], torch.finfo(scores.dtype).min)
        out = ops.matmul(torch.softmax(scores, dim=-1), v)
        return ops.linear(out.transpose(1, 2).reshape(b, length, c), self.out_proj.weight)


class FFN(nn.Module):
    """Conv1d(k) -> x k^-0.5 -> exact GELU -> Linear."""

    def __init__(self, dim: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.ffn_1 = nn.Conv1d(dim, 4 * dim, kernel_size, padding=kernel_size // 2)
        self.ffn_2 = nn.Linear(4 * dim, dim)

    def forward(self, ops: Ops, x: torch.Tensor) -> torch.Tensor:
        x = conv_tc(ops, self.ffn_1, x) * self.kernel_size ** -0.5
        return ops.linear(ops.drop(self, F.gelu(x)), self.ffn_2.weight, self.ffn_2.bias)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, kernel_size: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = Attention(dim, heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = FFN(dim, kernel_size)


class Layer(nn.Module):
    """``layers.{i}.op``: the reference's nesting of names."""

    def __init__(self, dim: int, heads: int, kernel_size: int):
        super().__init__()
        self.op = Block(dim, heads, kernel_size)


class Encoder(nn.Module):
    """FastSpeech2 encoder with RoPE: x sqrt(H) scaling, pre-LN blocks, a
    final LayerNorm, padded rows zeroed after every block."""

    def __init__(self, dim: int, layers: int, heads: int, kernel_size: int):
        super().__init__()
        self.dim = dim
        self.layers = nn.ModuleList([Layer(dim, heads, kernel_size) for _ in range(layers)])
        self.layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, ops: Ops, embed: torch.Tensor, extra: torch.Tensor,
                pad: torch.Tensor) -> torch.Tensor:
        keep = (~pad).float()[:, :, None]
        x = ops.drop(self, math.sqrt(self.dim) * embed + extra) * keep
        for layer in self.layers:
            blk = layer.op
            x = (x + ops.drop(blk, blk.self_attn(ops, blk.layer_norm1(x), pad))) * keep
            x = (x + ops.drop(blk, blk.ffn(ops, blk.layer_norm2(x)))) * keep
        return self.layer_norm(x) * keep


def curve(lin: nn.Linear, values: torch.Tensor) -> torch.Tensor:
    """Linear(1, H) of a curve [B, T] -> [B, T, H] (kept float32 by the port)."""
    return F.linear(values.float()[:, :, None], lin.weight, lin.bias)


def gather_frames(feats: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
    """[B, T_txt, H] at the 1-based map [B, T_mel] (0 -> a zero row)."""
    padded = F.pad(feats, (0, 0, 1, 0))
    return torch.gather(padded, 1, mel2ph.long()[:, :, None].expand(-1, -1, feats.shape[-1]))


def durations(mel2ph: torch.Tensor, t_txt: int) -> torch.Tensor:
    """Frames per token from a 1-based map: [B, T_mel] -> [B, t_txt]."""
    dur = torch.zeros((mel2ph.shape[0], t_txt + 1), dtype=torch.float32, device=mel2ph.device)
    dur.scatter_add_(1, mel2ph.long(), torch.ones_like(mel2ph, dtype=torch.float32))
    return dur[:, 1:]


def length_regulator(dur: torch.Tensor, length: int) -> torch.Tensor:
    """Integer durations [B, T] -> 1-based frame map [B, length] (0 past the end)."""
    ends = torch.cumsum(dur.long(), dim=1)
    pos = torch.arange(length, device=dur.device)[None, :].expand(dur.shape[0], -1)
    idx = torch.searchsorted(ends.contiguous(), pos.contiguous(), right=True)
    return torch.where(pos < ends[:, -1:], idx + 1, 0)


def rhythm_regulator(ph_dur: torch.Tensor, ph2word: torch.Tensor,
                     word_dur: torch.Tensor) -> torch.Tensor:
    """Scale phoneme durations so each word's sum meets its duration; round
    half to even."""
    ph_dur = ph_dur.float() * (ph2word > 0)
    idx = ph2word.long()
    sums = torch.zeros((word_dur.shape[0], word_dur.shape[1] + 1), device=ph_dur.device)
    sums = sums.scatter_add(1, idx, ph_dur)[:, 1:]
    alpha = word_dur.float() / sums.clamp(min=1e-5)
    return torch.round(ph_dur * torch.gather(F.pad(alpha, (1, 0)), 1, idx)).long()


def euler(velocity, x: torch.Tensor, t_start: float, steps: int, scale: float) -> torch.Tensor:
    """Rectified flow's euler integration from ``t_start`` to 1."""
    dt = (1.0 - t_start) / max(1, steps)
    for i in range(steps):
        t = torch.full((x.shape[0],), float(i), dtype=torch.float32, device=x.device) * dt + t_start
        x = x + velocity(x, scale * t) * dt
    return x
