"""Shared NN primitives (counterpart of diffsinger_tpu/models/commons.py).

Embeddings and linears with the reference init, the sinusoidal step
embedding, rotary and absolute position embeddings, the conv-FFN and the
FastSpeech2 transformer encoder, with or without RoPE. Activations are
channel-last [B, T, C]; attribute names follow the reference torch
``state_dict`` (``layers.{i}.op.self_attn.in_proj`` with RoPE,
``self_attn.in_proj_weight`` without, ``ffn.ffn_1`` ...). Softmax and the
rotary phases run in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.ops.flash_attention import flash_attention, flash_attention_op


class Embedding(nn.Embedding):
    """Embedding with the reference init: N(0, dim^-0.5), zero pad row.

    The pad row only starts at zero: it trains like any other row, as the JAX
    package's does (torch's ``padding_idx`` would hold its gradient at zero).
    That matters where index 0 also marks a real value: a note without glide,
    a phoneme without a language tag."""

    def __init__(self, num_embeddings: int, features: int, padding_idx: Optional[int] = None):
        super().__init__(num_embeddings, features)
        nn.init.normal_(self.weight, 0.0, features ** -0.5)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx].zero_()


class Linear(nn.Linear):
    """Linear with xavier-uniform weights and a zero bias (XavierUniformInitLinear)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        nn.init.xavier_uniform_(self.weight)
        if bias:
            nn.init.zeros_(self.bias)


class CurveEmbed(Linear):
    """Linear(1, H) embedding of a curve [B, T] -> [B, T, H], in float32.

    The JAX package's curve embeds take no compute dtype, so their parameters,
    inputs and outputs stay float32 in a bf16 model; a curve rounded to bf16
    moves f0's conditioning by up to 8.6 cents and durations above 256 frames
    by up to 4 frames. So this layer keeps float32 parameters when its model is
    cast to another dtype (a cast moves them to the new device only), and runs
    outside autocast. Callers cast the sum of the embeds into the model's dtype.
    """

    def __init__(self, features: int):
        super().__init__(1, features)

    def _apply(self, fn, recurse=True):
        def keep_dtype(t):
            out = fn(t)
            return t.to(out.device) if t.is_floating_point() and out.dtype != t.dtype else out

        return super()._apply(keep_dtype, recurse)

    def forward(self, curve: torch.Tensor) -> torch.Tensor:
        with torch.autocast(curve.device.type, enabled=False):
            return super().forward(curve.float()[:, :, None])


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Diffusion-step embedding: [B] float steps -> [B, dim] float32 (sin block, cos block)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def apply_rope(x: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over the last two axes [..., L, D]: interleaved pairs,
    full head rotation, float32 phases (lucidrains RotaryEmbedding 'lang' freqs:
    theta^(-2i/D), each repeated twice; rotate_half maps (x0, x1) -> (-x1, x0))."""
    d, length = x.shape[-1], x.shape[-2]
    freqs = 1.0 / (10000.0 ** (np.arange(0, d, 2)[: d // 2].astype(np.float32) / d))
    t = torch.arange(length, dtype=torch.float32, device=x.device)
    angles = t[:, None] * torch.from_numpy(freqs).to(x.device)[None, :]  # [L, D/2]
    angles = torch.repeat_interleave(angles, 2, dim=-1)  # [L, D] interleaved
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf = x.float()
    x2 = xf.reshape(*x.shape[:-1], d // 2, 2)
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)
    return (xf * cos + rot * sin).to(x.dtype)


# Rows of the absolute positional table: the longest phoneme or note sequence
# an encoder without RoPE and relative positions can take.
MAX_POSITIONS = 4096


def sinusoidal_positional_table(num_positions: int, dim: int, padding_idx: int = 0) -> np.ndarray:
    """Absolute positional table [num_positions, dim] (tensor2tensor layout:
    sin block then cos block, the reference's
    ``SinusoidalPositionalEmbedding.get_embedding``); row ``padding_idx`` is 0."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    inv = np.exp(np.arange(half, dtype=np.float64) * -emb)
    pos = np.arange(num_positions, dtype=np.float64)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_positions, 1))], axis=1)
    table[padding_idx] = 0
    return table.astype(np.float32)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_padding_mask: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over [B, H, L, D] in float32: K3 on CUDA
    tensors, its plain version on CPU tensors. Padding follows the TPU
    kernel's segment ids (valid sees valid, pad sees pad), so padded query
    rows differ from a plain masked softmax; the encoder zeroes them right
    after. While ``torch.export`` traces it, the core is the custom op
    ``ds::flash_attention``, so that the exported program launches K3."""
    args = (q.float().contiguous(), k.float().contiguous(), v.float().contiguous(),
            key_padding_mask.contiguous())
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.compiler.is_exporting():  # one graph node, launched as K3 by the program
        return flash_attention_op(*args, sm_scale)
    return flash_attention(*args, sm_scale=sm_scale)


class _PackedSelfAttention(nn.Module):
    """Multi-head self-attention over a packed QKV projection (no bias) and an
    ``out_proj``; its softmax core is :func:`attention_core` (K3)."""

    def qkv(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rotate(self, z: torch.Tensor) -> torch.Tensor:
        return z

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor) -> torch.Tensor:
        b, length, c = x.shape
        h = self.num_heads
        d = c // h
        q, k, v = self.qkv(x).chunk(3, dim=-1)

        def heads(z):
            return z.reshape(b, length, h, d).transpose(1, 2)  # [B, H, L, D]

        out = attention_core(self.rotate(heads(q)), self.rotate(heads(k)), heads(v),
                             key_padding_mask).to(x.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(b, length, c))


class SelfAttentionRoPE(_PackedSelfAttention):
    """Self-attention with RoPE on the queries and keys (``in_proj`` /
    ``out_proj`` Linears)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj = nn.Linear(embed_dim, 3 * embed_dim, bias=False)
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=False)

    def qkv(self, x: torch.Tensor) -> torch.Tensor:
        return self.in_proj(x)

    def rotate(self, z: torch.Tensor) -> torch.Tensor:
        return apply_rope(z)


class SelfAttentionAbs(_PackedSelfAttention):
    """The attention of the encoders without RoPE: the reference's
    ``nn.MultiheadAttention`` without bias, whose ``state_dict`` names the
    packed projection ``in_proj_weight`` (a parameter, not a Linear) and the
    output ``out_proj``. The same core (K3) at the same scale, no rotation.
    The JAX module masks keys only, so its padded rows attend to the valid
    keys where K3's attend to the pad keys; the encoder zeroes those rows
    after every layer, so the outputs agree."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=False)

    def qkv(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.in_proj_weight)


def swiglu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    out, gate = x.chunk(2, dim=dim)
    return out * F.silu(gate)


class TransformerFFN(nn.Module):
    """Conv1d(k) -> x k^-0.5 -> act -> dropout -> Linear (TransformerFFNLayer)."""

    def __init__(self, hidden_size: int, filter_size: int, kernel_size: int = 9,
                 act: str = "gelu", dropout: float = 0.0):
        super().__init__()
        if act not in ("gelu", "relu", "swish", "swiglu"):
            raise ValueError(f"{act} is not a valid activation")
        self.kernel_size = kernel_size
        self.act = act
        width = filter_size * 2 if act == "swiglu" else filter_size
        self.ffn_1 = nn.Conv1d(hidden_size, width, kernel_size, padding=kernel_size // 2)
        self.dropout = nn.Dropout(dropout)
        self.ffn_2 = Linear(filter_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ffn_1(x.transpose(1, 2)).transpose(1, 2)
        x = x * self.kernel_size ** -0.5
        if self.act == "gelu":
            x = F.gelu(x)
        elif self.act == "relu":
            x = F.relu(x)
        elif self.act == "swish":
            x = F.silu(x)
        else:
            x = swiglu(x)
        return self.ffn_2(self.dropout(x))


class EncSALayer(nn.Module):
    """Pre-LN self-attention + conv-FFN block; in training mode dropout acts
    on both residual branches and inside the FFN (the attention itself has
    none, as in the JAX encoder)."""

    def __init__(self, hidden_size: int, num_heads: int, kernel_size: int = 9,
                 act: str = "gelu", dropout: float = 0.0, use_rope: bool = True):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.self_attn = (SelfAttentionRoPE if use_rope else SelfAttentionAbs)(hidden_size,
                                                                               num_heads)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.ffn = TransformerFFN(hidden_size, 4 * hidden_size, kernel_size=kernel_size, act=act,
                                  dropout=dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        nonpadding = (~padding_mask).to(x.dtype)[:, :, None]
        y = self.dropout(self.self_attn(self.layer_norm1(x), padding_mask))
        x = (x + y) * nonpadding
        y = self.dropout(self.ffn(self.layer_norm2(x)))
        return (x + y) * nonpadding


class TransformerEncoderLayer(nn.Module):
    """Holds an EncSALayer as ``op``, the reference's nesting of names."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.op = EncSALayer(*args, **kwargs)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        return self.op(x, padding_mask)


class FastSpeech2Encoder(nn.Module):
    """N-layer transformer with x sqrt(H) input scaling and a final LN.

    With ``use_rope`` the attention rotates its queries and keys and no
    position is added. Without it (:class:`SelfAttentionAbs`) and with
    ``use_pos_embed``: under ``rel_pos`` the input is scaled by sqrt(H) once
    more (the reference's ESPnet ``RelPositionalEncoding`` adds nothing
    absolute, and its position term feeds an attention it never enables);
    else the sinusoidal table's row of each token's position among the
    valid tokens (1-based, padding row 0) is added.
    """

    def __init__(self, hidden_size: int, num_layers: int, ffn_kernel_size: int = 9,
                 ffn_act: str = "gelu", num_heads: int = 2, use_rope: bool = True,
                 dropout: float = 0.1, use_pos_embed: bool = True, rel_pos: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.use_rope = use_rope
        self.use_pos_embed = use_pos_embed
        self.rel_pos = rel_pos
        if use_pos_embed and not use_rope and not rel_pos:
            self.register_buffer("pos_table", torch.from_numpy(
                sinusoidal_positional_table(MAX_POSITIONS, hidden_size)), persistent=False)
        self.dropout = nn.Dropout(dropout)
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(hidden_size, num_heads, kernel_size=ffn_kernel_size,
                                    act=ffn_act, dropout=dropout, use_rope=use_rope)
            for _ in range(num_layers)
        ])
        self.layer_norm = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, main_embed: torch.Tensor, extra_embed: Optional[torch.Tensor],
                padding_mask: torch.Tensor) -> torch.Tensor:
        x = math.sqrt(self.hidden_size) * main_embed
        if extra_embed is not None:
            x = x + extra_embed
        if self.use_pos_embed and not self.use_rope:
            if self.rel_pos:
                x = x * math.sqrt(self.hidden_size)
            else:
                valid = ~padding_mask
                positions = torch.cumsum(valid.long(), dim=1) * valid
                x = x + self.pos_table.to(x.dtype)[positions]
        nonpadding = (~padding_mask).to(x.dtype)[:, :, None]
        x = self.dropout(x) * nonpadding
        for layer in self.layers:
            x = layer(x, padding_mask) * nonpadding
        return self.layer_norm(x) * nonpadding
