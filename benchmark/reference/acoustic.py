"""Plain reference of the acoustic model's inference: float32 PyTorch.

A frozen copy of the math of the port's ``models/acoustic_encoder.py``
(FastSpeech2Acoustic without speaker, language, variance, key-shift or speed
embeds), ``models/aux_decoder.py`` (the ConvNeXt draft),
``models/backbones/lynxnet.py`` with ``ops/lynx_fused.py``'s conv module
written as its equations (LayerNorm, 1x1 conv to 2I, SwiGLU, depthwise conv,
PReLU, 1x1 conv back; no kernel), ``core/reflow.py``'s euler sampler and
``core/spec_transform.py``'s normalisation, in the shape of
``models/toplevel.py::DiffSingerAcoustic.forward_infer``. The condition is
the same at every step, so its projections are made once a request.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import (Encoder, Ops, conv_tc, curve, durations, euler, gather_frames, pointwise,
                     step_embedding)


class FS2(nn.Module):
    def __init__(self, hp: dict, vocab: int):
        super().__init__()
        h = hp["hidden_size"]
        self.txt_embed = nn.Embedding(vocab, h)
        self.dur_embed = nn.Linear(1, h)
        self.encoder = Encoder(h, hp["enc_layers"], hp["num_heads"], hp["enc_ffn_kernel_size"])
        self.pitch_embed = nn.Linear(1, h)

    def forward(self, ops: Ops, tokens, mel2ph, f0):
        extra = curve(self.dur_embed, durations(mel2ph, tokens.shape[1]))
        enc = self.encoder(ops, self.txt_embed(tokens.long()), extra, tokens == 0)
        return gather_frames(enc, mel2ph) + curve(self.pitch_embed, torch.log(1 + f0.float() / 700))


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.zeros(dim))

    def forward(self, ops: Ops, x):
        y = self.norm(conv_tc(ops, self.dwconv, x))
        y = ops.linear(F.gelu(ops.linear(y, self.pwconv1.weight, self.pwconv1.bias)),
                       self.pwconv2.weight, self.pwconv2.bias)
        return x + ops.drop(self, self.gamma * y)


class ConvNeXtDecoder(nn.Module):
    def __init__(self, in_dims: int, out_dims: int, channels: int, layers: int, kernel: int):
        super().__init__()
        self.inconv = nn.Conv1d(in_dims, channels, kernel, padding=(kernel - 1) // 2)
        self.conv = nn.ModuleList([ConvNeXtBlock(channels) for _ in range(layers)])
        self.outconv = nn.Conv1d(channels, out_dims, kernel, padding=(kernel - 1) // 2)

    def forward(self, ops: Ops, x):
        x = conv_tc(ops, self.inconv, x)
        for block in self.conv:
            x = block(ops, x)
        return conv_tc(ops, self.outconv, x)


class AuxDecoder(nn.Module):
    """``aux_decoder.decoder``."""

    def __init__(self, hp: dict, out_dims: int):
        super().__init__()
        args = hp["shallow_diffusion_args"]["aux_decoder_args"]
        self.decoder = ConvNeXtDecoder(hp["hidden_size"], out_dims, args["num_channels"],
                                       args["num_layers"], args["kernel_size"])


class ConvModule(nn.Module):
    """``convmodule.net``: 0 LayerNorm, 2 pw1 (C -> 2I), 4 depthwise, 5 PReLU, 6 pw2."""

    def __init__(self, dim: int, inner: int, kernel: int):
        super().__init__()
        self.net = nn.ModuleList([
            nn.LayerNorm(dim, eps=1e-5), nn.Identity(), nn.Conv1d(dim, 2 * inner, 1),
            nn.Identity(), nn.Conv1d(inner, inner, kernel, groups=inner), PReLU(inner),
            nn.Conv1d(inner, dim, 1)])

    def forward(self, ops: Ops, x):
        net = self.net
        value, gate = pointwise(ops, net[2], net[0](x)).chunk(2, dim=-1)
        s = value * F.silu(gate)
        k = net[4].weight.shape[-1]
        s = F.pad(s.transpose(1, 2), (k // 2, k - 1 - k // 2))
        z = ops.conv1d(s, net[4].weight, net[4].bias, groups=s.shape[1]).transpose(1, 2)
        z = torch.where(z >= 0, z, net[5].weight * z)
        return pointwise(ops, net[6], z)


class PReLU(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features))


class ResidualLayer(nn.Module):
    def __init__(self, cond: int, dim: int, inner: int, kernel: int):
        super().__init__()
        self.diffusion_projection = nn.Conv1d(dim, dim, 1)
        self.conditioner_projection = nn.Conv1d(cond, dim, 1)
        self.convmodule = ConvModule(dim, inner, kernel)

    def forward(self, ops: Ops, x, proj, step):
        x = x + proj  # strong_cond: the condition enters before the residual
        y = x + pointwise(ops, self.diffusion_projection, step)[:, None, :]
        return self.convmodule(ops, y) + x


class LYNXNet(nn.Module):
    def __init__(self, hp: dict, in_dims: int):
        super().__init__()
        args = hp["backbone_args"]
        c = args["num_channels"]
        self.channels = c
        self.input_projection = nn.Conv1d(in_dims, c, 1)
        self.diffusion_embedding = nn.ModuleList(
            [nn.Identity(), nn.Linear(c, 4 * c), nn.Identity(), nn.Linear(4 * c, c)])
        self.residual_layers = nn.ModuleList([
            ResidualLayer(hp["hidden_size"], c, c * args.get("expansion_factor", 2),
                          args["kernel_size"]) for _ in range(args["num_layers"])])
        self.norm = nn.LayerNorm(c, eps=1e-5)
        self.output_projection = nn.Conv1d(c, in_dims, 1)

    def forward(self, ops: Ops, spec, t, projs):
        """``projs``: each layer's projection of the condition, made once a request."""
        x = pointwise(ops, self.input_projection, spec)
        emb = self.diffusion_embedding
        step = step_embedding(t, self.channels)
        step = ops.linear(F.gelu(ops.linear(step, emb[1].weight, emb[1].bias)),
                          emb[3].weight, emb[3].bias)
        for layer, proj in zip(self.residual_layers, projs):
            x = layer(ops, x, proj, step)
        return pointwise(ops, self.output_projection, self.norm(x))


class Diffusion(nn.Module):
    def __init__(self, hp: dict, out_dims: int):
        super().__init__()
        self.velocity_fn = LYNXNet(hp, out_dims)


class AcousticReference(nn.Module):
    """``forward(tokens, mel2ph, f0, noise)`` -> mel [B, T_mel, M] float32:
    encoder, ConvNeXt draft, shallow euler sampler from the draft blended
    with ``noise`` at ``T_start_infer``, denormalised, padded frames zero."""

    def __init__(self, hp: dict, vocab: int, lowp=None):
        super().__init__()
        unsupported = [k for k in ("use_spk_id", "use_lang_id", "use_key_shift_embed",
                                   "use_speed_embed", "use_energy_embed", "use_breathiness_embed",
                                   "use_voicing_embed", "use_tension_embed") if hp.get(k)]
        if (unsupported or not hp.get("use_rope") or hp["diffusion_type"] != "reflow"
                or hp["backbone_type"] != "lynxnet" or not hp["use_shallow_diffusion"]
                or not hp["backbone_args"].get("strong_cond")
                or hp["backbone_args"].get("activation", "PReLU") != "PReLU"
                or hp.get("sampling_algorithm", "euler") != "euler"):
            raise ValueError(f"the reference covers the benchmark's acoustic config only "
                             f"({unsupported})")
        self.hp = hp
        self.ops = Ops(lowp)
        m = hp["audio_num_mel_bins"]
        self.fs2 = FS2(hp, vocab)
        self.aux_decoder = AuxDecoder(hp, m)
        self.diffusion = Diffusion(hp, m)
        smin = torch.tensor(hp["spec_min"], dtype=torch.float32).reshape(-1)[:m]
        smax = torch.tensor(hp["spec_max"], dtype=torch.float32).reshape(-1)[:m]
        self.register_buffer("smin", smin.expand(m).clone(), persistent=False)
        self.register_buffer("smax", smax.expand(m).clone(), persistent=False)

    @torch.no_grad()
    def forward(self, tokens, mel2ph, f0, noise):
        with self.ops.backend():
            return self._forward(tokens, mel2ph, f0, noise)

    def _forward(self, tokens, mel2ph, f0, noise):
        ops, hp = self.ops, self.hp
        cond = self.fs2(ops, tokens, mel2ph, f0)
        mask = (mel2ph > 0).float()[:, :, None]
        span = self.smax - self.smin
        aux = self.aux_decoder.decoder(ops, cond) * (span / 2) + (self.smax + self.smin) / 2
        src = (aux * mask - self.smin) / span * 2 - 1
        t0 = hp["T_start_infer"]
        x = t0 * src + (1 - t0) * noise.float()
        net = self.diffusion.velocity_fn
        projs = [pointwise(ops, layer.conditioner_projection, cond)
                 for layer in net.residual_layers]
        x = euler(lambda x, t: net(ops, x, t, projs), x, t0, hp["sampling_steps"],
                  hp["time_scale_factor"])
        return ((x + 1) / 2 * span + self.smin) * mask
