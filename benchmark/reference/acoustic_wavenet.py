"""Plain reference of the WaveNet-DDPM acoustic model's inference: float32 PyTorch.

The encoder and the ConvNeXt draft are ``acoustic.py``'s, the WaveNet
denoiser ``variance.py``'s (the port's ``models/backbones/wavenet.py`` with
its residual blocks written as their equations; no kernel). Around them a
frozen copy of the math of the port's ``core/schedule.py`` (the linear beta
schedule) and ``core/ddpm.py`` (``q_sample`` and DDIM with eta 0), with
``core/spec_transform.py``'s normalisation, in the shape of
``models/toplevel.py::DiffSingerAcoustic.forward_infer`` under shallow
diffusion:

- the linear schedule runs from 1e-4 to 0.01 whatever ``max_beta`` says:
  the upstream reference never forwards ``max_beta`` into it, and the port
  keeps that;
- the draft, normalised, is noised to ``t = K - 1`` (``K`` the smaller of
  ``K_step_infer`` and ``K_step``) with the chunk row's noise;
- DDIM steps from ``(K - 1) // s * s`` down to 0 at stride ``s``
  (``diff_speedup``); below the stride ``a_prev`` is ``acp[0]``, not 1, as in
  the port and the upstream reference. The step's scalars are combined in
  float32 numpy, as the port combines them.

The condition is the same at every step, so its projections are made once a
request.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .acoustic import FS2, AuxDecoder
from .common import Ops, pointwise
from .variance import WaveNet


def linear_alphas_cumprod(timesteps: int) -> np.ndarray:
    """The cumulative products of the linear schedule, in float64 (1e-4 to
    0.01: ``max_beta`` is unread)."""
    return np.cumprod(1.0 - np.linspace(1e-4, 0.01, timesteps))


def q_sample(acp: np.ndarray, x0: torch.Tensor, t: int, noise: torch.Tensor) -> torch.Tensor:
    """x0 noised to step ``t``: the coefficients are float32 values of the
    float64 square roots."""
    c1, c2 = np.float32(np.sqrt(acp[t])), np.float32(np.sqrt(1.0 - acp[t]))
    return float(c1) * x0 + float(c2) * noise


def ddim(eps_fn, acp: np.ndarray, x: torch.Tensor, t_max: int, interval: int) -> torch.Tensor:
    """DDIM (eta 0) from ``(t_max - 1) // interval * interval`` down to 0."""
    acp32 = acp.astype(np.float32)
    one = np.float32(1)
    for t in range((t_max - 1) // interval * interval, -1, -interval):
        a_t, a_prev = acp32[t], acp32[max(t - interval, 0)]
        eps_c = np.sqrt((one - a_prev) / a_prev) - np.sqrt((one - a_t) / a_t)
        steps = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
        eps = eps_fn(x, steps)
        x = float(np.sqrt(a_prev)) * (x / float(np.sqrt(a_t)) + float(eps_c) * eps)
    return x


class Diffusion(nn.Module):
    def __init__(self, hp: dict, out_dims: int):
        super().__init__()
        self.denoise_fn = WaveNet(hp["hidden_size"], out_dims, hp["backbone_args"])


class AcousticWaveNetReference(nn.Module):
    """``forward(tokens, mel2ph, f0, noise)`` -> mel [B, T_mel, M] float32:
    encoder, ConvNeXt draft, the draft normalised and noised with ``noise``
    to the shallow start, DDIM down to 0, denormalised, padded frames zero."""

    def __init__(self, hp: dict, vocab: int, lowp=None):
        super().__init__()
        unsupported = [k for k in ("use_spk_id", "use_lang_id", "use_key_shift_embed",
                                   "use_speed_embed", "use_energy_embed", "use_breathiness_embed",
                                   "use_voicing_embed", "use_tension_embed") if hp.get(k)]
        k_step = min(hp["K_step_infer"], hp["K_step"])
        if (unsupported or not hp.get("use_rope") or hp["diffusion_type"] != "ddpm"
                or hp["backbone_type"] != "wavenet" or not hp["use_shallow_diffusion"]
                or hp.get("schedule_type", "linear") != "linear"
                or hp.get("diff_accelerator") != "ddim" or hp["diff_speedup"] <= 1
                or not 0 < k_step < hp["timesteps"]):
            raise ValueError(f"the reference covers the benchmark's WaveNet acoustic config "
                             f"only ({unsupported})")
        self.hp = hp
        self.ops = Ops(lowp)
        self.k_step = k_step
        self.acp = linear_alphas_cumprod(hp["timesteps"])
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
        ops = self.ops
        cond = self.fs2(ops, tokens, mel2ph, f0)
        mask = (mel2ph > 0).float()[:, :, None]
        span = self.smax - self.smin
        aux = self.aux_decoder.decoder(ops, cond) * (span / 2) + (self.smax + self.smin) / 2
        src = (aux * mask - self.smin) / span * 2 - 1
        x = q_sample(self.acp, src, self.k_step - 1, noise.float())
        net = self.diffusion.denoise_fn
        projs = [pointwise(ops, layer.conditioner_projection, cond)
                 for layer in net.residual_layers]
        x = ddim(lambda x, t: net(ops, x, t, projs), self.acp, x, self.k_step,
                 self.hp["diff_speedup"])
        return ((x + 1) / 2 * span + self.smin) * mask
