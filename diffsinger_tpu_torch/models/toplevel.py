"""Top-level acoustic model (counterpart of diffsinger_tpu/models/toplevel.py).

:class:`AcousticModule` holds the parameters under the reference torch names
(``fs2``, ``aux_decoder.decoder``, ``diffusion.velocity_fn``);
:class:`DiffSingerAcoustic` is the entry point that runs the inference
forward: encoder -> ConvNeXt aux draft -> shallow rectified flow over LYNXNet
-> spec denorm. The training forward and the dynamic (export) forward wait
for later slices, as do DDPM and the variance model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from diffsinger_tpu_torch.core import reflow as reflow_core
from diffsinger_tpu_torch.core.spec_transform import SpecTransform
from diffsinger_tpu_torch.models import compat
from diffsinger_tpu_torch.models.acoustic_encoder import FastSpeech2Acoustic
from diffsinger_tpu_torch.models.aux_decoder import AuxDecoderAdaptor
from diffsinger_tpu_torch.models.backbones import build_backbone, precompute_cond_projections
from diffsinger_tpu_torch.utils import resolve_device


@dataclasses.dataclass
class ShallowDiffusionOutput:
    aux_out: Optional[torch.Tensor] = None
    diff_out: Optional[torch.Tensor] = None


class ReflowCore(nn.Module):
    """Holds the backbone as ``velocity_fn``, the reference's name for it."""

    def __init__(self, velocity_fn: nn.Module):
        super().__init__()
        self.velocity_fn = velocity_fn


class AcousticModule(nn.Module):
    """Parameter container: fs2 encoder + aux decoder + denoiser backbone."""

    def __init__(self, hp: dict, vocab_size: int, out_dims: int):
        super().__init__()
        self.fs2 = FastSpeech2Acoustic.from_hparams(hp, vocab_size)
        self.aux_decoder = None
        if hp.get("use_shallow_diffusion", False):
            shallow = hp["shallow_diffusion_args"]
            self.aux_decoder = AuxDecoderAdaptor(
                in_dims=hp["hidden_size"], out_dims=out_dims,
                spec_min=hp["spec_min"], spec_max=hp["spec_max"],
                aux_decoder_arch=shallow["aux_decoder_arch"],
                aux_decoder_args=dict(shallow["aux_decoder_args"]),
            )
        backbone_type = compat.get_backbone_type(hp)
        backbone_args = compat.get_backbone_args(hp, backbone_type)
        self.diffusion = ReflowCore(build_backbone(
            out_dims, 1, backbone_type, backbone_args, cond_dims=hp["hidden_size"]))

    @property
    def denoiser(self) -> nn.Module:
        return self.diffusion.velocity_fn

    def encode(self, txt_tokens, mel2ph, f0, **kwargs) -> torch.Tensor:
        return self.fs2(txt_tokens, mel2ph, f0, **kwargs)

    def denoise(self, x, t, cond, cond_proj=None) -> torch.Tensor:
        return self.denoiser(x, t, cond, cond_proj=cond_proj)

    def aux(self, cond, infer: bool = True) -> torch.Tensor:
        return self.aux_decoder(cond, infer=infer)


class DiffSingerAcoustic:
    """The acoustic model's inference entry point.

    Builds :class:`AcousticModule` (``self.module``) in ``dtype`` (float32 or
    bfloat16) on ``device``: the card unless the caller asks for another, and
    an error if there is no card. Load weights with
    ``model.module.load_state_dict`` (see ``utils.convert``).
    """

    def __init__(self, hp: dict, vocab_size: int, out_dims: int, dtype=None, device=None):
        self.hp = dict(hp)
        self.out_dims = out_dims
        self.device = resolve_device(device)
        self.dtype = dtype or torch.float32
        self.diffusion_type = hp.get("diffusion_type", "ddpm")
        if self.diffusion_type != "reflow":
            raise NotImplementedError(
                f"diffusion_type {self.diffusion_type!r}: only reflow is ported so far")
        self.module = AcousticModule(hp, vocab_size, out_dims).to(
            device=self.device, dtype=self.dtype).eval()
        self.spec_transform = SpecTransform(hp["spec_min"], hp["spec_max"], out_dims)
        self.use_shallow_diffusion = hp.get("use_shallow_diffusion", False)
        self.t_start = hp.get("T_start", 0.0) if self.use_shallow_diffusion else 0.0
        self.time_scale_factor = hp.get("time_scale_factor", 1000)

    @torch.no_grad()
    def forward_infer(self, txt_tokens, mel2ph, f0, *, steps: Optional[int] = None,
                      t_start_infer: Optional[float] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      **kwargs) -> ShallowDiffusionOutput:
        """Aux draft + sampler. txt_tokens [B, T_txt], mel2ph [B, T_mel] (1-based,
        0 = padded frame), f0 [B, T_mel] Hz; mel out [B, T_mel, M] float32.

        ``noise`` [B, T_mel, M] float32 replaces the draw from ``generator``.
        """
        hp = self.hp
        m = self.module
        cond = m.encode(txt_tokens, mel2ph, f0, **kwargs)
        frame_mask = (mel2ph > 0).float()[:, :, None]

        aux_mel = None
        src_spec = None
        if self.use_shallow_diffusion:
            aux_mel = m.aux(cond, infer=True) * frame_mask
            src_spec = self.spec_transform.norm(aux_mel)

        # the condition is the same at every step: project it once per layer
        cond_projs = precompute_cond_projections(m.denoiser, cond)

        def denoise(x, t):
            return m.denoise(x, t, cond, cond_proj=cond_projs)

        t0 = t_start_infer if t_start_infer is not None else hp.get("T_start_infer", self.t_start)
        x = reflow_core.inference(
            denoise, tuple(cond.shape[:2]) + (self.out_dims,),
            t_start=t0,
            steps=steps if steps is not None else hp.get("sampling_steps", 20),
            algorithm=hp.get("sampling_algorithm", "euler"),
            time_scale_factor=self.time_scale_factor,
            device=cond.device, generator=generator,
            x_end=src_spec, use_shallow_diffusion=self.use_shallow_diffusion, noise=noise,
        )
        mel = self.spec_transform.denorm(x) * frame_mask
        return ShallowDiffusionOutput(aux_out=aux_mel, diff_out=mel)
