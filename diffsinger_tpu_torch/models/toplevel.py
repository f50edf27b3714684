"""Top-level models (counterpart of diffsinger_tpu/models/toplevel.py, inference).

:class:`AcousticModule` holds the acoustic parameters under the reference
torch names (``fs2``, ``aux_decoder.decoder``, and the backbone as
``diffusion.velocity_fn`` under rectified flow or ``diffusion.denoise_fn``
under DDPM); :class:`DiffSingerAcoustic` runs its inference forward (encoder
-> ConvNeXt aux draft -> shallow sampler -> spec denorm) and its training
forward (the aux draft and one denoiser call at a drawn or injected time).

:class:`VarianceModule` holds the variance model's parameters (``fs2``,
``spk_embed``, ``melody_encoder``, the pitch and variance embeds, and the
backbones under ``pitch_predictor`` and ``variance_predictor``);
:class:`DiffSingerVariance` predicts phoneme durations, then the pitch delta
and the variance curves with a sampler each, and runs its training forward
(the log-domain durations and one denoiser call of each branch at a drawn or
injected time).

Both cores run rectified flow (``core/reflow.py``) or DDPM (``core/ddpm.py``
with the fast solvers). ``DiffSingerAcoustic.forward_infer_dynamic`` and
``DiffSingerVariance.forward_pitch_deployed`` / ``forward_variance_deployed``
are the deployment forwards that ``deployment/`` exports. The entry points
run their request loops from a roomy frame (``utils/frames.py``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import torch
import torch.nn as nn

from diffsinger_tpu_torch.core import ddpm as ddpm_core
from diffsinger_tpu_torch.core import reflow as reflow_core
from diffsinger_tpu_torch.core.schedule import DiffusionSchedule
from diffsinger_tpu_torch.core.spec_transform import (
    MultiVarianceTransform, PitchTransform, SpecTransform)
from diffsinger_tpu_torch.models import compat
from diffsinger_tpu_torch.models.acoustic_encoder import FastSpeech2Acoustic
from diffsinger_tpu_torch.models.aux_decoder import AuxDecoderAdaptor
from diffsinger_tpu_torch.models.backbones import build_backbone, precompute_cond_projections
from diffsinger_tpu_torch.models.commons import CurveEmbed, Embedding
from diffsinger_tpu_torch.models.variance_encoder import FastSpeech2Variance, MelodyEncoder
from diffsinger_tpu_torch.utils import no_tf32, resolve_device
from diffsinger_tpu_torch.utils.frames import runs_with_room
from diffsinger_tpu_torch.utils.seq import gather_frames, length_regulator, rhythm_regulator

VARIANCE_CHECKLIST = ["energy", "breathiness", "voicing", "tension"]

_warned_max_beta = False


def _warn_unread_max_beta(hp: dict) -> None:
    """Once per process: ``max_beta`` is read by neither package. The
    reference never forwards it into its beta schedule, so the linear schedule
    always ends at 0.01, and a checkpoint's schedule is that one."""
    global _warned_max_beta
    mb = hp.get("max_beta")
    if (_warned_max_beta or mb is None
            or hp.get("schedule_type", "linear") != "linear"
            or abs(float(mb) - 0.01) < 1e-12):
        return
    _warned_max_beta = True
    warnings.warn(
        f"max_beta={mb} is accepted but UNREAD: the reference never forwards "
        "it into its beta schedule, so for checkpoint/sample parity the "
        "linear schedule always ends at 0.01.")


def _schedule(hp: dict, diffusion_type: str, timesteps: int) -> Optional[DiffusionSchedule]:
    if diffusion_type == "ddpm":
        _warn_unread_max_beta(hp)  # not forwarded, as in the reference
        return DiffusionSchedule.create(hp.get("schedule_type", "linear"), timesteps)
    if diffusion_type == "reflow":
        return None
    raise NotImplementedError(diffusion_type)


def variance_prediction_list(hp: dict) -> list:
    return [v for v in VARIANCE_CHECKLIST if hp.get(f"predict_{v}", False)]


def sample(hp: dict, schedule: Optional[DiffusionSchedule], denoise, shape: tuple, *,
           k_step: int, device, generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None,
           noise_fn: Optional[ddpm_core.StepNoiseFn] = None,
           x_start: Optional[torch.Tensor] = None, use_shallow_diffusion: bool = False,
           depth: Optional[int] = None, steps: Optional[int] = None,
           t_start: float = 0.0) -> torch.Tensor:
    """Both families' sampler dispatch: DDPM with ``schedule`` (``depth``
    defaults to ``K_step_infer``), else rectified flow (``steps`` defaults to
    ``sampling_steps``), each reading its algorithm from ``hp``."""
    if schedule is not None:
        return ddpm_core.inference(
            denoise, schedule, shape, k_step=k_step,
            depth=depth if depth is not None else hp.get("K_step_infer", k_step),
            speedup=hp.get("diff_speedup", 10), algorithm=hp.get("diff_accelerator", "ddim"),
            device=device, generator=generator, x_start=x_start,
            use_shallow_diffusion=use_shallow_diffusion, noise=noise, noise_fn=noise_fn)
    return reflow_core.inference(
        denoise, shape, t_start=t_start,
        steps=steps if steps is not None else hp.get("sampling_steps", 20),
        algorithm=hp.get("sampling_algorithm", "euler"),
        time_scale_factor=hp.get("time_scale_factor", 1000), device=device,
        generator=generator, x_end=x_start, use_shallow_diffusion=use_shallow_diffusion,
        noise=noise)


@dataclasses.dataclass
class ShallowDiffusionOutput:
    aux_out: Optional[torch.Tensor] = None
    diff_out: Optional[torch.Tensor] = None


class DiffusionCore(nn.Module):
    """Holds a backbone under the reference's name for it: ``denoise_fn`` in
    a DDPM model, ``velocity_fn`` in a rectified-flow one."""

    def __init__(self, backbone: nn.Module, diffusion_type: str):
        super().__init__()
        self.fn_name = "denoise_fn" if diffusion_type == "ddpm" else "velocity_fn"
        setattr(self, self.fn_name, backbone)

    @property
    def backbone(self) -> nn.Module:
        return getattr(self, self.fn_name)


# ---------------------------------------------------------------------------
# Acoustic
# ---------------------------------------------------------------------------


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
        self.diffusion = DiffusionCore(build_backbone(
            out_dims, 1, backbone_type, backbone_args, cond_dims=hp["hidden_size"],
            remat=hp.get("recompute_grads", False)),
            hp.get("diffusion_type", "ddpm"))

    @property
    def denoiser(self) -> nn.Module:
        return self.diffusion.backbone

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
    ``model.module.load_state_dict`` (see ``utils.convert``). The module is
    built in eval mode; a trainer puts it in training mode for
    :meth:`forward_train`, which turns its dropout on.
    """

    def __init__(self, hp: dict, vocab_size: int, out_dims: int, dtype=None, device=None):
        self.hp = dict(hp)
        self.out_dims = out_dims
        self.device = resolve_device(device)
        self.dtype = dtype or torch.float32
        self.diffusion_type = hp.get("diffusion_type", "ddpm")
        self.use_shallow_diffusion = hp.get("use_shallow_diffusion", False)
        self.timesteps = hp.get("timesteps", 1000)
        self.k_step = (hp.get("K_step", self.timesteps) if self.use_shallow_diffusion
                       else self.timesteps)
        self.schedule = _schedule(hp, self.diffusion_type, self.timesteps)
        self.module = AcousticModule(hp, vocab_size, out_dims).to(
            device=self.device, dtype=self.dtype).eval()
        self.spec_transform = SpecTransform(hp["spec_min"], hp["spec_max"], out_dims)
        self.t_start = hp.get("T_start", 0.0) if self.use_shallow_diffusion else 0.0
        self.time_scale_factor = hp.get("time_scale_factor", 1000)

    def forward_train(self, txt_tokens, mel2ph, f0, gt_mel, *,
                      t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None, **kwargs):
        """Training forward: ``(aux_out, (pred, target, t))`` for the losses.

        ``aux_out`` is the aux decoder's normalised mel [B, T_mel, M] (None
        unless it trains), fed ``cond * g + cond.detach() * (1 - g)`` with g =
        ``aux_decoder_grad``; the second item is None under staged training
        (``train_diffusion: false``). Rectified flow: t [B] float in
        [T_start, 1], the denoiser at ``t * time_scale_factor``, target the
        velocity. DDPM: t [B] int in [0, K_step), target the noise. ``t`` and
        ``noise`` [B, T_mel, M] are drawn from ``generator`` unless given.
        """
        hp = self.hp
        m = self.module
        cond = m.encode(txt_tokens, mel2ph, f0, **kwargs)
        shallow = hp["shallow_diffusion_args"] if self.use_shallow_diffusion else {}
        aux_out = None
        if self.use_shallow_diffusion and shallow["train_aux_decoder"]:
            g = shallow["aux_decoder_grad"]
            aux_out = m.aux(cond * g + cond.detach() * (1 - g), infer=False)
        if self.use_shallow_diffusion and not shallow.get("train_diffusion", True):
            return aux_out, None

        spec = self.spec_transform.norm(gt_mel.float())
        b, dev = spec.shape[0], spec.device
        if self.schedule is not None:
            if t is None:
                t = torch.randint(0, self.k_step, (b,), generator=generator, device=dev)
            x_noisy, noise = ddpm_core.p_losses_inputs(self.schedule, spec, t, noise=noise,
                                                       generator=generator)
            return aux_out, (m.denoise(x_noisy, t.float(), cond), noise, t)
        if t is None:
            t = self.t_start + (1.0 - self.t_start) * torch.rand(b, generator=generator,
                                                                  device=dev)
        x_t, v_gt = reflow_core.p_losses_inputs(spec, t, noise=noise, generator=generator)
        return aux_out, (m.denoise(x_t, t * self.time_scale_factor, cond), v_gt, t)

    @torch.no_grad()
    @no_tf32()
    @runs_with_room
    def forward_infer(self, txt_tokens, mel2ph, f0, *, steps: Optional[int] = None,
                      depth: Optional[int] = None,
                      t_start_infer: Optional[float] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      noise_fn: Optional[ddpm_core.StepNoiseFn] = None,
                      **kwargs) -> ShallowDiffusionOutput:
        """Aux draft + sampler. txt_tokens [B, T_txt], mel2ph [B, T_mel] (1-based,
        0 = padded frame), f0 [B, T_mel] Hz; mel out [B, T_mel, M] float32.

        ``noise`` [B, T_mel, M] float32 replaces the first draw from
        ``generator``; ``noise_fn(i)`` the DDPM ancestral sampler's draw at
        step i. ``depth`` (DDPM: steps of the shallow trajectory) defaults to
        ``K_step_infer``; ``steps`` and ``t_start_infer`` are rectified flow's.
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

        shape = tuple(cond.shape[:2]) + (self.out_dims,)
        x = sample(hp, self.schedule, denoise, shape, k_step=self.k_step, device=cond.device,
                   generator=generator, noise=noise, noise_fn=noise_fn, x_start=src_spec,
                   use_shallow_diffusion=self.use_shallow_diffusion, depth=depth, steps=steps,
                   t_start=(t_start_infer if t_start_infer is not None
                            else hp.get("T_start_infer", self.t_start)))
        mel = self.spec_transform.denorm(x) * frame_mask
        return ShallowDiffusionOutput(aux_out=aux_mel, diff_out=mel)

    @torch.no_grad()
    @no_tf32()
    @runs_with_room
    def forward_infer_dynamic(self, txt_tokens, mel2ph, f0, *, depth, steps,
                              noise: torch.Tensor, **kwargs) -> ShallowDiffusionOutput:
        """The deployment forward (counterpart of JAX ``forward_infer_dynamic``):
        encoder, the aux draft when the model is shallow, the hoisted condition
        projections, the euler (rectified flow) or DDIM (DDPM) sampler with
        ``depth`` (float32 scalar tensor) and ``steps`` (int scalar tensor) on
        the host, the spec denorm and the frame mask. ``noise`` [B, T_mel, M]
        float32 is the sampler's start: this function draws nothing, so
        ``torch.export`` traces it whole. For DDPM ``depth`` is a fraction of
        ``timesteps``; for rectified flow the sampler starts at
        ``max(1 - depth, T_start)``.
        """
        m = self.module
        cond = m.encode(txt_tokens, mel2ph, f0, **kwargs)
        frame_mask = (mel2ph > 0).float()[:, :, None]

        aux_mel = None
        src_spec = None
        if self.use_shallow_diffusion:
            aux_mel = m.aux(cond, infer=True) * frame_mask
            src_spec = self.spec_transform.norm(aux_mel)

        cond_projs = precompute_cond_projections(m.denoiser, cond)

        def denoise(x, t):
            return m.denoise(x, t, cond, cond_proj=cond_projs)

        if self.schedule is not None:
            x = ddpm_core.inference_dynamic(denoise, self.schedule, noise, depth=depth,
                                            steps=steps, k_step=self.k_step, x_start=src_spec)
        else:
            x = reflow_core.inference_dynamic(denoise, noise, depth=depth, steps=steps,
                                              t_start_min=self.t_start,
                                              time_scale_factor=self.time_scale_factor,
                                              x_end=src_spec)
        mel = self.spec_transform.denorm(x) * frame_mask
        return ShallowDiffusionOutput(aux_out=aux_mel, diff_out=mel)


# ---------------------------------------------------------------------------
# Variance
# ---------------------------------------------------------------------------


class VarianceModule(nn.Module):
    """Parameter container of the variance model, with its pieces as methods."""

    def __init__(self, hp: dict, vocab_size: int):
        super().__init__()
        h = hp["hidden_size"]
        diffusion_type = hp.get("diffusion_type", "ddpm")
        self.use_spk_id = hp["use_spk_id"]
        self.predict_pitch = hp["predict_pitch"]
        self.var_list = variance_prediction_list(hp)
        self.spk_embed = Embedding(hp["num_spk"], h) if self.use_spk_id else None
        self.fs2 = FastSpeech2Variance.from_hparams(hp, vocab_size)

        self.use_melody_encoder = False
        if self.predict_pitch:
            pitch_hp = hp["pitch_prediction_args"]
            self.use_melody_encoder = hp.get("use_melody_encoder", False)
            if self.use_melody_encoder:
                self.melody_encoder = MelodyEncoder.from_hparams(hp)
                self.delta_pitch_embed = CurveEmbed(h)
            else:
                self.base_pitch_embed = CurveEmbed(h)
            self.pitch_retake_embed = Embedding(2, h)
            backbone_type = compat.get_backbone_type(hp, nested_config=pitch_hp)
            backbone_args = compat.get_backbone_args(pitch_hp, backbone_type)
            self.pitch_predictor = DiffusionCore(build_backbone(
                pitch_hp["repeat_bins"], 1, backbone_type, backbone_args, cond_dims=h,
                remat=hp.get("recompute_grads", False)),
                diffusion_type)
        if self.var_list:
            self.pitch_embed = CurveEmbed(h)
            self.variance_embeds = nn.ModuleDict({v: CurveEmbed(h) for v in self.var_list})
            var_hp = hp["variances_prediction_args"]
            backbone_type = compat.get_backbone_type(hp, nested_config=var_hp)
            backbone_args = compat.get_backbone_args(var_hp, backbone_type)
            self.variance_predictor = DiffusionCore(build_backbone(
                var_hp["total_repeat_bins"] // len(self.var_list), len(self.var_list),
                backbone_type, backbone_args, cond_dims=h,
                remat=hp.get("recompute_grads", False)), diffusion_type)

    @property
    def pitch_denoiser(self) -> nn.Module:
        return self.pitch_predictor.backbone

    @property
    def variance_denoiser(self) -> nn.Module:
        return self.variance_predictor.backbone

    def encode(self, txt_tokens, midi, ph2word, ph_dur=None, word_dur=None, spk_id=None,
               ph_spk_mix_embed=None, languages=None, infer: bool = True):
        """fs2 encoder (+ token-level speaker embed) -> (encoder_out, dur_pred);
        ``infer=False`` gives the training form of ``dur_pred`` (log domain)."""
        ph_spk = None
        if self.use_spk_id:
            ph_spk = (ph_spk_mix_embed if ph_spk_mix_embed is not None
                      else self.spk_embed(spk_id)[:, None, :])
        return self.fs2(txt_tokens, midi, ph2word, ph_dur=ph_dur, word_dur=word_dur,
                        spk_embed=ph_spk, languages=languages, infer=infer)

    def frame_condition(self, encoder_out, mel2ph, spk_id=None, spk_mix_embed=None):
        condition = gather_frames(encoder_out, mel2ph)
        if self.use_spk_id:
            spk = spk_mix_embed if spk_mix_embed is not None else self.spk_embed(spk_id)[:, None, :]
            condition = condition + spk
        return condition

    def melody_encode(self, note_midi, note_rest, note_dur, note_glide=None):
        return self.melody_encoder(note_midi, note_rest, note_dur, glide=note_glide)

    def pitch_condition(self, condition, mel2ph, base_pitch, pitch=None, pitch_expr=None,
                        pitch_retake=None, melody_frame=None, delta_pitch_in=None):
        """Pitch-branch condition -> (pitch_cond, base_pitch). ``pitch_retake``
        None means all frames are retaken. With ``pitch_expr`` the retake
        embedding is interpolated between its two rows; without the melody
        encoder, frames not retaken take the given ``pitch`` as base pitch."""
        pitch_cond = condition
        if melody_frame is not None:
            pitch_cond = pitch_cond + melody_frame
        retake_unset = pitch_retake is None
        if retake_unset:
            pitch_retake = torch.ones_like(mel2ph, dtype=torch.bool)
        if pitch_expr is None:
            retake_embed = self.pitch_retake_embed(pitch_retake.long())
        else:
            table = self.pitch_retake_embed.weight
            expr = (pitch_expr * pitch_retake)[:, :, None]
            retake_embed = expr * table[1] + (1.0 - expr) * table[0]
        pitch_cond = pitch_cond + retake_embed
        if self.use_melody_encoder:
            if delta_pitch_in is None:
                delta_pitch_in = torch.zeros_like(base_pitch)
            curve = self.delta_pitch_embed(delta_pitch_in)
        else:
            if not retake_unset:
                base_pitch = base_pitch * pitch_retake + pitch * (~pitch_retake)
            curve = self.base_pitch_embed(base_pitch)
        return (pitch_cond.float() + curve).to(pitch_cond.dtype), base_pitch

    def variance_condition(self, condition, pitch, variances: Dict,
                           variance_retake: Optional[Dict]):
        """Variance-branch condition: the pitch embed, and the given curves
        where they are not retaken."""
        curves = self.pitch_embed(pitch)
        if variance_retake is not None:
            for v_name in self.var_list:
                keep = (~variance_retake[v_name])[:, :, None]
                curves = curves + self.variance_embeds[v_name](variances[v_name]) * keep
        return (condition.float() + curves).to(condition.dtype)


class DiffSingerVariance:
    """The variance model's entry point: inference, and the training forward.

    Builds :class:`VarianceModule` (``self.module``) in ``dtype`` on
    ``device``: the card unless the caller asks for another, and an error if
    there is no card. The module is built in eval mode; a trainer puts it in
    training mode for :meth:`forward_train`, which turns its dropout on.
    """

    def __init__(self, hp: dict, vocab_size: int, dtype=None, device=None):
        self.hp = dict(hp)
        self.device = resolve_device(device)
        self.dtype = dtype or torch.float32
        self.predict_dur = hp["predict_dur"]
        self.predict_pitch = hp["predict_pitch"]
        self.var_list = variance_prediction_list(hp)
        self.use_melody_encoder = hp.get("use_melody_encoder", False)
        self.diffusion_type = hp.get("diffusion_type", "ddpm")
        self.timesteps = hp.get("timesteps", 1000)
        self.k_step = hp.get("K_step", self.timesteps)
        self.time_scale_factor = hp.get("time_scale_factor", 1000)
        self.schedule = _schedule(hp, self.diffusion_type, self.timesteps)
        self.module = VarianceModule(hp, vocab_size).to(device=self.device, dtype=self.dtype).eval()

        if self.predict_pitch:
            p = hp["pitch_prediction_args"]
            self.pitch_transform = PitchTransform(
                vmin=p["pitd_norm_min"], vmax=p["pitd_norm_max"],
                cmin=p["pitd_clip_min"], cmax=p["pitd_clip_max"],
                repeat_bins=p["repeat_bins"])
        if self.var_list:
            ranges, clamps = [], []
            for v in self.var_list:
                if v == "tension":
                    ranges.append((hp["tension_logit_min"], hp["tension_logit_max"]))
                    clamps.append((hp["tension_logit_min"], hp["tension_logit_max"]))
                else:
                    ranges.append((hp[f"{v}_db_min"], hp[f"{v}_db_max"]))
                    clamps.append((hp[f"{v}_db_min"], 0.0))
            total_rb = hp["variances_prediction_args"]["total_repeat_bins"]
            self.variance_transform = MultiVarianceTransform(
                ranges=ranges, clamps=clamps, repeat_bins=total_rb // len(self.var_list))

    def forward_train(
        self, txt_tokens, midi, ph2word, ph_dur, mel2ph, base_pitch, pitch,
        variances: Dict, *, pitch_retake=None, variance_retake: Optional[Dict] = None,
        spk_id=None, languages=None, note_midi=None, note_rest=None, note_dur=None,
        note_glide=None, mel2note=None,
        t_pitch: Optional[torch.Tensor] = None, noise_pitch: Optional[torch.Tensor] = None,
        t_var: Optional[torch.Tensor] = None, noise_var: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Training forward: ``(dur_pred_log [B, T_ph] | None, (pred, target,
        t) | None, (pred, target, t) | None)`` for the duration, pitch and
        variance losses.

        The pitch branch is conditioned on the frames not in ``pitch_retake``
        (with the melody encoder through ``(pitch - base_pitch) *
        ~pitch_retake``) and learns the normalised delta ``pitch -
        base_pitch``; the variance branch is conditioned on the ground-truth
        ``pitch`` and the curves not in ``variance_retake`` and learns the
        flattened normalised curves [B, T, F*R]. The times and noises are drawn
        from ``generator`` unless given (``t_pitch`` / ``noise_pitch`` first,
        then ``t_var`` / ``noise_var``); see :meth:`_train_core`.
        """
        m = self.module
        encoder_out, dur_pred = m.encode(txt_tokens, midi, ph2word, ph_dur=ph_dur, spk_id=spk_id,
                                         languages=languages, infer=False)
        if not self.predict_pitch and not self.var_list:
            return dur_pred, None, None
        condition = m.frame_condition(encoder_out, mel2ph, spk_id=spk_id)

        pitch_out = None
        if self.predict_pitch:
            melody_frame = None
            delta_pitch_in = None
            if self.use_melody_encoder:
                mel_out = m.melody_encode(note_midi, note_rest, note_dur, note_glide=note_glide)
                melody_frame = gather_frames(mel_out, mel2note)
                delta_pitch_in = (pitch - base_pitch) * (~pitch_retake)
            pitch_cond, _ = m.pitch_condition(
                condition, mel2ph, base_pitch, pitch=pitch, pitch_retake=pitch_retake,
                melody_frame=melody_frame, delta_pitch_in=delta_pitch_in)
            x0 = self.pitch_transform.norm(pitch - base_pitch)
            pitch_out = self._train_core(m.pitch_denoiser, pitch_cond, x0, t_pitch, noise_pitch,
                                         generator)

        var_out = None
        if self.var_list:
            var_cond = m.variance_condition(condition, pitch, variances, variance_retake)
            x0 = self.variance_transform.flatten(
                self.variance_transform.norm([variances[v] for v in self.var_list]))
            var_out = self._train_core(m.variance_denoiser, var_cond, x0, t_var, noise_var,
                                       generator)
        return dur_pred, pitch_out, var_out

    def _train_core(self, denoiser: nn.Module, cond: torch.Tensor, x0: torch.Tensor,
                    t: Optional[torch.Tensor], noise: Optional[torch.Tensor], generator):
        """One denoiser call on flat [B, T, D] data -> (pred, target, t).
        Rectified flow: t [B] uniform in [0, 1), the denoiser at ``t *
        time_scale_factor``, target the velocity. DDPM: t [B] int in [0,
        K_step), target the noise."""
        b, dev = x0.shape[0], x0.device
        if self.schedule is not None:
            if t is None:
                t = torch.randint(0, self.k_step, (b,), generator=generator, device=dev)
            x_noisy, noise = ddpm_core.p_losses_inputs(self.schedule, x0, t, noise=noise,
                                                       generator=generator)
            return denoiser(x_noisy, t.float(), cond), noise, t
        if t is None:
            t = torch.rand(b, generator=generator, device=dev)
        x_t, v_gt = reflow_core.p_losses_inputs(x0, t, noise=noise, generator=generator)
        return denoiser(x_t, t * self.time_scale_factor, cond), v_gt, t

    @torch.no_grad()
    @no_tf32()
    @runs_with_room
    def forward_infer(
        self, txt_tokens, midi, ph2word, base_pitch, *, ph_dur=None, word_dur=None,
        mel2ph=None, pitch=None, pitch_expr=None, pitch_retake=None,
        variances: Optional[Dict] = None, variance_retake: Optional[Dict] = None,
        spk_id=None, spk_mix_embed=None, ph_spk_mix_embed=None, languages=None,
        note_midi=None, note_rest=None, note_dur=None, note_glide=None, mel2note=None,
        steps: Optional[int] = None,
        predict_pitch: Optional[bool] = None, predict_variances: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
        noise_pitch: Optional[torch.Tensor] = None,
        noise_variances: Optional[torch.Tensor] = None,
        noise_fn_pitch: Optional[ddpm_core.StepNoiseFn] = None,
        noise_fn_variances: Optional[ddpm_core.StepNoiseFn] = None,
    ):
        """Returns (dur_pred [B, T_ph] | None, pitch_pred [B, T] delta | None,
        {variance name: [B, T]}).

        ``predict_pitch`` / ``predict_variances`` switch a branch off for the
        call. The pitch branch draws from ``generator`` first, then the
        variance branch; ``noise_pitch`` / ``noise_variances`` [B, T, F*R]
        replace their first draws and ``noise_fn_pitch`` /
        ``noise_fn_variances`` the DDPM ancestral sampler's per-step draws.
        """
        m = self.module
        do_pitch = self.predict_pitch and (predict_pitch is not False)
        do_vars = bool(self.var_list) and (predict_variances is not False)
        encoder_out, dur_pred = m.encode(
            txt_tokens, midi, ph2word, ph_dur=ph_dur, word_dur=word_dur, spk_id=spk_id,
            ph_spk_mix_embed=ph_spk_mix_embed, languages=languages)
        if not do_pitch and not do_vars:
            return dur_pred, None, {}

        if mel2ph is None and word_dur is not None:
            dur_align = rhythm_regulator(dur_pred, ph2word, word_dur)
            mel2ph = length_regulator(dur_align, base_pitch.shape[1])
        condition = m.frame_condition(encoder_out, mel2ph, spk_id=spk_id,
                                      spk_mix_embed=spk_mix_embed)

        pitch_pred = None
        if do_pitch:
            melody_frame = None
            delta_pitch_in = None
            if self.use_melody_encoder:
                mel_out = m.melody_encode(note_midi, note_rest, note_dur, note_glide=note_glide)
                melody_frame = gather_frames(mel_out, mel2note)
                if pitch_retake is not None:
                    delta_pitch_in = (pitch - base_pitch) * (~pitch_retake)
            pitch_cond, base_pitch = m.pitch_condition(
                condition, mel2ph, base_pitch, pitch=pitch, pitch_expr=pitch_expr,
                pitch_retake=pitch_retake, melody_frame=melody_frame,
                delta_pitch_in=delta_pitch_in)
            x = self._infer_core(m.pitch_denoiser, pitch_cond, self.pitch_transform.repeat_bins,
                                 steps, generator, noise_pitch, noise_fn_pitch)
            pitch_pred = self.pitch_transform.denorm(x)

        variances_pred = {}
        if do_vars:
            if pitch is None:
                pitch = base_pitch + pitch_pred
            var_cond = m.variance_condition(condition, pitch, variances or {}, variance_retake)
            width = len(self.var_list) * self.variance_transform.repeat_bins
            x = self._infer_core(m.variance_denoiser, var_cond, width, steps, generator,
                                 noise_variances, noise_fn_variances)
            outs = self.variance_transform.denorm(self.variance_transform.unflatten(x))
            variances_pred = dict(zip(self.var_list, outs))
        return dur_pred, pitch_pred, variances_pred

    # ------------------------------------------------------------------
    # Deployed views (counterpart of the JAX ``forward_pitch_deployed`` and
    # ``forward_variance_deployed``): they start from the linguistic view's
    # ``encoder_out`` and compute the frame alignment, the smoothed base pitch
    # and the retake and expr blending from the deployed inputs.

    def _deployed_frame_condition(self, encoder_out, ph_dur, t_mel: int, spk_mix_embed):
        mel2ph = length_regulator(ph_dur, t_mel)
        return self.module.frame_condition(encoder_out, mel2ph,
                                           spk_mix_embed=spk_mix_embed), mel2ph

    @torch.no_grad()
    @no_tf32()
    @runs_with_room
    def forward_pitch_deployed(
        self, encoder_out, ph_dur, note_midi, note_dur, pitch, retake, *, note_rest=None,
        note_glide=None, expr=None, spk_mix_embed=None, steps=None, noise=None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The deployed pitch predictor -> the absolute pitch [B, T] (midi): the
        predicted delta plus the blended base pitch.

        ``ph_dur`` and ``note_dur`` [B, T_ph] are integer frames; ``mel2ph``,
        ``mel2note`` and the base pitch (the notes' pitch smoothed over
        ``midi_smooth_width``) come from them. ``retake`` [B, T] bool keeps the
        input ``pitch`` outside its spans; ``expr`` [B, T] (if given) blends
        the two rows of the retake embedding. ``steps`` as a 0-d integer
        tensor selects the deployment sampler (:meth:`_infer_core`);
        ``noise`` [B, T, repeat_bins] replaces the draw from ``generator``.
        """
        from diffsinger_tpu_torch.dsp.common import sinusoidal_smooth

        hp = self.hp
        m = self.module
        t_mel = pitch.shape[1]
        condition, mel2ph = self._deployed_frame_condition(encoder_out, ph_dur, t_mel,
                                                           spk_mix_embed)
        mel2note = length_regulator(note_dur, t_mel)
        frame_midi = gather_frames(note_midi.float()[:, :, None], mel2note)[:, :, 0]
        timestep = hp["hop_size"] / hp["audio_sample_rate"]
        base_pitch = sinusoidal_smooth(frame_midi,
                                       max(1, round(hp["midi_smooth_width"] / timestep)))
        melody_frame = None
        delta_pitch_in = None
        if self.use_melody_encoder:
            mel_out = m.melody_encode(note_midi, note_rest, note_dur, note_glide=note_glide)
            melody_frame = gather_frames(mel_out, mel2note)
            delta_pitch_in = (pitch - base_pitch) * (~retake)
        pitch_cond, base_pitch = m.pitch_condition(
            condition, mel2ph, base_pitch, pitch=pitch, pitch_expr=expr, pitch_retake=retake,
            melody_frame=melody_frame, delta_pitch_in=delta_pitch_in)
        x = self._infer_core(m.pitch_denoiser, pitch_cond, self.pitch_transform.repeat_bins,
                             steps, generator, noise, None)
        return self.pitch_transform.denorm(x) + base_pitch

    @torch.no_grad()
    @no_tf32()
    @runs_with_room
    def forward_variance_deployed(
        self, encoder_out, ph_dur, pitch, variances: Dict, retake, *, spk_mix_embed=None,
        steps=None, noise=None, generator: Optional[torch.Generator] = None,
    ) -> tuple:
        """The deployed multi-variance predictor -> the predicted curves [B, T]
        in ``var_list`` order. ``retake`` [B, T, F] bool (F over ``var_list``)
        keeps the input curves outside its spans; ``noise`` [B, T, F*R]."""
        m = self.module
        condition, _ = self._deployed_frame_condition(encoder_out, ph_dur, pitch.shape[1],
                                                      spk_mix_embed)
        variance_retake = {v: retake[:, :, i] for i, v in enumerate(self.var_list)}
        var_cond = m.variance_condition(condition, pitch, variances, variance_retake)
        width = len(self.var_list) * self.variance_transform.repeat_bins
        x = self._infer_core(m.variance_denoiser, var_cond, width, steps, generator, noise, None)
        return tuple(self.variance_transform.denorm(self.variance_transform.unflatten(x)))

    def _infer_core(self, denoiser: nn.Module, cond: torch.Tensor, width: int,
                    steps, generator, noise, noise_fn) -> torch.Tensor:
        """Sample a flat [B, T, width] tensor from noise with the configured core.

        ``steps`` as a 0-d tensor selects the deployment samplers (rectified
        flow's euler, DDPM's DDIM) from pure noise, with the step count an
        input of an exported program; an int or None the configured ones."""
        proj = precompute_cond_projections(denoiser, cond)

        def denoise(x, t):
            return denoiser(x, t, cond, cond_proj=proj)

        shape = tuple(cond.shape[:2]) + (width,)
        if isinstance(steps, torch.Tensor):
            if noise is None:
                noise = torch.randn(shape, generator=generator, dtype=torch.float32,
                                    device=cond.device)
            depth = torch.ones((), dtype=torch.float32)
            if self.schedule is not None:
                return ddpm_core.inference_dynamic(denoise, self.schedule, noise, depth=depth,
                                                   steps=steps, k_step=self.k_step)
            return reflow_core.inference_dynamic(denoise, noise, depth=depth, steps=steps,
                                                 t_start_min=0.0,
                                                 time_scale_factor=self.time_scale_factor)
        return sample(self.hp, self.schedule, denoise, shape,
                      k_step=self.k_step, device=cond.device, generator=generator,
                      noise=noise, noise_fn=noise_fn, steps=steps)
