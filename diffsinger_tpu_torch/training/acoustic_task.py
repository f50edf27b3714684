"""Acoustic training task (counterpart of diffsinger_tpu/training/acoustic_task.py).

The loss of a batch (the aux decoder's L1 scaled by ``lambda_aux_mel_loss``,
plus the diffusion or flow loss), the datasets over the binarized store, and
the validation extras: ``forward_infer`` on the kernels, mel figures, and wavs
from the port's vocoder where ``val_with_vocoder``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from diffsinger_tpu_torch.data.dataset import VARIANCES, AcousticDataset
from diffsinger_tpu_torch.models.losses import aux_mel_loss, diffusion_loss, reflow_loss
from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
from diffsinger_tpu_torch.training.base_task import BaseTask


def encoder_kwargs_from_batch(hp: dict, batch: Dict) -> Dict:
    """The encoder's conditioning inputs that the config enables (speaker and
    language ids, key shift, speed, variance curves), from a batch."""
    kwargs = {}
    if hp.get("use_spk_id", False):
        kwargs["spk_embed_id"] = batch["spk_ids"]
    if hp.get("use_lang_id", False):
        kwargs["languages"] = batch["languages"]
    if hp.get("use_key_shift_embed", False):
        kwargs["key_shift"] = batch["key_shift"]
    if hp.get("use_speed_embed", False):
        kwargs["speed"] = batch["speed"]
    variances = {v: batch[v] for v in VARIANCES if hp.get(f"use_{v}_embed", False)}
    if variances:
        kwargs["variances"] = variances
    return kwargs


def make_acoustic_loss_fn(model: DiffSingerAcoustic):
    """``loss_fn(batch, **draws) -> (total, losses)``; ``draws`` (``t``,
    ``noise``, ``generator``) go to :meth:`DiffSingerAcoustic.forward_train`."""
    hp = model.hp
    diffusion_type = hp.get("diffusion_type", "ddpm")
    shallow = hp.get("shallow_diffusion_args", {}) if model.use_shallow_diffusion else {}
    if model.use_shallow_diffusion and not (shallow.get("train_aux_decoder", True)
                                            or shallow.get("train_diffusion", True)):
        raise ValueError("shallow_diffusion_args: train_aux_decoder and train_diffusion "
                         "are both false — nothing would train")
    lambda_aux = hp.get("lambda_aux_mel_loss", 0.2)
    loss_type = hp.get("main_loss_type", "l2")
    log_norm = hp.get("main_loss_log_norm", False)

    def loss_fn(batch: Dict, **draws):
        aux_out, diff_out = model.forward_train(
            batch["tokens"], batch["mel2ph"], batch["f0"], batch["mel"], **draws,
            **encoder_kwargs_from_batch(hp, batch))
        nonpadding = (batch["mel2ph"] > 0).float()
        losses = {}
        if aux_out is not None:
            norm_gt = model.spec_transform.norm(batch["mel"].float())
            losses["aux_mel_loss"] = lambda_aux * aux_mel_loss(aux_out, norm_gt, nonpadding)
        if diff_out is not None:
            pred, target, t = diff_out
            if diffusion_type == "ddpm":
                losses["mel_loss"] = diffusion_loss(pred, target, nonpadding, loss_type=loss_type)
            else:
                losses["mel_loss"] = reflow_loss(pred, target, t, nonpadding,
                                                 loss_type=loss_type, log_norm=log_norm)
        return sum(losses.values()), losses

    return loss_fn


class AcousticTask(BaseTask):
    category = "acoustic"

    def build_model(self):
        return DiffSingerAcoustic(self.hp, vocab_size=len(self.phoneme_dictionary),
                                  out_dims=self.hp["audio_num_mel_bins"],
                                  dtype=torch.float32, device=self.device)

    def build_loss_fn(self, model):
        return make_acoustic_loss_fn(model)

    def build_datasets(self):
        d = self.hp["binary_data_dir"]
        return AcousticDataset(d, self.hp, "train"), AcousticDataset(d, self.hp, "valid")

    def validation_extras(self, valid_ds, batch: dict) -> None:
        """For the first ``num_valid_plots`` items: ``forward_infer`` (float32,
        the kernels on the card), mel figures of the prediction and the aux
        draft against the ground truth, and the vocoded prediction."""
        hp = self.hp
        n_plots = hp.get("num_valid_plots", 10)
        indices = batch["indices"]
        if not any(i < n_plots for i in indices):
            return
        from diffsinger_tpu_torch.utils.plot import spec_to_figure

        gen = torch.Generator(self.device).manual_seed(0)
        out = self.model.forward_infer(batch["tokens"], batch["mel2ph"], batch["f0"],
                                       generator=gen, **encoder_kwargs_from_batch(hp, batch))
        if not hasattr(self, "_vocoder"):
            self._vocoder = None
            if hp.get("val_with_vocoder", True):
                try:
                    from diffsinger_tpu_torch.vocoders.registry import get_vocoder_cls

                    self._vocoder = get_vocoder_cls(hp)(hp, device=self.device)
                except Exception as e:  # the figures do not need it
                    print(f"| validation vocoder unavailable: {e}")
        vmin, vmax = hp.get("mel_vmin", -14), hp.get("mel_vmax", 4)
        step = self.global_step
        for j, data_idx in enumerate(indices):
            if data_idx >= n_plots:
                continue
            mel_len = int(valid_ds.metadata["mel"][data_idx])
            gt = batch["mel"][j, :mel_len].float().cpu().numpy()
            for tag, mel in (("diffmel", out.diff_out), ("auxmel", out.aux_out)):
                if mel is None:
                    continue
                pred = mel[j, :mel_len].float().cpu().numpy()
                spec = np.concatenate([np.abs(pred - gt) + vmin, gt, pred], axis=-1)
                self.logger.add_figure(f"{tag}_{data_idx}",
                                       lambda s=spec: spec_to_figure(s, vmin, vmax), step)
            if self._vocoder is not None:
                wav = self._vocoder.spec2wav(out.diff_out[j, :mel_len].float().cpu().numpy(),
                                             f0=batch["f0"][j, :mel_len].cpu().numpy())
                self.logger.add_audio(f"diff_{data_idx}", wav, step, hp["audio_sample_rate"])
