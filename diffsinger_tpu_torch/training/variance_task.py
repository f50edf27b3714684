"""Variance training task (counterpart of diffsinger_tpu/training/variance_task.py).

The loss of a batch (the duration loss on the phoneme, word and sentence
levels, and the diffusion or flow loss of the pitch and variance branches
under random retake masks), the datasets over the binarized store, and the
validation extras: ``forward_infer`` on the kernels, the streaming metrics
(rhythm correctness, phoneme duration accuracy, pitch accuracy and R^2 of
pitch and each curve) and the duration, pitch and curve figures.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from diffsinger_tpu_torch.data.dataset import VarianceDataset
from diffsinger_tpu_torch.models.losses import diffusion_loss, dur_loss, reflow_loss
from diffsinger_tpu_torch.models.metrics import (
    MetricState, PhonemeDurationAccuracy, R2State, RawCurveAccuracy, RawCurveR2Score,
    RhythmCorrectness,
)
from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance, variance_prediction_list
from diffsinger_tpu_torch.training.base_task import BaseTask


def random_retake_masks(b: int, t: int, *, generator: Optional[torch.Generator] = None,
                        device=None, draws: Optional[Sequence[torch.Tensor]] = None
                        ) -> torch.Tensor:
    """Retake masks [B, T] bool: a quarter of the rows retaken whole, and in
    every row one span with bounds drawn in [0, t] and sorted (about half the
    frames overall). ``draws`` gives the three integer draws (row [B, 1] in
    [0, 4), two bounds [B] each in [0, t]) instead of ``generator``."""
    if draws is None:
        draws = (torch.randint(0, 4, (b, 1), generator=generator, device=device),
                 torch.randint(0, t + 1, (b,), generator=generator, device=device),
                 torch.randint(0, t + 1, (b,), generator=generator, device=device))
    rows, lo, hi = draws
    bounds = torch.sort(torch.stack([lo, hi], dim=1), dim=1).values
    pos = torch.arange(t, device=bounds.device)[None, :]
    return (rows == 0) | ((pos >= bounds[:, :1]) & (pos < bounds[:, 1:]))


def make_variance_loss_fn(model: DiffSingerVariance):
    """``loss_fn(batch, **draws) -> (total, losses)``. ``draws``:
    ``pitch_retake`` [B, T] and ``variance_retake`` {name: [B, T]} (drawn
    from ``generator`` unless given: the pitch mask first, then one mask per
    variance in config order), and ``t_pitch``, ``noise_pitch``, ``t_var``,
    ``noise_var``, ``generator`` for :meth:`DiffSingerVariance.forward_train`."""
    hp = model.hp
    var_list = variance_prediction_list(hp)
    diffusion_type = hp.get("diffusion_type", "ddpm")
    loss_type = hp.get("main_loss_type", "l2")
    log_norm = hp.get("main_loss_log_norm", False)
    dur_hp = hp.get("dur_prediction_args", {})

    def loss_fn(batch: Dict, *, pitch_retake=None, variance_retake=None, **draws):
        tokens = batch["tokens"]
        mel2ph = batch.get("mel2ph")
        generator = draws.get("generator")
        if mel2ph is not None:
            b, t = mel2ph.shape
            if hp["predict_pitch"] and pitch_retake is None:
                pitch_retake = random_retake_masks(b, t, generator=generator, device=mel2ph.device)
            if var_list and variance_retake is None:
                variance_retake = {v: random_retake_masks(b, t, generator=generator,
                                                          device=mel2ph.device)
                                   for v in var_list}
        dur_pred, pitch_out, var_out = model.forward_train(
            tokens, batch.get("midi"), batch.get("ph2word"), batch["ph_dur"], mel2ph,
            batch.get("base_pitch"), batch.get("pitch"), {v: batch[v] for v in var_list},
            pitch_retake=pitch_retake, variance_retake=variance_retake,
            spk_id=batch.get("spk_ids"), languages=batch.get("languages"),
            note_midi=batch.get("note_midi"), note_rest=batch.get("note_rest"),
            note_dur=batch.get("note_dur"), note_glide=batch.get("note_glide"),
            mel2note=batch.get("mel2note"), **draws)
        losses = {}
        if dur_pred is not None and hp["predict_dur"]:
            losses["dur_loss"] = hp.get("lambda_dur_loss", 1.0) * dur_loss(
                dur_pred, batch["ph_dur"], batch["ph2word"], (tokens > 0).float(),
                offset=dur_hp.get("log_offset", 1.0), loss_type=dur_hp.get("loss_type", "mse"),
                lambda_pdur=dur_hp.get("lambda_pdur_loss", 0.3),
                lambda_wdur=dur_hp.get("lambda_wdur_loss", 1.0),
                lambda_sdur=dur_hp.get("lambda_sdur_loss", 3.0))
        nonpadding = (mel2ph > 0).float() if mel2ph is not None else None
        for name, out, lam in (("pitch_loss", pitch_out, hp.get("lambda_pitch_loss", 1.0)),
                               ("var_loss", var_out, hp.get("lambda_var_loss", 1.0))):
            if out is None:
                continue
            pred, target, t = out
            if diffusion_type == "ddpm":
                losses[name] = lam * diffusion_loss(pred, target, nonpadding, loss_type=loss_type)
            else:
                losses[name] = lam * reflow_loss(pred, target, t, nonpadding,
                                                 loss_type=loss_type, log_norm=log_norm)
        return sum(losses.values()), losses

    return loss_fn


def infer_kwargs_from_batch(hp: dict, batch: Dict) -> Dict:
    """The conditioning inputs of ``forward_infer`` that a batch holds: the
    given durations and alignment, speaker and language ids, the melody
    encoder's notes, and the ground-truth pitch for the variance branch."""
    kwargs = {k: batch[src] for k, src in (
        ("ph_dur", "ph_dur"), ("mel2ph", "mel2ph"), ("spk_id", "spk_ids"),
        ("languages", "languages"), ("note_midi", "note_midi"), ("note_rest", "note_rest"),
        ("note_dur", "note_dur"), ("note_glide", "note_glide"), ("mel2note", "mel2note"),
    ) if batch.get(src) is not None}
    if variance_prediction_list(hp) and batch.get("pitch") is not None:
        kwargs["pitch"] = batch["pitch"]
    return kwargs


class VarianceTask(BaseTask):
    category = "variance"

    def build_model(self):
        return DiffSingerVariance(self.hp, vocab_size=len(self.phoneme_dictionary),
                                  dtype=torch.float32, device=self.device)

    def build_loss_fn(self, model):
        return make_variance_loss_fn(model)

    def build_datasets(self):
        d = self.hp["binary_data_dir"]
        return VarianceDataset(d, self.hp, "train"), VarianceDataset(d, self.hp, "valid")

    def validation_extras(self, valid_ds, batch: dict) -> None:
        """``forward_infer`` (float32, the kernels on the card, a generator
        seeded 0); the streaming metrics over the batch; figures of the first
        ``num_valid_plots`` items."""
        hp = self.hp
        var_list = variance_prediction_list(hp)
        gen = torch.Generator(self.device).manual_seed(0)
        dur_pred, pitch_pred, var_pred = self.model.forward_infer(
            batch["tokens"], batch.get("midi"), batch.get("ph2word"), batch.get("base_pitch"),
            generator=gen, **infer_kwargs_from_batch(hp, batch))
        ms = self.metric_states
        if dur_pred is not None and hp["predict_dur"]:
            nonpad = batch["tokens"] > 0
            pred, gt = torch.round(dur_pred), batch["ph_dur"].float()
            ms["rhythm_corr"] = RhythmCorrectness(0.05).update(
                ms.get("rhythm_corr", MetricState()), pred, gt, batch["ph2word"], nonpad)
            ms["ph_dur_acc"] = PhonemeDurationAccuracy(0.2).update(
                ms.get("ph_dur_acc", MetricState()), pred, gt, batch["ph2word"], nonpad)
        pitch_abs = None
        if pitch_pred is not None and batch.get("pitch") is not None:
            mask = (batch["mel2ph"] > 0) & ~batch["uv"]
            pitch_abs = batch["base_pitch"] + pitch_pred  # forward_infer gives the delta
            ms["pitch_acc"] = RawCurveAccuracy(0.5).update(
                ms.get("pitch_acc", MetricState()), pitch_abs, batch["pitch"], mask)
            ms["pitch_r2"] = RawCurveR2Score().update(
                ms.get("pitch_r2", R2State()), pitch_abs, batch["pitch"], mask)
        for v in var_list:
            if v in var_pred:
                ms[f"{v}_r2"] = RawCurveR2Score().update(
                    ms.get(f"{v}_r2", R2State()), var_pred[v], batch[v], batch["mel2ph"] > 0)

        n_plots = hp.get("num_valid_plots", 10)
        if not any(i < n_plots for i in batch["indices"]):
            return
        from diffsinger_tpu_torch.utils.plot import (
            curve_to_figure, dur_to_figure, pitch_note_to_figure)

        def host(x, j, n):
            return x[j, :n].float().cpu().numpy()

        step = self.global_step
        meta = valid_ds.metadata
        for j, data_idx in enumerate(batch["indices"]):
            if data_idx >= n_plots:
                continue
            if dur_pred is not None and hp["predict_dur"]:
                n_ph = int(meta["tokens"][data_idx])
                gt, pred = host(batch["ph_dur"], j, n_ph), host(dur_pred, j, n_ph)
                self.logger.add_figure(f"dur_{data_idx}",
                                       lambda g=gt, p=pred, n=n_ph: dur_to_figure(g, p, [""] * n),
                                       step)
            if pitch_abs is not None:
                t = int(meta["pitch"][data_idx])
                gt, pred = host(batch["pitch"], j, t), host(pitch_abs, j, t)
                self.logger.add_figure(f"pitch_{data_idx}",
                                       lambda g=gt, p=pred: pitch_note_to_figure(g, p), step)
            for v in var_list:
                if v in var_pred:
                    t = int(meta[v][data_idx])
                    gt, pred = host(batch[v], j, t), host(var_pred[v], j, t)
                    self.logger.add_figure(f"{v}_{data_idx}",
                                           lambda g=gt, p=pred: curve_to_figure(g, p), step)
