"""Faults planted under the timed path, to see ``correct`` come out false.

Each fault is a function of a patcher ``set(target, name, value)`` (an
attribute of a class or module, or a key of a dict) that the caller undoes:
pytest's ``monkeypatch`` in the CPU tests, :class:`Patches` in
``calibrate.py`` on the card, at the cell's own widths.
"""

from __future__ import annotations

import torch


class Patches:
    """``set`` like ``monkeypatch.setattr`` / ``setitem``; ``undo`` puts back
    every value in reverse order."""

    def __init__(self):
        self._saved = []

    def set(self, target, name, value) -> None:
        if isinstance(target, dict):
            self._saved.append((target, name, target[name]))
            target[name] = value
        else:
            self._saved.append((target, name, getattr(target, name)))
            setattr(target, name, value)

    def undo(self) -> None:
        while self._saved:
            target, name, value = self._saved.pop()
            if isinstance(target, dict):
                target[name] = value
            else:
                setattr(target, name, value)


def step_unchanged(set_) -> None:
    """Every sampler step returns its state unchanged."""
    from diffsinger_tpu_torch.core import reflow

    set_(reflow._STEPS, "euler", lambda fn, x, t, dt, tsf: x)


def half_the_batch(set_) -> None:
    """Each chunk's second half of rows is left out (zeros come back)."""
    from diffsinger_tpu_torch.inference.ds_acoustic import DiffSingerAcousticInfer
    from diffsinger_tpu_torch.inference.ds_variance import DiffSingerVarianceInfer

    run_wav = DiffSingerAcousticInfer._run_wav

    def acoustic(self, *args, **kwargs):
        wav = run_wav(self, *args, **kwargs)
        wav[wav.shape[0] // 2:] = 0
        return wav

    run_padded = DiffSingerVarianceInfer._run_padded

    def variance(self, *args, **kwargs):
        dur, pitch, curves = run_padded(self, *args, **kwargs)
        half = pitch.shape[0] // 2
        dur[half:] = 0
        pitch[half:] = 0
        for v in curves.values():
            v[half:] = 0
        return dur, pitch, curves

    set_(DiffSingerAcousticInfer, "_run_wav", acoustic)
    set_(DiffSingerVarianceInfer, "_run_padded", variance)


def answer_altered(set_) -> None:
    """The answer is altered where it is produced: the acoustic model's mel
    one natural-log unit louder; the predicted pitch one semitone higher."""
    from diffsinger_tpu_torch.inference.ds_acoustic import DiffSingerAcousticInfer
    from diffsinger_tpu_torch.inference.ds_variance import DiffSingerVarianceInfer

    run_model = DiffSingerAcousticInfer._run_model

    def acoustic(self, *args, **kwargs):
        mel, f0 = run_model(self, *args, **kwargs)
        return mel + 1.0, f0

    run_padded = DiffSingerVarianceInfer._run_padded

    def variance(self, *args, **kwargs):
        dur, pitch, curves = run_padded(self, *args, **kwargs)
        return dur, pitch + 1.0, curves

    set_(DiffSingerAcousticInfer, "_run_model", acoustic)
    set_(DiffSingerVarianceInfer, "_run_padded", variance)


def update_skipped(set_) -> None:
    """Each training step leaves the weights as they were (the gradients
    are cleared, the optimizer does not step)."""
    from diffsinger_tpu_torch.training.base_task import BaseTask

    def apply_update(self):
        self.optimizer.zero_grad(set_to_none=True)
        self.global_step += 1
        return torch.zeros(())
    set_(BaseTask, "apply_update", apply_update)


def half_the_rows(set_) -> None:
    """Each training batch's second half of rows is left out: their frames
    are dropped from the loss, which is the mean over the first half."""
    from diffsinger_tpu_torch.training import acoustic_task

    make = acoustic_task.make_acoustic_loss_fn

    def make_half(model):
        loss_fn = make(model)

        def half(batch, **draws):
            mel2ph = batch["mel2ph"].clone()
            mel2ph[mel2ph.shape[0] // 2:] = 0
            return loss_fn(dict(batch, mel2ph=mel2ph), **draws)
        return half
    set_(acoustic_task, "make_acoustic_loss_fn", make_half)


def velocity_altered(set_) -> None:
    """The denoiser's predicted velocity is altered where it is produced
    (+0.05 on every element)."""
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic

    forward_train = DiffSingerAcoustic.forward_train

    def altered(self, *args, **kwargs):
        aux_out, (pred, target, t) = forward_train(self, *args, **kwargs)
        return aux_out, (pred + 0.05, target, t)
    set_(DiffSingerAcoustic, "forward_train", altered)


SERVING = {f.__name__: f for f in (step_unchanged, half_the_batch, answer_altered)}
TRAINING = {f.__name__: f for f in (update_skipped, half_the_rows, velocity_altered)}


def plant(name: str, set_) -> None:
    dict(SERVING, **TRAINING)[name](set_)
