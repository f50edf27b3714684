"""Figures (counterpart of diffsinger_tpu/utils/plot.py): the validation
figures (the acoustic model's mel; the variance model's durations, pitch and
curves) and the binarizers' distribution summaries. matplotlib is imported
when a figure is drawn."""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def spec_to_figure(spec, vmin=None, vmax=None, title=None):
    """A [T, M] spectrogram as a matplotlib figure (Agg backend)."""
    plt = _plt()
    fig = plt.figure(figsize=(12, 9))
    if title:
        plt.title(title, fontsize=15)
    plt.pcolor(np.asarray(spec).T, vmin=vmin, vmax=vmax)
    plt.tight_layout()
    return fig


def dur_to_figure(dur_gt, dur_pred, txt, title=None):
    """Phoneme boundaries: the target's above the axis (blue), the
    prediction's below it (red), each phoneme's text at its middle."""
    plt = _plt()
    dur_gt = np.asarray(dur_gt).astype(np.int64)
    dur_pred = np.asarray(dur_pred).astype(np.int64)
    gt_pos, pred_pos = np.cumsum(dur_gt), np.cumsum(dur_pred)
    fig = plt.figure(figsize=(12, 6))
    for i in range(len(dur_gt)):
        shift = 4 if i % 2 else 5
        label = txt[i] if i < len(txt) else ""
        plt.text(gt_pos[i] - dur_gt[i] / 2, shift, label, size=16, horizontalalignment="center")
        plt.text(pred_pos[i] - dur_pred[i] / 2, -shift, label, size=16,
                 horizontalalignment="center")
        plt.vlines(gt_pos[i], 0, 2, colors="b")
        plt.vlines(pred_pos[i], -2, 0, colors="r")
    plt.axhline(0, color="black", linewidth=0.5)
    plt.ylim(-6, 6)
    if title:
        plt.title(title)
    plt.tight_layout()
    return fig


def pitch_note_to_figure(pitch_gt, pitch_pred=None, note_midi=None, note_dur=None,
                         note_rest=None, title=None):
    """Pitch curves (target blue, prediction red) over the notes (green)."""
    plt = _plt()
    fig = plt.figure(figsize=(12, 6))
    plt.plot(np.asarray(pitch_gt), color="b", label="gt")
    if pitch_pred is not None:
        plt.plot(np.asarray(pitch_pred), color="r", label="pred")
    if note_midi is not None and note_dur is not None:
        end = np.cumsum(np.asarray(note_dur))
        start = np.concatenate([[0], end[:-1]])
        rest = np.asarray(note_rest) if note_rest is not None else np.zeros(len(end), bool)
        for s, e, m, r in zip(start, end, np.asarray(note_midi), rest):
            if not r:
                plt.hlines(m, s, e, colors="g", linewidth=2)
    plt.legend()
    if title:
        plt.title(title)
    plt.tight_layout()
    return fig


def curve_to_figure(curve_gt, curve_pred=None, curve_base=None, grid=None, title=None):
    """A curve: target blue, prediction red, base green."""
    plt = _plt()
    fig = plt.figure(figsize=(12, 6))
    plt.plot(np.asarray(curve_gt), color="b", label="gt")
    if curve_pred is not None:
        plt.plot(np.asarray(curve_pred), color="r", label="pred")
    if curve_base is not None:
        plt.plot(np.asarray(curve_base), color="g", label="base")
    if grid is not None:
        plt.grid(axis="y")
    plt.legend()
    if title:
        plt.title(title)
    plt.tight_layout()
    return fig


def distribution_to_figure(title, x_label, y_label, items, values, zoom=0.8, rotate=False):
    """A bar chart of ``values`` over ``items``; returns pyplot, whose current
    figure it is."""
    plt = _plt()
    plt.figure(figsize=(int(len(items) * zoom), 10))
    plt.bar(x=items, height=values)
    plt.xlabel(x_label)
    plt.ylabel(y_label)
    plt.title(title)
    if rotate:
        plt.xticks(rotation=90)
    return plt
