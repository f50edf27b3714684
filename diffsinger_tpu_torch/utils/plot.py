"""Validation figures (counterpart of diffsinger_tpu/utils/plot.py, the mel
figure). matplotlib is imported when a figure is drawn."""

from __future__ import annotations

import numpy as np


def spec_to_figure(spec, vmin=None, vmax=None, title=None):
    """A [T, M] spectrogram as a matplotlib figure (Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 9))
    if title:
        plt.title(title, fontsize=15)
    plt.pcolor(np.asarray(spec).T, vmin=vmin, vmax=vmax)
    plt.tight_layout()
    return fig
