"""The whole model's share of the chip's peak: the products' FLOPs of every
returned phrase at its true lengths (``work.acoustic`` + ``work.vocoder``, or
``work.variance``), over the traced window's seconds and the configuration's
peak."""

LAYER = "Whole model"
SOURCE = "host_clock"
UNIT = "%"
MOVES = "song_s_per_s"


def read(layer):
    if not layer.get("true_flops") or not layer.get("window_s"):
        return None
    return 100.0 * layer["true_flops"] / (layer["window_s"] * layer["peak_flops"])
