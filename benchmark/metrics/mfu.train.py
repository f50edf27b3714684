"""The whole training step's share of the chip's peak: 3 x the forward's
products (``work.acoustic_train``) at every row's true lengths over the
traced window's steps, over the window's seconds and the configuration's
peak."""

LAYER = "Whole model"
SOURCE = "host_clock"
UNIT = "%"
MOVES = "train_frames_per_s"


def read(layer):
    if not layer.get("true_flops") or not layer.get("window_s"):
        return None
    return 100.0 * layer["true_flops"] / (layer["window_s"] * layer["peak_flops"])
