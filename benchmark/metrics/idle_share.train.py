"""The device's idle share of the traced training window: 1 - the union of
its kernels, copies and sets over all streams / the window."""

LAYER = "Device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "train_frames_per_s"


def read(layer):
    red = layer.get("trace") or {}
    if not red.get("window_s"):
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
