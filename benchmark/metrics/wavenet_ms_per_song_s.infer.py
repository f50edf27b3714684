"""Device milliseconds inside the pitch and variance predictors' ranges
(their WaveNet denoisers) per second of score predicted in the traced
window."""

LAYER = "Variance predictors"
SOURCE = "device_trace"
UNIT = "ms/s"
MOVES = "song_s_per_s"


def read(layer):
    device_s = (layer.get("trace") or {}).get("device_s", {}).get("wavenet")
    if not device_s or not layer.get("song_s"):
        return None
    return 1000.0 * device_s / layer["song_s"]
