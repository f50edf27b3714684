"""Device milliseconds inside the program's span ``ds.model.sample`` (the
sampler: its denoiser calls and the launches around them) per second of
audio returned in the traced window."""

LAYER = "Sampler"
SOURCE = "device_trace"
UNIT = "ms/s"
MOVES = "song_s_per_s"


def read(layer):
    device_s = (layer.get("trace") or {}).get("device_s", {}).get("ds.model.sample")
    if not device_s or not layer.get("song_s"):
        return None
    return 1000.0 * device_s / layer["song_s"]
