"""Device milliseconds inside the vocoder's range per second of audio
returned in the traced window."""

LAYER = "Vocoder"
SOURCE = "device_trace"
UNIT = "ms/s"
MOVES = "song_s_per_s"


def read(layer):
    device_s = (layer.get("trace") or {}).get("device_s", {}).get("vocoder")
    if not device_s or not layer.get("song_s"):
        return None
    return 1000.0 * device_s / layer["song_s"]
