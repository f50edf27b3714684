"""The padded share of the frames the model was given: 1 - true frames /
padded frames over the window's chunks, counted from the host arrays each
chunk is stacked from."""

LAYER = "Server"
SOURCE = "program_counter"
UNIT = "%"
MOVES = "song_s_per_s"


def read(layer):
    counts = layer.get("counts") or {}
    if not counts.get("padded_frames"):
        return None
    return 100.0 * (1.0 - counts["true_frames"] / counts["padded_frames"])
