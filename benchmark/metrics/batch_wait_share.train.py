"""The trainer's wait for its next batch: host seconds inside
``BaseTask.next_batch`` (the benchmark's wrapper) over the window's."""

LAYER = "Trainer"
SOURCE = "host_clock"
UNIT = "%"
MOVES = "train_frames_per_s"


def read(layer):
    if not layer.get("window_s") or "wait_s" not in layer:
        return None
    return 100.0 * layer["wait_s"] / layer["window_s"]
