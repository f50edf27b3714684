"""The all-reduce that the backward does not hide: rank 0's device time in
NCCL's kernels while no other kernel of its card runs, over the traced
training window (``drivers/train_acoustic_ddp.py::nccl_exposed``)."""

LAYER = "Distribution"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "train_frames_per_s"


def read(layer):
    window_s = (layer.get("trace") or {}).get("window_s")
    if not window_s or not layer.get("nccl_kernels"):
        return None
    return 100.0 * layer["nccl_exposed_s"] / window_s
