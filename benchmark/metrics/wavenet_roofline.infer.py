"""The WaveNet's residual stacks against their roofline: the least time for
their work (``work_wavenet.stack_least_seconds``: the frames of the counter
``wavenet.stack_frames`` at the configuration's widths, the larger of bf16
tensor-core FLOPs over 989 TFLOP/s and bytes over 3.35 TB/s), over the
device time of the kernels launched inside the program's span
``ds.wavenet.stack``. The work is the same whatever implements the blocks."""

LAYER = "Denoiser and its kernels"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "song_s_per_s"


def read(layer):
    device_s = (layer.get("trace") or {}).get("device_s", {}).get("ds.wavenet.stack")
    least = layer.get("wavenet_least_s")
    if not device_s or not least:
        return None
    return 100.0 * least / device_s
