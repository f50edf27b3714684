"""LYNXNet's conv modules against their roofline: the least time for their
work at the shapes they were called with (``work.lynx_convmodule``: the
larger of bytes over HBM bandwidth, bf16 tensor FLOPs over 989 TFLOP/s and
CUDA-core FLOPs over 67 TFLOP/s, a call at a time), over the device time of
the kernels launched inside the conv modules' ranges."""

LAYER = "Denoiser and its kernels"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "song_s_per_s"


def read(layer):
    device_s = (layer.get("trace") or {}).get("device_s", {}).get("lynxnet.convmodule")
    least = (layer.get("counts") or {}).get("lynx_least_s")
    if not device_s or not least:
        return None
    return 100.0 * least / device_s
