"""The trace reduction on a made-up profile: busy time as a union over
streams, device time by host range through the launching operator, idle
gaps named by the innermost open range."""

import pytest
import torch

from benchmark import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, device, start, end, corr=0, link=0):
        self._v = (name, device, start, end, corr, link)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def profile():
    return [
        Event(trace.WINDOW, CPU, 0, 1000),
        Event("server.request", CPU, 0, 1000),
        Event("server.enqueue", CPU, 100, 300),
        Event("vocoder", CPU, 150, 300),
        Event("aten::mm", CPU, 110, 120, corr=1),
        Event("aten::conv1d", CPU, 160, 170, corr=2),
        Event("cudaLaunchKernel", CPU, 180, 185, corr=77),
        Event("gemm", CUDA, 200, 400, corr=11, link=1),
        Event("conv", CUDA, 350, 500, corr=12, link=2),  # overlaps gemm on another stream
        Event("elementwise", CUDA, 600, 650, corr=77, link=999),  # launched by a runtime call
        Event("Memcpy DtoH (Device -> Pinned)", CUDA, 900, 950),
        Event("vocoder", CUDA, 200, 500),  # the host range drawn on the device: not work
    ]


def test_reduce():
    red = trace.reduce(profile(), ("vocoder", "server.enqueue", "server.request"))
    assert red["window_s"] == pytest.approx(1000e-9)
    assert red["busy_s"] == pytest.approx((300 + 50 + 50) * 1e-9)
    assert red["device_s"]["server.enqueue"] == pytest.approx((200 + 150 + 50) * 1e-9)
    assert red["device_s"]["vocoder"] == pytest.approx((150 + 50) * 1e-9)
    assert red["device_s"]["server.request"] == pytest.approx(400e-9)
    gaps = dict(red["idle_gaps"])
    # gaps: 0-200 opens in server.request, 500-600 and 650-900 and 950-1000 too
    assert gaps == {"server.request": pytest.approx((200 + 100 + 250 + 50) * 1e-9)}
    assert red["links"] == {"kernels": 3, "by_operator": 2, "by_runtime": 1}


def test_nothing_on_the_device_reads_nothing():
    assert trace.reduce([Event(trace.WINDOW, CPU, 0, 10)], ("vocoder",)) == {}
