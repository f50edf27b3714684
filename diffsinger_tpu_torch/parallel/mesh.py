"""Devices (counterpart of diffsinger_tpu/parallel/mesh.py).

The JAX package lays a 1-D data mesh over its chips and lets XLA shard the
batch axis. The port runs one replica per device instead: a trainer rank per
card (``parallel/dist.py``), or a server that runs its chunks in turn on the
cards it holds (``inference/serving.py``). This module picks the devices.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch


def local_devices(pl_trainer_devices: Union[str, int, Sequence[int]] = "auto",
                  device_type: str = "cuda") -> List[torch.device]:
    """The cards a run uses: ``'auto'`` (or -1) every visible one, an int
    that many from index 0, a list those indices. On the CPU, one device."""
    if device_type != "cuda":
        return [torch.device(device_type)]
    n_visible = torch.cuda.device_count()
    if pl_trainer_devices in ("auto", -1, "-1", None):
        indices = list(range(n_visible))
    elif isinstance(pl_trainer_devices, (list, tuple)):
        indices = [int(i) for i in pl_trainer_devices]
    else:
        indices = list(range(int(pl_trainer_devices)))
    bad = [i for i in indices if not 0 <= i < n_visible]
    if bad or not indices:
        raise ValueError(f"pl_trainer_devices {pl_trainer_devices!r} names cards {bad or indices} "
                         f"but {n_visible} are visible")
    return [torch.device("cuda", i) for i in indices]
