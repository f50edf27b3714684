"""Process groups for training over ranks (counterpart of
diffsinger_tpu/parallel/dist.py).

One process per device, joined by ``torch.distributed``: NCCL between cards,
gloo on the CPU (or on a card when ``backend='gloo'`` is asked for). A
process joins a group when its environment names one, by either contract:

* the JAX package's: ``DS_COORDINATOR_ADDRESS=host:port`` (or an init URL
  such as ``file:///path``), ``DS_NUM_PROCESSES=N``, ``DS_PROCESS_ID=r``, and
  optionally ``DS_LOCAL_RANK``;
* ``torchrun``'s: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
  and ``MASTER_PORT``.

Each rank binds ``cuda:{local rank}`` by its index. The group carries a
timeout (``DS_DIST_TIMEOUT`` seconds, else 1800), so that a rank that dies
makes the others raise instead of waiting for ever. Nothing falls back: a
backend that fails to start raises.

:func:`spawn` starts one process per rank with ``spawn`` and waits for them
with a deadline, which ``cli.train`` uses on a host with several cards.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def launcher_env() -> Optional[dict]:
    """``{rank, world_size, local_rank, init_method}`` from the environment,
    or None when no launcher set it."""
    env = os.environ
    if env.get("DS_COORDINATOR_ADDRESS"):
        addr = env["DS_COORDINATOR_ADDRESS"]
        rank = int(env["DS_PROCESS_ID"])
        local = env.get("DS_LOCAL_RANK", env.get("LOCAL_RANK"))
        return {"rank": rank, "world_size": int(env["DS_NUM_PROCESSES"]),
                "local_rank": int(local) if local is not None else None,
                "init_method": addr if "://" in addr else f"tcp://{addr}"}
    if env.get("WORLD_SIZE") and env.get("RANK") is not None and env.get("MASTER_ADDR"):
        return {"rank": int(env["RANK"]), "world_size": int(env["WORLD_SIZE"]),
                "local_rank": int(env.get("LOCAL_RANK", 0)), "init_method": "env://"}
    return None


def group_timeout() -> float:
    """The group's timeout in seconds."""
    return float(os.environ.get("DS_DIST_TIMEOUT", 1800))


def maybe_initialize_distributed(device=None, *, backend: Optional[str] = None) -> torch.device:
    """Join the process group that the environment names, if any, and return
    the device this rank runs on.

    ``device`` is the caller's request ('cpu', 'cuda', 'cuda:1' or None for
    the card). A rank on a card binds ``cuda:{local rank}`` (the local rank
    defaults to the rank modulo the visible cards) unless ``device`` names an
    index. The backend is NCCL on a card and gloo on the CPU unless
    ``backend`` says otherwise. Without a launcher environment nothing is
    joined and ``device`` is returned as given (None: ``cuda``).
    """
    dev = torch.device("cuda" if device is None else device)
    env = launcher_env()
    if env is None:
        return dev
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            local = env["local_rank"]
            if local is None:
                local = env["rank"] % torch.cuda.device_count()
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        kwargs = {}
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(
            backend, init_method=env["init_method"], world_size=env["world_size"],
            rank=env["rank"], timeout=datetime.timedelta(seconds=group_timeout()), **kwargs)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor; ``x`` itself with one rank)."""
    if world_size() == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def all_reduce_mean(values: dict) -> dict:
    """Host metrics {name: float or scalar tensor} averaged over the ranks, as floats."""
    names = sorted(values)
    if world_size() == 1 or not names:
        return {k: float(values[k]) for k in names}
    dev = next((v.device for v in values.values() if isinstance(v, torch.Tensor)),
               torch.device("cpu"))
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    vec = torch.stack([torch.as_tensor(values[k], dtype=torch.float64, device=dev).reshape(())
                       .detach() for k in names])
    dist.all_reduce(vec, op=dist.ReduceOp.SUM)
    return {k: float(v) / world_size() for k, v in zip(names, vec.tolist())}


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence = (), *, timeout: Optional[float] = None
          ) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` processes started with ``spawn``
    and wait for all of them. Raises the first failure of a rank (the others
    are ended), and ``TimeoutError`` if they have not all ended after
    ``timeout`` seconds (then every rank is ended)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=tuple(args), nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not end within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
