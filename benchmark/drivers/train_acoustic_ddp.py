"""The acoustic model's training on several ranks, a card each, through
``BaseTask.start`` under ``DistributedDataParallel``, as ``cli.train`` runs
it on a host with several cards.

Set-up writes ``train_acoustic``'s seeded store once (rank 0, before the
others start), then starts ranks 1 .. N-1 as ``cli.train`` starts them
(``spawn``, the launch contract in each one's environment, a group over
``tcp://localhost``: NCCL on the cards, gloo on the CPU), N the cell's
``chips``. Rank 0 runs in the benchmark's own process, under its tracer.
Every rank builds ``AcousticTask`` from the configuration with the run's
seed and the seeded weights (DDP broadcasts rank 0's), and wraps its loop
methods in ``train_acoustic``'s :class:`~benchmark.drivers.train_acoustic.Loop`:
the checked steps' captures with this rank's dropout masks on its own rows,
the window from the end of the first epoch (the same update on every rank:
every rank has the same batch positions). Rank 0's clock closes the window:
at each update of the window rank 0 sends its verdict over a gloo group of
the ranks' own, and every rank reads it two updates later, so all of them
stop after the same update, with no collective left open.

``train_frames_per_s`` is the true mel frames of every rank's steps in the
window over rank 0's window. After the window each rank writes its captures
and its rows' counts to the run's scratch folder and leaves the group; with
the program freed, rank 0's plain reference follows the checked steps over
the global batch (the ranks' rows in rank order, each rank's masks on its
own rows) and the run compares the global loss (the mean of the ranks')
and rank 0's first gradient and change, which the all-reduce makes every
rank's, under the configuration's limits.

In a traced run the per-layer metrics read rank 0: its kernels, its rows'
products over one card's peak, and its NCCL kernels' device time while no
other kernel of its card runs (:func:`nccl_exposed`).
"""

from __future__ import annotations

import bisect
import collections
import os
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, serving, trace
from benchmark.drivers import train_acoustic
from benchmark.drivers.train_acoustic import Loop, WindowClosed

RANGES = train_acoustic.RANGES
GROUP_TIMEOUT_S = "300"  # a rank that dies makes the others raise within this
VERDICT_LAG = 2  # updates between rank 0's verdict and its reading on every rank


class RankLoop(Loop):
    """``Loop`` with the window's end agreed by the ranks."""

    def __init__(self, run, task, flags):
        super().__init__(run, task)
        self.flags = flags  # a gloo group: the verdict travels on the hosts
        self.verdicts = collections.deque()

    def window_full(self) -> bool:
        """Rank 0's verdict of ``VERDICT_LAG`` updates ago, the same on every
        rank. Each update sends rank 0's verdict without waiting for it, so
        the hosts are not held in step with each other (DDP's all-reduce does
        not hold them either); once the window is full every verdict still
        on its way is waited for, so no collective is left open."""
        import torch.distributed as tdist

        full = tdist.get_rank() == 0 and time.perf_counter() - self.window_start >= \
            self.run.seconds
        flag = torch.tensor([float(full)])
        self.verdicts.append((tdist.all_reduce(flag, op=tdist.ReduceOp.MAX, group=self.flags,
                                               async_op=True), flag))
        if len(self.verdicts) <= VERDICT_LAG:
            return False
        work, flag = self.verdicts.popleft()
        work.wait()
        if not flag.item():
            return False
        while self.verdicts:
            self.verdicts.popleft()[0].wait()
        return True

    def apply_update(self):
        """``Loop.apply_update`` with the window closed by :meth:`window_full`:
        ``Loop`` reads its own clock alone, which would let the ranks stop
        after different updates and leave one waiting in the all-reduce."""
        task = self.task
        with self.run.tracer.span("trainer.update"):
            norm = self.orig["apply_update"]()
        self.updates += 1
        params = [p for p in task.module.parameters() if p.requires_grad]
        if self.updates == 1:  # AdamW's first moment after one step: (1 - beta1) g
            beta1 = task.optimizer.param_groups[0]["betas"][0]
            state = task.optimizer.state
            moments = [state[p]["exp_avg"] if "exp_avg" in state.get(p, {}) else
                       torch.zeros_like(p) for p in params]
            self.grad1 = [v / (1 - beta1)
                          for v in torch.stack(torch._foreach_norm(moments)).tolist()]
        if self.updates == self.checked:
            self.change = torch.stack(torch._foreach_norm(
                torch._foreach_sub([p.detach() for p in params], self.start))).tolist()
            self.start = None
        if self.window is not None:
            if self.window_full():
                self._sync()
                self.window_s = time.perf_counter() - self.window_start
                self.window.__exit__(None, None, None)
                self.run.tracer.stop()
                raise WindowClosed()
        elif self.updates >= self.checked and task.epoch >= 1:  # the first epoch is done
            self._sync()
            self.run.tracer.start()
            self.window = self.run.tracer.span(trace.WINDOW)
            self.window.__enter__()
            self.window_start = time.perf_counter()
        return norm


def pack(mask: torch.Tensor) -> tuple:
    return tuple(mask.shape), np.packbits(mask.cpu().numpy().reshape(-1))


def unpack(packed: tuple, device) -> torch.Tensor:
    shape, bits = packed
    n = int(np.prod(shape))
    return torch.from_numpy(np.unpackbits(bits, count=n).reshape(shape).astype(bool)).to(device)


def captures_to_host(captured: List[Dict]) -> List[Dict]:
    """A rank's checked steps on the host, its dropout masks as bits."""
    out = []
    for c in captured:
        host = {k: v.cpu() for k, v in c.items() if isinstance(v, torch.Tensor)}
        host["masks"] = {name: [(pack(keep), p) for keep, p in queue]
                         for name, queue in c["masks"].items()}
        out.append(host)
    return out


def global_captures(per_rank: List[List[Dict]], device) -> List[Dict]:
    """Each checked step over the global batch: the ranks' rows in rank
    order, each mask of a module's call likewise, and the global loss: the
    mean of the ranks' losses (each its rows' sum over the global
    denominator, times the rank count, for DDP's mean of the gradients;
    ``models/losses.py::global_ratio``)."""
    out = []
    for steps in zip(*per_rank):
        step = {k: torch.cat([s[k] for s in steps]).to(device)
                for k in train_acoustic.BATCH_KEYS + ("t", "noise")}
        step["loss"] = sum(float(s["loss"]) for s in steps) / len(steps)
        step["masks"] = {name: [(torch.cat([unpack(s["masks"][name][i][0], device)
                                            for s in steps]), p)
                                for i, (_, p) in enumerate(steps[0]["masks"][name])]
                         for name in steps[0]["masks"]}
        out.append(step)
    return out


def nccl_exposed(events):
    """(seconds, NCCL kernels) of the window: the seconds in which a kernel
    of NCCL runs on the card and no other kernel does (the union of NCCL's
    kernels less the union of the others'), and how many NCCL kernels ran.
    Host ranges that the profiler also draws on the device's timeline (the
    benchmark's, DDP's forward, ``nccl:all_reduce``) are not kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    window = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
              if e.device_type() != cuda and e.name() == trace.WINDOW]
    if not window:
        return 0.0, 0
    w0, w1 = window[0]
    nccl, other = [], []
    for e in events:
        name = e.name()
        if (e.device_type() != cuda or e.is_user_annotation()  # ranges drawn on the device
                or name in RANGES or name == trace.WINDOW
                or name.startswith(("Memcpy", "Memset"))):
            continue
        s, end = max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)
        if end > s:
            (nccl if "nccl" in name.lower() else other).append((s, end))
    exposed = 0
    covered = trace.union(other)  # sorted, disjoint
    ends = [ce for _, ce in covered]
    for s, e in trace.union(nccl):
        exposed += e - s
        i = bisect.bisect_right(ends, s)
        while i < len(covered) and covered[i][0] < e:
            exposed -= min(e, covered[i][1]) - max(s, covered[i][0])
            i += 1
    return exposed / 1e9, len(nccl)


def join_group(rank: int, world: int, init_method: str, device_type: str):
    """The launch contract in the environment, the group joined; returns this
    rank's device and a gloo group of every rank."""
    import torch.distributed as tdist

    from diffsinger_tpu_torch.parallel import dist

    os.environ.update(DS_COORDINATOR_ADDRESS=init_method, DS_NUM_PROCESSES=str(world),
                      DS_PROCESS_ID=str(rank), DS_LOCAL_RANK=str(rank))
    os.environ.setdefault("DS_DIST_TIMEOUT", GROUP_TIMEOUT_S)
    device = dist.maybe_initialize_distributed(device_type)
    return device, tdist.new_group(backend="gloo")


def train_rank(run, store: str, flags):
    """This rank's task through its window; returns the loop."""
    task = train_acoustic.build_task(run, store)
    loop = RankLoop(run, task, flags)
    try:
        task.start(max_steps=1 << 30)
    except WindowClosed:
        pass
    if loop.window is None:
        raise RuntimeError("the run ended before its window opened")
    return loop


def rank_main(i: int, world: int, init_method: str, spec: dict) -> None:
    """Rank ``i + 1``, in a process of its own: train, then write its
    captures and counts to the scratch folder."""
    from diffsinger_tpu_torch.parallel import dist

    rank = i + 1
    device, flags = join_group(rank, world, init_method, spec["device_type"])
    run = harness.Run(cell=spec["cell"], config=spec["config"], mix=spec["mix"],
                      seed=spec["seed"], seconds=spec["seconds"], trace=False, device=device,
                      scratch=spec["scratch"], tracer=trace.Tracer(False))
    try:
        loop = train_rank(run, spec["store"], flags)
        torch.save({"captured": captures_to_host(loop.captured),
                    "rows": torch.cat(loop.rows, dim=1).cpu() if loop.rows else None},
                   spec["scratch"] / f"rank{rank}.pt")
    finally:
        dist.destroy()


def watch(ctx, failed: threading.Event) -> None:
    """End this process (and every rank) as soon as a rank fails: the others
    would wait for it in a collective until the group's timeout."""
    while not failed.is_set():
        for p in ctx.processes:
            if p.exitcode not in (None, 0):
                print(f"rank process {p.pid} failed (exit {p.exitcode})", flush=True)
                for q in ctx.processes:
                    if q.is_alive():
                        q.kill()
                os._exit(5)
        time.sleep(0.5)


def run(run) -> None:
    import importlib

    import torch.multiprocessing as mp

    from diffsinger_tpu_torch.cli.train import _free_port
    from diffsinger_tpu_torch.parallel import dist

    world = run.cell["chips"]
    marks = run.layer.setdefault("setup_marks", {})
    marks["traffic"] = time.perf_counter()
    store = train_acoustic.write_store(run)
    marks["server"] = time.perf_counter()
    if run.device.type == "cuda":
        from diffsinger_tpu_torch.ops import native

        native.build()  # once, before the ranks load the kernels
    init_method = f"tcp://localhost:{_free_port()}"
    spec = dict(cell=run.cell, config=run.config, mix=run.mix, seed=run.seed,
                seconds=run.seconds, scratch=run.scratch, store=store,
                device_type=run.device.type)
    # the spawned ranks find the function under its importable name
    me = importlib.import_module("benchmark.drivers.train_acoustic_ddp")
    ctx = mp.start_processes(me.rank_main, args=(world, init_method, spec), nprocs=world - 1,
                             join=False, start_method="spawn")
    stop = threading.Event()
    threading.Thread(target=watch, args=(ctx, stop), daemon=True).start()
    saved_env = {k: os.environ.get(k) for k in ("DS_COORDINATOR_ADDRESS", "DS_NUM_PROCESSES",
                                                 "DS_PROCESS_ID", "DS_LOCAL_RANK",
                                                 "DS_DIST_TIMEOUT")}
    try:
        _, flags = join_group(0, world, init_method, run.device.type)
        marks["warm-up"] = time.perf_counter()
        loop = train_rank(run, store, flags)
        dist.destroy()
        deadline = time.monotonic() + 120
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError("the ranks did not end after the window")
    finally:
        stop.set()
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
        dist.destroy()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    others = [torch.load(run.scratch / f"rank{r}.pt", weights_only=False)
              for r in range(1, world)]
    run.window_start = loop.window_start
    run.attempted = len(loop.rows)  # rank 0's window steps: every rank's count
    frames, flops = train_acoustic.true_work(run, loop.rows)
    frames += sum(int(o["rows"][0].sum()) for o in others if o["rows"] is not None)
    run.e2e["train_frames_per_s"] = frames / loop.window_s
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    run.layer.update(window_s=loop.window_s, true_flops=3 * flops,
                     peak_flops=run.config["peak_flops_per_s"], wait_s=loop.wait_s,
                     steps=len(loop.rows), peak_mem_bytes=run.memory_peak_bytes, ranks=world)
    if run.trace:
        run.layer["nccl_exposed_s"], run.layer["nccl_kernels"] = nccl_exposed(
            run.tracer.events())
    mine = train_acoustic.program_numbers(loop)
    captured = global_captures([captures_to_host(loop.captured)]
                               + [o["captured"] for o in others], run.device)
    got = dict(mine, loss=[c["loss"] for c in captured])
    del loop, others
    serving.free_program()
    if run.lowp is not None:  # the control: the reference one precision down, in the program's place
        got = train_acoustic.reference(run, captured, lowp=run.lowp)
    want = train_acoustic.reference(run, captured)
    measured = train_acoustic.gaps(got, want)
    run.layer["leaves_left_out"] = len(want["grad1"]) - len(train_acoustic.moved(want["grad1"]))
    limits = run.config["limits"]
    run.checks = [harness.Check(name, value, limits[name]) for name, value in measured.items()
                  if name in limits]
