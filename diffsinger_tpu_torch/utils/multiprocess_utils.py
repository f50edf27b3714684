"""Order-preserving multiprocess runner (counterpart of
diffsinger_tpu/utils/multiprocess_utils.py).

Spawned workers each take every ``num_workers``-th job and put their results
on a queue of their own; the queues are drained in turn, so results come back
in the order of the jobs whatever each one takes.
"""

from __future__ import annotations

import multiprocessing
import queue
import traceback


def _worker(fn, args_chunk, queue, device):
    import torch

    if device is not None and torch.device(device).type == "cuda":
        # "cuda" without an index is the default card, which set_device refuses
        torch.cuda.set_device(torch.device(device).index or 0)
    for job_idx, args in args_chunk:
        try:
            result = fn(*args)
            queue.put((job_idx, result, None))
        except KeyboardInterrupt:
            break
        except Exception:
            queue.put((job_idx, None, traceback.format_exc()))


def _next_result(q, proc, i: int, poll_s: float = 5.0):
    """The next result of a worker's queue; raises when the worker has ended
    without putting one (it died outside a job, or was killed)."""
    while True:
        try:
            return q.get(timeout=poll_s)
        except queue.Empty:
            if proc.is_alive():
                continue
            try:  # it may have put the result just before it ended
                return q.get(timeout=poll_s)
            except queue.Empty:
                raise RuntimeError(f"the worker of item {i} ended (exit code {proc.exitcode}) "
                                   "without its result") from None


def chunked_multiprocess_run(fn, args_list, num_workers: int, device=None,
                             q_max_size: int = 100):
    """Yield fn(*args) for each args of ``args_list``, in order. ``fn`` must
    pickle (a method of a picklable object, or a top-level function). Each
    worker makes ``device`` its current CUDA device when it names a card;
    the device the work runs on is the one ``fn`` carries."""
    if num_workers <= 0:
        for args in args_list:
            yield fn(*args)
        return

    ctx = multiprocessing.get_context("spawn")
    n = len(args_list)
    queues = [ctx.Queue(maxsize=q_max_size // num_workers + 1) for _ in range(num_workers)]
    chunks = [[] for _ in range(num_workers)]
    for i, args in enumerate(args_list):
        chunks[i % num_workers].append((i, args))
    procs = [
        ctx.Process(target=_worker, args=(fn, chunk, q, device), daemon=True)
        for chunk, q in zip(chunks, queues)
    ]
    for p in procs:
        p.start()
    try:
        for i in range(n):
            job_idx, result, err = _next_result(queues[i % num_workers], procs[i % num_workers], i)
            if job_idx != i:
                raise RuntimeError(f"result order broken: expected {i}, got {job_idx}")
            if err is not None:
                raise RuntimeError(f"Worker error on item {i}:\n{err}")
            yield result
    finally:
        for p in procs:
            p.join(timeout=1)
            if p.is_alive():
                p.terminate()
