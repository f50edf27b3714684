"""What the serving drivers share: seeded streams, the closed loop, the host
ranges around a server's methods and modules, and the pick of phrases the
reference checks."""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from benchmark import generator

WARMUP_KEY = 1 << 30  # the warm-up requests' draws, apart from the window's


def stream(seed: int, *keys: int) -> int:
    """A generator seed for one draw (of one chunk of one request, or of the weights)."""
    return int(np.random.SeedSequence([generator.seed_key(seed), *keys]).generate_state(
        2, np.uint64)[0])


def timestep(hp: dict) -> float:
    """Seconds a mel frame."""
    return hp["hop_size"] / hp["audio_sample_rate"]


def closed_loop(run, pool: List, serve: Callable) -> Tuple[list, float]:
    """Warm up on every song of the pool once (the window's every chunk shape:
    cuDNN and cuBLAS choose their algorithms at a shape's first call), then
    serve songs in the pool's order, one at a time, until ``run.seconds``
    have passed. Returns the requests ``(k, answers)`` and the window's
    seconds."""
    for k, song in enumerate(pool):
        serve(song, WARMUP_KEY + k)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    run.layer["counts"] = run.instrument() if run.trace else {}
    done = []
    run.tracer.start()
    run.window_start = time.perf_counter()
    with run.tracer.span("bench.window"):
        k = 0
        while True:
            with run.tracer.span("server.request"):
                done.append((k, serve(pool[k % len(pool)], k)))
            k += 1
            if time.perf_counter() - run.window_start >= run.seconds:
                break
    window_s = time.perf_counter() - run.window_start
    run.tracer.stop()
    return done, window_s


def wrap(tracer, obj, name: str, span: str) -> None:
    """``obj.name`` runs inside the host range ``span``."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        with tracer.span(span):
            return fn(*args, **kwargs)
    setattr(obj, name, wrapped)


def ranged(tracer, module: torch.nn.Module, span: str, on_call=None) -> None:
    """Every call of ``module`` runs inside the host range ``span``;
    ``on_call(args)`` sees its arguments first."""
    state = {}

    def pre(mod, args):
        if on_call is not None:
            on_call(args)
        state["cm"] = tracer.span(span)
        state["cm"].__enter__()

    def post(mod, args, out):
        state.pop("cm").__exit__(None, None, None)
    module.register_forward_pre_hook(pre)
    module.register_forward_hook(post)


def pick(seed: int, done: List[Tuple[int, list]], lengths: Dict, count: int) -> List[tuple]:
    """The phrases compared with the reference: the longest returned one and
    a seeded draw from the others, as (request, phrase)."""
    items = [(k, i) for k, answers in done for i in range(len(answers))]
    longest = max(items, key=lambda ki: (lengths[ki], -ki[0], -ki[1]))
    rest = [it for it in items if it != longest]
    rng = np.random.default_rng([generator.seed_key(seed), 7])
    n = min(len(rest), count - 1)
    return [longest] + [rest[j] for j in rng.choice(len(rest), n, replace=False)]


def free_program() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(run, driver) -> None:
    """A serving cell's run: traffic from the seed, the server from the
    driver, the closed loop, then (the server freed) the reference's check
    of a sample of the answers. ``driver`` gives ``build_server(run)``,
    ``request(run, server) -> serve(song, k)``, ``instrument(run, server)``,
    ``frames(run, answer)``, ``flops(run, seg, frames)``, ``reference(run,
    pool, picks, lowp)`` and ``compare(run, got, want)``. The servers print
    a line a phrase; standard output is kept for the result line."""
    ts = timestep(run.config["hparams"])
    marks = run.layer.setdefault("setup_marks", {})
    marks["traffic"] = time.perf_counter()
    pool = generator.songs(run.mix, run.seed, ts)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        marks["server"] = time.perf_counter()
        server = driver.build_server(run)
        marks["warm-up"] = time.perf_counter()
        run.instrument = lambda: driver.instrument(run, server)
        done, window_s = closed_loop(run, pool, driver.request(run, server))
    run.instrument = None
    run.attempted = len(done)
    lengths = {(k, i): driver.frames(run, a) for k, answers in done for i, a in enumerate(answers)}
    song_s = sum(lengths.values()) * ts
    run.e2e["song_s_per_s"] = song_s / window_s
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    true_flops = sum(driver.flops(run, seg, lengths[(k, i)])
                     for k, _ in done for i, seg in enumerate(pool[k % len(pool)]))
    run.layer.update(window_s=window_s, song_s=song_s, true_flops=true_flops,
                     peak_flops=run.config["peak_flops_per_s"])
    del server
    free_program()
    picks = pick(run.seed, done, lengths, run.mix["reference_phrases"])
    got = {(k, i): done[k][1][i] for k, i in picks}
    if run.lowp is not None:  # the control: the reference one precision down, in the program's place
        got = driver.reference(run, pool, picks, lowp=run.lowp)
    run.checks = driver.compare(run, got, driver.reference(run, pool, picks))
