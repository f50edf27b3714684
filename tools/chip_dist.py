#!/usr/bin/env python3
"""Training over NCCL ranks and serving over replicas on every visible card.

    python3 tools/chip_dist.py [--parts train,serve]

Written for one host with four H100s joined by NVLink; it runs on any count
of cards (with one, the ranks are one NCCL rank under DDP). For each family
at full width, in '16-mixed' (chip_smoke.py's [train] and [train_variance]
tasks and batches: B = 48 segments a rank, acoustic T_mel 1024, variance
T_mel 1664):

* one card, no process group: 10 timed optimizer steps after 3 warm-ups;
* N ranks, one process a card (``spawn``), NCCL, the trainer's DDP step
  (each rank its own seeded batch, the draws at the global batch's shape):
  10 timed steps after 3 warm-ups on every rank, then one step under the
  profiler on rank 0 (idle share, NCCL kernels' device time).

Then ``AcousticServer`` and ``VarianceServer`` over all the cards against one
card, on chip_smoke.py's served segments ``SERVE_REPEAT`` times over (a
request of several chunks, which run whole on the cards in turn): seconds,
true frames/s, enqueue seconds a chunk, and the outputs' largest difference
from one card's. ``--parts`` picks the training or the serving part. Prints the card's name and power limit first and one JSON
line of every number last; the details go to chiprun_out/chip_dist.json.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the tasks, batches and seeded weights of its phases)

STEPS, WARMUP = 10, 3
SERVE_REPEAT = 4  # the served segments this many times over: 5 chunks of at most 16


def family_task(family: str, work_dir: Path, device, rank: int):
    """(task, batch on the device, true frames) of [train]'s or
    [train_variance]'s full-width step; the batch's items seeded by rank."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask
    from diffsinger_tpu_torch.training.variance_task import VarianceTask

    rng = np.random.default_rng(35 + 100 * rank)
    if family == "acoustic":
        hp = cs.acoustic_train_hp(work_dir)
        task = cs.quiet(AcousticTask, hp, device=device)
        ds = cs.memory_acoustic_dataset(cs.train_items(
            rng, cs.TRAIN_B, cs.TRAIN_T_TXT, cs.TRAIN_T_MEL, hp["audio_num_mel_bins"],
            *cs.TRAIN_LENGTHS), hp)
        n = cs.TRAIN_B
    else:
        hp = cs.variance_hp(work_dir)
        task = cs.quiet(VarianceTask, hp, device=device)
        ds = cs.memory_variance_dataset(cs.variance_train_items(
            rng, cs.VAR_TRAIN_B, *cs.VAR_TRAIN_LENGTHS, 170), hp)
        n = cs.VAR_TRAIN_B
    task.configure_optimizer()
    cs.seeded_weights(task.module, 34)
    collated = ds.collater([ds[i] for i in range(n)])
    batch = task.to_device({k: v for k, v in collated.items()
                            if isinstance(v, np.ndarray) and k != "indices"})
    return task, batch, int((batch["mel2ph"] > 0).sum().item())


def timed_steps(task, batch, world: int, rank: int) -> dict:
    """WARMUP, then STEPS timed optimizer steps of the loop's body, the draws
    made at the global batch's shape (this rank's rows)."""
    import torch

    rows = batch["tokens"].shape[0]
    micro = 0

    def step():
        nonlocal micro
        metrics = task.train_step(batch, **task.micro_draws(batch, micro, rows * world,
                                                            rows * rank))
        task.apply_update()
        micro += 1
        return metrics

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        metrics = step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"steps_per_s": STEPS / wall, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "loss": float(metrics["total_loss"]), "step": step}


def rank_main(rank: int, world: int, init_method: str, family: str, out: str) -> None:
    """One NCCL rank: DDP around the family's full-width step."""
    import torch

    os.environ.update(DS_COORDINATOR_ADDRESS=init_method, DS_NUM_PROCESSES=str(world),
                      DS_PROCESS_ID=str(rank), DS_LOCAL_RANK=str(rank))
    from diffsinger_tpu_torch.parallel import dist

    dev = dist.maybe_initialize_distributed("cuda")
    task, batch, frames = family_task(family, Path(out) / f"{family}_rank{rank}", dev, rank)
    task.wrap_ddp()
    result = timed_steps(task, batch, world, rank)
    step = result.pop("step")
    if rank == 0:
        cs.OUT_DIR.mkdir(exist_ok=True)
        result["profile"] = cs.profile_request(step, f"one {family} DDP step on rank 0 of {world}",
                                               table=f"chip_dist_profile_{family}.txt")
    else:
        step()  # the profiled step's peer
    result.update(frames=frames, backend=torch.distributed.get_backend(), device=str(dev))
    (Path(out) / f"{family}_rank{rank}.json").write_text(json.dumps(result))
    dist.destroy()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def serving(n_cards: int, card: str) -> dict:
    """Both servers over all the cards against one card, on chip_smoke.py's
    [serve] and [variance] segments ``SERVE_REPEAT`` times over: seconds
    (the second of two calls), true frames/s, enqueue seconds a chunk, the
    card each chunk ran on, and the largest difference from one card's
    outputs (float32 wavs and curves as served)."""
    import numpy as np
    import torch

    from diffsinger_tpu_torch.cli import infer as cli
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.inference.serving import AcousticServer, VarianceServer

    devices = [torch.device("cuda", i) for i in range(n_cards)]
    root = Path(tempfile.mkdtemp(prefix="chip_dist_serve_"))
    hp = load_config(ROOT / "configs" / "acoustic.yaml", "sampling_steps=50")
    exp, _, _ = cs.write_experiment(root / "a", hp)
    shp = cli.migrate_legacy_hparams(load_config(exp_name=exp, infer=True,
                                                 ckpt_root=root / "a" / "checkpoints"))
    vexp, _, _ = cs.write_variance_experiment(root / "v")
    vhp = cli.migrate_legacy_hparams(load_config(exp_name=vexp, infer=True,
                                                 ckpt_root=root / "v" / "checkpoints"),
                                     infer_acoustic=False)
    out = {}
    segments = [seg for name in cs.SERVE_SCORES for seg in cs.load_score(name)] * SERVE_REPEAT
    vsegments = [seg for name in cs.VARIANCE_SCORES
                 for seg in cs.load_score(name)] * SERVE_REPEAT

    def arrays(result):  # a wav, or a (durations, pitch, {curve}) triple
        if isinstance(result, np.ndarray):
            return [result]
        return [x for x in (result[0], result[1], *result[2].values()) if x is not None]

    for name, cls, params, call, segs in (
            ("acoustic", AcousticServer, shp, "synthesize_batch", segments),
            ("variance", VarianceServer, vhp, "predict_batch", vsegments)):
        first = None
        for n in sorted({1, n_cards}):
            server = cs.loaded(name, cls, params, max_batch_size=cs.SERVE_BATCH,
                               devices=devices[:n])
            cs.quiet(getattr(server, call), segs, seed=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = cs.quiet(getattr(server, call), segs, seed=1)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            first = got if first is None else first
            diff = max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
                       for x, y in zip(got, first) for a, b in zip(arrays(x), arrays(y)))
            entry = {"seconds": seconds, "max_diff_from_one_card": diff}
            if name == "acoustic":
                frames = sum(cs.quiet(server.preprocess_input, s)["mel2ph"].shape[1]
                             for s in segs)
                entry.update(frames_per_s=frames / seconds,
                             enqueue_s_per_chunk=[st["dispatch_s"] for st in server.last_stats],
                             chunk_devices=server.last_chunk_devices)
            out[f"{name}_{n}_cards"] = entry
            cs.log(f"[chip_dist] {cls.__name__} over {n} card(s), {len(segs)} segments: "
                   f"{seconds:.3f} s" + (f", {entry['frames_per_s']:.1f} true frames/s, enqueue "
                                         f"a chunk {['%.3f' % x for x in entry['enqueue_s_per_chunk']]} s "
                                         f"on cards {entry['chunk_devices']}"
                                         if "frames_per_s" in entry else "")
                   + f"; max|diff| from one card's {diff:.3e} on {card}")
            del server
            torch.cuda.empty_cache()
    return out


def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default="train,serve",
                        help="comma-separated: train (the ranks), serve (the servers)")
    parts = set(parser.parse_args().parts.split(","))

    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    n_cards = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable"
    cs.log(card)
    cs.log(f"[chip_dist] {n_cards} card(s): {[torch.cuda.get_device_name(i) for i in range(n_cards)]}")
    from diffsinger_tpu_torch.ops import native
    from diffsinger_tpu_torch.parallel import dist

    native.build()
    report = {"card": card, "cards": n_cards}
    tmp = Path(tempfile.mkdtemp(prefix="chip_dist_"))
    for family in ("acoustic", "variance") if "train" in parts else ():
        task, batch, frames = family_task(family, tmp / f"{family}_one", torch.device("cuda", 0), 0)
        one = timed_steps(task, batch, 1, 0)
        one.pop("step")
        del task, batch
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dist.spawn(rank_main, n_cards, (n_cards, f"tcp://localhost:{free_port()}", family,
                                        str(tmp)), timeout=900)
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((tmp / f"{family}_rank{r}.json").read_text()) for r in range(n_cards)]
        sps = min(r["steps_per_s"] for r in ranks)
        prof = ranks[0].get("profile", {})
        nccl_ms = prof.get("groups_ms", {}).get("NCCL collectives")
        entry = {"one_card": one, "ranks": ranks, "spawn_s": spawn_s,
                 "scaling": n_cards * sps / one["steps_per_s"],
                 "frames_per_s_one": one["steps_per_s"] * frames,
                 "frames_per_s_all": sps * sum(r["frames"] for r in ranks)}
        report[family] = entry
        cs.log(f"[chip_dist] {family}: one card {one['steps_per_s']:.3f} steps/s; {n_cards} "
               f"{ranks[0]['backend']} ranks {sps:.3f} steps/s each (slowest), scaling "
               f"{entry['scaling']:.3f}x, true frames/s {entry['frames_per_s_one']:.0f} -> "
               f"{entry['frames_per_s_all']:.0f}; rank 0's step under the profiler: idle share "
               f"{prof.get('idle_share', float('nan')):.3f}, NCCL kernels "
               f"{nccl_ms if nccl_ms is not None else float('nan'):.2f} ms, of which "
               f"{prof.get('nccl_exposed_ms', float('nan')):.2f} ms under no other kernel, in "
               f"{prof.get('wall_ms', float('nan')):.1f} ms; peak memory "
               f"{ranks[0]['peak_mem_gib']:.2f} GiB a rank (one card {one['peak_mem_gib']:.2f}) "
               f"on {card}")
    if "serve" in parts:
        report["serving"] = serving(n_cards, card)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "chip_dist.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
