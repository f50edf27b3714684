"""The acoustic model's training through ``BaseTask.start``, the loop that
``cli.train acoustic`` runs on one card.

Set-up writes a binarized store under the run's scratch folder with the
port's own store writer (``data/indexed_datasets.py``), in
``AcousticBinarizer``'s layout (tokens, mel2ph, mel, f0, spk_id; an empty
validation split), builds ``AcousticTask`` from the configuration (its
``seed`` the run's), gives the model seeded weights, and calls ``start``.
Its first steps run in set-up: the first ``checked_steps`` with the dropout
masks recorded by forward hooks on the program's ``nn.Dropout`` modules,
then the rest of the first epoch (every bucket shape the store makes). The
window opens after the epoch's last update and closes at the first update
past ``--seconds``, by raising out of ``start`` (whose ``finally`` stops the
input pipeline's threads); validation and checkpoints fall outside it.
``train_frames_per_s`` is the true mel frames of the window's steps over
its seconds.

After the window, with the program freed, the plain reference follows the
checked steps from the same weights, batches, draws and masks, and the run
compares each step's loss, the first clipped gradient by leaf (the
program's from AdamW's first moment after one step) and each leaf's change
after the checked steps.
"""

from __future__ import annotations

import pickle
import statistics
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from benchmark import generator, serving, weights, work
from benchmark.harness import Check
from benchmark.reference import preprocess as pp
from benchmark.reference.train import TrainReference
from benchmark.trace import WINDOW

RANGES = ("encoder", "aux_decoder", "lynxnet", "trainer.next_batch", "trainer.step",
          "trainer.update")  # innermost first
WEIGHTS_KEY = 1 << 43
BATCH_KEYS = ("tokens", "mel2ph", "f0", "mel")


class WindowClosed(Exception):
    """Raised out of ``start`` when the window is full."""


def write_store(run) -> str:
    """The seeded store, as ``cli.binarize acoustic`` lays it out."""
    from diffsinger_tpu_torch.data.indexed_datasets import IndexedDatasetBuilder

    hp = run.config["hparams"]
    ts = serving.timestep(hp)
    ids = pp.phoneme_ids(generator.DICTIONARY)
    root = run.scratch / "binary"
    builder = IndexedDatasetBuilder(root, "train")
    meta = {k: [] for k in ("spk_ids", "lengths", "tokens", "mel2ph", "mel", "f0")}
    for item in generator.store_items(run.mix, run.seed, ts, hp["audio_num_mel_bins"]):
        a = pp.acoustic_arrays(item["seg"], ids, ts)
        if len(a["mel2ph"]) != len(item["mel"]):
            raise AssertionError("a store item's frames differ from its plan")
        builder.add_item({"spk_id": 0, "tokens": a["tokens"], "mel2ph": a["mel2ph"],
                          "mel": item["mel"], "f0": a["f0"].astype(np.float32)})
        for k in ("tokens", "mel2ph", "mel", "f0"):
            meta[k].append(len(a[k]) if k != "mel" else len(item["mel"]))
        meta["spk_ids"].append(0)
        meta["lengths"].append(len(item["mel"]))
    builder.finalize()
    with open(root / "train.meta", "wb") as f:
        pickle.dump(meta, f)
    IndexedDatasetBuilder(root, "valid").finalize()
    with open(root / "valid.meta", "wb") as f:
        pickle.dump({k: [] for k in meta}, f)
    return str(root)


def weight_values(run, module) -> Dict[str, torch.Tensor]:
    return weights.make(weights.shapes_of(module), serving.stream(run.seed, WEIGHTS_KEY),
                        run.device, torch.float32)


def build_task(run, store: str):
    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask

    hp = dict(run.config["hparams"], work_dir=str(run.scratch / "exp"), binary_data_dir=store,
              dictionary=str(generator.DICTIONARY), seed=run.seed % (1 << 31))
    task = AcousticTask(hp, device=run.device)
    weights.fill(task.module, weight_values(run, task.module))
    return task


class Loop:
    """The benchmark's wrappers of the task's loop methods: the checked
    steps' captures, the window, its counts and its host ranges."""

    def __init__(self, run, task):
        self.run, self.task = run, task
        self.checked = run.mix["checked_steps"]
        self.steps = self.updates = 0
        self.captured: List[Dict] = []
        self.masks = defaultdict(list)
        self.hooks = [m.register_forward_hook(self._record(name))
                      for name, m in task.module.named_modules()
                      if isinstance(m, torch.nn.Dropout) and m.p > 0]
        self.names = [n for n, p in task.module.named_parameters() if p.requires_grad]
        self.start = [p.detach().clone() for p in task.module.parameters() if p.requires_grad]
        self.window = None
        self.window_start = self.window_s = 0.0
        self.rows: List[torch.Tensor] = []
        self.wait_s = 0.0
        tr = run.tracer
        self.orig = {k: getattr(task, k) for k in ("next_batch", "train_step", "apply_update")}
        task.next_batch, task.train_step = self.next_batch, self.train_step
        task.apply_update = self.apply_update
        if run.trace:
            m = task.module
            serving.ranged(tr, m.fs2, "encoder")
            serving.ranged(tr, m.aux_decoder, "aux_decoder")
            serving.ranged(tr, m.denoiser, "lynxnet")

    def _record(self, name):
        def hook(module, args, out):
            # kept where the output is not 0, or where the input already was
            self.masks[name].append(((out != 0) | (args[0] == 0), module.p))
        return hook

    def next_batch(self, batches):
        t0 = time.perf_counter()
        with self.run.tracer.span("trainer.next_batch"):
            out = self.orig["next_batch"](batches)
        if self.window is not None:
            self.wait_s += time.perf_counter() - t0
        return out

    def train_step(self, batch, *, sync=True, **draws):
        with self.run.tracer.span("trainer.step"):
            out = self.orig["train_step"](batch, sync=sync, **draws)
        if self.steps < self.checked:
            self.captured.append(dict(
                {k: batch[k].detach().clone() for k in BATCH_KEYS},
                t=draws["t"].detach().clone(), noise=draws["noise"].detach().clone(),
                masks=dict(self.masks), loss=out["total_loss"].detach().float().clone()))
            self.masks = defaultdict(list)
            if self.steps == self.checked - 1:
                for h in self.hooks:
                    h.remove()
        if self.window is not None:
            self.rows.append(torch.stack([(batch["mel2ph"] > 0).sum(1),
                                          (batch["tokens"] > 0).sum(1)]))
        self.steps += 1
        return out

    def apply_update(self):
        task = self.task
        with self.run.tracer.span("trainer.update"):
            norm = self.orig["apply_update"]()
        self.updates += 1
        params = [p for p in task.module.parameters() if p.requires_grad]
        if self.updates == 1:  # AdamW's first moment after one step: (1 - beta1) g
            beta1 = task.optimizer.param_groups[0]["betas"][0]
            state = task.optimizer.state  # a leaf the optimizer never got has no moment
            moments = [state[p]["exp_avg"] if "exp_avg" in state.get(p, {}) else
                       torch.zeros_like(p) for p in params]
            self.grad1 = [v / (1 - beta1)
                          for v in torch.stack(torch._foreach_norm(moments)).tolist()]
        if self.updates == self.checked:
            self.change = torch.stack(torch._foreach_norm(
                torch._foreach_sub([p.detach() for p in params], self.start))).tolist()
            self.start = None
        if self.window is not None:
            if time.perf_counter() - self.window_start >= self.run.seconds:
                self._sync()
                self.window_s = time.perf_counter() - self.window_start
                self.window.__exit__(None, None, None)
                self.run.tracer.stop()
                raise WindowClosed()
        elif self.updates >= self.checked and task.epoch >= 1:  # the first epoch is done
            self._sync()
            self.run.tracer.start()
            self.window = self.run.tracer.span(WINDOW)
            self.window.__enter__()
            self.window_start = time.perf_counter()
        return norm

    def _sync(self):
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)


def program_numbers(loop: Loop) -> Dict:
    return {"loss": [float(c["loss"]) for c in loop.captured],
            "grad1": dict(zip(loop.names, loop.grad1)),
            "change": dict(zip(loop.names, loop.change))}


def reference(run, captured: List[Dict], lowp=None) -> Dict:
    """The checked steps by the plain reference (``lowp``: the control's precision)."""
    hp = run.config["hparams"]
    ids = pp.phoneme_ids(generator.DICTIONARY)
    ref = TrainReference(hp, max(ids.values()) + 1, lowp=lowp).to(run.device)
    weights.fill(ref, weight_values(run, ref))
    batches = [dict(c, masks={k: list(v) for k, v in c["masks"].items()}) for c in captured]
    out = ref.steps(batches)
    del ref
    return out


def moved(grad1: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is a thousandth of the median
    leaf's or more: the others move under Adam by round-off alone."""
    median = statistics.median(grad1.values())
    return [n for n, g in grad1.items() if g >= 1e-3 * median]


def gaps(got: Dict, want: Dict) -> Dict[str, float]:
    """The gaps of each step's loss (relative), of the first gradient's and
    of the change's norms by leaf, each against the larger of the leaf's
    reference norm and the median leaf's; the change over the leaves that
    the reference moves (:func:`moved`)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["loss"], want["loss"]))
    g_ref = want["grad1"]
    g_med = statistics.median(g_ref.values())
    grad = max(abs(got["grad1"][n] - g) / max(g, g_med, 1e-30) for n, g in g_ref.items())
    leaves = moved(g_ref)
    c_ref = want["change"]
    c_med = statistics.median(c_ref[n] for n in leaves)
    change = max(abs(got["change"][n] - c_ref[n]) / max(c_ref[n], c_med, 1e-30) for n in leaves)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def true_work(run, rows: List[torch.Tensor]):
    """True frames, and the forward's products at each row's true lengths."""
    if not rows:
        return 0, 0.0
    counts = torch.cat(rows, dim=1).cpu().numpy()  # [2, rows]: frames, tokens
    hp = run.config["hparams"]
    flops = sum(work.acoustic_train(1, int(n_tok), int(n_fr), hp)
                for n_fr, n_tok in counts.T if n_fr > 0)
    return int(counts[0].sum()), flops


def run(run) -> None:
    marks = run.layer.setdefault("setup_marks", {})
    marks["traffic"] = time.perf_counter()
    store = write_store(run)
    marks["server"] = time.perf_counter()
    task = build_task(run, store)
    marks["warm-up"] = time.perf_counter()
    loop = Loop(run, task)
    try:
        task.start(max_steps=1 << 30)
    except WindowClosed:
        pass
    if loop.window is None:
        raise RuntimeError("the run ended before its window opened")
    run.window_start = loop.window_start
    run.attempted = len(loop.rows)  # the window's steps
    frames, flops = true_work(run, loop.rows)
    run.e2e["train_frames_per_s"] = frames / loop.window_s
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    run.layer.update(window_s=loop.window_s, true_flops=3 * flops,
                     peak_flops=run.config["peak_flops_per_s"], wait_s=loop.wait_s,
                     steps=len(loop.rows), peak_mem_bytes=run.memory_peak_bytes)
    got = program_numbers(loop)
    captured = loop.captured
    del task, loop
    serving.free_program()
    if run.lowp is not None:  # the control: the reference one precision down, in the program's place
        got = reference(run, captured, lowp=run.lowp)
    want = reference(run, captured)
    measured = gaps(got, want)
    run.layer["leaves_left_out"] = len(want["grad1"]) - len(moved(want["grad1"]))
    limits = run.config["limits"]
    run.checks = [Check(name, value, limits[name]) for name, value in measured.items()
                  if name in limits]

