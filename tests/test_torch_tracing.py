"""The port's spans and counters (``utils/tracing.py``) on the CPU, at narrow widths.

Off, a span is one shared no-op and nothing is recorded. On, under
``torch.profiler``: a served request shows the server's, the model's, the
sampler's and the vocoder's spans nested as ``NAMES`` orders them, with the
answers unchanged; a training run shows the trainer's spans, LYNXNet's
backward and the input threads' CPU counters; ``profile_steps`` turns the
spans on for its window; an exported program is the same with tracing on or off.
"""

import json
import pathlib
import pickle
import warnings
from unittest import mock

import numpy as np
import pytest
import torch

from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.core import reflow
from diffsinger_tpu_torch.utils import prefetch, tracing
from diffsinger_tpu_torch.utils.prefetch import PrefetchIterator

REPO = pathlib.Path(__file__).resolve().parents[1]
DICT = REPO / "dictionaries" / "opencpop-extension.txt"
MELS = 16
NARROW = dict(hidden_size=32, enc_layers=2, sampling_steps=2, audio_num_mel_bins=MELS,
              backbone_args=dict(num_channels=32, num_layers=2, kernel_size=31, dropout_rate=0.0,
                                 strong_cond=True),
              shallow_diffusion_args=dict(
                  train_aux_decoder=True, train_diffusion=True, val_gt_start=False,
                  aux_decoder_arch="convnext", aux_decoder_grad=0.1,
                  aux_decoder_args=dict(num_channels=16, num_layers=1, kernel_size=7,
                                        dropout_rate=0.1)),
              dictionary=str(DICT))
VOCODER = dict(num_mels=MELS, sampling_rate=44100, upsample_rates=[8, 8, 2, 2, 2],
               upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=32,
               resblock="1", resblock_kernel_sizes=[3, 7, 11],
               resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
               mini_nsf=False, noise_sigma=0.0)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no counters."""
    tracing.enable(False)
    tracing.counters().clear()
    yield
    tracing.enable(False)
    tracing.counters().clear()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def acoustic_hp(**over) -> dict:
    hp = load_config(str(REPO / "configs" / "acoustic.yaml"))
    hp.update(NARROW)
    hp.update(over)
    return hp


def spans(prof) -> dict:
    """The ``ds.*`` events of a profile: {name: [(start, end), ...]}."""
    out = {}
    for e in prof.events():
        if e.name.startswith("ds."):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def inside(inner, outer) -> bool:
    """Every interval of ``inner`` lies within one of ``outer``."""
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer) for s, e in inner)


def test_off_a_span_is_one_shared_noop_and_nothing_is_recorded():
    assert not tracing.enabled()
    assert tracing.span("ds.sampler.step") is tracing.span("ds.vocoder")
    tracing.add("pipeline.x.cpu_s", 1.0)
    with torch.profiler.profile() as prof, mock.patch.object(
            prefetch.time, "thread_time", side_effect=AssertionError("a clock read while off")):
        reflow.sample_ode(lambda x, t: -x, torch.ones(2, 4, 3), t_start=0.0, steps=3)
        assert list(PrefetchIterator(range(5), 2, name="ds-collate")) == list(range(5))
    assert not spans(prof)
    assert tracing.counters() == {}


def test_names_are_the_programs_own():
    """Every name starts with ``ds.``, appears once and is none of the
    benchmark's host ranges."""
    assert all(n.startswith("ds.") for n in tracing.NAMES)
    assert len(set(tracing.NAMES)) == len(tracing.NAMES)
    bench = {"encoder", "vocoder", "lynxnet", "lynxnet.convmodule", "aux_decoder", "wavenet",
             "server.preprocess", "server.enqueue", "server.fetch", "server.request",
             "trainer.next_batch", "trainer.step", "trainer.update", "bench.window"}
    assert not bench & set(tracing.NAMES)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from diffsinger_tpu_torch.inference.serving import AcousticServer

    exp = tmp_path_factory.mktemp("tracing_exp")
    (exp / "vocoder").mkdir()
    (exp / "vocoder" / "config.json").write_text(json.dumps(VOCODER))
    hp = acoustic_hp(work_dir=str(exp), vocoder_ckpt=str(exp / "vocoder" / "model.ckpt"))
    torch.manual_seed(0)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*RANDOM weights.*")
        return AcousticServer(hp, max_batch_size=1, device="cpu")


def test_a_served_request_nests_its_spans_and_keeps_its_answers(server):
    """Two segments in two chunks at 2 steps: 2 ``ds.sampler.step`` a chunk,
    each inside ``ds.model.sample``; the model's spans and the vocoder's
    inside ``ds.server.enqueue``; the waveforms the same as untraced."""
    with open(REPO / "samples" / "00_xiao_xing_xing.ds", encoding="utf-8") as f:
        segments = json.load(f)
    want = server.synthesize_batch(segments, seed=3)
    tracing.enable(True)
    with torch.profiler.profile() as prof:
        got = server.synthesize_batch(segments, seed=3)
    tracing.enable(False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    s = spans(prof)
    assert set(s) == {"ds.server.preprocess", "ds.server.stack", "ds.server.enqueue",
                      "ds.server.fetch", "ds.model.condition", "ds.model.sample",
                      "ds.sampler.step", "ds.vocoder"}
    assert set(s) <= set(tracing.NAMES)
    chunks = len(server.last_stats)
    assert chunks == 2 and len(s["ds.server.preprocess"]) == 1
    for name in ("ds.server.stack", "ds.server.enqueue", "ds.server.fetch", "ds.model.condition",
                 "ds.model.sample", "ds.vocoder"):
        assert len(s[name]) == chunks, name
    assert len(s["ds.sampler.step"]) == 2 * chunks
    assert inside(s["ds.sampler.step"], s["ds.model.sample"])
    for name in ("ds.model.condition", "ds.model.sample", "ds.vocoder"):
        assert inside(s[name], s["ds.server.enqueue"]), name
    order = tracing.NAMES.index
    assert order("ds.sampler.step") < order("ds.model.sample") < order("ds.server.enqueue")


def write_store(root, n=6, seed=0):
    """A tiny acoustic store in ``AcousticBinarizer``'s layout, by the port's writer."""
    from diffsinger_tpu_torch.data.indexed_datasets import IndexedDatasetBuilder

    rng = np.random.default_rng(seed)
    for prefix, count in (("train", n), ("valid", 0)):
        builder = IndexedDatasetBuilder(root, prefix)
        meta = {k: [] for k in ("spk_ids", "lengths", "tokens", "mel2ph", "mel", "f0")}
        for _ in range(count):
            n_tok, t = int(rng.integers(4, 10)), int(rng.integers(40, 90))
            dur = rng.multinomial(t - n_tok, np.ones(n_tok) / n_tok) + 1
            item = dict(spk_id=0, tokens=rng.integers(1, 40, n_tok),
                        mel2ph=np.repeat(np.arange(1, n_tok + 1), dur),
                        mel=rng.uniform(-10, -1, (t, MELS)).astype(np.float32),
                        f0=rng.uniform(150, 400, t).astype(np.float32))
            builder.add_item(item)
            for k in ("tokens", "mel2ph", "mel", "f0"):
                meta[k].append(len(item[k]))
            meta["spk_ids"].append(0)
            meta["lengths"].append(t)
        builder.finalize()
        with open(root / f"{prefix}.meta", "wb") as f:
            pickle.dump(meta, f)


def make_task(tmp_path, **over):
    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask

    write_store(tmp_path / "binary")
    hp = acoustic_hp(work_dir=str(tmp_path / "exp"), binary_data_dir=str(tmp_path / "binary"),
                     max_batch_frames=200, val_check_interval=1000, log_interval=1000,
                     num_sanity_val_steps=0, permanent_ckpt_interval=-1, num_valid_plots=0,
                     val_with_vocoder=False, seed=5, train_prefetch_depth=1, **over)
    return AcousticTask(hp, device="cpu")


def test_a_training_run_shows_the_trainers_spans_and_the_input_threads_counters(tmp_path):
    task = make_task(tmp_path)
    tracing.enable(True)
    with torch.profiler.profile() as prof:
        task.start(max_steps=2)
    tracing.enable(False)
    s = spans(prof)
    for name in ("ds.train.forward", "ds.train.backward", "ds.train.clip",
                 "ds.train.optimizer"):
        assert len(s.get(name, [])) == 2, name
    lynx = s.get("ds.lynx.bwd", [])
    assert len(lynx) == 2 * 2  # two conv modules a step
    assert inside(lynx, s["ds.train.backward"])  # the CPU's backward runs on the caller's thread
    assert set(s) <= set(tracing.NAMES)
    c = tracing.counters()
    assert c["pipeline.ds-collate.cpu_s"] > 0 and c["pipeline.ds-upload.cpu_s"] > 0


def test_profile_steps_turn_the_spans_on_for_their_window(tmp_path):
    task = make_task(tmp_path, profile_steps=1)
    task.start(max_steps=4)
    trace = (tmp_path / "exp" / "profile" / "trace.json").read_text()
    assert '"ds.train.forward"' in trace and '"ds.lynx.bwd"' in trace
    assert not tracing.enabled()


def test_an_exported_program_is_the_same_with_tracing_on():
    """The acoustic view (encoder, aux draft, the euler loop) exported with
    tracing off and on: the same graph, no profiler op in it, the same mel."""
    from diffsinger_tpu_torch.deployment.exporters import AcousticProgram
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic

    torch.manual_seed(0)
    model = DiffSingerAcoustic(acoustic_hp(), vocab_size=40, out_dims=MELS, device="cpu")
    model.module.eval()
    view = AcousticProgram(model, "acoustic", [], {}, None, None)
    t_txt, t_mel = 16, 64
    tokens = torch.randint(1, 40, (1, t_txt), dtype=torch.int32)
    mel2ph = torch.clamp(torch.arange(t_mel, dtype=torch.int32)[None] // 4 + 1, max=t_txt)
    args = (tokens, mel2ph, torch.full((1, t_mel), 220.0), torch.tensor(0.6),
            torch.tensor(2, dtype=torch.int32), torch.randn(1, t_mel, MELS))
    programs = []
    for on in (False, True):
        tracing.enable(on)
        with torch.no_grad():
            programs.append(torch.export.export(view, args))
    off, on = programs
    assert on.graph_module.code == off.graph_module.code
    assert "profiler" not in on.graph_module.code
    with torch.no_grad():
        np.testing.assert_array_equal(on.module()(*args).numpy(), off.module()(*args).numpy())
