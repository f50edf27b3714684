"""The port's ONNX lowering (``diffsinger_tpu_torch/deployment/onnx/lowering.py``):
a ``torch.export`` program -> ONNX bytes -> the port's numpy interpreter,
against the eager PyTorch function (op cases, the counterparts of
``tests/test_onnx.py``'s), against the JAX acoustic model's
``forward_infer_dynamic`` on one experiment folder, and against the JAX
vocoder. Every emitted model passes the JAX package's own structural checker
restricted to its audited op set.

Tolerances: op cases 1e-5 (convolutions 1e-4: sums in another order); the
acoustic graph the JAX ONNX test's atol 2e-4 / rtol 1e-4; the vocoder 1e-5,
``test_vocoder_onnx_parity``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from diffsinger_tpu.deployment.onnx.checker import check_model as jax_check_model
from diffsinger_tpu.deployment.onnx.lowering import EMITTED_OPS as JAX_EMITTED_OPS
from diffsinger_tpu_torch.deployment.onnx import EMITTED_OPS, LoweringError, lower_program, run_model
from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.deployment.exporters import DiffSingerAcousticExporter
from diffsinger_tpu_torch.deployment.onnx import protowire as pw
from diffsinger_tpu_torch.deployment.onnx.builder import _parse_value_info, parse_model
from diffsinger_tpu_torch.utils import while_loop
from tests.torch_parity import REPO, make_exp


class Fn(torch.nn.Module):
    def __init__(self, fn, **modules):
        super().__init__()
        self.fn = fn
        for name, m in modules.items():
            setattr(self, name, m)

    def forward(self, *args):
        return self.fn(self, *args)


def lower(module, args, names):
    with torch.no_grad():
        ep = torch.export.export(module, tuple(args))
    n_out = len(ep.graph_signature.user_outputs)
    data = lower_program(ep, name="m", input_names=names,
                         output_names=[f"y{i}" for i in range(n_out)]).model_bytes()
    jax_check_model(data, known_ops=JAX_EMITTED_OPS)
    return data


def check(module, args, names, tol=1e-5):
    data = lower(module, args, names)
    got = run_model(data, {n: a.numpy() for n, a in zip(names, args)})
    with torch.no_grad():
        want = module(*args)
    want = want if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype and g.shape == tuple(w.shape)
        np.testing.assert_allclose(g, w.numpy(), atol=tol, rtol=tol)
    return parse_model(data)


def rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_emitted_ops_are_in_the_jax_packages_audited_set():
    assert EMITTED_OPS <= JAX_EMITTED_OPS


def test_elementwise_and_broadcast():
    def f(m, x, y, n):
        a = torch.tanh(x) * y + torch.sqrt(torch.abs(x)) - torch.sigmoid(y)
        b = F.gelu(x) + F.leaky_relu(x, 0.1) + torch.clamp(x, min=-0.5) ** 2
        c = torch.remainder(x * 3, 1.0) + torch.floor(x) / 2 - torch.round(y * 4)
        d = torch.where(x > y, x, -y).exp() + torch.rsqrt(torch.abs(y) + 1) * torch.sin(x)
        q = n // 3 + n % 4 - torch.clamp(n, max=5)  # int32: floor division, remainder
        return a, b + c, d, q, (x >= 0) & (y < 0.5) | ~(x == y)

    n = torch.tensor([[-7, -1, 0, 5], [9, 3, -12, 4], [1, 2, 3, -4]], dtype=torch.int32)
    check(Fn(f), (rand(3, 4), rand(4, seed=1), n), ["x", "y", "n"])


def test_attention_softmax():
    def f(m, q, k, pad):
        s = q @ k.transpose(-1, -2) / 8 ** 0.5
        s = s.masked_fill(pad[:, None, None, :], float("-inf"))
        return torch.softmax(s, dim=-1)

    pad = torch.zeros(2, 8, dtype=torch.bool)
    pad[1, 5:] = True
    g = check(Fn(f), (rand(2, 4, 8, 8), rand(2, 4, 8, 8, seed=1), pad), ["q", "k", "pad"])
    assert {"MatMul", "Exp", "ReduceMax", "ReduceSum"} <= {n.op_type for n in g.nodes}


def test_shape_ops_and_reductions():
    def f(m, x):
        a = torch.flip(x[:, 1:5], dims=[1])
        b = F.pad(x, (2, 1))
        c = torch.cumsum(x, dim=1)
        cat = torch.cat([a, b[:, :4], c[:, :4]], dim=1).t().reshape(-1)
        ln = m.ln(x.reshape(2, 2, 4))
        return (cat, torch.where(x > 0, x, 0.1 * x).sum(dim=1), torch.argmax(x, -1),
                x.mean(dim=-1, keepdim=True), x.amax(dim=0), ln, x[:, ::2].unsqueeze(0))

    ln = torch.nn.LayerNorm(4)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.2 * rand(4, seed=3))
        ln.bias.copy_(0.1 * rand(4, seed=4))
    check(Fn(f, ln=ln), (rand(2, 8),), ["x"])


def test_gather_and_scatter():
    def f(m, idx, mel2ph):
        e = m.emb(idx)
        ramp = torch.arange(6, dtype=torch.float32)
        dur = torch.zeros(2, 6, dtype=torch.int64).scatter_add(
            1, mel2ph.long(), torch.ones_like(mel2ph, dtype=torch.int64))
        frames = torch.gather(F.pad(e, (0, 0, 1, 0)), 1,
                              mel2ph.long()[:, :, None].expand(-1, -1, 6))
        table = torch.linspace(0, 1, 10)
        return e * ramp, dur, frames, table[idx[:, 0]]

    emb = torch.nn.Embedding(10, 6)
    idx = torch.tensor([[1, 2, 3, 4, 5], [3, 4, 9, 0, 0]], dtype=torch.int32)
    mel2ph = torch.tensor([[1, 1, 2, 3, 3, 3, 4, 5], [1, 2, 2, 3, 0, 0, 0, 0]], dtype=torch.int32)
    g = check(Fn(f, emb=emb), (idx, mel2ph), ["idx", "mel2ph"])
    assert {"Gather", "GatherElements", "ScatterND"} <= {n.op_type for n in g.nodes}


def test_while_loop_lowers_to_loop():
    """The port's ``utils.while_loop`` under export: a trip count from an
    input, a counter on the host and a captured weight; one graph for every n."""
    def f(m, x, n):
        def cond(i, x):
            return i < n

        def body(i, x):
            return i + 1, 0.9 * x + torch.tanh(x @ m.w) * i.float()

        return while_loop(cond, body, (torch.zeros((), dtype=torch.int64), x))[1]

    module = Fn(f)
    module.w = torch.nn.Parameter(0.3 * rand(3, 3, seed=2), requires_grad=False)
    x = rand(2, 3)
    data = lower(module, (x, torch.tensor(2, dtype=torch.int32)), ["x", "n"])
    assert "Loop" in {nd.op_type for nd in parse_model(data).nodes}
    for n in (0, 1, 4):
        (got,) = run_model(data, {"x": x.numpy(), "n": np.int32(n)})
        with torch.no_grad():
            want = module(x, torch.tensor(n, dtype=torch.int32))
        np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=1e-5)


def test_convs():
    torch.manual_seed(0)
    conv = torch.nn.Conv1d(4, 6, 3, padding=1)
    check(Fn(lambda m, x: m.c(x), c=conv), (rand(2, 4, 16),), ["x"], tol=1e-4)
    dw = torch.nn.Conv1d(8, 8, 5, padding=4, dilation=2, groups=8)
    check(Fn(lambda m, x: m.c(x), c=dw), (rand(1, 8, 32),), ["x"], tol=1e-4)
    ct = torch.nn.ConvTranspose1d(6, 4, 8, stride=4, padding=2)
    g = check(Fn(lambda m, x: m.c(x), c=ct), (rand(1, 6, 10),), ["x"], tol=1e-4)
    assert "ConvTranspose" in {n.op_type for n in g.nodes}


def test_the_variance_views_ops():
    """What the variance model's deployed views add: ``length_regulator``'s
    ``searchsorted`` (left and right), ``sinusoidal_smooth``'s replicate
    padding, the duration predictor's ReLU, ``log1p``, bool masks in
    arithmetic and a WaveNet's dilated convolution."""
    from diffsinger_tpu_torch.dsp.common import sinusoidal_smooth
    from diffsinger_tpu_torch.utils.seq import length_regulator

    def f(m, dur, x, keep, curve):
        left = torch.searchsorted(torch.cumsum(dur, 1).contiguous(),
                                  torch.full((2, 3), 7, dtype=torch.int64), right=False)
        return (length_regulator(dur, 30), left, sinusoidal_smooth(curve, 5),
                F.relu(x) + torch.log1p(x.abs()), x * ~keep, m.c(x[:, None].expand(-1, 4, -1)))

    torch.manual_seed(0)
    conv = torch.nn.Conv1d(4, 8, 3, padding=4, dilation=4)
    dur = torch.tensor([[3, 0, 5, 2, 4], [1, 1, 6, 0, 0]])
    keep = torch.from_numpy(np.random.default_rng(2).random((2, 12)) < 0.5)
    curve = torch.from_numpy(np.cumsum(np.random.default_rng(3).standard_normal((2, 30)), 1)
                             .astype(np.float32))
    g = check(Fn(f, c=conv), (dur, rand(2, 12), keep, curve), ["dur", "x", "keep", "curve"],
              tol=1e-4)
    assert "ReduceSum" in {n.op_type for n in g.nodes}


def test_an_op_without_lowering_names_the_aten_op():
    with torch.no_grad():
        ep = torch.export.export(Fn(lambda m, x: torch.fft.rfft(x).abs()), (rand(8),))
    with pytest.raises(LoweringError, match="aten"):
        lower_program(ep, name="m", input_names=["x"], output_names=["y"])


@pytest.mark.parametrize("stem", ["acoustic_sampler", "variance_pitch", "vocoder"])
def test_the_interpreter_copy_runs_the_committed_external_fixtures(stem):
    """The port's copies of the checker and the interpreter on the JAX
    package's committed ONNX fixtures and their expected I/O."""
    from diffsinger_tpu_torch.deployment.onnx.checker import check_model

    folder = REPO / "tests" / "fixtures" / "onnx_external"
    data = (folder / f"{stem}.onnx").read_bytes()
    check_model(data, known_ops=JAX_EMITTED_OPS)
    with np.load(folder / f"{stem}_io.npz") as npz:
        n = int(npz["meta/n_cases"])
        atol, rtol = float(npz["meta/atol"]), float(npz["meta/rtol"])
        cases = [({key.split("/", 2)[2]: npz[key] for key in npz.files
                   if key.startswith(f"case{k}/in/")},
                  [npz[f"case{k}/out/{i}"] for i in range(sum(
                      1 for key in npz.files if key.startswith(f"case{k}/out/")))])
                 for k in range(n)]
    for ins, want in cases:
        got = run_model(data, ins)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


# the JAX vocoder test's tiny mini-NSF config (tests/test_vocoder.py)
TINY_VOCODER = dict(num_mels=8, sampling_rate=44100, upsample_rates=[4, 4, 2, 2],
                    upsample_kernel_sizes=[8, 8, 4, 4], upsample_initial_channel=32,
                    resblock="1", resblock_kernel_sizes=[3, 5],
                    resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5]], mini_nsf=True,
                    noise_sigma=0.0)


def test_vocoder_onnx_matches_the_jax_generator():
    """The mini-NSF generator exported through ``VocoderProgram`` and lowered,
    against the JAX ``Generator`` on the same weights (1e-5)."""
    import types

    from diffsinger_tpu.utils.torch_convert import convert_nsf_hifigan
    from diffsinger_tpu.vocoders.nsf_hifigan_model import Generator as JaxGenerator
    from diffsinger_tpu_torch.deployment.exporters import VocoderProgram
    from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import Generator, NsfHifiGanConfig

    cfg = types.SimpleNamespace(**TINY_VOCODER,
                                hop_size=int(np.prod(TINY_VOCODER["upsample_rates"])))
    # seeded port weights, every one moved off its init, through the JAX
    # package's own converter (a JAX init takes 8-20 s on the CPU)
    torch.manual_seed(0)
    port = Generator(NsfHifiGanConfig.from_json(TINY_VOCODER), device="cpu").eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in port.parameters():
            t.add_((0.3 if t.ndim == 1 else 0.5 * float(t.std())) * torch.randn(t.shape, generator=g))
    port.requires_grad_(False)
    params = convert_nsf_hifigan(port.state_dict(), cfg)
    mel = np.random.default_rng(0).standard_normal((1, 16, 8)).astype(np.float32)
    f0 = np.full((1, 16), 220.0, np.float32)
    f0[0, 8:] = 330.0
    want = np.asarray(JaxGenerator(cfg, fold_lanes=0).apply(params, jnp.asarray(mel),
                                                            jnp.asarray(f0)))
    data = lower(VocoderProgram(port, []), (torch.from_numpy(mel), torch.from_numpy(f0)),
                 ["mel", "f0"])
    (got,) = run_model(data, {"mel": mel, "f0": f0})
    assert "ConvTranspose" in {n.op_type for n in parse_model(data).nodes}
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# one experiment folder per exposure case, exported by both packages

ONE_LAYER = dict(backbone_args=dict(num_channels=32, num_layers=1, kernel_size=31,
                                    dropout_rate=0.0, strong_cond=True))

CASES = {
    # gender, velocity and both speakers exposed; no shallow diffusion
    "exposed": (dict(ONE_LAYER, use_shallow_diffusion=False, use_spk_id=True, num_spk=2,
                     use_key_shift_embed=True, use_speed_embed=True, use_energy_embed=True),
                {}),
    # shallow; gender, velocity and one speaker frozen in
    "frozen": (dict(ONE_LAYER, use_spk_id=True, num_spk=2, use_key_shift_embed=True,
                    use_speed_embed=True),
               dict(freeze_gender=0.5, freeze_velocity=True, freeze_spk="spk1")),
}


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """{case: (port exporter, JAX hparams, JAX onnx dir, port onnx dir)}."""
    from diffsinger_tpu.config import load_config as jax_load_config
    from diffsinger_tpu.deployment.exporters import DiffSingerAcousticExporter as JaxExporter

    out = {}
    for case, (over, kwargs) in CASES.items():
        root = tmp_path_factory.mktemp(case)
        ckpt_root = make_exp(root, case, over)
        jhp = jax_load_config(exp_name=case, infer=True, ckpt_root=ckpt_root)
        php = load_config(exp_name=case, infer=True, ckpt_root=ckpt_root)
        JaxExporter(jhp, root / "jax", buckets=[(16, 64)], fmt="onnx", **kwargs).export()
        exporter = DiffSingerAcousticExporter(php, root / "port", buckets=[(16, 64)],
                                              fmt="onnx", device="cpu", **kwargs)
        exporter.export()
        out[case] = (exporter, jhp, root / "jax", root / "port")
    return out


def signature(data: bytes):
    graph = pw.decode_message(pw.decode_message(data)[7][0])
    ios = [[_parse_value_info(v) for v in graph.get(field, [])] for field in (11, 12)]
    return [[(n, np.dtype(d).name, tuple(s)) for n, d, s in io] for io in ios]


@pytest.mark.parametrize("case", list(CASES))
def test_onnx_signatures_and_dsconfig_equal_the_jax_exporters(bundles, case):
    _, _, jax_dir, port_dir = bundles[case]
    jcfg = yaml.safe_load((jax_dir / "dsconfig.yaml").read_text())
    pcfg = yaml.safe_load((port_dir / "dsconfig.yaml").read_text())
    assert pcfg.pop("device") == "cpu"
    assert pcfg == jcfg  # file names included: both write <exp>.acoustic.onnx
    for view in ("fs2_aux_onnx", "acoustic_onnx"):
        name = jcfg["buckets"]["16x64"][view]
        data = (port_dir / name).read_bytes()
        jax_check_model(data, known_ops=JAX_EMITTED_OPS)
        assert signature(data) == signature((jax_dir / name).read_bytes()), view
    inputs = parse_model((port_dir / jcfg["acoustic"]).read_bytes()).inputs
    if case == "exposed":
        assert inputs == ["tokens", "mel2ph", "f0", "steps", "spk_embed", "energy", "gender",
                          "velocity"]
        for spk in ("spk0", "spk1"):  # the speakers' .emb attachments
            emb = f"{case}.{spk}.emb"
            np.testing.assert_allclose(np.fromfile(port_dir / emb, np.float32),
                                       np.fromfile(jax_dir / emb, np.float32), atol=1e-6)
    else:
        assert inputs == ["tokens", "mel2ph", "f0", "depth", "steps"]
        assert not list(port_dir.glob("*.emb"))
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in jax_dir.iterdir())


def test_acoustic_onnx_matches_jax_over_steps_and_depths(bundles):
    """The bundle's acoustic graph of the shallow, frozen case (gender 0.5 ->
    key shift 2.5, speed 1, speaker 1 frozen in) through the interpreter,
    against JAX ``forward_infer_dynamic`` with those values and the same
    noise: the interpreter draws the graph's RandomNormalLike from
    ``default_rng(rng_seed)``, so the test makes the same draw."""
    from diffsinger_tpu.models.toplevel import DiffSingerAcoustic as JaxAcoustic
    from diffsinger_tpu.utils.torch_model_convert import convert_acoustic

    exporter, jhp, _, port_dir = bundles["frozen"]
    state = exporter.model.module.state_dict()
    jmodel = JaxAcoustic(jhp, vocab_size=len(exporter.infer.phoneme_dictionary), out_dims=16)
    params = convert_acoustic(state, jhp)
    frozen = dict(key_shift=jnp.full((1, 1), 2.5), speed=jnp.ones((1, 1)),
                  spk_mix_embed=jnp.asarray(state["fs2.spk_embed.weight"][1].numpy())[None, None])
    data = (port_dir / exporter.bucket_files["16x64"]["acoustic_onnx"]).read_bytes()
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :4] = np.arange(1, 5)
    mel2ph = np.zeros((1, 64), np.int32)
    mel2ph[0, :40] = np.repeat(np.arange(1, 5), 10)
    f0 = np.full((1, 64), 220.0, np.float32)
    outs = []
    for i, (depth, steps) in enumerate(((0.6, 2), (0.6, 5), (0.6, 10), (0.2, 5))):
        (got,) = run_model(data, {"tokens": tokens, "mel2ph": mel2ph, "f0": f0,
                                  "depth": np.float32(depth), "steps": np.int32(steps)},
                           rng_seed=i)
        noise = np.random.default_rng(i).standard_normal((1, 64, 16)).astype(np.float32)
        want = jmodel.forward_infer_dynamic(
            params, None, jnp.asarray(tokens), jnp.asarray(mel2ph), jnp.asarray(f0),
            depth=jnp.float32(depth), steps=jnp.int32(steps), noise=jnp.asarray(noise),
            **frozen).diff_out
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=1e-4)
        outs.append(got)
    # steps and depth reach the graph: the same noise draw gives other mels
    noise_fixed = [run_model(data, {"tokens": tokens, "mel2ph": mel2ph, "f0": f0,
                                    "depth": np.float32(d), "steps": np.int32(s)},
                             rng_seed=0)[0] for d, s in ((0.6, 2), (0.6, 10), (0.2, 2))]
    assert not np.allclose(noise_fixed[0], noise_fixed[1])
    assert not np.allclose(noise_fixed[0], noise_fixed[2])
