"""Export of the acoustic model and the vocoder (``diffsinger_tpu_torch/deployment/``)
against the JAX package's, on the CPU in float32.

* ``DiffSingerAcoustic.forward_infer_dynamic`` against JAX's on the same
  weights and noise, for rectified flow and DDPM, shallow and not, over
  steps and depths (depth <= 0 passes the aux draft through): max |diff| <= 1e-4;
* the ``.pt2`` programs saved, loaded and run through the artifact runtimes
  against the eager model and generator: <= 1e-6 (the ONNX graphs are
  ``tests/test_torch_onnx.py``'s);
* the runtimes' bucket choice and refusals, and ``cli.export`` (acoustic,
  vocoder and variance bundles) in a process that cannot import JAX.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.deployment.exporters import (
    DiffSingerAcousticExporter, NSFHiFiGANExporter)
from diffsinger_tpu_torch.deployment.runtime import AcousticArtifactRuntime, VocoderArtifactRuntime
from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import VocoderNoise
from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
from tests.torch_parity import (HP, MELS, REPO, VOCAB, acoustic_inputs, jax_kwargs, make_exp,
                                port_kwargs)

ONE_LAYER = dict(backbone_args=dict(num_channels=32, num_layers=1, kernel_size=31,
                                    dropout_rate=0.0, strong_cond=True))

MODELS = {
    "reflow-shallow": ({}, (0.0, 0.25, 0.6)),
    "reflow": (dict(use_shallow_diffusion=False), (1.0,)),
    "ddpm-shallow": (dict(diffusion_type="ddpm", K_step=400, K_step_infer=400,
                          diff_speedup=10), (-0.1, 0.1, 0.4)),
    "ddpm": (dict(diffusion_type="ddpm", use_shallow_diffusion=False, diff_speedup=10), (1.0,)),
}


def seeded_pair(hp: dict, seed: int):
    """(JAX model, its params, port model): seeded port weights, every one
    moved off its init as ``make_exp`` moves them, given to the JAX model
    through the JAX package's own converter (a JAX init takes 15 s here)."""
    from diffsinger_tpu.models.toplevel import DiffSingerAcoustic as JaxAcoustic
    from diffsinger_tpu.utils.torch_model_convert import convert_acoustic

    torch.manual_seed(seed)
    port = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=MELS, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    state = {}
    for k, v in port.module.state_dict().items():
        if k.endswith("net.5.weight"):  # PReLU slopes stay in (0, 1)
            state[k] = 0.1 + 0.4 * torch.rand(v.shape, generator=g)
        else:
            scale = 0.3 if v.ndim == 1 else 0.02 + 0.5 * float(v.std())
            state[k] = v + scale * torch.randn(v.shape, generator=g)
    port.module.load_state_dict(state)
    return JaxAcoustic(hp, vocab_size=VOCAB, out_dims=MELS), convert_acoustic(state, hp), port


@pytest.mark.parametrize("model", list(MODELS))
def test_forward_infer_dynamic_matches_jax(model):
    over, depths = MODELS[model]
    jmodel, params, port = seeded_pair(dict(HP, **over), seed=5)
    inp = acoustic_inputs(seed=6, t_mel=40)
    noise = np.random.default_rng(7).standard_normal((2, 40, 16)).astype(np.float32)
    outs = []
    for depth in depths:
        for steps in (2, 5):
            # run op by op, as the other parity tests run the JAX model: under
            # jit XLA's fusions move its own output by up to 7e-5 here
            want = jmodel.forward_infer_dynamic(
                params, None, jnp.asarray(inp["tokens"]), jnp.asarray(inp["mel2ph"]),
                jnp.asarray(inp["f0"]), depth=jnp.float32(depth), steps=jnp.int32(steps),
                noise=jnp.asarray(noise), **jax_kwargs(inp))
            got = port.forward_infer_dynamic(
                torch.from_numpy(inp["tokens"]), torch.from_numpy(inp["mel2ph"]),
                torch.from_numpy(inp["f0"]), depth=torch.tensor(depth, dtype=torch.float32),
                steps=torch.tensor(steps), noise=torch.from_numpy(noise), **port_kwargs(inp))
            assert np.abs(got.diff_out.numpy() - np.asarray(want.diff_out)).max() <= 1e-4
            if "shallow" in model:
                assert np.abs(got.aux_out.numpy() - np.asarray(want.aux_out)).max() <= 1e-4
            outs.append(got.diff_out.numpy())
    assert not np.allclose(outs[-2], outs[-1])  # the step count moves the sample
    if "shallow" in model:
        assert np.array_equal(outs[0], outs[1])  # depth <= 0: the draft, no step
        assert not np.allclose(outs[0], outs[-1])


# ---------------------------------------------------------------------------
# .pt2 programs and the runtimes

@pytest.fixture(scope="module")
def pt2_bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("pt2")
    ckpt_root = make_exp(root, "tiny", dict(ONE_LAYER, use_energy_embed=True,
                                            use_key_shift_embed=True))
    hp = load_config(exp_name="tiny", infer=True, ckpt_root=ckpt_root)
    exporter = DiffSingerAcousticExporter(hp, root / "acoustic", buckets=[(16, 64)],
                                          device="cpu")
    exporter.export()
    hp_voc = dict(hp, vocoder_ckpt=str(root / "vocoder" / "model.ckpt"))
    NSFHiFiGANExporter(hp_voc, root / "vocoder_bundle", buckets=[64], device="cpu").export()
    return root, exporter.model


def test_pt2_acoustic_program_equals_the_eager_model(pt2_bundle):
    """Saved, loaded and run through the runtime, against
    ``forward_infer_dynamic`` on the padded inputs and the same noise."""
    root, model = pt2_bundle
    runtime = AcousticArtifactRuntime(root / "acoustic", device="cpu")
    inp = acoustic_inputs(seed=3, b=1, t_txt=12, t_mel=50)
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 64, 16))
                             .astype(np.float32))
    gender = np.linspace(-1.2, 1.2, 50, dtype=np.float32)[None]
    for depth, steps in ((None, None), (0.3, 5)):
        got = runtime.synthesize_mel(inp["tokens"], inp["mel2ph"], inp["f0"], depth=depth,
                                     steps=steps, noise=noise, energy=inp["energy"],
                                     gender=gender)
        pad = lambda a, n, v=0: torch.from_numpy(np.pad(a, [(0, 0), (0, n - a.shape[1])],
                                                        constant_values=v))
        g = torch.clamp(pad(gender, 64), -1, 1)  # the shift range is [-5, 5]
        want = model.forward_infer_dynamic(
            pad(inp["tokens"], 16), pad(inp["mel2ph"], 64), pad(inp["f0"], 64, 220.0),
            depth=torch.tensor(0.6 if depth is None else depth),
            steps=torch.tensor(2 if steps is None else steps), noise=noise,
            variances={"energy": pad(inp["energy"], 64)},
            key_shift=torch.where(g >= 0, g * 5.0, g * 5.0)).diff_out[:, :50]
        assert got.shape == (1, 50, 16)
        assert np.abs(got - want.numpy()).max() <= 1e-6
    seeded = [runtime.synthesize_mel(inp["tokens"], inp["mel2ph"], inp["f0"], seed=s,
                                     energy=inp["energy"]) for s in (1, 1, 2)]
    assert np.array_equal(seeded[0], seeded[1]) and not np.allclose(seeded[0], seeded[2])


def test_runtime_picks_the_smallest_bucket_that_fits(pt2_bundle, tmp_path):
    root, _ = pt2_bundle
    manifest = yaml.safe_load((root / "acoustic" / "dsconfig.yaml").read_text())
    manifest["buckets"] = {"64x512": {}, "16x64": {}, "32x128": {}, "128x256": {}}
    (tmp_path / "dsconfig.yaml").write_text(yaml.safe_dump(manifest))
    runtime = AcousticArtifactRuntime(tmp_path, device="cpu")
    assert [runtime.pick_bucket(t, m)[:2] for t, m in ((5, 64), (17, 64), (20, 100),
                                                       (100, 200), (20, 300))] == [
        (16, 64), (32, 128), (32, 128), (128, 256), (64, 512)]


def test_pt2_vocoder_program_equals_the_eager_generator(pt2_bundle):
    """The full-NSF vocoder: its draws are inputs of the program, made by the
    runtime from a seeded generator in the generator's own order."""
    root, _ = pt2_bundle
    runtime = VocoderArtifactRuntime(root / "vocoder_bundle", device="cpu")
    assert runtime.manifest["noise_inputs"] == ["rand_ini", "source"]
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((1, 50, 16)).astype(np.float32)
    f0 = rng.uniform(150, 400, (1, 50)).astype(np.float32)
    got = runtime.vocode(mel, f0, seed=9)
    gen = torch.Generator().manual_seed(9)
    noise = VocoderNoise(rand_ini=torch.rand((1, 1, 9), generator=gen),
                         source=torch.randn((1, 64 * 512, 9), generator=gen))
    pad = lambda a, v=0: torch.from_numpy(np.pad(a, [(0, 0), (0, 14)] + [(0, 0)] * (a.ndim - 2),
                                                 constant_values=v))
    with torch.no_grad():
        want = runtime_generator(root)(pad(mel), pad(f0, 220.0), noise=noise)[:, :50 * 512]
    assert got.shape == (1, 50 * 512)
    assert np.abs(got - want.numpy()).max() <= 1e-6


def runtime_generator(root):
    from diffsinger_tpu_torch.vocoders.nsf_hifigan import NsfHifiGAN

    return NsfHifiGAN(dict(vocoder_ckpt=str(root / "vocoder" / "model.ckpt")),
                      device="cpu").model


def test_runtimes_refuse_what_they_cannot_serve(pt2_bundle, tmp_path):
    root, _ = pt2_bundle
    runtime = AcousticArtifactRuntime(root / "acoustic", device="cpu")
    tokens = np.ones((1, 40), np.int32)
    with pytest.raises(ValueError, match="no exported bucket fits"):
        runtime.synthesize_mel(tokens, np.ones((1, 100), np.int32), np.ones((1, 100), np.float32))
    with pytest.raises(ValueError, match="no exported vocoder bucket fits"):
        VocoderArtifactRuntime(root / "vocoder_bundle", device="cpu").vocode(
            np.zeros((1, 65, 16), np.float32), np.zeros((1, 65), np.float32))
    manifest = yaml.safe_load((root / "acoustic" / "dsconfig.yaml").read_text())
    for change, error in ((dict(flavor="onnx"), "flavor is 'onnx'"),
                          (dict(device="cuda"), "exported for 'cuda'")):
        (tmp_path / "dsconfig.yaml").write_text(yaml.safe_dump(dict(manifest, **change)))
        with pytest.raises(ValueError, match=error):
            AcousticArtifactRuntime(tmp_path, device="cpu")


def test_a_full_nsf_vocoder_has_no_onnx_export(pt2_bundle, tmp_path):
    root, _ = pt2_bundle
    with pytest.raises(ValueError, match="full-NSF"):
        NSFHiFiGANExporter(dict(vocoder_ckpt=str(root / "vocoder" / "model.ckpt")), tmp_path,
                           fmt="onnx", device="cpu")


CLI = """
import sys
from diffsinger_tpu_torch.cli import export
export.main(["acoustic", "--exp", "cli", "--out", sys.argv[1] + "/acoustic", "--format",
             "both", "--freeze_gender", "0", "--buckets", "16x64", "--device", "cpu"])
export.main(["nsf-hifigan", "--config", sys.argv[2], "--out", sys.argv[1] + "/vocoder",
             "--buckets", "64", "--device", "cpu"])
export.main(["variance", "--exp", "cli_var", "--out", sys.argv[1] + "/variance", "--format",
             "both", "--freeze_glide", "--buckets", "16x64", "--device", "cpu"])
jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "diffsinger_tpu"))
print("JAX-PACKAGE-MODULES", jax_modules)
"""


def test_cli_export_without_the_jax_package(tmp_path):
    import os

    from tests.torch_parity import make_variance_exp

    ckpt_root = make_exp(tmp_path, "cli", dict(ONE_LAYER, use_key_shift_embed=True))
    make_variance_exp(tmp_path, "cli_var", dict(use_melody_encoder=True, use_glide_embed=True))
    cfg = tmp_path / "vocoder.yaml"
    cfg.write_text(yaml.safe_dump(dict(base_config=[str(REPO / "configs" / "acoustic.yaml")],
                                       vocoder_ckpt=str(tmp_path / "vocoder" / "model.ckpt"),
                                       audio_num_mel_bins=16)))
    blocker = ("import sys\nclass _Block:\n    def find_spec(self, name, path=None, target=None):\n"
               "        if name.split('.')[0] in ('jax', 'diffsinger_tpu'):\n"
               "            raise ImportError(f'{name} is not to be imported')\n"
               "sys.meta_path.insert(0, _Block())\n"
               "[sys.modules.pop(m) for m in list(sys.modules) if m.split('.')[0] in ('jax', 'jaxlib', 'diffsinger_tpu')]\n")
    proc = subprocess.run([sys.executable, "-c", blocker + CLI, str(tmp_path / "out"), str(cfg)],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, DS_CKPT_ROOT=str(ckpt_root)))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "JAX-PACKAGE-MODULES []" in proc.stdout
    out = tmp_path / "out"
    manifest = yaml.safe_load((out / "acoustic" / "dsconfig.yaml").read_text())
    assert manifest["flavor"] == "both" and manifest["device"] == "cpu"
    assert manifest["use_key_shift_embed"] is False  # frozen
    assert {"cli.diffusion.pt2", "cli.fs2_aux.pt2", "cli.acoustic.onnx", "cli.fs2_aux.onnx",
            "phonemes.json", "dictionary.txt"} <= {p.name for p in (out / "acoustic").iterdir()}
    assert (out / "vocoder" / "nsf_hifigan.pt2").exists()
    manifest = yaml.safe_load((out / "variance" / "dsconfig.yaml").read_text())
    assert manifest["flavor"] == "both" and manifest["device"] == "cpu"
    assert manifest["linguistic"] == "cli_var.linguistic_dur.pt2"
    assert manifest["use_glide_embed"] is False and manifest["use_note_rest"] is True  # frozen
    assert manifest["inputs"]["pitch"] == ["encoder_out", "ph_dur", "note_midi", "note_rest",
                                           "note_dur", "pitch", "expr", "retake", "steps"]
    assert manifest["inputs"]["variance"] == ["encoder_out", "ph_dur", "pitch", "energy",
                                              "breathiness", "voicing", "tension", "retake",
                                              "steps"]
    assert {f"cli_var.{v}.{ext}" for v in ("pitch", "variance") for ext in ("pt2", "onnx")} | {
        "cli_var.linguistic_dur.pt2", "cli_var.linguistic.onnx", "phonemes.json",
        "dictionary.txt"} <= {p.name for p in (out / "variance").iterdir()}
