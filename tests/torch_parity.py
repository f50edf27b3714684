"""Shared set-up for the parity tests of the PyTorch port (tests/test_torch_*.py).

Both sides get the same parameters and inputs: the JAX model is initialised,
its zero- or tiny-initialised parameters (biases, LayerNorm scales, PReLU
slopes, ConvNeXt gammas, LYNXNet's output projection) are overwritten with
seeded random values so that every stage contributes, and the port loads them
through ``diffsinger_tpu_torch.utils.convert``. Everything runs on the CPU in
float32; tests/conftest.py sets JAX's matmul precision to 'highest'.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

HP = dict(
    hidden_size=32,
    enc_layers=2,
    num_heads=2,
    enc_ffn_kernel_size=3,
    ffn_act="gelu",
    dropout=0.1,
    use_pos_embed=True,
    rel_pos=True,
    use_rope=True,
    use_lang_id=False,
    num_lang=1,
    use_spk_id=False,
    num_spk=1,
    use_energy_embed=True,
    use_breathiness_embed=False,
    use_voicing_embed=False,
    use_tension_embed=False,
    use_key_shift_embed=True,
    use_speed_embed=False,
    audio_num_mel_bins=16,
    diffusion_type="reflow",
    T_start=0.4,
    T_start_infer=0.4,
    timesteps=1000,
    time_scale_factor=1000,
    spec_min=[-12],
    spec_max=[0],
    use_shallow_diffusion=True,
    shallow_diffusion_args=dict(
        train_aux_decoder=True, train_diffusion=True, val_gt_start=False,
        aux_decoder_arch="convnext",
        aux_decoder_args=dict(num_channels=24, num_layers=2, kernel_size=7, dropout_rate=0.1),
        aux_decoder_grad=0.1,
    ),
    backbone_type="lynxnet",
    backbone_args=dict(num_channels=32, num_layers=2, kernel_size=31,
                       dropout_rate=0.0, strong_cond=True),
    sampling_algorithm="euler",
    sampling_steps=4,
)
VOCAB = 30
MELS = 16

# leaves overwritten with random values, by their last path key
_RANDOM_LEAVES = {"bias", "alpha", "gamma", "scale"}


def to_numpy(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def randomize(params, seed: int):
    """Overwrite zero/constant-initialised leaves with seeded random values."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [getattr(k, "key", str(k)) for k in path]
        shape = np.shape(leaf)
        if keys[-1] == "alpha":
            return jnp.asarray(rng.uniform(0.1, 0.5, shape).astype(np.float32))
        if keys[-1] == "scale":
            return jnp.asarray((1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32))
        if keys[-1] in _RANDOM_LEAVES:
            return jnp.asarray((0.3 * rng.standard_normal(shape)).astype(np.float32))
        if "output_projection" in keys and keys[-1] == "kernel":
            return jnp.asarray((0.2 * rng.standard_normal(shape)).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(fill, params)


def acoustic_pair(hp=None, seed: int = 0):
    """(JAX DiffSingerAcoustic, its params, port DiffSingerAcoustic) sharing weights."""
    from diffsinger_tpu.models.toplevel import DiffSingerAcoustic as JaxAcoustic
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
    from diffsinger_tpu_torch.utils.convert import acoustic_state_dict_from_flax

    hp = dict(hp or HP)
    jmodel = JaxAcoustic(hp, vocab_size=VOCAB, out_dims=MELS)
    params = randomize(jmodel.init(jax.random.PRNGKey(seed)), seed + 100)
    port = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=MELS, device="cpu")
    port.module.load_state_dict(acoustic_state_dict_from_flax(to_numpy(params), hp))
    return jmodel, params, port


def jax_ddpm_step_noises(key, n_steps: int, shape) -> list:
    """The per-step draws of the JAX ancestral sampler from ``key``: at each
    step it splits its key and draws from the second half."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, tuple(shape), jnp.float32))))
    return out


# a variance model at narrow widths: word-mode durations, pitch on WaveNet,
# three of the four variances on another WaveNet
VAR_HP = dict(
    hidden_size=32, enc_layers=2, num_heads=2, enc_ffn_kernel_size=3, ffn_act="gelu",
    dropout=0.1, use_pos_embed=True, rel_pos=True, use_rope=True,
    use_lang_id=False, num_lang=1, use_spk_id=False, num_spk=1,
    predict_dur=True, predict_pitch=True, predict_energy=True, predict_breathiness=True,
    predict_voicing=False, predict_tension=True,
    use_melody_encoder=False, melody_encoder_args=dict(hidden_size=32, enc_layers=2),
    use_glide_embed=False, glide_types=["up", "down"], glide_embed_scale=11.313708498984760,
    dur_prediction_args=dict(arch="fs2", hidden_size=24, dropout=0.1, num_layers=2,
                             kernel_size=3, log_offset=1.0),
    pitch_prediction_args=dict(pitd_norm_min=-8.0, pitd_norm_max=8.0, pitd_clip_min=-12.0,
                               pitd_clip_max=12.0, repeat_bins=8, backbone_type="wavenet",
                               backbone_args=dict(num_layers=3, num_channels=16,
                                                  dilation_cycle_length=2)),
    variances_prediction_args=dict(total_repeat_bins=12, backbone_type="wavenet",
                                   backbone_args=dict(num_layers=2, num_channels=16,
                                                      dilation_cycle_length=2)),
    energy_db_min=-96.0, energy_db_max=-12.0, breathiness_db_min=-96.0,
    breathiness_db_max=-20.0, voicing_db_min=-96.0, voicing_db_max=-12.0,
    tension_logit_min=-10.0, tension_logit_max=10.0,
    diffusion_type="reflow", schedule_type="linear", timesteps=1000, K_step=1000,
    time_scale_factor=1000, sampling_algorithm="euler", sampling_steps=3,
    diff_accelerator="ddim", diff_speedup=10,
)


def variance_pair(hp=None, seed: int = 0, params=None):
    """(JAX DiffSingerVariance, its params, port DiffSingerVariance) sharing
    weights; ``params`` of a model with the same parameter tree (the sampler
    settings may differ) skips the JAX init."""
    from diffsinger_tpu.models.toplevel import DiffSingerVariance as JaxVariance
    from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance
    from diffsinger_tpu_torch.utils.convert import variance_state_dict_from_flax

    hp = dict(hp or VAR_HP)
    jmodel = JaxVariance(hp, vocab_size=VOCAB)
    if params is None:
        params = randomize(jmodel.init(jax.random.PRNGKey(seed)), seed + 100)
    port = DiffSingerVariance(hp, vocab_size=VOCAB, device="cpu")
    port.module.load_state_dict(variance_state_dict_from_flax(to_numpy(params), hp))
    return jmodel, params, port


def acoustic_inputs(seed: int = 0, b: int = 2, t_txt: int = 12, t_mel: int = 48):
    """Tokens with pad tokens, mel2ph with padded (0) frames, f0 and curves."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((b, t_txt), np.int32)
    mel2ph = np.zeros((b, t_mel), np.int32)
    n_tok = [t_txt - 2 * i for i in range(b)]  # later rows hold fewer tokens
    for i, n in enumerate(n_tok):
        tokens[i, :n] = rng.integers(1, VOCAB, n)
        dur = rng.integers(1, 2 * t_mel // (n + 1), n)
        frames = np.repeat(np.arange(1, n + 1), dur)[: t_mel - 3 * i]
        mel2ph[i, :len(frames)] = frames
    f0 = rng.uniform(150.0, 400.0, (b, t_mel)).astype(np.float32)
    energy = rng.uniform(-60, -20, (b, t_mel)).astype(np.float32)
    key_shift = rng.uniform(-3, 3, (b, 1)).astype(np.float32)
    return dict(tokens=tokens, mel2ph=mel2ph, f0=f0, energy=energy, key_shift=key_shift)


def jax_kwargs(inp):
    return dict(key_shift=jnp.asarray(inp["key_shift"]),
                variances={"energy": jnp.asarray(inp["energy"])})


def port_kwargs(inp):
    return dict(key_shift=torch.from_numpy(inp["key_shift"]),
                variances={"energy": torch.from_numpy(inp["energy"])})


def assert_close(got, want, atol=1e-5, rtol=1e-5):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# a shared experiment folder for the inference-runtime tests
# ---------------------------------------------------------------------------

import json  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402

import yaml  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
DICT = REPO / "dictionaries" / "opencpop-extension.txt"

# configs/acoustic.yaml cut to a few narrow layers; two sampler steps
TINY_EXP = dict(
    hidden_size=32, enc_layers=2, sampling_steps=2, audio_num_mel_bins=MELS,
    backbone_args=dict(num_channels=32, num_layers=2, kernel_size=31,
                       dropout_rate=0.0, strong_cond=True),
    shallow_diffusion_args=dict(
        train_aux_decoder=True, train_diffusion=True, val_gt_start=False,
        aux_decoder_arch="convnext",
        aux_decoder_args=dict(num_channels=24, num_layers=2, kernel_size=7, dropout_rate=0.1),
        aux_decoder_grad=0.1,
    ),
)
# a full-NSF vocoder at narrow widths (hop 512, as the shipped one)
TINY_VOCODER = dict(num_mels=MELS, sampling_rate=44100, upsample_rates=[8, 8, 2, 2, 2],
                    upsample_kernel_sizes=[16, 16, 4, 4, 4], upsample_initial_channel=32,
                    resblock="1", resblock_kernel_sizes=[3, 7, 11],
                    resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                    mini_nsf=False, noise_sigma=0.0)


def load_ds(name: str):
    with open(REPO / "samples" / name, encoding="utf-8") as f:
        return json.load(f)


def make_exp(root: pathlib.Path, name: str, overrides: dict | None = None, *,
             acoustic_steps: int | None = 10, vocoder: dict | None = TINY_VOCODER,
             seed: int = 0) -> pathlib.Path:
    """Write ``<root>/checkpoints/<name>`` the way a user's experiment folder
    looks: ``config.yaml``, ``dictionary.txt`` (or, with ``dictionaries`` in the
    overrides, a ``lang_map.json``), ``spk_map.json`` with ``use_spk_id``, and (unless ``acoustic_steps`` is
    None) ``model_ckpt_steps_<N>.ckpt`` in the reference layout, a ``torch.save``d
    dict with Lightning's ``model.`` prefix, the diffusion wrapper's buffers and
    ``category``. With ``vocoder``, ``<root>/vocoder/{config.json,model.ckpt}``
    holds a generator state dict under ``generator`` with weight norm unfused, as
    the released vocoders have it. All weights are seeded random values, none
    left at zero. Returns the checkpoints root; both packages then load the
    folder with their own ``load_config(exp_name=name, infer=True, ckpt_root=...)``.
    """
    from diffsinger_tpu.config import load_config as jax_load_config
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
    from diffsinger_tpu_torch.utils.ckpt import checkpoint_path
    from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary
    from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import Generator, NsfHifiGanConfig

    ckpt_root = root / "checkpoints"
    work_dir = ckpt_root / name
    work_dir.mkdir(parents=True)
    hp = dict(jax_load_config(str(REPO / "configs" / "acoustic.yaml"), save_snapshot=False))
    hp.update(TINY_EXP)
    hp.update(overrides or {})
    hp.pop("work_dir", None)
    if hp.get("dictionaries"):  # lang -> file name under dictionaries/
        hp["dictionaries"] = {k: str(REPO / "dictionaries" / v)
                              for k, v in hp["dictionaries"].items()}
        (work_dir / "lang_map.json").write_text(json.dumps(
            {lang: i + 1 for i, lang in enumerate(sorted(hp["dictionaries"]))}))
    else:
        hp["dictionary"] = str(DICT)
        hp.pop("dictionaries", None)
        shutil.copy(DICT, work_dir / "dictionary.txt")
    hp["vocoder_ckpt"] = str(root / "vocoder" / "model.ckpt")
    with open(work_dir / "config.yaml", "w") as f:
        yaml.safe_dump(hp, f, allow_unicode=True)
    if hp.get("use_spk_id"):
        (work_dir / "spk_map.json").write_text(json.dumps(
            {f"spk{i}": i for i in range(hp["num_spk"])}))

    g = torch.Generator().manual_seed(seed)

    def randomized(module):
        state = {}
        for k, v in module.state_dict().items():
            if k.endswith(("net.5.weight", "alpha")):  # PReLU slopes stay in (0, 1)
                state[k] = 0.1 + 0.4 * torch.rand(v.shape, generator=g)
            else:
                scale = 0.3 if v.ndim == 1 else 0.02 + (0.5 * float(v.std()) if v.numel() > 1 else 0.3)
                state[k] = v + scale * torch.randn(v.shape, generator=g)
        return state

    if acoustic_steps is not None:
        vocab = len(load_phoneme_dictionary(dict(hp, work_dir=str(work_dir))))
        torch.manual_seed(seed)
        model = DiffSingerAcoustic(hp, vocab_size=vocab, out_dims=hp["audio_num_mel_bins"],
                                   device="cpu")
        state = {"model." + k: v for k, v in randomized(model.module).items()}
        # buffers of the reference's diffusion wrapper, which neither package's loader wants
        state["model.diffusion.spec_min"] = torch.tensor(hp["spec_min"])[None, None]
        state["model.diffusion.spec_max"] = torch.tensor(hp["spec_max"])[None, None]
        torch.save({"state_dict": state, "category": "acoustic", "global_step": acoustic_steps},
                   checkpoint_path(work_dir, acoustic_steps))

    if vocoder is not None:
        voc_dir = root / "vocoder"
        voc_dir.mkdir()
        (voc_dir / "config.json").write_text(json.dumps(dict(vocoder, discriminator_periods=[3, 5])))
        torch.manual_seed(seed + 1)
        gen = Generator(NsfHifiGanConfig.from_json(vocoder), device="cpu")
        state = {}
        for k, v in randomized(gen).items():
            normed = k.endswith(".weight") and v.ndim == 3 and not k.startswith(
                ("noise_convs", "source_conv"))
            if normed:  # weight_norm(dim=0): g holds the norm over the other dims
                state[k + "_v"] = v
                state[k + "_g"] = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt() * (
                    1 + 0.1 * torch.rand(v.shape[0], 1, 1, generator=g))
            else:
                state[k] = v
        torch.save({"generator": state}, voc_dir / "model.ckpt")
    return ckpt_root


def jax_sampler_noise(seed: int, shape) -> np.ndarray:
    """The draw the JAX sampler makes from ``PRNGKey(seed)`` for a batch of ``shape``."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed & 0xFFFF_FFFF), tuple(shape),
                                        dtype=jnp.float32))


def jax_vocoder_noise(batch: int, frames: int, hop: int = 512, channels: int = 0,
                      sigma: bool = False):
    """The draws the JAX generator makes from its fixed ``PRNGKey(0)``: the
    initial phases and the source noise of ``sine_source_full`` and, with
    ``sigma``, the noise added after ``conv_pre`` [batch, frames, channels]."""
    from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import VocoderNoise

    rng = jax.random.PRNGKey(0)
    rng_phase, rng_noise = jax.random.split(rng)
    out = VocoderNoise(
        rand_ini=torch.from_numpy(np.array(jax.random.uniform(rng_phase, (1, 1, 9)))),
        source=torch.from_numpy(np.array(
            jax.random.normal(rng_noise, (batch, frames * hop, 9)))))
    if sigma:
        _, sub = jax.random.split(rng)
        out.sigma = torch.from_numpy(np.array(
            jax.random.normal(sub, (batch, frames, channels), jnp.float32)))
    return out


# configs/variance.yaml cut to a few narrow layers, every variance on, two
# sampler steps (the nested sections are whole: a config replaces them whole)
TINY_VARIANCE = dict(
    hidden_size=32, enc_layers=2, sampling_steps=2,
    predict_energy=True, predict_breathiness=True, predict_voicing=True, predict_tension=True,
    dur_prediction_args=dict(arch="fs2", hidden_size=24, dropout=0.1, num_layers=2,
                             kernel_size=3, log_offset=1.0, loss_type="mse",
                             lambda_pdur_loss=0.3, lambda_wdur_loss=1.0, lambda_sdur_loss=3.0),
    melody_encoder_args=dict(hidden_size=16, enc_layers=2),
    pitch_prediction_args=dict(pitd_norm_min=-8.0, pitd_norm_max=8.0, pitd_clip_min=-12.0,
                               pitd_clip_max=12.0, repeat_bins=8, backbone_type="wavenet",
                               backbone_args=dict(num_layers=3, num_channels=16,
                                                  dilation_cycle_length=2)),
    variances_prediction_args=dict(total_repeat_bins=16, backbone_type="wavenet",
                                   backbone_args=dict(num_layers=2, num_channels=16,
                                                      dilation_cycle_length=2)),
)


def make_variance_exp(root: pathlib.Path, name: str, overrides: dict | None = None, *,
                      variance_steps: int | None = 10, seed: int = 0) -> pathlib.Path:
    """Write ``<root>/checkpoints/<name>``, a variance experiment folder as a
    user has it: ``config.yaml`` (configs/variance.yaml with TINY_VARIANCE and
    ``overrides``), ``dictionary.txt``, ``spk_map.json`` with ``use_spk_id``,
    and (unless ``variance_steps`` is None) ``model_ckpt_steps_<N>.ckpt`` in the
    reference layout: Lightning's ``model.`` prefix, the diffusion wrappers'
    buffers, ``category: variance``. Seeded random weights, none left at zero.
    Returns the checkpoints root."""
    from diffsinger_tpu.config import load_config as jax_load_config
    from diffsinger_tpu_torch.core.schedule import DiffusionSchedule
    from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance
    from diffsinger_tpu_torch.utils.ckpt import checkpoint_path
    from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary

    ckpt_root = root / "checkpoints"
    work_dir = ckpt_root / name
    work_dir.mkdir(parents=True)
    hp = dict(jax_load_config(str(REPO / "configs" / "variance.yaml"), save_snapshot=False))
    hp.update(TINY_VARIANCE)
    hp.update(overrides or {})
    hp.pop("work_dir", None)
    hp.pop("dictionaries", None)
    hp["dictionary"] = str(DICT)
    shutil.copy(DICT, work_dir / "dictionary.txt")
    with open(work_dir / "config.yaml", "w") as f:
        yaml.safe_dump(hp, f, allow_unicode=True)
    if hp.get("use_spk_id"):
        (work_dir / "spk_map.json").write_text(json.dumps(
            {f"spk{i}": i for i in range(hp["num_spk"])}))
    if variance_steps is None:
        return ckpt_root

    g = torch.Generator().manual_seed(seed)
    vocab = len(load_phoneme_dictionary(dict(hp, work_dir=str(work_dir))))
    torch.manual_seed(seed)
    model = DiffSingerVariance(hp, vocab_size=vocab, device="cpu")
    state = {}
    for k, v in model.module.state_dict().items():
        scale = 0.3 if v.ndim == 1 else 0.02 + (0.5 * float(v.std()) if v.numel() > 1 else 0.3)
        state["model." + k] = v + scale * torch.randn(v.shape, generator=g)
    # buffers of the reference's diffusion wrappers, which neither package's loader wants
    for wrapper in ("pitch_predictor", "variance_predictor"):
        state[f"model.{wrapper}.spec_min"] = torch.zeros(1, 1, 1, 1)
        state[f"model.{wrapper}.spec_max"] = torch.ones(1, 1, 1, 1)
        if hp["diffusion_type"] == "ddpm":
            sched = DiffusionSchedule.create("linear", hp["timesteps"])
            state[f"model.{wrapper}.alphas_cumprod"] = torch.from_numpy(sched.alphas_cumprod)
    torch.save({"state_dict": state, "category": "variance", "global_step": variance_steps},
               checkpoint_path(work_dir, variance_steps))
    return ckpt_root
