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
