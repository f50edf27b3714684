"""JAX (flax) parameters -> the port's ``state_dict``s.

The inverse of the JAX package's torch -> flax converters
(``utils/torch_model_convert.py::convert_acoustic`` / ``convert_variance`` and
``utils/torch_convert.py::convert_nsf_hifigan``), so weights move both ways.
The parameters come as nested dicts of numpy arrays, with or without the
top-level ``"params"`` key. Layout rules:

* flax ``Dense`` kernel [in, out]     -> torch ``Linear`` weight [out, in]
* flax ``Dense`` used for a 1x1 conv  -> torch ``Conv1d`` weight [out, in, 1]
* flax ``Conv`` kernel [k, in, out]   -> torch ``Conv1d`` weight [out, in, k]
* ``ConvTranspose1dTorch`` kernel [k, in, out] -> ``ConvTranspose1d`` [in, out, k]
* the JAX package's ``Linear`` nests its Dense under a ``dense`` scope.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from diffsinger_tpu_torch.models import compat

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd: StateDict, prefix: str, node: dict, *, as_conv1x1: bool = False) -> None:
    w = np.transpose(np.asarray(node["kernel"]))  # [out, in]
    sd[f"{prefix}.weight"] = _t(w[:, :, None] if as_conv1x1 else w)
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def _linear(sd: StateDict, prefix: str, node: dict) -> None:
    _dense(sd, prefix, node["dense"])


def _conv(sd: StateDict, prefix: str, node: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(node["kernel"]), (2, 1, 0)))
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def _layernorm(sd: StateDict, prefix: str, node: dict) -> None:
    sd[f"{prefix}.weight"] = _t(node["scale"])
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _fs2_encoder(sd: StateDict, prefix: str, p: dict, num_layers: int, use_rope: bool) -> None:
    """Without RoPE the attention is the reference's ``nn.MultiheadAttention``,
    whose packed projection is the parameter ``in_proj_weight``."""
    _layernorm(sd, f"{prefix}.layer_norm", p["layer_norm"])
    for i in range(num_layers):
        q, lp = f"{prefix}.layers.{i}.op", p[f"layers_{i}"]
        _layernorm(sd, f"{q}.layer_norm1", lp["layer_norm1"])
        _layernorm(sd, f"{q}.layer_norm2", lp["layer_norm2"])
        _conv(sd, f"{q}.ffn.ffn_1", lp["ffn"]["ffn_1"])
        _linear(sd, f"{q}.ffn.ffn_2", lp["ffn"]["ffn_2"])
        if use_rope:
            _dense(sd, f"{q}.self_attn.in_proj", lp["self_attn"]["in_proj"])
        else:
            sd[f"{q}.self_attn.in_proj_weight"] = _t(
                np.transpose(np.asarray(lp["self_attn"]["in_proj"]["kernel"])))
        _dense(sd, f"{q}.self_attn.out_proj", lp["self_attn"]["out_proj"])


def _fs2_acoustic(sd: StateDict, p: dict, hp: dict, prefix: str = "fs2") -> None:
    sd[f"{prefix}.txt_embed.weight"] = _t(p["txt_embed"]["embedding"])
    _linear(sd, f"{prefix}.dur_embed", p["dur_embed"])
    _linear(sd, f"{prefix}.pitch_embed", p["pitch_embed"])
    _fs2_encoder(sd, f"{prefix}.encoder", p["encoder"], hp["enc_layers"],
                 hp.get("use_rope", False))
    if hp.get("use_lang_id", False):
        sd[f"{prefix}.lang_embed.weight"] = _t(p["lang_embed"]["embedding"])
    if hp.get("use_spk_id", False):
        sd[f"{prefix}.spk_embed.weight"] = _t(p["spk_embed"]["embedding"])
    for v in ("energy", "breathiness", "voicing", "tension"):
        if hp.get(f"use_{v}_embed", False):
            _linear(sd, f"{prefix}.variance_embeds.{v}", p[f"variance_embeds_{v}"])
    if hp.get("use_key_shift_embed", False):
        _linear(sd, f"{prefix}.key_shift_embed", p["key_shift_embed"])
    if hp.get("use_speed_embed", False):
        _linear(sd, f"{prefix}.speed_embed", p["speed_embed"])


def _lynxnet(sd: StateDict, prefix: str, p: dict, num_layers: int) -> None:
    _dense(sd, f"{prefix}.input_projection", p["input_projection"], as_conv1x1=True)
    _dense(sd, f"{prefix}.diffusion_embedding.1", p["diffusion_embedding_1"])
    _dense(sd, f"{prefix}.diffusion_embedding.3", p["diffusion_embedding_3"])
    _layernorm(sd, f"{prefix}.norm", p["norm"])
    _dense(sd, f"{prefix}.output_projection", p["output_projection"], as_conv1x1=True)
    for i in range(num_layers):
        q, lp = f"{prefix}.residual_layers.{i}", p[f"residual_layers_{i}"]
        _dense(sd, f"{q}.conditioner_projection", lp["conditioner_projection"], as_conv1x1=True)
        _dense(sd, f"{q}.diffusion_projection", lp["diffusion_projection"], as_conv1x1=True)
        cm = lp["convmodule"]
        _layernorm(sd, f"{q}.convmodule.net.0", cm["norm"])
        _conv(sd, f"{q}.convmodule.net.2", cm["pw_conv1"])
        _conv(sd, f"{q}.convmodule.net.4", cm["dw_conv"])
        if "act" in cm:  # PReLU's slopes; SiLU and ReLU have no parameters
            sd[f"{q}.convmodule.net.5.weight"] = _t(cm["act"]["alpha"])
        _conv(sd, f"{q}.convmodule.net.6", cm["pw_conv2"])


def _wavenet(sd: StateDict, prefix: str, p: dict, num_layers: int) -> None:
    _dense(sd, f"{prefix}.input_projection", p["input_projection"], as_conv1x1=True)
    _dense(sd, f"{prefix}.mlp.0", p["mlp_0"])
    _dense(sd, f"{prefix}.mlp.2", p["mlp_2"])
    _dense(sd, f"{prefix}.skip_projection", p["skip_projection"], as_conv1x1=True)
    _dense(sd, f"{prefix}.output_projection", p["output_projection"], as_conv1x1=True)
    for i in range(num_layers):
        q, lp = f"{prefix}.residual_layers.{i}", p[f"residual_layers_{i}"]
        _conv(sd, f"{q}.dilated_conv", lp["dilated_conv"])
        _dense(sd, f"{q}.diffusion_projection", lp["diffusion_projection"])
        _dense(sd, f"{q}.conditioner_projection", lp["conditioner_projection"], as_conv1x1=True)
        _dense(sd, f"{q}.output_projection", lp["output_projection"], as_conv1x1=True)


def _backbone(sd: StateDict, prefix: str, p: dict, backbone_type: str,
              backbone_args: dict) -> None:
    if backbone_type == "wavenet":
        _wavenet(sd, prefix, p, backbone_args.get("num_layers", 20))
    elif backbone_type == "lynxnet":
        _lynxnet(sd, prefix, p, backbone_args.get("num_layers", 6))
    else:
        raise NotImplementedError(backbone_type)


def _core_prefix(outer: str, hp: dict) -> str:
    """DDPM names its backbone ``denoise_fn``, rectified flow ``velocity_fn``."""
    fn = "denoise_fn" if hp.get("diffusion_type", "ddpm") == "ddpm" else "velocity_fn"
    return f"{outer}.{fn}"


def _convnext_decoder(sd: StateDict, prefix: str, p: dict, num_layers: int) -> None:
    _conv(sd, f"{prefix}.inconv", p["inconv"])
    _conv(sd, f"{prefix}.outconv", p["outconv"])
    for i in range(num_layers):
        q, bp = f"{prefix}.conv.{i}", p[f"conv_{i}"]
        _conv(sd, f"{q}.dwconv", bp["dwconv"])
        _layernorm(sd, f"{q}.norm", bp["norm"])
        _dense(sd, f"{q}.pwconv1", bp["pwconv1"])
        _dense(sd, f"{q}.pwconv2", bp["pwconv2"])
        sd[f"{q}.gamma"] = _t(bp["gamma"])


def acoustic_state_dict_from_flax(params_np: dict, hp: dict) -> StateDict:
    """JAX ``AcousticModule`` parameters -> ``AcousticModule.state_dict()`` of the port."""
    p = params_np.get("params", params_np)
    sd: StateDict = {}
    _fs2_acoustic(sd, p["fs2"], hp)
    backbone_type = compat.get_backbone_type(hp)
    _backbone(sd, _core_prefix("diffusion", hp), p["denoiser"], backbone_type,
              compat.get_backbone_args(hp, backbone_type) or {})
    if hp.get("use_shallow_diffusion", False):
        aux_args = hp["shallow_diffusion_args"]["aux_decoder_args"]
        _convnext_decoder(sd, "aux_decoder.decoder", p["aux_decoder"]["decoder"],
                          aux_args.get("num_layers", 6))
    return sd


def variance_state_dict_from_flax(params_np: dict, hp: dict) -> StateDict:
    """JAX ``VarianceModule`` parameters -> ``VarianceModule.state_dict()`` of the port."""
    from diffsinger_tpu_torch.models.toplevel import variance_prediction_list

    p = params_np.get("params", params_np)
    sd: StateDict = {}
    fs2 = p["fs2"]
    sd["fs2.txt_embed.weight"] = _t(fs2["txt_embed"]["embedding"])
    _fs2_encoder(sd, "fs2.encoder", fs2["encoder"], hp["enc_layers"], hp.get("use_rope", False))
    if hp.get("use_lang_id", False):
        sd["fs2.lang_embed.weight"] = _t(fs2["lang_embed"]["embedding"])
    if hp["predict_dur"]:
        sd["fs2.onset_embed.weight"] = _t(fs2["onset_embed"]["embedding"])
        _linear(sd, "fs2.word_dur_embed", fs2["word_dur_embed"])
        sd["fs2.midi_embed.weight"] = _t(fs2["midi_embed"]["embedding"])
        dp = fs2["dur_predictor"]
        _linear(sd, "fs2.dur_predictor.linear", dp["linear"])
        for i in range(hp["dur_prediction_args"]["num_layers"]):
            _conv(sd, f"fs2.dur_predictor.conv.{i}.1", dp[f"conv_{i}"])
            _layernorm(sd, f"fs2.dur_predictor.conv.{i}.3", dp[f"norm_{i}"])
    else:
        _linear(sd, "fs2.ph_dur_embed", fs2["ph_dur_embed"])
    if hp.get("use_spk_id", False):
        sd["spk_embed.weight"] = _t(p["spk_embed"]["embedding"])

    if hp["predict_pitch"]:
        pitch_hp = hp["pitch_prediction_args"]
        if hp.get("use_melody_encoder", False):
            me, me_hp = p["melody_encoder"], hp.get("melody_encoder_args", {})
            _linear(sd, "melody_encoder.note_midi_embed", me["note_midi_embed"])
            _linear(sd, "melody_encoder.note_dur_embed", me["note_dur_embed"])
            _fs2_encoder(sd, "melody_encoder.encoder", me["encoder"],
                         me_hp.get("enc_layers", hp["enc_layers"]),
                         me_hp.get("use_rope", hp.get("use_rope", False)))
            _linear(sd, "melody_encoder.out_proj", me["out_proj"])
            if hp.get("use_glide_embed", False):
                sd["melody_encoder.note_glide_embed.weight"] = _t(
                    me["note_glide_embed"]["embedding"])
            _linear(sd, "delta_pitch_embed", p["delta_pitch_embed"])
        else:
            _linear(sd, "base_pitch_embed", p["base_pitch_embed"])
        sd["pitch_retake_embed.weight"] = _t(p["pitch_retake_embed"]["embedding"])
        bt = compat.get_backbone_type(hp, nested_config=pitch_hp)
        _backbone(sd, _core_prefix("pitch_predictor", hp), p["pitch_denoiser"], bt,
                  compat.get_backbone_args(pitch_hp, bt) or {})

    var_list = variance_prediction_list(hp)
    if var_list:
        _linear(sd, "pitch_embed", p["pitch_embed"])
        for v in var_list:
            _linear(sd, f"variance_embeds.{v}", p[f"variance_embeds_{v}"])
        var_hp = hp["variances_prediction_args"]
        bt = compat.get_backbone_type(hp, nested_config=var_hp)
        _backbone(sd, _core_prefix("variance_predictor", hp), p["variance_denoiser"], bt,
                  compat.get_backbone_args(var_hp, bt) or {})
    return sd


def nsf_hifigan_state_dict_from_flax(params_np: dict, cfg) -> StateDict:
    """JAX ``Generator`` parameters (full-NSF or mini-NSF, canonical names) -> the
    port's ``Generator.state_dict()`` (weight norm already fused)."""
    p = params_np.get("params", params_np)
    sd: StateDict = {}
    _conv(sd, "conv_pre", p["conv_pre"])
    _conv(sd, "conv_post", p["conv_post"])
    for i in range(len(cfg.upsample_rates)):
        up = p[f"ups_{i}"]
        sd[f"ups.{i}.weight"] = _t(np.transpose(np.asarray(up["kernel"]), (1, 2, 0)))
        sd[f"ups.{i}.bias"] = _t(up["bias"])
        if not cfg.mini_nsf:
            _conv(sd, f"noise_convs.{i}", p[f"noise_convs_{i}"])
    if cfg.mini_nsf:
        _conv(sd, "source_conv", p["source_conv"])
    else:
        _dense(sd, "m_source.l_linear", p["m_source_linear"])
    names = ("convs1", "convs2") if cfg.resblock == "1" else ("convs",)
    n_res = 3 if cfg.resblock == "1" else 2
    for idx in range(len(cfg.upsample_rates) * len(cfg.resblock_kernel_sizes)):
        rp = p[f"resblocks_{idx}"]
        for name in names:
            for m in range(n_res):
                _conv(sd, f"resblocks.{idx}.{name}.{m}", rp[f"{name}_{m}"])
    return sd
