"""RMVPE neural pitch extractor (counterpart of diffsinger_tpu/models/rmvpe.py;
reference modules/pe/rmvpe/*).

``E2E0``: a 16 kHz HTK log-mel (128 bins, hop 160) through ``DeepUnet0`` (a
5-level residual 2-D U-Net), a 3x3 convolution to 3 channels, a BiGRU of
256 a direction and a 360-bin sigmoid over cents. The modules carry the
reference's names (``unet.encoder.layers.{i}.conv.{j}.*``,
``unet.decoder.layers.{i}.conv1.{0,1}``, ``cnn.*``, ``fc.0.gru.*``,
``fc.1.*``), so a reference checkpoint's ``ckpt["model"]`` loads with
``strict=True`` and the JAX package's ``convert_rmvpe`` reads the port's
weights. ``DeepUnet0`` builds the reference's ``TimbreFilter`` (``unet.tf``)
and, like it, does not call it. Inference only: BatchNorms run in eval mode
on their stored statistics, the GRU is ``nn.GRU`` (cuDNN's on the card).

:class:`RMVPE` runs the frontend and the network on its device in float32
with TF32 off (a TF32 convolution moves the sigmoid, and with it the voicing
at threshold 0.03), and the cents decoding (local average or Viterbi) in
numpy on the host.
"""

from __future__ import annotations

import pathlib
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffsinger_tpu_torch.dsp.common import as_signal, interp_f0
from diffsinger_tpu_torch.dsp.mel import mel_filterbank
from diffsinger_tpu_torch.dsp.pe import BasePE
from diffsinger_tpu_torch.dsp.resample import resample
from diffsinger_tpu_torch.dsp.stft import stft_complex
from diffsinger_tpu_torch.utils import no_tf32, resolve_device
from diffsinger_tpu_torch.utils.infer_utils import resample_align_curve

SAMPLE_RATE = 16000
N_CLASS = 360
N_MELS = 128
MEL_FMIN = 30
MEL_FMAX = 8000
WINDOW_LENGTH = 1024
CONST = 1997.3794084376191


class ConvBlockRes(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, momentum: float = 0.01):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, (3, 3), padding=(1, 1), bias=False),
            nn.BatchNorm2d(out_channels, momentum=momentum),
            nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, (3, 3), padding=(1, 1), bias=False),
            nn.BatchNorm2d(out_channels, momentum=momentum),
            nn.ReLU(),
        )
        self.is_shortcut = in_channels != out_channels
        if self.is_shortcut:
            self.shortcut = nn.Conv2d(in_channels, out_channels, (1, 1))

    def forward(self, x):
        return self.conv(x) + (self.shortcut(x) if self.is_shortcut else x)


class ResEncoderBlock(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, n_blocks=1, momentum=0.01):
        super().__init__()
        self.conv = nn.ModuleList(
            [ConvBlockRes(in_channels, out_channels, momentum)]
            + [ConvBlockRes(out_channels, out_channels, momentum) for _ in range(n_blocks - 1)])
        self.kernel_size = kernel_size
        if kernel_size is not None:
            self.pool = nn.AvgPool2d(kernel_size=kernel_size)

    def forward(self, x):
        for block in self.conv:
            x = block(x)
        if self.kernel_size is not None:
            return x, self.pool(x)
        return x


class Encoder(nn.Module):
    def __init__(self, in_channels, in_size, n_encoders, kernel_size, n_blocks, out_channels=16,
                 momentum=0.01):
        super().__init__()
        self.bn = nn.BatchNorm2d(in_channels, momentum=momentum)
        self.layers = nn.ModuleList()
        self.latent_channels = []
        for _ in range(n_encoders):
            self.layers.append(ResEncoderBlock(in_channels, out_channels, kernel_size, n_blocks,
                                               momentum=momentum))
            self.latent_channels.append([out_channels, in_size])
            in_channels = out_channels
            out_channels *= 2
            in_size //= 2
        self.out_size = in_size
        self.out_channel = out_channels

    def forward(self, x):
        skips = []
        x = self.bn(x)
        for layer in self.layers:
            skip, x = layer(x)
            skips.append(skip)
        return x, skips


class Intermediate(nn.Module):
    def __init__(self, in_channels, out_channels, n_inters, n_blocks, momentum=0.01):
        super().__init__()
        self.layers = nn.ModuleList(
            [ResEncoderBlock(in_channels, out_channels, None, n_blocks, momentum)]
            + [ResEncoderBlock(out_channels, out_channels, None, n_blocks, momentum)
               for _ in range(n_inters - 1)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class ResDecoderBlock(nn.Module):
    def __init__(self, in_channels, out_channels, stride, n_blocks=1, momentum=0.01):
        super().__init__()
        out_padding = (0, 1) if tuple(stride) == (1, 2) else (1, 1)
        self.conv1 = nn.Sequential(
            nn.ConvTranspose2d(in_channels, out_channels, (3, 3), stride, padding=(1, 1),
                               output_padding=out_padding, bias=False),
            nn.BatchNorm2d(out_channels, momentum=momentum),
            nn.ReLU(),
        )
        self.conv2 = nn.ModuleList(
            [ConvBlockRes(out_channels * 2, out_channels, momentum)]
            + [ConvBlockRes(out_channels, out_channels, momentum) for _ in range(n_blocks - 1)])

    def forward(self, x, concat_tensor):
        x = torch.cat((self.conv1(x), concat_tensor), dim=1)
        for block in self.conv2:
            x = block(x)
        return x


class Decoder(nn.Module):
    def __init__(self, in_channels, n_decoders, stride, n_blocks, momentum=0.01):
        super().__init__()
        self.layers = nn.ModuleList()
        for _ in range(n_decoders):
            out_channels = in_channels // 2
            self.layers.append(ResDecoderBlock(in_channels, out_channels, stride, n_blocks,
                                               momentum))
            in_channels = out_channels

    def forward(self, x, skips):
        for i, layer in enumerate(self.layers):
            x = layer(x, skips[-1 - i])
        return x


class TimbreFilter(nn.Module):
    """The reference builds it in ``DeepUnet0``; ``DeepUnet0`` does not call it."""

    def __init__(self, latent_rep_channels):
        super().__init__()
        self.layers = nn.ModuleList([ConvBlockRes(c[0], c[0]) for c in latent_rep_channels])


class DeepUnet0(nn.Module):
    def __init__(self, kernel_size, n_blocks, en_de_layers=5, inter_layers=4, in_channels=1,
                 en_out_channels=16):
        super().__init__()
        self.encoder = Encoder(in_channels, 128, en_de_layers, kernel_size, n_blocks,
                               en_out_channels)
        self.intermediate = Intermediate(self.encoder.out_channel // 2, self.encoder.out_channel,
                                         inter_layers, n_blocks)
        self.tf = TimbreFilter(self.encoder.latent_channels)
        self.decoder = Decoder(self.encoder.out_channel, en_de_layers, kernel_size, n_blocks)

    def forward(self, x):
        x, skips = self.encoder(x)
        return self.decoder(self.intermediate(x), skips)


class BiGRU(nn.Module):
    def __init__(self, input_features, hidden_features, num_layers):
        super().__init__()
        self.gru = nn.GRU(input_features, hidden_features, num_layers=num_layers,
                          batch_first=True, bidirectional=True)

    def forward(self, x):
        return self.gru(x)[0]


class E2E0(nn.Module):
    """mel [B, N_MELS, T] -> sigmoid cents activations [B, T, N_CLASS]
    (reference model.py)."""

    def __init__(self, n_blocks, n_gru, kernel_size, en_de_layers=5, inter_layers=4,
                 in_channels=1, en_out_channels=16):
        super().__init__()
        self.unet = DeepUnet0(kernel_size, n_blocks, en_de_layers, inter_layers, in_channels,
                              en_out_channels)
        self.cnn = nn.Conv2d(en_out_channels, 3, (3, 3), padding=(1, 1))
        if n_gru:
            self.fc = nn.Sequential(BiGRU(3 * N_MELS, 256, n_gru), nn.Linear(512, N_CLASS),
                                    nn.Dropout(0.25), nn.Sigmoid())
        else:
            self.fc = nn.Sequential(nn.Linear(3 * N_MELS, N_CLASS), nn.Dropout(0.25), nn.Sigmoid())

    def forward(self, mel):
        x = mel.transpose(-1, -2).unsqueeze(1)                   # [B, 1, T, M]
        x = self.cnn(self.unet(x)).transpose(1, 2).flatten(-2)   # [B, T, 3 M]
        return self.fc(x)


# ---------------------------------------------------------------------------
# decoding (reference utils.py:8-43), numpy on the host
# ---------------------------------------------------------------------------


def to_local_average_f0(hidden: np.ndarray, center: Optional[np.ndarray] = None,
                        thred: float = 0.03) -> np.ndarray:
    """hidden: [T, N]; returns f0 [T] (0 where unvoiced)."""
    idx = np.arange(N_CLASS)[None, :]
    idx_cents = idx * 20 + CONST
    if center is None:
        center = np.argmax(hidden, axis=1, keepdims=True)
    start = np.clip(center - 4, 0, None)
    end = np.clip(center + 5, None, N_CLASS)
    mask = (idx >= start) & (idx < end)
    weights = hidden * mask
    product_sum = np.sum(weights * idx_cents, axis=1)
    weight_sum = np.sum(weights, axis=1)
    cents = product_sum / (weight_sum + (weight_sum == 0))
    f0 = 10 * 2 ** (cents / 1200)
    uv = hidden.max(axis=1) < thred
    return (f0 * ~uv).astype(np.float32)


def _viterbi(prob: np.ndarray, transition: np.ndarray) -> np.ndarray:
    """Log-domain Viterbi (librosa.sequence.viterbi equivalent).
    prob: [N, T] normalized observation probs; transition: [N, N] rows=from."""
    n, t = prob.shape
    log_p = np.log(np.maximum(prob, 1e-30))
    log_a = np.log(np.maximum(transition, 1e-30))
    value = np.zeros((t, n))
    ptr = np.zeros((t, n), dtype=np.int64)
    value[0] = log_p[:, 0] + np.log(1.0 / n)
    for i in range(1, t):
        trans = value[i - 1][:, None] + log_a  # [from, to]
        ptr[i] = np.argmax(trans, axis=0)
        value[i] = log_p[:, i] + trans[ptr[i], np.arange(n)]
    path = np.zeros(t, dtype=np.int64)
    path[-1] = np.argmax(value[-1])
    for i in range(t - 2, -1, -1):
        path[i] = ptr[i + 1, path[i + 1]]
    return path


def to_viterbi_f0(hidden: np.ndarray, thred: float = 0.03) -> np.ndarray:
    if not hasattr(to_viterbi_f0, "transition"):
        xx, yy = np.meshgrid(range(N_CLASS), range(N_CLASS))
        transition = np.maximum(30 - np.abs(xx - yy), 0).astype(np.float64)
        to_viterbi_f0.transition = transition / transition.sum(axis=1, keepdims=True)
    prob = hidden.T.astype(np.float64)
    prob = prob / prob.sum(axis=0)
    path = _viterbi(prob, to_viterbi_f0.transition)
    return to_local_average_f0(hidden, center=path[:, None], thred=thred)


# ---------------------------------------------------------------------------
# the extractor (reference inference.py:15-70)
# ---------------------------------------------------------------------------


class RMVPE(BasePE):
    """``pe: rmvpe``: the network on ``device`` (the card unless the caller
    names another) from the checkpoint at ``model_path`` (``{"model": state
    dict}``; a checkpoint that does not load raises). ``seconds`` sums the
    time in the network (frontend to the fetch of its activations) and in the
    decoding (host)."""

    def __init__(self, model_path, hop_length: int = 160, device=None):
        self._model_path = str(model_path)
        self.device = resolve_device(device)
        self.model = E2E0(4, 1, (2, 2))
        ckpt = torch.load(self._model_path, map_location="cpu", weights_only=False)
        self.model.load_state_dict(ckpt["model"], strict=True)
        self.model.eval().to(self.device)
        self.hop_length = hop_length
        self.mel_basis = torch.from_numpy(mel_filterbank(
            SAMPLE_RATE, WINDOW_LENGTH, N_MELS, MEL_FMIN, MEL_FMAX, htk=True)).to(self.device)
        self.window = torch.from_numpy((0.5 - 0.5 * np.cos(
            2 * np.pi * np.arange(WINDOW_LENGTH) / WINDOW_LENGTH)).astype(np.float32)).to(self.device)
        self.seconds = {"network": 0.0, "decode": 0.0}

    def provenance(self) -> str:
        return f"rmvpe({pathlib.Path(self._model_path).name})"

    @no_tf32()
    def mel(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, L] at 16 kHz -> log-mel [B, T, N_MELS] (periodic Hann of 1024,
        centre padding, HTK filters, log of the magnitude clamped at 1e-5)."""
        spec = stft_complex(audio, n_fft=WINDOW_LENGTH, hop=self.hop_length, win_size=WINDOW_LENGTH,
                            window=self.window, center=True).abs()
        return torch.log(torch.clamp(torch.einsum("mk,btk->btm", self.mel_basis, spec), min=1e-5))

    @torch.no_grad()
    @no_tf32()
    def activations(self, audio, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
        """The network's [T, N_CLASS] activations of a waveform [L] (a tensor
        on any device or an array), T frames of 10 ms, on the device."""
        audio = as_signal(audio, self.device)[None]
        if sample_rate != SAMPLE_RATE:
            audio = resample(audio, sample_rate, SAMPLE_RATE)
        mel = self.mel(audio)
        n_frames = mel.shape[1]
        mel = F.pad(mel, (0, 0, 0, 32 * ((n_frames - 1) // 32 + 1) - n_frames))
        return self.model(mel.transpose(1, 2))[0, :n_frames]

    def infer_from_audio(self, audio, sample_rate=SAMPLE_RATE, thred=0.03,
                         use_viterbi=False) -> np.ndarray:
        t0 = time.perf_counter()
        hidden = self.activations(audio, sample_rate).cpu().numpy()
        t1 = time.perf_counter()
        f0 = (to_viterbi_f0 if use_viterbi else to_local_average_f0)(hidden, thred=thred)
        self.seconds["network"] += t1 - t0
        self.seconds["decode"] += time.perf_counter() - t1
        return f0

    def get_pitch(self, waveform, samplerate, length, *, hop_size, f0_min=65, f0_max=1100,
                  speed=1, interp_uv=False, device=None):
        f0 = self.infer_from_audio(waveform, sample_rate=samplerate)
        uv = f0 == 0
        f0, uv = interp_f0(f0, uv)
        hop = int(np.round(hop_size * speed))
        time_step = hop / samplerate
        f0_res = resample_align_curve(f0, 0.01, time_step, length)
        uv_res = resample_align_curve(uv.astype(np.float32), 0.01, time_step, length) > 0.5
        if not interp_uv:
            f0_res[uv_res] = 0
        return f0_res, uv_res
