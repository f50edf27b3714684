"""Vocal-remover CascadedNet harmonic-noise separator (counterpart of
diffsinger_tpu/models/hnsep.py; reference modules/hnsep/vr/{nets,layers}.py).

Three stages of band-split U-Nets (``BaseNet``: strided encoders, an ASPP
block, bilinear decoders, a BiLSTM over frames) over the complex STFT give a
bounded complex mask, tanh(|m|) m / (|m| + 1e-8); the harmonic part is the
iSTFT of the masked spectrum. The modules carry the reference's names
(``stg1_low_band_net.0.*``, ``*.conv.{0,1}``, ``*.lstm_dec2.lstm.*``,
``out``, ``aux_out``), so its state dict loads with ``strict=True`` and the
JAX package's ``convert_cascaded_net`` reads the port's weights. Inference
only: BatchNorms run on their stored statistics.

:func:`predict_harmonic` runs the reference's ``predict_from_audio`` framing
on the waveform's device in float32 with TF32 off, and with cuDNN's
benchmark on: for the 3x3 convolution of 320 to 128 channels over 128 bins
and 168-240 frames (``stg2_low_band_net.0.dec3``, items of about 7.8-11.2 s
at hop 512) cuDNN's heuristics pick an engine that takes 200-250 ms and a
20.6 GiB workspace on an H100, where the benchmark finds one of 0.9 ms. The
benchmark runs once for each new padded length (the framing pads to
32-frame buckets) and costs 0.6-4 s there.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffsinger_tpu_torch.dsp.common import as_signal
from diffsinger_tpu_torch.dsp.stft import istft, stft_complex
from diffsinger_tpu_torch.utils import no_tf32


def crop_center(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Crop h1's frame axis (3) to h2's, centred (layers.py)."""
    if h1.shape[3] == h2.shape[3]:
        return h1
    if h1.shape[3] < h2.shape[3]:
        raise ValueError("h1_shape[3] must be greater than h2_shape[3]")
    s = (h1.shape[3] - h2.shape[3]) // 2
    return h1[:, :, :, s:s + h2.shape[3]]


class Conv2DBNActiv(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, dilation=1, activ=nn.ReLU):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nout, kernel_size=ksize, stride=stride, padding=pad,
                      dilation=dilation, bias=False),
            nn.BatchNorm2d(nout),
            activ(),
        )

    def forward(self, x):
        return self.conv(x)


class Encoder(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, activ=nn.LeakyReLU):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, stride, pad, activ=activ)
        self.conv2 = Conv2DBNActiv(nout, nout, ksize, 1, pad, activ=activ)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class Decoder(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, activ=nn.ReLU, dropout=False):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, 1, pad, activ=activ)
        self.dropout = nn.Dropout2d(0.1) if dropout else None

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        if skip is not None:
            x = torch.cat([x, crop_center(skip, x)], dim=1)
        h = self.conv1(x)
        return self.dropout(h) if self.dropout is not None else h


class ASPPModule(nn.Module):
    """Dilations are (freq, time) pairs (BaseNet's ((4,2),(8,4),(12,6)))."""

    def __init__(self, nin, nout, dilations=((4, 2), (8, 4), (12, 6)), activ=nn.ReLU,
                 dropout=False):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d((1, None)),
                                   Conv2DBNActiv(nin, nout, 1, 1, 0, activ=activ))
        self.conv2 = Conv2DBNActiv(nin, nout, 1, 1, 0, activ=activ)
        self.conv3 = Conv2DBNActiv(nin, nout, 3, 1, dilations[0], dilations[0], activ=activ)
        self.conv4 = Conv2DBNActiv(nin, nout, 3, 1, dilations[1], dilations[1], activ=activ)
        self.conv5 = Conv2DBNActiv(nin, nout, 3, 1, dilations[2], dilations[2], activ=activ)
        self.bottleneck = Conv2DBNActiv(nout * 5, nout, 1, 1, 0, activ=activ)
        self.dropout = nn.Dropout2d(0.1) if dropout else None

    def forward(self, x):
        h = x.shape[2]
        # the reference's bilinear resize of a one-bin map to h bins is a repeat
        feat1 = self.conv1(x).expand(-1, -1, h, -1)
        out = torch.cat([feat1, self.conv2(x), self.conv3(x), self.conv4(x), self.conv5(x)], dim=1)
        out = self.bottleneck(out)
        return self.dropout(out) if self.dropout is not None else out


class LSTMModule(nn.Module):
    def __init__(self, nin_conv, nin_lstm, nout_lstm):
        super().__init__()
        self.conv = Conv2DBNActiv(nin_conv, 1, 1, 1, 0)
        self.lstm = nn.LSTM(input_size=nin_lstm, hidden_size=nout_lstm // 2, bidirectional=True)
        self.dense = nn.Sequential(nn.Linear(nout_lstm, nin_lstm), nn.BatchNorm1d(nin_lstm),
                                   nn.ReLU())

    def forward(self, x):
        n, _, nbins, nframes = x.shape
        h = self.conv(x)[:, 0].permute(2, 0, 1)        # [frames, N, bins]
        h, _ = self.lstm(h)
        h = self.dense(h.reshape(-1, h.shape[-1]))     # [frames * N, bins]
        return h.reshape(nframes, n, 1, nbins).permute(1, 2, 3, 0)


class BaseNet(nn.Module):
    def __init__(self, nin, nout, nin_lstm, nout_lstm, dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.enc1 = Conv2DBNActiv(nin, nout, 3, 1, 1)
        self.enc2 = Encoder(nout, nout * 2, 3, 2, 1)
        self.enc3 = Encoder(nout * 2, nout * 4, 3, 2, 1)
        self.enc4 = Encoder(nout * 4, nout * 6, 3, 2, 1)
        self.enc5 = Encoder(nout * 6, nout * 8, 3, 2, 1)
        self.aspp = ASPPModule(nout * 8, nout * 8, dilations, dropout=True)
        self.dec4 = Decoder(nout * (6 + 8), nout * 6, 3, 1, 1)
        self.dec3 = Decoder(nout * (4 + 6), nout * 4, 3, 1, 1)
        self.dec2 = Decoder(nout * (2 + 4), nout * 2, 3, 1, 1)
        self.lstm_dec2 = LSTMModule(nout * 2, nin_lstm, nout_lstm)
        self.dec1 = Decoder(nout * (1 + 2) + 1, nout * 1, 3, 1, 1)

    def forward(self, x):
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        h = self.aspp(e5)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        h = torch.cat([h, self.lstm_dec2(h)], dim=1)
        return self.dec1(h, e1)


class CascadedNet(nn.Module):
    """Complex spectrum [B, C, n_fft//2+1, frames] -> complex mask of the
    same shape (nets.py). C is 2 (stereo) or 1 (``is_mono``)."""

    def __init__(self, n_fft, hop_length, nout=32, nout_lstm=128, is_complex=True,
                 is_mono=False):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.is_complex = is_complex
        self.is_mono = is_mono
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.nin_lstm = self.max_bin // 2
        self.offset = 64
        nin = (4 if is_complex else 2) // (2 if is_mono else 1)
        self.stg1_low_band_net = nn.Sequential(
            BaseNet(nin, nout // 2, self.nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout // 2, nout // 4, 1, 1, 0))
        self.stg1_high_band_net = BaseNet(nin, nout // 4, self.nin_lstm // 2, nout_lstm // 2)
        self.stg2_low_band_net = nn.Sequential(
            BaseNet(nout // 4 + nin, nout, self.nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout, nout // 2, 1, 1, 0))
        self.stg2_high_band_net = BaseNet(nout // 4 + nin, nout // 2, self.nin_lstm // 2,
                                          nout_lstm // 2)
        self.stg3_full_band_net = BaseNet(3 * nout // 4 + nin, nout, self.nin_lstm, nout_lstm)
        self.out = nn.Conv2d(nout, nin, 1, bias=False)
        self.aux_out = nn.Conv2d(3 * nout // 4, nin, 1, bias=False)  # training only

    def forward(self, x):
        if self.is_complex:
            x = torch.cat([x.real, x.imag], dim=1)
        x = x[:, :, :self.max_bin]
        bandw = x.shape[2] // 2
        l1_in, h1_in = x[:, :, :bandw], x[:, :, bandw:]
        l1 = self.stg1_low_band_net(l1_in)
        h1 = self.stg1_high_band_net(h1_in)
        aux1 = torch.cat([l1, h1], dim=2)
        l2 = self.stg2_low_band_net(torch.cat([l1_in, l1], dim=1))
        h2 = self.stg2_high_band_net(torch.cat([h1_in, h1], dim=1))
        aux2 = torch.cat([l2, h2], dim=2)
        f3 = self.stg3_full_band_net(torch.cat([x, aux1, aux2], dim=1))
        mask = self.out(f3)
        if self.is_complex:
            half = mask.shape[1] // 2
            mask = torch.complex(mask[:, :half], mask[:, half:])
            mag = mask.abs()
            mask = torch.tanh(mag) * mask / (mag + 1e-8)
        else:
            mask = torch.sigmoid(mask)
        # the top bin by replication
        return torch.cat([mask, mask[:, :, -1:].expand(-1, -1, self.output_bin - mask.shape[2], -1)],
                         dim=2)


_SEP_CACHE = {}


def load_sep_model(model_path, device: torch.device):
    """CascadedNet and its ``config.yaml`` (beside the checkpoint: n_fft,
    hop_length, n_out, n_out_lstm, is_mono) on ``device``, cached by path and
    device. A checkpoint that does not load raises."""
    import yaml

    key = (str(pathlib.Path(model_path).resolve()), str(device))
    if key not in _SEP_CACHE:
        with open(pathlib.Path(model_path).with_name("config.yaml")) as f:
            args = yaml.safe_load(f)
        model = CascadedNet(args["n_fft"], args["hop_length"], args["n_out"], args["n_out_lstm"],
                            True, is_mono=args["is_mono"])
        model.load_state_dict(torch.load(model_path, map_location="cpu", weights_only=False),
                              strict=True)
        window = torch.from_numpy(np.hanning(args["n_fft"] + 1)[:-1].astype(np.float32))
        _SEP_CACHE[key] = (model.eval().to(device), window.to(device))
    return _SEP_CACHE[key]


@torch.no_grad()
@torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False, allow_tf32=False)
@no_tf32()
def predict_harmonic(model_path, waveform, device=None) -> torch.Tensor:
    """The harmonic part [L] of a waveform (a tensor, separated on its device,
    or an array, sent to ``device``): the reference's ``predict_from_audio``
    (pad to 32 k - 1 frames a hop, STFT, mask, iSTFT, crop); a mono input is
    repeated to the model's two channels and the two outputs averaged."""
    x = as_signal(waveform, device)
    model, window = load_sep_model(model_path, x.device)
    n_fft, hop = model.n_fft, model.hop_length
    t = x.shape[0]
    n_frames = t // hop + 1
    t_pad = (32 * (n_frames // 32 + 1) - 1) * hop - t
    tl_pad = t_pad // 2 // hop * hop
    stft = dict(n_fft=n_fft, hop=hop, win_size=n_fft, window=window, center=True)
    spec = stft_complex(F.pad(x, (tl_pad, t_pad - tl_pad))[None], **stft)   # [1, F, K]
    spec = spec.transpose(1, 2)[:, None]                                      # [1, 1, K, F]
    if not model.is_mono:
        spec = torch.cat([spec, spec], dim=1)
    pred = (spec * model(spec)).mean(dim=1)                                   # [1, K, F]
    out = istft(pred.transpose(1, 2), **stft)[0, tl_pad:tl_pad + t]
    return F.pad(out, (0, t - out.shape[0]))
