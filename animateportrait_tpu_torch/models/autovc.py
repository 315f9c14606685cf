"""AutoVC voice-normalization generator. Port of
``animateportrait_tpu/models/autovc.py`` with the reference's module
layout (Module1/src/autovc/retrain_version/model_vc_37_1.py:165-200), so
its state-dict keys are the reference checkpoint's.

Sequences are (B, T, C) at the module boundary, as in the JAX package; the
convs run on (B, C, T) inside. T must be a multiple of ``freq`` (the
pipeline pads chunks to a multiple of 32).
"""
from __future__ import annotations

import torch
import torch.nn as nn

DIM_FREQ = 80
DIM_F0 = 257
DIM_ENC = 512
DIM_DEC = 512
NUM_GRP = 32


class ConvNorm(nn.Module):
    """The reference's ConvNorm: a Conv1d(k5, pad 2) under ``.conv``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, 5, padding=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class AutoVCEncoder(nn.Module):
    """3 x (Conv1d + GroupNorm32 + ReLU) -> 2-layer BiLSTM -> codes
    (B, T//freq, 2*dim_neck)."""

    def __init__(self, dim_neck: int = 16, dim_emb: int = 256,
                 freq: int = 16):
        super().__init__()
        self.dim_neck, self.freq = dim_neck, freq
        self.convolutions = nn.ModuleList([
            nn.Sequential(ConvNorm(DIM_FREQ + dim_emb if i == 0 else DIM_ENC,
                                   DIM_ENC),
                          nn.GroupNorm(NUM_GRP, DIM_ENC))
            for i in range(3)])
        self.lstm = nn.LSTM(DIM_ENC, dim_neck, 2, batch_first=True,
                            bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        for conv in self.convolutions:
            x = torch.relu(conv(x))
        out, _ = self.lstm(x.transpose(1, 2))
        B, T = out.shape[:2]
        nblk = T // self.freq
        fwd = out[..., :self.dim_neck].reshape(B, nblk, self.freq, -1)
        bwd = out[..., self.dim_neck:].reshape(B, nblk, self.freq, -1)
        # forward stream at block ends, backward at block starts
        return torch.cat([fwd[:, :, -1], bwd[:, :, 0]], dim=-1)


class LinearNorm(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear_layer = nn.Linear(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_layer(x)


class AutoVCDecoder(nn.Module):
    """3-layer LSTM(512) + projection to 80 mel bins."""

    def __init__(self, dim_neck: int = 16, dim_emb: int = 256):
        super().__init__()
        self.lstm = nn.LSTM(dim_neck * 2 + dim_emb + DIM_F0, DIM_DEC, 3,
                            batch_first=True)
        self.linear_projection = LinearNorm(DIM_DEC, DIM_FREQ)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, _ = self.lstm(x)
        return self.linear_projection(out)


class AutoVCPostnet(nn.Module):
    """5 x (Conv1d + GroupNorm) residual refiner, tanh between."""

    def __init__(self):
        super().__init__()
        chans = [(DIM_FREQ, 512), (512, 512), (512, 512), (512, 512),
                 (512, DIM_FREQ)]
        self.convolutions = nn.ModuleList([
            nn.Sequential(ConvNorm(i, o),
                          nn.GroupNorm(NUM_GRP if o == 512 else 5, o))
            for i, o in chans])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        for conv in self.convolutions[:-1]:
            x = torch.tanh(conv(x))
        return self.convolutions[-1](x).transpose(1, 2)


class AutoVCGenerator(nn.Module):
    """forward(mel (B,T,80), spk_src (B,256), spk_trg (B,256),
    f0_onehot (B,T,257)) -> (mel_dec, mel_postnet, codes_flat)."""

    def __init__(self, dim_neck: int = 16, dim_emb: int = 256,
                 freq: int = 16):
        super().__init__()
        self.dim_emb, self.freq = dim_emb, freq
        self.encoder = AutoVCEncoder(dim_neck, dim_emb, freq)
        self.decoder = AutoVCDecoder(dim_neck, dim_emb)
        self.postnet = AutoVCPostnet()

    def forward(self, mel, spk_src, spk_trg, f0_onehot):
        B, T = mel.shape[:2]
        src = spk_src[:, None, :].expand(B, T, self.dim_emb)
        codes = self.encoder(torch.cat([mel, src], dim=-1))
        code_exp = torch.repeat_interleave(codes, self.freq, dim=1)
        trg = spk_trg[:, None, :].expand(B, T, self.dim_emb)
        mel_dec = self.decoder(torch.cat([code_exp, trg, f0_onehot], dim=-1))
        mel_post = mel_dec + self.postnet(mel_dec)
        return mel_dec, mel_post, codes.reshape(B, -1)
