"""Audio -> landmark nets (content and speaker/pos branches). Port of
``animateportrait_tpu/models/audio2landmark.py`` with the reference's
module layout (Module1/src/models/model_audio2landmark.py), so the
state-dict keys are the reference checkpoints'.

Reference quirks kept (they change numerics):
- the positional-encoding table uses exponents 2i and 2(i+1) (:109-115);
- ``Norm`` divides by (unbiased std + eps), not sqrt(var + eps) (:197-210);
- the feed-forward width is 2048 although d_model is 64 (:184-194).
Attention is plain matmul + softmax.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FACE_ID_FEAT_SIZE = 204
AUDIO_FEAT_SIZE = 161


def positional_encoding_table(d_model: int, max_seq_len: int = 512
                              ) -> np.ndarray:
    """The reference PE table with its nonstandard exponents."""
    pe = np.zeros((max_seq_len, d_model), np.float32)
    pos = np.arange(max_seq_len, dtype=np.float64)[:, None]
    i = np.arange(0, d_model, 2, dtype=np.float64)[None, :]
    pe[:, 0::2] = np.sin(pos / (10000.0 ** (2.0 * i / d_model)))
    pe[:, 1::2] = np.cos(pos / (10000.0 ** (2.0 * (i + 1) / d_model)))
    return pe


class Audio2landmarkContent(nn.Module):
    """18-frame audio window -> 204-d landmark displacement (use_prior_net,
    hidden 256, 3 LSTM layers). forward(au (N,18,80), face_id (1|N,204))."""

    def __init__(self, num_window_frames: int = 18, in_size: int = 80,
                 hidden_size: int = 256, num_layers: int = 3):
        super().__init__()
        self.in_size = in_size
        self.fc_prior = nn.Sequential(
            nn.Linear(in_size, 256), nn.BatchNorm1d(256), nn.LeakyReLU(0.2),
            nn.Linear(256, AUDIO_FEAT_SIZE))
        self.bilstm = nn.LSTM(AUDIO_FEAT_SIZE, hidden_size, num_layers,
                              batch_first=True)
        self.fc = nn.Sequential(
            nn.Linear(hidden_size + FACE_ID_FEAT_SIZE, 512),
            nn.BatchNorm1d(512), nn.LeakyReLU(0.2), nn.Linear(512, 256),
            nn.BatchNorm1d(256), nn.LeakyReLU(0.2),
            nn.Linear(256, FACE_ID_FEAT_SIZE))

    def forward(self, au: torch.Tensor, face_id: torch.Tensor):
        N, W = au.shape[:2]
        x = self.fc_prior(au.reshape(N * W, self.in_size))
        out, _ = self.bilstm(x.reshape(N, W, AUDIO_FEAT_SIZE))
        out = out[:, -1, :]
        if face_id.shape[0] == 1:
            face_id = face_id.expand(N, face_id.shape[1])
        return self.fc(torch.cat([out, face_id], dim=1)), face_id


class Embedder(nn.Module):
    def __init__(self, cin: int, d_model: int):
        super().__init__()
        self.embed = nn.Linear(cin, d_model)

    def forward(self, x):
        return self.embed(x)


class PositionalEncoder(nn.Module):
    def __init__(self, d_model: int, max_seq_len: int = 512):
        super().__init__()
        self.d_model = d_model
        self.register_buffer(
            "pe", torch.from_numpy(positional_encoding_table(
                d_model, max_seq_len))[None], persistent=False)

    def forward(self, x):
        return x * math.sqrt(self.d_model) + self.pe[:, :x.shape[1]]


class Norm(nn.Module):
    """alpha * (x - mean) / (unbiased std + eps) + bias."""

    def __init__(self, d_model: int, eps: float = 1e-6):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(d_model))
        self.bias = nn.Parameter(torch.zeros(d_model))
        self.eps = eps

    def forward(self, x):
        return (self.alpha * (x - x.mean(dim=-1, keepdim=True))
                / (x.std(dim=-1, keepdim=True) + self.eps) + self.bias)


class MultiHeadAttention(nn.Module):
    def __init__(self, heads: int, d_model: int):
        super().__init__()
        self.heads, self.d_model = heads, d_model
        self.q_linear = nn.Linear(d_model, d_model)
        self.v_linear = nn.Linear(d_model, d_model)
        self.k_linear = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q, k, v):
        bs, dk = q.shape[0], self.d_model // self.heads

        def split(t):
            return t.reshape(bs, -1, self.heads, dk).transpose(1, 2)

        qh = split(self.q_linear(q))
        kh = split(self.k_linear(k))
        vh = split(self.v_linear(v))
        scores = F.softmax(qh @ kh.transpose(-2, -1) / math.sqrt(dk), dim=-1)
        o = (scores @ vh).transpose(1, 2).reshape(bs, -1, self.d_model)
        return self.out(o)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int = 2048):
        super().__init__()
        self.linear_1 = nn.Linear(d_model, d_ff)
        self.linear_2 = nn.Linear(d_ff, d_model)

    def forward(self, x):
        return self.linear_2(F.relu(self.linear_1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.norm_1, self.norm_2 = Norm(d_model), Norm(d_model)
        self.attn = MultiHeadAttention(heads, d_model)
        self.ff = FeedForward(d_model)

    def forward(self, x):
        x2 = self.norm_1(x)
        x = x + self.attn(x2, x2, x2)
        return x + self.ff(self.norm_2(x))


class Encoder(nn.Module):
    """embed -> scaled PE -> N layers -> Norm."""

    def __init__(self, cin: int, d_model: int, N: int, heads: int):
        super().__init__()
        self.embed = Embedder(cin, d_model)
        self.pe = PositionalEncoder(d_model)
        self.layers = nn.ModuleList([EncoderLayer(d_model, heads)
                                     for _ in range(N)])
        self.norm = Norm(d_model)

    def forward(self, x):
        x = self.pe(self.embed(x))
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class Audio2landmarkPos(nn.Module):
    """Speaker-aware position branch. forward(au (T,18,80), emb (T,256),
    face_id (*,204), z (T,128)): the whole segment is ONE transformer
    sequence (batch 1), as the reference's ``comb_encode.unsqueeze(0)``."""

    def __init__(self, audio_feat_size: int = 80, c_enc_hidden_size: int = 256,
                 num_layers: int = 3, spk_emb_enc_size: int = 128,
                 transformer_d_model: int = 32, N: int = 2, heads: int = 2,
                 z_size: int = 128):
        super().__init__()
        d_model = transformer_d_model * heads
        self.audio_content_encoder = nn.LSTM(
            audio_feat_size, c_enc_hidden_size, num_layers, batch_first=True)
        self.spk_emb_encoder = nn.Sequential(
            nn.Linear(256, 256), nn.LeakyReLU(0.02), nn.Linear(256, 128),
            nn.LeakyReLU(0.02), nn.Linear(128, spk_emb_enc_size))
        self.encoder = Encoder(c_enc_hidden_size + spk_emb_enc_size + z_size,
                               d_model, N, heads)
        self.out = nn.Sequential(
            nn.Linear(d_model + z_size, 512), nn.LeakyReLU(0.02),
            nn.Linear(512, 256), nn.LeakyReLU(0.02),
            nn.Linear(256, FACE_ID_FEAT_SIZE))

    def forward(self, au, emb, face_id, z):
        a, _ = self.audio_content_encoder(au)
        spk = self.spk_emb_encoder(emb)
        comb = torch.cat([a[:, -1, :], spk, z], dim=1)
        e_out = torch.cat([self.encoder(comb[None])[0], z], dim=1)
        return self.out(e_out), face_id[0:1], spk
