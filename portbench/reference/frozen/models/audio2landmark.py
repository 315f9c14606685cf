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

from portbench.reference.frozen.nn import BatchNorm1d

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
    hidden 256, 3 LSTM layers). forward(au (N,18,80), face_id (1|N,204)).
    In training mode (``.train()``) its BatchNorms take flax's batch
    statistics, as the JAX module's ``train=True``."""

    def __init__(self, num_window_frames: int = 18, in_size: int = 80,
                 hidden_size: int = 256, num_layers: int = 3):
        super().__init__()
        self.in_size = in_size
        self.fc_prior = nn.Sequential(
            nn.Linear(in_size, 256), BatchNorm1d(256), nn.LeakyReLU(0.2),
            nn.Linear(256, AUDIO_FEAT_SIZE))
        self.bilstm = nn.LSTM(AUDIO_FEAT_SIZE, hidden_size, num_layers,
                              batch_first=True)
        self.fc = nn.Sequential(
            nn.Linear(hidden_size + FACE_ID_FEAT_SIZE, 512),
            BatchNorm1d(512), nn.LeakyReLU(0.2), nn.Linear(512, 256),
            BatchNorm1d(256), nn.LeakyReLU(0.2),
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
        return self.attend(self.q_linear(q), self.k_linear(k),
                           self.v_linear(v))

    def attend(self, q, k, v):
        """The heads' attention of projected queries, keys and values,
        through the output projection (the sequence-parallel pos projects
        its keys and values before it gathers them)."""
        bs, dk = q.shape[0], self.d_model // self.heads

        def split(t):
            return t.reshape(bs, -1, self.heads, dk).transpose(1, 2)

        qh, kh, vh = split(q), split(k), split(v)
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
    sequence (batch 1), as the reference's ``comb_encode.unsqueeze(0)``.
    With a leading batch (au (B,T,18,80), emb (B,T,256), face_id
    (B,*,204), z (B,T,128)) each of the B segments is its own sequence."""

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
        lead = au.shape[:-3]
        a, _ = self.audio_content_encoder(au.reshape(-1, *au.shape[-2:]))
        spk = self.spk_emb_encoder(emb)
        comb = torch.cat([a[:, -1, :].reshape(*z.shape[:-1], -1), spk, z],
                         dim=-1)
        seqs = self.encoder(comb.reshape(-1, *comb.shape[-2:]))
        e_out = torch.cat([seqs.reshape(*lead, *seqs.shape[-2:]), z], dim=-1)
        return self.out(e_out), face_id[..., 0:1, :], spk


class Audio2landmarkSpeakerAware(nn.Module):
    """The speaker-aware branch with its head-pose head (pos_dim 7:
    quaternion + translation), the speaker-branch trainer's net. The JAX
    module reconciles the reference's drifted trainer and model (SURVEY.md
    2.13): the pos branch's audio encoder and speaker MLP, one transformer
    encoder over the segment (batch 1), a face-id-conditioned landmark head
    (``fls_out``) and the pose head (``pos_out``).

    forward(au (T,18,80), emb (T,256), face_id (1|T,204), add_z_spk,
    z, generator) -> (fl_pred (T,204), pos_pred (T,pos_dim), face_id[0:1],
    spk_encode). With ``add_z_spk`` the speaker code takes 0.01 z, where z
    (T,128) is the given unit normal draw or one drawn from ``generator``
    (the JAX module draws it from its ``z_spk`` rng)."""

    def __init__(self, spk_emb_enc_size: int = 128,
                 transformer_d_model: int = 32, N: int = 2, heads: int = 2,
                 pos_dim: int = 7):
        super().__init__()
        d_model = transformer_d_model * heads
        self.audio_content_encoder = nn.LSTM(80, 256, 3, batch_first=True)
        self.spk_emb_encoder = nn.Sequential(
            nn.Linear(256, 256), nn.LeakyReLU(0.02), nn.Linear(256, 128),
            nn.LeakyReLU(0.02), nn.Linear(128, spk_emb_enc_size))
        self.encoder = Encoder(256 + spk_emb_enc_size, d_model, N, heads)
        self.fls_out = nn.Sequential(
            nn.Linear(d_model + FACE_ID_FEAT_SIZE, 512), nn.LeakyReLU(0.02),
            nn.Linear(512, 256), nn.LeakyReLU(0.02),
            nn.Linear(256, FACE_ID_FEAT_SIZE))
        self.pos_out = nn.Sequential(
            nn.Linear(d_model, 32), nn.LeakyReLU(0.02), nn.Linear(32, 16),
            nn.LeakyReLU(0.02), nn.Linear(16, pos_dim))

    def forward(self, au, emb, face_id, add_z_spk: bool = False,
                z: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        a, _ = self.audio_content_encoder(au)
        spk = self.spk_emb_encoder(emb)
        if add_z_spk:
            if z is None:
                z = torch.randn(spk.shape, generator=generator,
                                device=spk.device, dtype=spk.dtype)
            spk = spk + z * 0.01
        e_out = self.encoder(torch.cat([a[:, -1, :], spk], dim=1)[None])[0]
        face_id_t = face_id.expand(e_out.shape[0], face_id.shape[1]) \
            if face_id.shape[0] == 1 else face_id
        fl_pred = self.fls_out(torch.cat([e_out, face_id_t], dim=1))
        return fl_pred, self.pos_out(e_out), face_id[0:1, :], spk


def _head(cin: int) -> nn.Sequential:
    """The discriminators' Linear(cin, 512) - LeakyReLU(0.02) - Linear(512,
    256) - LeakyReLU(0.02) - Linear(256, 1)."""
    return nn.Sequential(
        nn.Linear(cin, 512), nn.LeakyReLU(0.02), nn.Linear(512, 256),
        nn.LeakyReLU(0.02), nn.Linear(256, 1))


def _windows(feat: torch.Tensor, win_size: int, win_step: int
             ) -> torch.Tensor:
    """The reference's training windows of a sequence (T, F), as one gather
    -> (n_win, w, F): w = T - 1 when T <= win_size, else win_size; the
    windows start at 0 .. T - w - 1 and take every ``win_step``-th frame
    of their w."""
    T = feat.shape[0]
    w = T - 1 if T <= win_size else win_size
    idx = (torch.arange(T - w, device=feat.device)[:, None]
           + torch.arange(0, w, win_step, device=feat.device)[None, :])
    return feat[idx]


class DiscriminatorMLP(nn.Module):
    """Frame-wise landmark discriminator (TalkingToon_spk2res_lstmgan_DL,
    model_audio2landmark.py:409-424): feat (N, 204) -> (N, 1)."""

    def __init__(self):
        super().__init__()
        self.fl_DL = _head(FACE_ID_FEAT_SIZE)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self.fl_DL(feat)


class TransformerDT(nn.Module):
    """Windowed transformer discriminator over a landmark sequence
    (Transformer_DT, :427-450): forward(fls (T, 204), spk_emb (T, 128))
    -> (n_win, 1). Each window (``_windows``) is one sequence of the
    ``Encoder``, max-pooled over its frames."""

    def __init__(self, transformer_d_model: int = 32, N: int = 2,
                 heads: int = 2, spk_emb_enc_size: int = 128):
        super().__init__()
        d_model = transformer_d_model * heads
        self.encoder = Encoder(FACE_ID_FEAT_SIZE + spk_emb_enc_size, d_model,
                               N, heads)
        self.out = _head(d_model)

    def forward(self, fls: torch.Tensor, spk_emb: torch.Tensor,
                win_size: int = 64, win_step: int = 1) -> torch.Tensor:
        d_in = _windows(torch.cat([fls, spk_emb], dim=1), win_size, win_step)
        return self.out(self.encoder(d_in).amax(dim=1))


class DiscriminatorGRU(nn.Module):
    """GRU temporal discriminator (TalkingToon_spk2res_lstmgan_DT,
    :453-490): forward(comb_encode (T, comb_emb_size), fls (T, 204)) ->
    (n_win, 1). A max-pool over 4 frames (stride 1), the windows of the
    T - 3 pooled frames (``_windows``), a 3-layer GRU, its last output."""

    def __init__(self, comb_emb_size: int = 256, hidden: int = 256):
        super().__init__()
        self.fl_DT = nn.GRU(comb_emb_size + FACE_ID_FEAT_SIZE, hidden, 3,
                            batch_first=True)
        self.projection = _head(hidden)

    def forward(self, comb_encode: torch.Tensor, fls: torch.Tensor,
                win_size: int = 32, win_step: int = 1) -> torch.Tensor:
        feat = torch.cat([comb_encode, fls], dim=1)
        pooled = F.max_pool1d(feat.T[None], 4, 1)[0].T
        out, _ = self.fl_DT(_windows(pooled, win_size, win_step))
        return self.projection(out[:, -1, :])
