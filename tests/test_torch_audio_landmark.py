"""The audio front end and the landmark predictor of the PyTorch port
against the JAX package: AutoVC and the two landmark nets on shared
weights, the post-chain steps, and both stages end to end on a short
synthetic speech clip. Bound: max |diff| <= 1e-4 in fp32 unless stated."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models.audio2landmark import (
    Audio2landmarkContent, Audio2landmarkPos)
from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
from animateportrait_tpu.utils.smoke import random_variables
from torch_port_helpers import maxdiff

K = jax.random.key(0)


def _autovc():
    from animateportrait_tpu.models.autovc import AutoVCGenerator as J

    v = random_variables(lambda: J().init(K, jnp.zeros((1, 32, 80)),
                                  jnp.zeros((1, 256)), jnp.zeros((1, 256)),
                                  jnp.zeros((1, 32, 257))))
    t = AutoVCGenerator()
    t.load_state_dict(from_jax.autovc_state_dict(v))
    return J(), v, t.eval()


def _landmark_nets():
    from animateportrait_tpu.models import audio2landmark as ja

    rng = np.random.default_rng(7)
    pos_v = random_variables(lambda: ja.Audio2landmarkPos().init(
        K, jnp.zeros((4, 18, 80)), jnp.zeros((4, 256)), jnp.zeros((1, 204)),
        jnp.zeros((4, 128))), seed=1)
    cont_v = random_variables(lambda: ja.Audio2landmarkContent().init(
        K, jnp.zeros((4, 18, 80)), jnp.zeros((1, 204))), seed=2)
    # non-trivial BatchNorm statistics
    cont_v = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape).astype(a.dtype)
                      if "var" in str(p[-1]) else
                      rng.uniform(-0.5, 0.5, a.shape).astype(a.dtype)
                      if "mean" in str(p[-1]) else a), cont_v)
    pos, content = Audio2landmarkPos(), Audio2landmarkContent()
    pos.load_state_dict(from_jax.pos_state_dict(pos_v))
    content.load_state_dict(from_jax.content_state_dict(cont_v))
    return pos_v, cont_v, pos.eval(), content.eval()


def test_autovc_matches_jax():
    jm, v, tm = _autovc()
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 64, 80)).astype(np.float32)
    spk = rng.standard_normal((2, 256)).astype(np.float32)
    f0 = np.eye(257, dtype=np.float32)[rng.integers(0, 257, (2, 64))]
    ref = jm.apply(v, *(jnp.asarray(a) for a in (mel, spk, spk, f0)))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (mel, spk, spk, f0)))
    for a, b in zip(got, ref):
        assert maxdiff(a, b) <= 1e-4


def test_landmark_nets_match_jax():
    from animateportrait_tpu.models import audio2landmark as ja

    pos_v, cont_v, pos, content = _landmark_nets()
    rng = np.random.default_rng(1)
    T = 24
    au = rng.standard_normal((T, 18, 80)).astype(np.float32)
    emb = np.tile(rng.standard_normal((1, 256)).astype(np.float32), (T, 1))
    z = np.zeros((T, 128), np.float32)
    fid = rng.standard_normal((1, 204)).astype(np.float32)
    ref, _, ref_spk = ja.Audio2landmarkPos().apply(
        pos_v, *(jnp.asarray(a) for a in (au, emb, fid, z)))
    ref_c, _ = ja.Audio2landmarkContent().apply(
        cont_v, jnp.asarray(au), jnp.asarray(fid))
    with torch.no_grad():
        got, _, spk = pos(*(torch.from_numpy(a) for a in (au, emb, fid, z)))
        got_c, _ = content(torch.from_numpy(au), torch.from_numpy(fid))
    assert maxdiff(got, ref) <= 1e-4
    assert maxdiff(spk, ref_spk) <= 1e-4
    assert maxdiff(got_c, ref_c) <= 1e-4


def _lips_with_inversions(T=40, seed=3):
    """(T, 204) faces whose inner lip is flipped (negative area) on runs of
    frames, including frame 0 and consecutive frames."""
    from animateportrait_tpu.utils import assets

    rng = np.random.default_rng(seed)
    base = assets.std_face_landmarks().astype(np.float32)
    fl = np.repeat(base[None], T, 0) + rng.normal(0, 0.02, (T, 68, 3))
    flip = np.zeros(T, bool)
    flip[[0, 3, 4, 5, 9, 20, 21, 39]] = True
    fl[flip, 60:68, 1] = -fl[flip, 60:68, 1] + 2 * fl[flip, 60:68, 1].mean()
    return fl.reshape(T, 204).astype(np.float32)


def test_post_chain_steps_match_jax():
    from animateportrait_tpu.ops.geometry import area_of_signed_polygon
    from animateportrait_tpu.pipeline import landmark as jl
    from animateportrait_tpu_torch.pipeline import landmark as tl

    fl = _lips_with_inversions()
    areas = np.asarray(area_of_signed_polygon(
        jnp.asarray(fl.reshape(-1, 68, 3)[:, 60:68, :2])))
    assert (areas < 0).sum() >= 5 and areas[0] < 0   # the fix is exercised
    f = torch.from_numpy(fl)
    # the running-maximum form associates sums differently from the scan
    assert maxdiff(tl.solve_inverse_lip(f),
                   jl.solve_inverse_lip(jnp.asarray(fl))) <= 1e-5
    assert maxdiff(tl.close_mouth_blend(f.reshape(-1, 68, 3)),
                   jl.close_mouth_blend(jnp.asarray(fl).reshape(-1, 68, 3))
                   ) <= 1e-6
    assert maxdiff(tl.calibrate_content(f, 2.0, 1.5),
                   jl.calibrate_content(jnp.asarray(fl), 2.0, 1.5)) <= 1e-6
    assert maxdiff(tl.revise_nose_top(f),
                   jl.revise_nose_top(jnp.asarray(fl))) == 0.0
    au = np.random.default_rng(0).standard_normal((40, 80))
    np.testing.assert_array_equal(tl.sliding_windows(au),
                                  jl.sliding_windows(au))


def test_landmark_predictor_matches_jax():
    from animateportrait_tpu.pipeline.landmark import (
        LandmarkPredictor as JPred)
    from animateportrait_tpu.utils import assets
    from animateportrait_tpu_torch.pipeline.landmark import LandmarkPredictor

    pos_v, cont_v, pos, content = _landmark_nets()
    rng = np.random.default_rng(2)
    windows = rng.standard_normal((45, 18, 80)).astype(np.float32)
    emb = rng.standard_normal(256).astype(np.float32)
    face_id = (assets.std_face_landmarks().reshape(1, 204) * 0.1).astype(
        np.float32)
    ref = JPred(pos_v, cont_v)(windows, emb, face_id)
    with torch.no_grad():
        got = LandmarkPredictor(pos, content, device="cpu")(windows, emb,
                                                           face_id)
    assert got.shape == ref.shape == (45, 204)
    assert maxdiff(got, ref) <= 1e-4


@pytest.mark.parametrize("gender", ["F", "M"])   # two f0 search bands
def test_audio_pipeline_matches_jax(gender):
    from animateportrait_tpu.pipeline.audio import AudioPipeline as JAudio
    from animateportrait_tpu_torch.pipeline.audio import AudioPipeline
    from animateportrait_tpu_torch.utils.smoke import make_wav

    _, v, tm = _autovc()
    wav = make_wav(1.0, seed=4)
    ref = JAudio(v, chunk=512)(wav, gender)
    with torch.no_grad():
        got = AudioPipeline(tm, chunk=512, device="cpu")(wav, gender)
    assert got.mel_raw.shape == ref.mel_raw.shape == (63, 80)
    # the mel rests on |STFT| (atol 2e-3 on 1024-term sums) through a log:
    # bins at the -100 dB floor amplify the STFT's rounding
    assert maxdiff(got.mel_raw, ref.mel_raw) <= 2e-3
    np.testing.assert_array_equal(got.f0_norm > -1, ref.f0_norm > -1)
    assert maxdiff(got.f0_norm, ref.f0_norm) <= 1e-4
    assert maxdiff(got.mel_autovc, ref.mel_autovc) <= 1e-3
    np.testing.assert_array_equal(got.spk_emb, ref.spk_emb)
