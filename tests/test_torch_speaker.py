"""The port's speaker encoder against the JAX package on the same weights
(JAX random variables carried over by ``io/from_jax.py``): the
``VoiceEncoder`` net, ``get_spk_emb`` on a 2 s WAV, the converter by a
round trip, and the audio front end with an encoder."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models.speaker_encoder import (
    VoiceEncoder, get_spk_emb, preprocess_wav, wav_to_mel40)
from animateportrait_tpu_torch.utils.smoke import make_wav
from animateportrait_tpu.utils.smoke import random_variables
from torch_port_helpers import maxdiff

K = jax.random.key(0)


def _encoders(seed=1):
    from animateportrait_tpu.models.speaker_encoder import VoiceEncoder as JV

    v = random_variables(lambda: JV().init(K, jnp.zeros((1, 160, 40))),
                         seed=seed)
    tm = VoiceEncoder().eval()
    tm.load_state_dict(from_jax.voice_encoder_state_dict(v))
    return v, tm


def test_voice_encoder_matches_jax():
    from animateportrait_tpu.models.speaker_encoder import VoiceEncoder as JV

    v, tm = _encoders()
    mels = np.random.default_rng(2).standard_normal((2, 50, 40)).astype(
        np.float32)
    ref = JV().apply(v, jnp.asarray(mels))
    with torch.no_grad():
        got = tm(torch.from_numpy(mels))
    assert got.shape == (2, 256)
    # the JAX package's bound against the reference
    # (tests/test_speaker_encoder.py:34)
    assert maxdiff(got, ref) <= 2e-5


def test_get_spk_emb_matches_jax():
    from animateportrait_tpu.models import speaker_encoder as js

    v, tm = _encoders(seed=3)
    wav = make_wav(2.0, seed=5)
    np.testing.assert_array_equal(preprocess_wav(wav), js.preprocess_wav(wav))
    np.testing.assert_allclose(wav_to_mel40(wav, device="cpu").numpy(),
                               js.wav_to_mel40(wav), rtol=1e-4, atol=1e-4)
    ref = js.get_spk_emb(v, wav)
    got = get_spk_emb(tm, wav)
    assert got.shape == (256,)
    assert abs(np.linalg.norm(got) - 1.0) <= 1e-5
    assert maxdiff(got, ref) <= 1e-5


def test_voice_encoder_converter_round_trip():
    from animateportrait_tpu.models.speaker_encoder import (
        load_voice_encoder_params)

    v, _ = _encoders(seed=4)
    sd = from_jax.voice_encoder_state_dict(v)
    VoiceEncoder().load_state_dict(sd, strict=True)
    back = load_voice_encoder_params({k: t.numpy() for k, t in sd.items()})
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, a in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a))


def test_audio_pipeline_with_encoder_matches_jax():
    from animateportrait_tpu.models.autovc import AutoVCGenerator as JV
    from animateportrait_tpu.pipeline.audio import AudioPipeline as JAudio
    from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
    from animateportrait_tpu_torch.pipeline.audio import AudioPipeline

    av = random_variables(lambda: JV().init(
        K, jnp.zeros((1, 32, 80)), jnp.zeros((1, 256)), jnp.zeros((1, 256)),
        jnp.zeros((1, 32, 257))), seed=6)
    tav = AutoVCGenerator().eval()
    tav.load_state_dict(from_jax.autovc_state_dict(av))
    v, tm = _encoders(seed=7)
    wav = make_wav(1.0, seed=8)
    ref = JAudio(av, voice_encoder_variables=v, chunk=512)(wav)
    with torch.no_grad():
        got = AudioPipeline(tav, voice_encoder=tm, chunk=512,
                            device="cpu")(wav)
    assert np.abs(got.spk_emb).max() > 0
    assert maxdiff(got.spk_emb, ref.spk_emb) <= 1e-5
    # tests/test_torch_audio_landmark.py's bound on the AutoVC output
    assert maxdiff(got.mel_autovc, ref.mel_autovc) <= 1e-3
