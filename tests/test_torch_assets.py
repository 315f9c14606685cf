"""The port's own data tables and where its entry points run.

- ``animateportrait_tpu_torch/utils/assets.py`` reads the port's copies of
  the reference's data files; each table equals the JAX package's, element
  for element (this test imports the JAX package; the port does not).
- The entry points ``AudioPipeline``, ``extract_frontend``,
  ``wav_to_mel40``, ``LandmarkPredictor`` and ``Module2Renderer`` run on
  the card by default: without one they raise unless the caller asks for
  the CPU, and then they run there.
"""
import inspect

import numpy as np
import pytest
import torch
import torch.nn as nn

from animateportrait_tpu.utils import assets as jax_assets
from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
from animateportrait_tpu_torch.models.speaker_encoder import wav_to_mel40
from animateportrait_tpu_torch.pipeline.audio import (
    AudioPipeline, extract_frontend)
from animateportrait_tpu_torch.pipeline.landmark import LandmarkPredictor
from animateportrait_tpu_torch.pipeline.render import Module2Renderer
from animateportrait_tpu_torch.utils import assets
from animateportrait_tpu_torch.utils.device import resolve_device
from animateportrait_tpu_torch.utils.smoke import make_wav


@pytest.mark.parametrize("name", ["std_face_landmarks", "obama_speaker_emb"])
def test_table_equals_the_jax_packages(name):
    got, want = getattr(assets, name)(), getattr(jax_assets, name)()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_autovc_mean_std_equal_the_jax_packages():
    got, want = assets.autovc_mel_au_mean_std(), \
        jax_assets.autovc_mel_au_mean_std()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.size > 0
        np.testing.assert_array_equal(g, w)


def test_asset_dir_is_the_ports_own():
    assert assets.ASSET_DIR.replace("\\", "/").endswith(
        "animateportrait_tpu_torch/assets")


def _renderer(device=None):
    kw = {} if device is None else {"device": device}
    return Module2Renderer(nn.Identity(), nn.Identity(), nn.Identity(),
                           nn.Identity(), **kw)


def _landmarks(device=None):
    kw = {} if device is None else {"device": device}
    return LandmarkPredictor(nn.Identity(), nn.Identity(), **kw)


def _audio(device=None):
    kw = {} if device is None else {"device": device}
    return AudioPipeline(AutoVCGenerator(), **kw)


def _frontend(device=None):
    kw = {} if device is None else {"device": device}
    return extract_frontend(make_wav(0.25, seed=0), **kw)


def _mel40(device=None):
    kw = {} if device is None else {"device": device}
    return wav_to_mel40(make_wav(0.25, seed=0), **kw)


ENTRY_POINTS = {"AudioPipeline": (AudioPipeline, _audio),
                "extract_frontend": (extract_frontend, _frontend),
                "wav_to_mel40": (wav_to_mel40, _mel40),
                "LandmarkPredictor": (LandmarkPredictor, _landmarks),
                "Module2Renderer": (Module2Renderer, _renderer)}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(name):
    out = ENTRY_POINTS[name][1]("cpu")
    if isinstance(out, torch.Tensor):
        assert out.device.type == "cpu" and out.shape[1] == 40
    elif isinstance(out, tuple):
        assert [a.shape[1] for a in out[::2]] == [80, 257]
    else:
        assert out.device == torch.device("cpu")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device("cuda:0")
