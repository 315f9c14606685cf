"""The plain reference against the port, at small widths on the CPU, on
the same weights and inputs: the renderer's frames, the audio features,
the landmarks, and the Module2 step's losses and updates."""
import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference import drawing
from portbench.reference import train as ref_train
from portbench.tests import helpers


@pytest.fixture(scope="module")
def drawing_setup():
    import json
    import os

    helpers.few_threads()
    with open(os.path.join(helpers.REPO, "portbench", "configs",
                           "drawing_infer.json")) as f:
        cfg = json.load(f)
    cfg.update(helpers.TINY_DRAWING)
    nets = drawing.make_nets(cfg, helpers.SEED, "cpu")
    return cfg, nets


def _port_nets(cfg, nets):
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkPos)
    from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet

    port = {"autovc": AutoVCGenerator(), "pos": Audio2landmarkPos(),
            "content": Audio2landmarkContent(),
            "generator": TridentGeneratorFullIFW(
                output_nc=cfg["output_nc"], ngf=cfg["ngf"], div=3, disp=3),
            "flowunet": FlowUnet(nf=cfg["flow_nf"]), "modnet": MODNet(),
            "static_g": ResnetStyle2Generator(ngf=cfg["static_ngf"])}
    for k, net in port.items():
        net.load_state_dict(nets[k].state_dict())
        net.eval()
    return port


def test_renderer_matches(drawing_setup):
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    cfg, nets = drawing_setup
    ref = drawing.build_pipeline(cfg, nets, "cpu").renderer
    port = _port_nets(cfg, nets)
    r = Module2Renderer(port["generator"], port["flowunet"], port["modnet"],
                        port["static_g"], frame_batch=cfg["frame_batch"],
                        output_uint8=True, device="cpu")
    rng = np.random.default_rng(0)
    photo = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    lm = inputs.face_landmarks(rng, 256)
    tb = (lm[None] + rng.normal(0, 1.0, (6, 68, 2))).astype(np.float32)
    with torch.inference_mode():
        got, want = r(photo, lm, tb), ref(photo, lm, tb)
    assert got.shape == want.shape == (6, 256, 256, 1)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and diff.mean() < 1e-3


def test_audio_and_landmarks_match(drawing_setup):
    from animateportrait_tpu_torch.pipeline.audio import AudioPipeline
    from animateportrait_tpu_torch.pipeline.landmark import (
        LandmarkPredictor)

    cfg, nets = drawing_setup
    ref = drawing.build_pipeline(cfg, nets, "cpu")
    port = _port_nets(cfg, nets)
    wav = inputs.make_wav(1.2, 5)
    with torch.inference_mode():
        got = AudioPipeline(port["autovc"], device="cpu")(wav, "F")
        want = ref.audio(wav, "F")
        np.testing.assert_allclose(got.mel_autovc, want.mel_autovc,
                                   atol=1e-5)
        windows = np.random.default_rng(1).normal(
            0, 1, (40, 18, 80)).astype(np.float32)
        emb = np.zeros(256, np.float32)
        face = np.random.default_rng(2).normal(0, 0.1, (1, 204)).astype(
            np.float32)
        lp = LandmarkPredictor(port["pos"], port["content"], device="cpu")
        np.testing.assert_allclose(lp(windows, emb, face),
                                   ref.predictor(windows, emb, face),
                                   atol=1e-5)


def test_train_step_matches():
    import json
    import os

    from animateportrait_tpu_torch.train import module2 as port_m2

    helpers.few_threads()
    with open(os.path.join(helpers.REPO, "portbench", "configs",
                           "module2_train.json")) as f:
        cfg = json.load(f)
    cfg.update(helpers.TINY_TRAIN)
    batches = ref_train.make_batches(cfg, helpers.SEED, 3, "cpu")
    weights = ref_train.make_weights(cfg, helpers.SEED, "cpu")
    step, state, frozen = ref_train.build(port_m2, cfg, weights, "cpu")
    gen = ref_train.pool_generator(helpers.SEED)
    losses = [{k: float(v) for k, v in step.step(
        state, batches[i], frozen, gen).items()} for i in range(3)]
    ref = ref_train.reference_steps(cfg, helpers.SEED, batches, "cpu")
    for got, want in zip(losses, ref["losses"]):
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-3 * max(abs(want[k]), 1e-2)
    assert state.pool_count == ref["pool_count"]
