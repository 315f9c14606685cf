"""The batched front end (``pipeline/batch.py``) against its single-item
counterparts and the JAX package's ``pipeline/batch.py``: MTCNN over a
stack of photos (seeded face-biased weights), and the landmark predictor
over audios grouped by window count, a group of fewer than 10 windows and
an audio of two segments included."""
import os

import numpy as np
import pytest
import torch

from animateportrait_tpu_torch.models import mtcnn
from animateportrait_tpu_torch.pipeline.batch import (
    BatchedLandmarkPredictor, detect_faces_batch)
from animateportrait_tpu_torch.pipeline.landmark import LandmarkPredictor
from animateportrait_tpu_torch.utils.smoke import write_mtcnn_weights
from torch_port_helpers import maxdiff


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    from animateportrait_tpu.models import mtcnn as jm

    d = write_mtcnn_weights(str(tmp_path_factory.mktemp("w") / "mtcnn"),
                            seed=0)
    paths = [os.path.join(d, f"{n}.npy") for n in ("pnet", "rnet", "onet")]
    jdet = jm.MTCNNDetector(jm.load_pnet_params(paths[0]),
                            jm.load_rnet_params(paths[1]),
                            jm.load_onet_params(paths[2]))
    tdet = mtcnn.MTCNNDetector(mtcnn.load_pnet(paths[0]),
                               mtcnn.load_rnet(paths[1]),
                               mtcnn.load_onet(paths[2]), device="cpu")
    return jdet, tdet


def _photos(n, h=160, w=144, seed=6):
    return np.random.default_rng(seed).uniform(0, 255, (n, h, w, 3)).astype(
        np.float32)


def test_detect_faces_batch_equals_single_calls(detectors):
    _, tdet = detectors
    imgs = _photos(4)
    got = detect_faces_batch(tdet, imgs)
    assert len(got) == 4
    found = 0
    for img, (boxes, lms) in zip(imgs, got):
        sb, sl = tdet(img)
        np.testing.assert_array_equal(boxes, sb)
        np.testing.assert_array_equal(lms, sl)
        found += len(boxes)
    assert found > 0


def test_detect_faces_batch_matches_jax_batch(detectors):
    """Per image the faces JAX's vmapped cascade keeps, boxes and five
    points within 1 px and scores within 1e-4, the bounds of the single
    detector's parity test (test_torch_detect.py)."""
    from animateportrait_tpu.pipeline.batch import (
        detect_faces_batch as jax_batch)

    jdet, tdet = detectors
    imgs = _photos(3, seed=7)
    got = detect_faces_batch(tdet, imgs)
    ref = jax_batch(jdet, imgs)
    for (tb, tl), (jb, jl) in zip(got, ref):
        assert tb.shape == jb.shape and tl.shape == jl.shape
        if len(jb):
            assert maxdiff(tb[:, :4], jb[:, :4]) <= 1.0
            assert maxdiff(tl, jl) <= 1.0
            assert maxdiff(tb[:, 4], jb[:, 4]) <= 1e-4
    assert sum(len(b) for b, _ in ref) > 0


def test_detect_faces_batch_of_small_photos(detectors):
    """Photos too small for any pyramid level find no face."""
    _, tdet = detectors
    out = detect_faces_batch(tdet, _photos(2, 10, 10))
    assert [(b.shape, lm.shape) for b, lm in out] == [((0, 5), (0, 10))] * 2


@pytest.fixture(scope="module")
def predictors():
    from animateportrait_tpu.pipeline.landmark import (
        LandmarkPredictor as JPred)
    from test_torch_audio_landmark import _landmark_nets

    pos_v, cont_v, pos, content = _landmark_nets()
    return JPred(pos_v, cont_v), LandmarkPredictor(pos, content,
                                                   device="cpu")


def _audios(lengths, seed=3):
    from animateportrait_tpu.utils import assets

    rng = np.random.default_rng(seed)
    wins = [rng.standard_normal((T, 18, 80)).astype(np.float32)
            for T in lengths]
    embs = [rng.standard_normal(256).astype(np.float32) for _ in lengths]
    fid = (assets.std_face_landmarks().reshape(1, 204) * 0.1).astype(
        np.float32)
    fids = [fid + rng.normal(0, 0.01, (1, 204)).astype(np.float32)
            for _ in lengths]
    return wins, embs, fids


@pytest.mark.parametrize("lengths", [(40, 40, 33), (40, 7, 40, 530)],
                         ids=["three", "short_and_two_segments"])
def test_batched_landmarks_match_single_and_jax(predictors, lengths):
    """Two audios of one length batched, one alone; an audio under 10
    windows gives (0, 204); 530 windows are a 512-window segment and an
    18-window one. The test_torch_audio_landmark.py bound, max |diff| <=
    1e-4, against the single predictor and JAX's batch."""
    from animateportrait_tpu.pipeline.batch import (
        BatchedLandmarkPredictor as JB)

    jpred, tpred = predictors
    wins, embs, fids = _audios(lengths)
    got = BatchedLandmarkPredictor(tpred)(wins, embs, fids)
    ref = JB(jpred)(wins, embs, fids)
    assert [g.shape for g in got] == [r.shape for r in ref] == [
        (T, 204) if T >= 10 else (0, 204) for T in lengths]
    with torch.inference_mode():
        for w, e, f, g, r in zip(wins, embs, fids, got, ref):
            if w.shape[0] < 10:
                continue
            assert maxdiff(g, tpred(w, e, f)) <= 1e-4
            assert maxdiff(g, r) <= 1e-4


def test_segment_rows_are_single_segments(predictors):
    """``LandmarkPredictor._segment`` over a batch of three segments: each
    row is the segment run alone (a batch of one), each its own attention
    sequence."""
    _, tpred = predictors
    wins, embs, fids = _audios((24, 24, 24), seed=4)
    aus = torch.as_tensor(np.stack(wins))
    emb = torch.as_tensor(np.stack(embs))[:, None].expand(-1, 24, -1)
    fid = torch.as_tensor(np.stack(fids))
    with torch.inference_mode():
        batched = tpred._segment(aus, emb, fid)
        assert batched.shape == (3, 24, 204)
        for b in range(3):
            one = tpred._segment(aus[b: b + 1], emb[b: b + 1], fid[b: b + 1])
            assert maxdiff(batched[b].numpy(), one[0].numpy()) <= 1e-5
