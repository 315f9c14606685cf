"""The port's post-render stabilizer (``pipeline/postalign.py``) against
the JAX package's and against OpenCV and scipy, on the CPU:

- ``track_point`` within 1e-3 px of JAX's, and 0.5 px of
  ``cv2.calcOpticalFlowPyrLK`` (the JAX tests' bar);
- ``good_feature`` the same pixel as JAX's, with and without a mask;
- ``shift_reflect`` within 1e-4 of JAX's and of
  ``scipy.ndimage.shift(order=1, mode='reflect')``;
- ``postalign_video`` on a drifting uint8 clip: the tracked points within
  1e-3 px of the positions JAX's loop tracks, and the frames within one
  level of JAX's on at most 0.1% of the values; the stabilization check of
  ``tests/test_postalign.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from animateportrait_tpu.pipeline import postalign as jpa
from animateportrait_tpu_torch.pipeline import postalign as tpa


def _texture(h=128, w=128, seed=0):
    from scipy.signal import convolve2d
    rng = np.random.default_rng(seed)
    img = np.kron(rng.uniform(0, 255, (h // 8, w // 8)), np.ones((8, 8)))
    k = np.ones((5, 5)) / 25.0
    return convolve2d(img, k, mode="same", boundary="symm").astype(
        np.float32)


def _drifting_clip(n=8, size=96, seed=1):
    from scipy.ndimage import shift as nd_shift
    base = _texture(size, size)
    rng = np.random.default_rng(seed)
    offs = np.cumsum(rng.uniform(-1.5, 1.5, (n, 2)), axis=0)
    frames = [np.stack([nd_shift(base, offs[t], order=1, mode="reflect")] * 3,
                       -1) for t in range(n)]
    return np.stack(frames).astype(np.float32)


@pytest.mark.parametrize("shift", [(2.3, -1.7), (3.0, -2.0), (-0.6, 0.4)])
def test_track_point_matches_jax_and_cv2(shift):
    import cv2
    img = _texture().astype(np.uint8)
    m = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    moved = cv2.warpAffine(img, m, (128, 128))
    for p in ([60.0, 70.0], [64.0, 64.0], [30.5, 90.25]):
        ref = np.asarray(jpa.track_point(jnp.asarray(img, jnp.float32),
                                         jnp.asarray(moved, jnp.float32),
                                         jnp.array(p, jnp.float32)))
        got = tpa.track_point(torch.tensor(img, dtype=torch.float32),
                              torch.tensor(moved, dtype=torch.float32),
                              torch.tensor(p)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-3)
        p1, st, _ = cv2.calcOpticalFlowPyrLK(
            img, moved, np.array([[p]], np.float32), None, winSize=(15, 15),
            maxLevel=2, criteria=(cv2.TERM_CRITERIA_EPS
                                  | cv2.TERM_CRITERIA_COUNT, 10, 0.03))
        assert st[0, 0] == 1
        np.testing.assert_allclose(got, p1[0, 0], atol=0.5)


def test_good_feature_same_index_as_jax():
    img = _texture(64, 80, seed=3)
    mask = np.zeros_like(img)
    mask[-30:, 40:] = 1.0
    for m in (None, mask):
        ref = np.asarray(jpa.good_feature(
            jnp.asarray(img), None if m is None else jnp.asarray(m)))
        got = tpa.good_feature(torch.from_numpy(img), None if m is None
                               else torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, ref)
    corner = np.zeros((64, 64), np.float32)
    corner[30:, 30:] = 200.0
    got = tpa.good_feature(torch.from_numpy(corner)).numpy()
    assert abs(got[0] - 30) <= 2 and abs(got[1] - 30) <= 2
    np.testing.assert_allclose(
        np.asarray(jpa.corner_response(jnp.asarray(img))),
        tpa.corner_response(torch.from_numpy(img)).numpy(), rtol=1e-4,
        atol=1e-2)


@pytest.mark.parametrize("channels", [0, 3])
def test_shift_reflect_matches_jax_and_scipy(channels):
    from scipy.ndimage import shift as nd_shift
    rng = np.random.default_rng(0)
    shape = (16, 20) if not channels else (16, 20, channels)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    for dy, dx in ((2.0, -3.0), (0.5, 1.25), (-4.75, 0.0), (17.5, -41.25)):
        got = tpa.shift_reflect(torch.from_numpy(img),
                                torch.tensor([dy, dx])).numpy()
        ref = np.asarray(jpa.shift_reflect(jnp.asarray(img),
                                           jnp.array([dy, dx])))
        np.testing.assert_allclose(got, ref, atol=1e-4)
        sp = nd_shift(img, [dy, dx] + [0] * (img.ndim - 2), order=1,
                      mode="reflect")
        np.testing.assert_allclose(got, sp, atol=1e-4)
    # integer images keep their dtype, truncated as JAX's astype
    img8 = img.astype(np.uint8)
    got = tpa.shift_reflect(torch.from_numpy(img8), torch.tensor([0.5, 0.5]))
    ref = np.asarray(jpa.shift_reflect(jnp.asarray(img8),
                                       jnp.array([0.5, 0.5])))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


def _jax_points(frames, mask_region):
    """The points JAX's ``postalign_video`` loop tracks, frame by frame."""
    grays = [jpa.rgb_to_gray(jnp.asarray(f, jnp.float32)) for f in frames]
    h, w = frames.shape[1:3]
    mask = np.zeros((h, w), np.float32)
    mask[mask_region[0]:, mask_region[1]:] = 1.0
    pt = jpa.good_feature(grays[1], jnp.asarray(mask))
    pts = []
    for i in range(2, len(frames)):
        pt = jpa.track_point(grays[i - 1], grays[i], pt)
        pts.append(np.asarray(pt))
    return np.stack(pts)


def test_postalign_video_matches_jax_and_stabilizes():
    frames = _drifting_clip()
    clip8 = np.clip(np.round(frames), 0, 255).astype(np.uint8)
    out, pts = tpa.postalign_video(clip8, mask_region=(20, 20), device="cpu",
                                   return_points=True)
    ref = jpa.postalign_video(clip8, mask_region=(20, 20))
    assert out.shape == ref.shape == (6, 96, 96, 3) and out.dtype == np.uint8
    np.testing.assert_allclose(pts, _jax_points(clip8, (20, 20)), atol=1e-3)
    d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size, (
        d.max(), np.count_nonzero(d))

    # float frames: the JAX test's stabilization bar
    out = tpa.postalign_video(frames, mask_region=(20, 20), device="cpu")
    assert out.shape == (6, 96, 96, 3) and out.dtype == np.float32
    sl = np.s_[:, 20:-20, 20:-20, :]
    drift = np.mean(np.abs(np.diff(frames[2:][sl], axis=0)))
    stab = np.mean(np.abs(np.diff(out[sl], axis=0)))
    assert stab < 0.5 * drift
    np.testing.assert_allclose(
        out, jpa.postalign_video(frames, mask_region=(20, 20)), atol=1e-2)


def test_postalign_short_clip_and_gray():
    two = np.zeros((2, 8, 8, 3), np.uint8)
    assert tpa.postalign_video(two, device="cpu").shape == (0, 8, 8, 3)
    x = torch.tensor([[[100.0, 50.0, 200.0]]])
    np.testing.assert_allclose(float(tpa.rgb_to_gray(x)[0, 0]),
                               0.299 * 100 + 0.587 * 50 + 0.114 * 200,
                               rtol=1e-6)
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpa.postalign_video(np.zeros((3, 8, 8, 3), np.uint8))
