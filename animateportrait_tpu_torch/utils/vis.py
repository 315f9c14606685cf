"""Landmark visualization: the coloured 68/98/74-point curves, the
landmark-sequence preview video and the detection boxes. Port of
``animateportrait_tpu/utils/vis.py`` (``vis_landmark`` of the end-to-end
script main_end2end_module2.py:46-67, data_preparation.py's
``vis_landmark_on_img{,98,74}``, :197-266, and MTCNN's ``show_bboxes``),
drawn as OpenCV 5.0 draws them: ``cv2.line`` of thickness >= 2 through
``utils/image.py:draw_thick_line``, ``cv2.rectangle`` of thickness 2 as
its four edges, and filled ``cv2.circle`` discs, each shape's pixels set
to its colour (8-connected, no anti-aliasing). The preview video is the
port's uncompressed AVI (``utils/video.py``), where the JAX package
encodes Motion-JPEG with OpenCV.
"""
from __future__ import annotations

import numpy as np

from animateportrait_tpu_torch.utils.image import _fill_disc, draw_thick_line

CURVES = (
    (list(range(0, 16)), (255, 144, 25), False),    # jaw
    (list(range(17, 21)), (50, 205, 50), False),    # brows
    (list(range(22, 26)), (50, 205, 50), False),
    (list(range(27, 35)), (208, 224, 63), False),   # nose
    (list(range(36, 41)), (71, 99, 255), True),     # eyes
    (list(range(42, 47)), (71, 99, 255), True),
    (list(range(48, 59)), (238, 130, 238), True),   # mouth
    (list(range(60, 67)), (238, 130, 238), True),
)
CURVES_98 = (
    (list(range(0, 32)), (255, 144, 25), False),   # jaw
    (list(range(33, 41)), (50, 205, 50), True),    # brows
    (list(range(42, 50)), (50, 205, 50), True),
    (list(range(51, 59)), (208, 224, 63), False),  # nose
    (list(range(60, 67)), (71, 99, 255), True),    # eyes
    (list(range(68, 75)), (71, 99, 255), True),
    (list(range(76, 87)), (238, 130, 238), True),  # mouth
    (list(range(88, 95)), (238, 130, 238), True),
)
CURVES_74 = (
    (list(range(0, 16)), (255, 144, 25), False),   # jaw
    (list(range(17, 21)), (50, 205, 50), False),   # brows
    (list(range(22, 26)), (50, 205, 50), False),
    (list(range(27, 35)), (208, 224, 63), False),  # nose
    (list(range(36, 43)), (71, 99, 255), True),    # eyes
    (list(range(44, 51)), (71, 99, 255), True),
    (list(range(52, 63)), (238, 130, 238), True),  # mouth
    (list(range(64, 71)), (238, 130, 238), True),
)


def _draw_curves(img: np.ndarray, shape: np.ndarray, curves,
                 thickness: int) -> None:
    """Each curve's segments (and its closing one) in its colour, in
    order; one curve is one colour, so its segments share a mask."""
    h, w = img.shape[:2]
    pts = [tuple(p) for p in shape[:, :2].tolist()]
    for idx, color, loop in curves:
        mask = np.zeros((h, w), np.uint8)
        segs = [(pts[i], pts[i + 1]) for i in idx]
        if loop:
            segs.append((pts[idx[0]], pts[idx[-1] + 1]))
        for a, b in segs:
            draw_thick_line(mask, a, b, thickness)
        img[mask > 0] = color


def vis_landmark(height: int, width: int, shape: np.ndarray,
                 linewidth: int = 2) -> np.ndarray:
    """The coloured 68-point sketch on white, BGR uint8
    (main_end2end_module2.py:46-67):
    lines of linewidth * (height // 256), red discs of radius
    height // 256. Needs height >= 256 (OpenCV refuses thickness 0)."""
    img = np.full((height, width, 3), 255, np.uint8)
    shape = np.asarray(shape).astype("int32")
    _draw_curves(img, shape, CURVES, linewidth * (height // 256))
    mask = np.zeros((height, width), np.uint8)
    for x, y in shape[:68, :2].tolist():
        _fill_disc(mask, x, y, height // 256)
    img[mask > 0] = (0, 0, 255)
    return img


def vis_landmark_on_img(img: np.ndarray, shape: np.ndarray,
                        linewidth: int = 2, curves=CURVES) -> np.ndarray:
    """Draw the landmark curves onto ``img`` in place (and return it)."""
    _draw_curves(img, np.asarray(shape).astype("int32"), curves, linewidth)
    return img


def vis_landmark_on_img98(img, shape, linewidth=2):
    return vis_landmark_on_img(img, shape, linewidth, CURVES_98)


def vis_landmark_on_img74(img, shape, linewidth=2):
    """The 74-point variant (data_preparation.py:245-266)."""
    return vis_landmark_on_img(img, shape, linewidth, CURVES_74)


def landmark_sequence_video(path: str, fls: np.ndarray,
                            wav: np.ndarray | None = None,
                            size: int = 512, fps: float = 62.5) -> str:
    """A landmark sequence (T, 68, 2+) as a preview AVI of ``vis_landmark``
    frames (Module1/util/vis.py's role): uncompressed with the audio track
    when ``wav`` is given, else a silent Motion-JPEG AVI (``write_video``),
    as the JAX function."""
    from animateportrait_tpu_torch.utils.video import mux_avi, write_video

    frames = np.stack([vis_landmark(size, size, f[:, :2])[:, :, ::-1]
                       for f in np.asarray(fls)])            # BGR -> RGB
    if wav is None:
        return write_video(path, frames, fps=fps)
    return mux_avi(path, frames, wav, fps=fps)


def show_bboxes(img_bgr: np.ndarray, boxes: np.ndarray,
                landmarks: np.ndarray | None = None) -> np.ndarray:
    """Detection boxes (and 5-point landmarks) drawn on a copy of the image
    (MTCNN/visualization_utils.py:show_bboxes): each box's corners rounded
    to the nearest integer, its four edges as ``cv2.rectangle`` of
    thickness 2 draws them (a closed polyline of thick lines), white; each
    point a red disc of radius 2."""
    out = np.ascontiguousarray(img_bgr).copy()
    h, w = out.shape[:2]
    for b in np.asarray(boxes):
        x1, y1, x2, y2 = (int(round(v)) for v in b[:4])
        mask = np.zeros((h, w), np.uint8)
        corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
        for a, c in zip(corners, corners[1:] + corners[:1]):
            draw_thick_line(mask, a, c, 2)
        out[mask > 0] = (255, 255, 255)
    if landmarks is not None:
        for lm in np.asarray(landmarks):
            mask = np.zeros((h, w), np.uint8)
            for i in range(5):
                _fill_disc(mask, int(round(lm[i])), int(round(lm[i + 5])), 2)
            out[mask > 0] = (0, 0, 255)
    return out
