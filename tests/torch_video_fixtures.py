"""Writes the Motion-JPEG clip that ``tests/test_torch_cuda.py::
test_committed_fixtures_on_the_card_machine`` decodes on a machine without
OpenCV (``tests/test_torch_av2flau.py`` here, and
``::test_av2flau_card_vs_host`` converts it on the card), with OpenCV's
``VideoWriter`` from seeded synthetic frames, and the SHA-256 of each
frame ``cv2.VideoCapture`` decodes:

    python tests/torch_video_fixtures.py animateportrait_tpu_torch/assets

- ``face_clip_mjpg.avi``: 12 frames of 256^2 at 25 fps, ``MJPG`` (4:2:0),
  a smooth synthetic face drifting by a pixel or two a frame.

``video_fixtures.json`` holds, per file, the fps that
``cv2.VideoCapture(...).get(CAP_PROP_FPS)`` reads and, per decoded frame,
the hex SHA-256 of the C contiguous (H, W, 3) BGR uint8 array and its
shape."""
import hashlib
import json
import os
import sys

import numpy as np

CLIP = "face_clip_mjpg.avi"
HASHES = "video_fixtures.json"
FRAMES, SIZE, FPS = 12, 256, 25


def synthetic_frames(n: int = FRAMES, size: int = SIZE, seed: int = 5
                     ) -> np.ndarray:
    """(n, size, size, 3) BGR uint8: colour ramps and a bright oval with
    two dark eyes and a mouth, moved by a seeded sub-pixel drift each
    frame."""
    rng = np.random.default_rng(seed)
    drift = np.cumsum(rng.uniform(-1.5, 1.5, (n, 2)), axis=0)
    y, x = np.mgrid[0:size, 0:size] / size
    out = []
    for dy, dx in drift:
        u, v = x - dx / size, y - dy / size
        face = ((u - 0.5) ** 2 / 0.06 + (v - 0.5) ** 2 / 0.1) < 1
        dark = (((u - 0.4) ** 2 + (v - 0.42) ** 2) < 0.0012) | (
            ((u - 0.6) ** 2 + (v - 0.42) ** 2) < 0.0012) | (
            (np.abs(u - 0.5) < 0.08) & (np.abs(v - 0.66) < 0.012))
        rgb = np.stack([90 + 120 * x, 70 + 100 * y,
                        110 + 60 * np.sin(6 * x * y)], -1)
        rgb = rgb + 80 * face[..., None] - 150 * dark[..., None]
        out.append(np.clip(rgb, 0, 255).astype(np.uint8)[:, :, ::-1])
    return np.stack(out)


def digest(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "shape": list(a.shape)}


def cv2_frames(path: str) -> tuple[list, float]:
    """Every frame ``cv2.VideoCapture(path).read()`` gives, and its fps."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames, float(fps)


def main(out_dir: str) -> None:
    import cv2

    path = os.path.join(out_dir, CLIP)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), FPS,
                         (SIZE, SIZE))
    for f in synthetic_frames():
        vw.write(f)
    vw.release()
    frames, fps = cv2_frames(path)
    with open(os.path.join(out_dir, HASHES), "w") as f:
        json.dump({CLIP: {"fps": fps,
                          "frames": [digest(x) for x in frames]}}, f,
                  indent=1)
        f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1])
