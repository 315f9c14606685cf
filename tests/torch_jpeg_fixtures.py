"""Writes the JPEG fixtures that ``chip_smoke.py`` phase 11 decodes on a
machine without a JPEG encoder, with PIL from a seeded synthetic 512^2
photo, and the SHA-256 of PIL's and OpenCV's decodes of each:

    python tests/torch_jpeg_fixtures.py animateportrait_tpu_torch/assets

- ``portrait_420_rst_exif6.jpg``: 4:2:0, quality 90, a restart marker
  every 4 MCUs, EXIF orientation 6;
- ``portrait_gray.jpg``: one component (4:4:4), quality 90.

``jpeg_fixtures.json`` holds, per file, ``pil_rgb`` and ``pil_l``
(``Image.open(path).convert("RGB" | "L")``) and ``cv2_bgr``
(``cv2.imread(path)``, EXIF rotation applied): the hex SHA-256 of the C
contiguous uint8 array and its shape. For the quality-95 encoder it holds
``cv2_q95``, OpenCV's ``imwrite`` + ``imread`` of that BGR image (the
round trip of the JAX CLI's ``--video``), and ``cv2_q95_file``, the
SHA-256 and length of the bytes ``cv2.imencode(".jpg", ...)`` writes."""
import hashlib
import json
import os
import sys

import numpy as np

FIXTURES = ("portrait_420_rst_exif6.jpg", "portrait_gray.jpg")
HASHES = "jpeg_fixtures.json"


def synthetic_photo(size: int = 512, seed: int = 3) -> np.ndarray:
    """Smooth colour ramps and a bright oval with seeded noise (the
    photo of ``chip_smoke.py:write_photo``), (size, size, 3) uint8 RGB."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    face = ((x - 0.5) ** 2 / 0.08 + (y - 0.5) ** 2 / 0.13) < 1
    rgb = np.stack([90 + 120 * x, 70 + 100 * y,
                    110 + 60 * np.sin(6 * x * y)], -1) + 80 * face[..., None]
    rgb = rgb + rng.normal(0, 6, (size, size, 3))
    return np.clip(rgb, 0, 255).astype(np.uint8)


def digest(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "shape": list(a.shape)}


def reference_digests(path: str) -> dict:
    import cv2
    from PIL import Image

    with Image.open(path) as im:
        rgb, gray = np.asarray(im.convert("RGB")), np.asarray(im.convert("L"))
    bgr = cv2.imread(path)
    ok, enc = cv2.imencode(".jpg", bgr)
    return {"pil_rgb": digest(rgb), "pil_l": digest(gray),
            "cv2_bgr": digest(bgr),
            "cv2_q95": digest(cv2.imdecode(enc, cv2.IMREAD_COLOR)),
            "cv2_q95_file": {"sha256": hashlib.sha256(enc.tobytes())
                             .hexdigest(), "size": int(enc.size)}}


def write_fixtures(directory: str) -> dict:
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    photo = synthetic_photo()
    exif = Image.Exif()
    exif[0x0112] = 6
    color, gray = (os.path.join(directory, n) for n in FIXTURES)
    Image.fromarray(photo).save(color, "JPEG", quality=90, subsampling=2,
                                restart_marker_blocks=4,
                                exif=exif.tobytes())
    Image.fromarray(photo).convert("L").save(gray, "JPEG", quality=90)
    table = {n: reference_digests(os.path.join(directory, n))
             for n in FIXTURES}
    with open(os.path.join(directory, HASHES), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    return table


def write_digests(directory: str) -> dict:
    """The digests of the fixtures already in ``directory``, into
    ``jpeg_fixtures.json``."""
    table = {n: reference_digests(os.path.join(directory, n))
             for n in FIXTURES}
    with open(os.path.join(directory, HASHES), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    return table


if __name__ == "__main__":
    # --digests: leave the JPEG files as they are, rewrite the table
    if sys.argv[1] == "--digests":
        print(json.dumps(write_digests(sys.argv[2]), indent=1))
    else:
        print(json.dumps(write_fixtures(sys.argv[1]), indent=1))
