"""Named-puppet bounds/scale/shift table (Module1/util/utils.py:268-326).
Port of ``animateportrait_tpu/utils/puppet.py``.

Used by the MakeItTalk puppet demos: per-character TPS boundary anchors and
the scale/shift that maps normalized landmarks back to puppet pixels. The
generic branch derives the 12-anchor boundary from the puppet image size
and reads `<name>_scale_shift.txt` alongside it. The image is read by
``utils/image.py:read_image``, which gives the array ``cv2.imread`` does
(EXIF rotation of a JPEG included), without OpenCV.
"""
from __future__ import annotations

import os

import numpy as np

_B = 5000

_NAMED = {
    "wilk_old": (
        [-_B, -_B, -_B, 459, -_B, _B + 918, 419, _B + 918, _B + 838,
         _B + 918, _B + 838, 459, _B + 838, -_B, 419, -_B],
        -0.005276414887140783, (-475.4316, -193.53225)),
    "sketch": (
        [-10000, -10000, -10000, 221, -10000, 10443, 232, 10443, 10465,
         10443, 10465, 221, 10465, -10000, 232, -10000],
        -0.006393177201290783, (-226.8411, -176.5216)),
    "onepunch": (
        [0, 0, 0, 168, 0, 337, 282, 337, 565, 337, 565, 168, 565, 0,
         282, 0],
        -0.007558707536598317, (-301.4903, -120.05265)),
    "cat": (
        [0, 0, 0, 315, 0, 631, 299, 631, 599, 631, 599, 315, 599, 0,
         299, 0],
        -0.009099476040795225, (-297.17085, -259.2363)),
    "paint": (
        [0, 0, 0, 249, 0, 499, 212, 499, 424, 499, 424, 249, 424, 0,
         212, 0],
        -0.007409177996872789, (-161.92345878, -249.40250103)),
    "mulaney": (
        [0, 0, 0, 255, 0, 511, 341, 511, 682, 511, 682, 255, 682, 0,
         341, 0],
        -0.010651548568731444, (-333.54245, -189.081)),
    "cartoonM_old": (
        [0, 0, 0, 299, 0, 599, 399, 599, 799, 599, 799, 299, 799, 0,
         399, 0],
        -0.0055312373170456845, (-398.6125, -240.45235)),
    "beer": (
        [0, 0, 0, 309, 0, 618, 260, 618, 520, 618, 520, 309, 520, 0,
         260, 0],
        -0.0054102709937112374, (-254.1478, -156.6971)),
    "color": (
        [0, 0, 0, 140, 0, 280, 249, 280, 499, 280, 499, 140, 499, 0,
         249, 0],
        -0.012986159189209149, (-237.27065, -79.2465)),
}


def get_puppet_info(demo_ch: str, root_dir: str
                    ) -> tuple[np.ndarray, float, np.ndarray]:
    """Returns (bound (1, 2k), scale, shift (2,))."""
    if demo_ch in _NAMED:
        bound, scale, shift = _NAMED[demo_ch]
        return (np.asarray(bound, np.float64).reshape(1, -1), scale,
                np.asarray(shift, np.float64))
    from animateportrait_tpu_torch.utils.image import read_image

    for ext in (".jpg", ".png"):
        p = os.path.join(root_dir, demo_ch + ext)
        if os.path.exists(p):
            img = read_image(p)
            break
    else:
        raise FileNotFoundError(f"no puppet image for {demo_ch}")
    # the reference's names: "h" is the width and "w" the height
    h = img.shape[1] - 1
    w = img.shape[0] - 1
    bound = np.array([
        -_B, -_B, -_B, w // 4, -_B, w // 2, -_B, w // 4 * 3, -_B, _B + w,
        h // 2, _B + w, _B + h, _B + w, _B + h, w // 2, _B + h, -_B,
        h // 4, -_B, h // 2, -_B, h // 4 * 3, -_B],
        np.float64).reshape(1, -1)
    ss = np.loadtxt(os.path.join(root_dir, demo_ch + "_scale_shift.txt"))
    return bound, float(ss[0]), np.array([ss[1], ss[2]])
