"""face_of_art training data: ibug-style images with ``.pts`` landmarks.
Port of ``animateportrait_tpu/data/face_of_art.py`` (the reference's
Module1/thirdparty/face_of_art/menpo_functions.py:32-155 and
crop_training_set.py), menpo-free: 300-W bounding-box ``.mat`` files
(optional), margin-extended square face crops, and an epoch iterator that
applies the texture -> geometric -> basic augmentation of
``train/face_of_art.py`` and yields (images, maps_small, maps, landmarks).

Images are read by ``utils/image.py:read_image`` (``cv2.imread``'s bytes
for PNG and baseline JPEG) and resized by ``resize_linear_float``
(``cv2.resize`` INTER_LINEAR of float32, byte-equal). An item's image is
(S, S, 3) float32 in [0, 1], HWC as read; its landmarks (68, 2) (y, x),
0-based (menpo subtracts 1 from the 1-based ``.pts`` rows). The batches are
NCHW: images (B, 3, S, S), maps (B, 68, S/4, S/4) and (B, 68, S, S).
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Iterator

import numpy as np
import torch

from animateportrait_tpu_torch.utils.device import DEFAULT_DEVICE
from animateportrait_tpu_torch.utils.image import (
    read_image, resize_linear_float)

# mode -> 300-W bounding-box .mat files (menpo_functions.py:50-79)
_BB_FILES = {
    "TRAIN": ["bounding_boxes_afw.mat", "bounding_boxes_helen_trainset.mat",
              "bounding_boxes_lfpw_trainset.mat"],
    "common": ["bounding_boxes_helen_testset.mat",
               "bounding_boxes_lfpw_testset.mat"],
    "challenging": ["bounding_boxes_ibug.mat"],
    "full": ["bounding_boxes_ibug.mat", "bounding_boxes_helen_testset.mat",
             "bounding_boxes_lfpw_testset.mat"],
    "training": ["bounding_boxes_afw.mat",
                 "bounding_boxes_helen_trainset.mat",
                 "bounding_boxes_lfpw_trainset.mat"],
}

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def load_pts(path: str) -> np.ndarray:
    """Parse an ibug .pts landmark file -> (n, 2) float64 (y, x),
    0-based (the files store 1-based "x y" rows; menpo's importer
    subtracts 1 and swaps to (y, x))."""
    pts = []
    in_block = False
    for line in open(path):
        line = line.strip()
        if line == "{":
            in_block = True
        elif line == "}":
            break
        elif in_block and line:
            x, y = line.split()[:2]
            pts.append((float(y) - 1.0, float(x) - 1.0))
    return np.asarray(pts, np.float64)


def load_bb_files(bb_file_paths: list[str]) -> dict:
    """name -> (bb_init, bb_gt), each (1, 4) [xmin, ymin, xmax, ymax]
    0-based (menpo_functions.py:32-47 incl. the matlab -1)."""
    from scipy.io import loadmat

    out: dict = {}
    for bb_file in bb_file_paths:
        bb_mat = loadmat(bb_file)["bounding_boxes"]
        for i in range(int(np.max(bb_mat.shape))):
            name = str(bb_mat[0][i][0][0][0][0])
            bb_init = bb_mat[0][i][0][0][1] - 1
            bb_gt = bb_mat[0][i][0][0][2] - 1
            if name not in out:
                out[name] = (bb_init, bb_gt)
    return out


def load_bb_dictionary(bb_dir: str, mode: str = "TRAIN",
                       test_data: str = "full") -> dict | None:
    """menpo_functions.py:50-79."""
    key = mode if mode == "TRAIN" else test_data
    files = _BB_FILES.get(key)
    if files is None:
        return None
    return load_bb_files([os.path.join(bb_dir, f) for f in files])


def center_margin_bb(bb: np.ndarray, img_hw: tuple[int, int],
                     margin: float = 0.25) -> np.ndarray:
    """Square-margin bounding box, clamped to the image
    (menpo_functions.py:82-93; note the reference clamps x by width and
    y by height via img.bounds()[1] = (h, w))."""
    bb = np.asarray(bb, np.float64).reshape(1, 4)
    size = [bb[0, 2] - bb[0, 0], bb[0, 3] - bb[0, 1]]
    margins = (np.max(size) * (1 + margin) - size) / 2
    out = np.zeros_like(bb)
    # menpo clamps at img.bounds()[1] = (h-1, w-1), i.e. the last valid
    # pixel index, not the shape
    out[0, 0] = max(bb[0, 0] - margins[0], 0)
    out[0, 2] = min(bb[0, 2] + margins[0], img_hw[1] - 1)
    out[0, 1] = max(bb[0, 1] - margins[1], 0)
    out[0, 3] = min(bb[0, 3] + margins[1], img_hw[0] - 1)
    return out


def crop_to_face_image(image: np.ndarray, lms_yx: np.ndarray | None,
                       bb: np.ndarray | None = None,
                       margin: float = 0.25, image_size: int = 256,
                       normalize: bool = True
                       ) -> tuple[np.ndarray, np.ndarray | None]:
    """Crop to the (margin-extended) face box, pad to square with the
    mean pixel, resize to ``image_size``, carrying the landmarks through
    the same transform (menpo_functions.py:96-155). ``bb`` is
    [xmin, ymin, xmax, ymax]; when absent the GT landmarks' bounding box
    is used; when both are absent the whole image is used."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    if bb is None and lms_yx is not None:
        bb = np.array([[lms_yx[:, 1].min(), lms_yx[:, 0].min(),
                        lms_yx[:, 1].max(), lms_yx[:, 0].max()]])
    lms = None if lms_yx is None else np.asarray(lms_yx, np.float64).copy()

    if bb is not None:
        bb = center_margin_bb(bb, (h, w), margin=margin)
        y0, y1 = int(round(bb[0, 1])), int(round(bb[0, 3]))
        x0, x1 = int(round(bb[0, 0])), int(round(bb[0, 2]))
        y0, x0 = max(y0, 0), max(x0, 0)
        y1, x1 = min(max(y1, y0 + 1), h), min(max(x1, x0 + 1), w)
        img = img[y0:y1, x0:x1]
        if lms is not None:
            lms -= np.array([y0, x0])

    # pad the short side to square with the mean value (menpo 'mean')
    ch, cw = img.shape[:2]
    diff = ch - cw
    if diff < 0:
        img = np.pad(img, ((0, -diff), (0, 0), (0, 0)), mode="mean")
    elif diff > 0:
        img = np.pad(img, ((0, 0), (0, diff), (0, 0)), mode="mean")

    side = img.shape[0]
    img = resize_linear_float(img, (image_size, image_size))
    if lms is not None:
        lms *= image_size / side

    if normalize:
        # menpo rescale_pixels(0, 1) defaults to per_channel=True: each
        # RGB channel is min/max-rescaled independently
        lo = img.min(axis=(0, 1), keepdims=True)
        hi = img.max(axis=(0, 1), keepdims=True)
        span = np.where(hi > lo, hi - lo, 1.0)
        img = np.where(hi > lo, (img - lo) / span, img)
    return np.ascontiguousarray(img, np.float32), lms


@dataclasses.dataclass
class FOAItem:
    path: str
    image: np.ndarray      # (S, S, 3) f32 [0, 1], face-cropped
    lms: np.ndarray        # (68, 2) (y, x) in crop space


def load_foa_image_list(img_dir: str, bb_dictionary: dict | None = None,
                        bb_gt: bool = True, margin: float = 0.25,
                        image_size: int = 256,
                        max_items: int | None = None) -> list[FOAItem]:
    """Scan ``img_dir`` for image files with sibling ``.pts`` landmark
    files, face-crop each (load_menpo_image_list + crop,
    menpo_functions.py:260-283 minus augmentation, which is applied
    per-epoch by ``foa_epoch_batches``). A file ``read_image`` cannot read
    is skipped, as ``cv2.imread``'s None is."""
    paths = sorted(p for p in glob.glob(os.path.join(img_dir, "*"))
                   if p.lower().endswith(IMG_EXTS))
    items = []
    for p in paths:
        pts_path = os.path.splitext(p)[0] + ".pts"
        if not os.path.exists(pts_path):
            continue
        try:
            raw = read_image(p)
        except ValueError:
            continue
        img = raw[:, :, ::-1].astype(np.float32) / 255.0
        lms = load_pts(pts_path)
        bb = None
        if bb_dictionary is not None:
            ent = bb_dictionary.get(os.path.basename(p))
            if ent is not None:
                bb = ent[1] if bb_gt else ent[0]
        img, lms = crop_to_face_image(img, lms, bb=bb, margin=margin,
                                      image_size=image_size)
        items.append(FOAItem(path=p, image=img, lms=lms))
        if max_items is not None and len(items) >= max_items:
            break
    return items


def foa_epoch_batches(items: list[FOAItem], batch_size: int,
                      rng: np.random.Generator, img_dir_ns: str = "",
                      p_texture: float = 0.0, p_geom: float = 0.0,
                      augment: bool = True, image_size: int = 256,
                      sigma: float = 6.0, shuffle: bool = True,
                      device: torch.device | str = DEFAULT_DEVICE
                      ) -> Iterator[tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]]:
    """One epoch of (images (B, 3, S, S), maps_small (B, 68, S/4, S/4),
    maps (B, 68, S, S), landmarks (B, 68, 2)) batches, numpy float32.

    Per item: texture -> geometric -> basic augmentation
    (menpo_functions.py:279-283; the geometric warp on ``device``), then
    approx gaussian GT heatmaps at 1/4 and full resolution
    (data_loading_functions.py:115-160). Incomplete trailing batches are
    dropped, like the reference's ``batches_in_epoch`` floor."""
    from animateportrait_tpu_torch.train.face_of_art import (
        augment_foa_item, make_foa_targets)

    order = np.arange(len(items))
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order) - batch_size + 1, batch_size):
        imgs, smalls, larges, lms_out = [], [], [], []
        for idx in order[start:start + batch_size]:
            it = items[idx]
            img, lms = it.image, it.lms
            if augment:
                img, lms = augment_foa_item(
                    img, lms, rng, img_path=it.path, img_dir_ns=img_dir_ns,
                    p_texture=p_texture, p_geom=p_geom, basic=True,
                    image_size=image_size, device=device)
            small, large = make_foa_targets(lms, image_size=image_size,
                                            sigma=sigma)
            imgs.append(img)
            smalls.append(small)
            larges.append(large)
            lms_out.append(lms)
        yield (np.ascontiguousarray(np.stack(imgs).transpose(0, 3, 1, 2)),
               np.stack(smalls), np.stack(larges),
               np.stack(lms_out).astype(np.float32))
