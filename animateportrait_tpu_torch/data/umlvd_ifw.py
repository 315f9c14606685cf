"""The UMLVD-IFW training data (the drawing and cartoon twins), NCHW. Port
of ``animateportrait_tpu/data/umlvd_ifw.py`` (reference:
Module2/data/umlvd_ifw_dataset.py, umlvd_ifw_cartoon_dataset.py) over the
reference's on-disk layout (readme.md:57-59):

  <root>/Photo/...               unpaired photos (A)
  <root>/Drawing|Cartoon/...     unpaired style images (B)
  <root>/Alm/MTCNN/, /Blm/MTCNN/ landmark dot images
  <root>/Alm_txt/MTCNN/, ...     68-point landmark txts (+ _win.txt for clips)
  <root>/Amask|Bmask/{nose,eyes,lips}/
  <root>/fakeB_static/           static stylizations of the photos
  <root>/Drawing/scanner_frag_<k>_MTCNN/  consecutive-frame film clips

``UMLVDIFWDataset.sample(index, rng)`` makes the same numpy ``Generator``
draws in the same order as the JAX dataset, so item for item it gives what
that one gives: images (C, H, W) float32, landmarks (68, 2) (x, y), face
windows (4,) int32 and the Delaunay simplices ``tri_motion`` /
``tri_motion2`` (the train step evaluates the warp grids from them).
Images are decoded and resized on the host without PIL
(``utils/image.py``: ``load_images``, ``resize_bicubic_pil``), byte for
byte as PIL does it, the ``Photo/**/*.jpg`` photos through the port's JPEG
decoder (``utils/jpeg.py``) with PIL's semantics (no EXIF rotation).

``loader(...)`` feeds the train step from ``--num_threads`` worker
processes: the main process draws each batch's indices and one seed per
item, as ``UMLVDIFWDataset.batch`` does with threads, so a batch does not
depend on how the workers are scheduled.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import glob
import multiprocessing
import multiprocessing.util
import os

import numpy as np
import torch

from animateportrait_tpu_torch.ops.tps import triangulate_frames
from animateportrait_tpu_torch.utils.image import (
    draw_dots, load_images, image_size, resize_bicubic_pil)

FLIP_REMAP = np.array(
    [16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0,
     26, 25, 24, 23, 22, 21, 20, 19, 18, 17, 27, 28, 29, 30,
     35, 34, 33, 32, 31, 45, 44, 43, 42, 47, 46, 39, 38, 37, 36, 41, 40,
     54, 53, 52, 51, 50, 49, 48, 59, 58, 57, 56, 55,
     64, 63, 62, 61, 60, 67, 66, 65])


@dataclasses.dataclass(frozen=True)
class DataConfig:
    root: str
    style_dir: str = "Drawing"     # "Cartoon" for the cartoon twin
    load_size: int = 286
    crop_size: int = 256
    no_flip: bool = False
    input_nc: int = 3              # A grayscale when 1 (swapped by
    output_nc: int = 1             # --direction BtoA, umlvd:145-147)
    # --serial_batches: B paired as index % B_size, not drawn at random
    # (umlvd_ifw_dataset.py:151-155)
    serial_batches: bool = False
    # --max_dataset_size: a cap on each path list (image_folder.py:23-35)
    max_dataset_size: float = float("inf")
    max_offset: float = 3.0
    select_target12_thre: float = 0.0
    select_noniden_thre: float = 0.9
    coh_use_more: bool = True
    use_clips: bool = True         # False for the cartoon twin (no B12)
    rx: float = 0.15
    ry: float = 0.2
    rs: float = 0.7


def _to_tensor(img: np.ndarray, crop_pos, crop_size: int, flip: bool,
               normalize: bool = True) -> np.ndarray:
    """crop (zeros outside the image, as PIL's crop) -> flip -> float in
    [0, 1], or [-1, 1] with ``normalize``; (C, H, W) float32."""
    x, y = crop_pos
    h, w = img.shape[:2]
    out = np.zeros((crop_size, crop_size) + img.shape[2:], np.uint8)
    y0, y1 = max(y, 0), min(y + crop_size, h)
    x0, x1 = max(x, 0), min(x + crop_size, w)
    if y0 < y1 and x0 < x1:
        out[y0 - y:y1 - y, x0 - x:x1 - x] = img[y0:y1, x0:x1]
    if flip:
        out = out[:, ::-1]
    arr = np.asarray(out, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    if normalize:
        arr = arr * 2.0 - 1.0
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def _get_params2(cfg: DataConfig, size, rng: np.random.Generator) -> dict:
    """The face-region crop of an unpaired image (base_dataset.py)."""
    new_w = new_h = cfg.load_size
    x1 = max(0, int(round((cfg.rx + cfg.rs) * new_w)) - cfg.crop_size)
    x2 = min(max(0, new_w - cfg.crop_size), int(round(cfg.rx * new_w)))
    x = int(rng.integers(x1, x2 + 1))
    y1 = max(0, int(round((cfg.ry + cfg.rs) * new_h)) - cfg.crop_size)
    y2 = min(max(0, new_h - cfg.crop_size), int(round(cfg.ry * new_h)))
    y = int(rng.integers(y1, y2 + 1))
    flip = (not cfg.no_flip) and rng.random() > 0.5
    return {"crop_pos": (x, y), "flip": flip}


def _get_params3(cfg: DataConfig, size, win1, win2,
                 rng: np.random.Generator) -> dict:
    """A crop window holding both face windows (base_dataset.py:102-150)."""
    w, h = size
    x1 = min(win1[0], win2[0]) / w
    x2 = max(win1[1], win2[1]) / w
    y1 = min(win1[2], win2[2]) / h
    y2 = max(win1[3], win2[3]) / h
    new_w = new_h = cfg.load_size
    xa = max(0, int(round(x2 * new_w)) - cfg.crop_size)
    xb = min(max(0, new_w - cfg.crop_size), int(round(x1 * new_w)))
    x = int(rng.integers(xa, max(xa, xb) + 1))
    ya = max(0, int(round(y2 * new_h)) - cfg.crop_size)
    yb = min(max(0, new_h - cfg.crop_size), int(round(y1 * new_h)))
    y = int(rng.integers(ya, max(ya, yb) + 1))
    flip = (not cfg.no_flip) and rng.random() > 0.5
    return {"crop_pos": (x, y), "flip": flip}


def trans_lm(lm: np.ndarray, params: dict, cfg: DataConfig, size,
             win=None) -> tuple[np.ndarray, np.ndarray]:
    """Landmarks through the resize, crop and flip, and the face window
    (umlvdfw_test_dataset.py:12-31)."""
    w, h = size
    tx, ty = params["crop_pos"]
    lm = lm.copy()
    lm[:, 0] = lm[:, 0] * cfg.load_size / w - tx
    lm[:, 1] = lm[:, 1] * cfg.load_size / h - ty
    if params["flip"]:
        lm[:, 0] = cfg.crop_size - lm[:, 0]
        lm = lm[FLIP_REMAP]
    if win is None:
        x1 = int(round(cfg.rx * cfg.load_size - tx))
        x2 = x1 + int(round(cfg.rs * cfg.load_size))
        y1 = int(round(cfg.ry * cfg.load_size - ty))
        y2 = y1 + int(round(cfg.rs * cfg.load_size))
    else:
        x1 = int(round(win[0] * cfg.load_size / w - tx))
        x2 = int(round(win[1] * cfg.load_size / w - tx))
        y1 = int(round(win[2] * cfg.load_size / h - ty))
        y2 = int(round(win[3] * cfg.load_size / h - ty))
    if params["flip"]:
        x1, x2 = cfg.crop_size - x2, cfg.crop_size - x1
    return lm, np.array([x1, x2, y1, y2], np.int32)


def _draw_dots_chw(lm: np.ndarray, crop_size: int) -> np.ndarray:
    return np.ascontiguousarray(draw_dots(lm, crop_size).transpose(2, 0, 1))


class _Loads:
    """The images one item reads, each through ``Image.open(path).convert(
    "L" | "RGB").resize((load_size, load_size), BICUBIC)`` and then its crop
    and flip (``_to_tensor``). ``add`` books one and returns its number;
    ``run`` decodes every file at once (``utils/image.py:load_images``,
    which shares one wavefront among the PNGs of one size)."""

    def __init__(self, load_size: int, crop_size: int):
        self.load_size, self.crop_size = load_size, crop_size
        self.reqs: list[tuple] = []

    def add(self, path: str, grayscale: bool, params: dict,
            normalize: bool = True) -> "_Booked":
        self.reqs.append((path, grayscale, params["crop_pos"],
                          params["flip"], normalize))
        return _Booked(len(self.reqs) - 1)

    def run(self) -> list[np.ndarray]:
        files = sorted({(r[0], r[1]) for r in self.reqs})
        size = (self.load_size, self.load_size)
        imgs = dict(zip(files, (resize_bicubic_pil(img, size) for img in
                                load_images([f[0] for f in files],
                                            [f[1] for f in files]))))
        return [_to_tensor(imgs[(path, gray)], pos, self.crop_size, flip,
                           normalize)
                for path, gray, pos, flip, normalize in self.reqs]


@dataclasses.dataclass(frozen=True)
class _Booked:
    index: int


class UMLVDIFWDataset:
    """Index-addressable dataset; ``sample(index, rng)`` returns one item,
    a dict of numpy arrays in the train step's batch layout."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = cfg.root
        self.A_paths = sorted(
            glob.glob(os.path.join(root, "Photo", "**", "*.png"),
                      recursive=True)
            + glob.glob(os.path.join(root, "Photo", "**", "*.jpg"),
                        recursive=True))
        self.B_paths = sorted(
            glob.glob(os.path.join(root, cfg.style_dir, "**", "*.png"),
                      recursive=True))
        self.B_paths = [p for p in self.B_paths if "scanner_frag" not in p]
        if np.isfinite(cfg.max_dataset_size):
            cap = int(cfg.max_dataset_size)
            self.A_paths = self.A_paths[:cap]
            self.B_paths = self.B_paths[:cap]
        self.B12_paths = []
        if cfg.use_clips:
            for clip in range(34):
                frames = sorted(glob.glob(os.path.join(
                    root, cfg.style_dir, f"scanner_frag_{clip}_MTCNN",
                    "*.png")))
                if frames:
                    self.B12_paths.append(frames)

    def __len__(self):
        return max(len(self.A_paths), len(self.B_paths))

    def b_index(self, index: int, rng: np.random.Generator) -> int:
        """B pairing: index % B_size under --serial_batches, else drawn."""
        if self.cfg.serial_batches:
            return index % len(self.B_paths)
        return int(rng.integers(0, len(self.B_paths)))

    # --- paths in the reference layout ---
    def _lm_img(self, p, kind):
        sub = "/Alm/MTCNN/" if kind == "A" else "/Blm/MTCNN/"
        src = "/Photo/" if kind == "A" else f"/{self.cfg.style_dir}/"
        return p.replace(src, sub)

    def _lm_txt(self, p, kind):
        sub = "/Alm_txt/MTCNN/" if kind == "A" else "/Blm_txt/MTCNN/"
        src = "/Photo/" if kind == "A" else f"/{self.cfg.style_dir}/"
        return os.path.splitext(p.replace(src, sub))[0] + ".txt"

    def _mask(self, p, kind, part):
        sub = f"/Amask/{part}/" if kind == "A" else f"/Bmask/{part}/"
        src = "/Photo/" if kind == "A" else f"/{self.cfg.style_dir}/"
        return p.replace(src, sub)

    @staticmethod
    def _read_lm(path):
        with open(path) as f:
            rows = f.read().splitlines()
        return np.array([[float(e.split()[0]), float(e.split()[1])]
                         for e in rows], np.float32)

    def sample(self, index: int, rng: np.random.Generator) -> dict:
        cfg = self.cfg
        ls, cs = cfg.load_size, cfg.crop_size
        A_path = self.A_paths[index % len(self.A_paths)]
        B_path = self.B_paths[self.b_index(index, rng)]

        loads = _Loads(ls, cs)

        def load_group(path, kind, params_src_size, params):
            lm68 = self._read_lm(self._lm_txt(path, kind))
            lm68, win = trans_lm(lm68, params, cfg, params_src_size)
            out = {"img": loads.add(path, (cfg.input_nc if kind == "A"
                                           else cfg.output_nc) == 1, params),
                   "lm_img": loads.add(self._lm_img(path, kind), True,
                                       params),
                   "lm68": lm68, "win": win}
            for part, key in (("nose", "mask"), ("eyes", "maske"),
                              ("lips", "maskl")):
                out[key] = loads.add(self._mask(path, kind, part), True,
                                     params, normalize=False)
            return out

        A_size = image_size(A_path)
        B_size = image_size(B_path)
        pA = _get_params2(cfg, A_size, rng)
        pB = _get_params2(cfg, B_size, rng)
        A = load_group(A_path, "A", A_size, pA)
        B = load_group(B_path, "B", B_size, pB)

        item = {
            "real_A": A["img"], "real_B": B["img"],
            "A_lm": A["lm_img"], "A_lm_68": A["lm68"], "winA": A["win"],
            "Br_mask": B["mask"], "Br_maske": B["maske"],
            "Br_maskl": B["maskl"], "winBr": B["win"],
        }

        # a consecutive pair of film-clip frames for the coherence D
        if self.B12_paths:
            ci = int(rng.integers(0, len(self.B12_paths)))
            fi = int(rng.integers(0, len(self.B12_paths[ci]) - 1))
            B1_path = self.B12_paths[ci][fi]
            B2_path = self.B12_paths[ci][fi + 1]

            def read_win(p):
                with open(os.path.splitext(self._lm_txt(p, "B"))[0]
                          + "_win.txt") as f:
                    vals = f.read().split()
                return np.array([float(v) for v in vals[:4]], np.float32)

            win1 = read_win(B1_path)
            win2 = read_win(B2_path)
            B1_size = image_size(B1_path)
            p1 = _get_params3(cfg, B1_size, win1, win2, rng)
            for name, path in (("B1_img", B1_path), ("B2_img", B2_path)):
                item[name] = loads.add(path, cfg.output_nc == 1, p1)
            if cfg.coh_use_more:
                for name in ("B3", "B4"):
                    cj = int(rng.integers(0, len(self.B12_paths)))
                    fj = int(rng.integers(0, len(self.B12_paths[cj])))
                    item[name] = loads.add(self.B12_paths[cj][fj],
                                           cfg.output_nc == 1, pB)
        else:
            z = np.zeros((cfg.output_nc, cs, cs), np.float32)
            item.update({"B1_img": z, "B2_img": z, "B3": z, "B4": z})

        # 3-way target sampling (umlvd_ifw_dataset.py:278-372)
        r = rng.random()
        if self.B12_paths and r <= cfg.select_target12_thre:
            # consecutive video frames become the targets: their landmark
            # data under the same transform p1
            lm1 = self._read_lm(self._lm_txt(B1_path, "B"))
            lm2 = self._read_lm(self._lm_txt(B2_path, "B"))
            lm1, w1 = trans_lm(lm1, p1, cfg, B1_size, win1)
            lm2, w2 = trans_lm(lm2, p1, cfg, B1_size, win2)
            item.update({
                "tB_lm_68": lm1, "tB2_lm_68": lm2,
                "tB_lm": _draw_dots_chw(lm1, cs),
                "tB2_lm": _draw_dots_chw(lm2, cs),
                "winB": w1, "winB2": w2,
            })
            for part, key in (("nose", "mask"), ("eyes", "maske"),
                              ("lips", "maskl")):
                item[f"B_{key}"] = loads.add(self._mask(B1_path, "B", part),
                                             True, p1, normalize=False)
                item[f"B2_{key}"] = loads.add(
                    self._mask(B2_path, "B", part), True, p1,
                    normalize=False)
        else:
            if r <= cfg.select_noniden_thre:
                base_lm, base_lm_img = B["lm68"], B["lm_img"]
                base_win, src = B["win"], B
            else:
                base_lm, base_lm_img = A["lm68"], A["lm_img"]
                base_win, src = A["win"], A
            offset = rng.random(base_lm.shape).astype(np.float32) \
                * cfg.max_offset
            off2 = rng.random((1, 2)).astype(np.float32) * cfg.max_offset
            offset[48:68] = off2
            lm2 = base_lm + offset
            item.update({
                "tB_lm_68": base_lm.copy(), "tB2_lm_68": lm2,
                "tB_lm": base_lm_img, "tB2_lm": _draw_dots_chw(lm2, cs),
                "winB": base_win.copy(), "winB2": base_win.copy(),
            })
            for key in ("mask", "maske", "maskl"):
                item[f"B_{key}"] = item[f"B2_{key}"] = src[key]

        # the static stylization of the photo (warp_loss == 2,
        # identity_loss == 2)
        fakeBs = A_path.replace("/Photo/", "/fakeB_static/")
        item["fakeB_static"] = loads.add(fakeBs, cfg.output_nc == 1, pA)
        tensors = loads.run()
        item = {k: tensors[v.index].copy() if isinstance(v, _Booked) else v
                for k, v in item.items()}

        # the Delaunay simplices (int32, as the JAX dataset keeps them) of
        # the two warp-target point sets; the train step evaluates the
        # griddata-linear grids from them
        for key, lm in (("tri_motion", item["tB_lm_68"]),
                        ("tri_motion2", item["tB2_lm_68"])):
            item[key] = triangulate_frames(lm[None], cs)[0].astype(np.int32)
        return item

    def batch(self, indices, rng: np.random.Generator,
              num_threads: int = 0) -> dict:
        """A batch, stacked. With ``num_threads`` > 1 and more than one
        index, each item draws from its own ``default_rng(seed)``, the seeds
        drawn from ``rng`` first, and the items are sampled on a thread
        pool; else all items draw from ``rng`` in turn."""
        if num_threads and num_threads > 1 and len(indices) > 1:
            from concurrent.futures import ThreadPoolExecutor

            seeds = rng.integers(0, 2 ** 63 - 1, size=len(indices))
            with ThreadPoolExecutor(max_workers=num_threads) as pool:
                items = list(pool.map(
                    lambda iz: self.sample(iz[0],
                                           np.random.default_rng(iz[1])),
                    zip(indices, seeds)))
        else:
            items = [self.sample(i, rng) for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


# --- the worker-process loader ---------------------------------------------


class _SeededItems(torch.utils.data.Dataset):
    """``UMLVDIFWDataset.sample`` addressed by (index, seed)."""

    def __init__(self, ds: UMLVDIFWDataset):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, key):
        index, seed = key
        return self.ds.sample(int(index), np.random.default_rng(int(seed)))


class SeededBatches:
    """An endless batch sampler: each batch is ``batch_size`` indices drawn
    from ``rng``, then one seed per item, as ``UMLVDIFWDataset.batch``
    draws them with threads (and the JAX package's ``train_cli`` feeds it
    the indices)."""

    def __init__(self, n: int, batch_size: int, rng: np.random.Generator):
        self.n, self.batch_size, self.rng = n, batch_size, rng

    def __iter__(self):
        while True:
            idx = self.rng.integers(0, self.n, size=self.batch_size)
            seeds = self.rng.integers(0, 2 ** 63 - 1, size=self.batch_size)
            yield list(zip(idx.tolist(), seeds.tolist()))


def loader(ds: UMLVDIFWDataset, batch_size: int, rng: np.random.Generator,
           num_workers: int, pin_memory: bool
           ) -> torch.utils.data.DataLoader:
    """An endless ``DataLoader`` of stacked batches (dicts of tensors) over
    ``ds``: ``num_workers`` worker processes (0: the calling process),
    which stay up between batches. A worker's exception is raised in the
    calling process with the worker's traceback.

    The workers fork from a fresh single-threaded server process that has
    imported this module (``forkserver``), never from the calling process,
    whose threads and CUDA context a fork would copy. A spawned worker
    instead tears its interpreter down at exit, and there a library's C++
    thread aborts it ("terminate called without an active exception") in
    most runs, which the loader then raises; a forked one leaves by
    ``os._exit``. The server and multiprocessing's resource tracker are
    stopped when the calling process exits (``stop_worker_servers``)."""
    kw = {}
    if num_workers > 0:
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])
        _stop_servers_at_exit()
        kw = dict(multiprocessing_context=ctx, persistent_workers=True,
                  prefetch_factor=2)
    return torch.utils.data.DataLoader(
        _SeededItems(ds), batch_sampler=SeededBatches(len(ds), batch_size,
                                                      rng),
        num_workers=num_workers, pin_memory=pin_memory, **kw)


@functools.cache
def _stop_servers_at_exit() -> None:
    # exit priority -1: after multiprocessing's own exit finalizers (those
    # of priority 0 unlink the queues' semaphores) and the join of the
    # daemonic workers
    multiprocessing.util.Finalize(None, stop_worker_servers, exitpriority=-1)


def stop_worker_servers() -> None:
    """Stop the loader's forkserver and multiprocessing's resource tracker,
    and wait for both to exit. Left alone, each notices only after the
    calling process has exited that it is gone, and then outlives it while
    its own interpreter (torch imported) shuts down. Call it after every
    loader's workers have stopped and the loader is dropped: the tracker
    unlinks the semaphores of the queues still alive. A later ``loader``
    starts both anew."""
    from multiprocessing import forkserver, resource_tracker

    gc.collect()           # the dropped loaders' queues, in cycles
    # multiprocessing has no public way to stop either; both are 3.12's
    # module singletons, and _stop is a no-op for one that never started
    forkserver._forkserver._stop()
    tracker = resource_tracker._resource_tracker
    # a spawned process inherits its parent's tracker as a bare file
    # descriptor, without the pid that _stop waits on: the parent's to stop
    if tracker._pid is not None:
        tracker._stop()
