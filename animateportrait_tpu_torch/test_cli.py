"""Inference CLI of the PyTorch/CUDA port with the reference's
``Module2/test.py`` flag surface. Port of ``animateportrait_tpu/test_cli.py``:

    python -m animateportrait_tpu_torch.test_cli --dataroot <db> --name \\
        formal/drawing --model geomcgt_ifw_test \\
        --netG resnet_9blocks_rcatland32_full_ifw --netg_resb_div 3 \\
        --netg_resb_disp 3 --output_nc 1 --load_size 256 --crop_size 256 \\
        --epoch 70 --num_test 10000 --serial_batches --imagefolder <db>

It resolves the photo (A) and landmark-frame (B) lists from
``datasets/list/{phase}A|B/<dataroot>.txt`` (the files the reference
driver's ``getTestList`` writes, main_end2end_module2.py:71-87) or from
``<dataroot>/{phase}A|B``, renders every frame through the renderer's
``render_visuals`` (one call per photo, its frames in batches of
``--frame_batch``), and writes the reference's results tree:

    <results_dir>/<name>/<phase>_<epoch>/<imagefolder>/
        <nameA>-><nameB>_<label>.png      (one per visual)
    <results_dir>/<name>/<phase>_<epoch>/index<folder>.html

with the nine visuals of geomcgt_ifw_test_model.py:196-204: real_A,
real_A_lm, target_B_lm, fake_B, fake_B_vis, fg_mask, fakeB_static,
fake_B_fore, fg_mask1. The landmark drawings (``--draw_op`` 0 dots, 1
dots and lines, 2 coloured polygons) are ``utils/image.py:
draw_landmarks``, which draws as OpenCV and PIL do.

The generator loads strictly at the ``--netg_resb_div`` and
``--netg_resb_disp`` it is built with (the JAX CLI builds it at
``--netg_resb_disp`` and loads it at its loader's default of 1, so a
``disp=3`` checkpoint of the reference command does not load there). A
missing checkpoint takes seeded random weights with a warning.
``--device`` (default ``cuda``) is where the nets run; without a CUDA
device ``cuda`` is an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from animateportrait_tpu_torch.io.reference import (
    MODNET_TRAINING_HEADS, load_or_init)

LABELS = ("real_A", "real_A_lm", "target_B_lm", "fake_B", "fake_B_vis",
          "fg_mask", "fakeB_static", "fake_B_fore", "fg_mask1")


def build_test_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("animateportrait_tpu_torch-test")
    # base options (base_options.py): the subset test.py reads
    p.add_argument("--dataroot", required=True,
                   help="db name (resolved through datasets/list/) or a "
                   "directory holding {phase}A/{phase}B")
    p.add_argument("--name", default="formal/drawing",
                   help="experiment name; 'drawing'/'cartoon' picks the "
                   "static stylizer (geomcgt_ifw_test_model.py:225)")
    p.add_argument("--model", default="geomcgt_ifw_test")
    p.add_argument("--netG", default="resnet_9blocks_rcatland32_full_ifw")
    p.add_argument("--netg_resb_div", type=int, default=3)
    p.add_argument("--netg_resb_disp", type=int, default=1)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--input_nc", type=int, default=3)
    p.add_argument("--output_nc", type=int, default=3)
    p.add_argument("--norm", default="instance")
    p.add_argument("--no_dropout", action="store_true")
    p.add_argument("--load_size", type=int, default=256)
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--no_flip", action="store_true")
    p.add_argument("--dataset_mode", default="umlvdfw_test")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--epoch", default="latest")
    p.add_argument("--serial_batches", action="store_true")
    p.add_argument("--max_dataset_size", type=int, default=float("inf"))
    p.add_argument("--direction", default="AtoB")
    p.add_argument("--preprocess", default="resize_and_crop")
    p.add_argument("--suffix", default="")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--batch_size", type=int, default=1)   # test.py forces 1
    p.add_argument("--num_threads", type=int, default=0)  # test.py forces 0
    p.add_argument("--gpu_ids", default="0")
    p.add_argument("--display_winsize", type=int, default=256)
    # test options (test_options.py:10-25)
    p.add_argument("--ntest", type=int, default=float("inf"))
    p.add_argument("--results_dir", default="./results/")
    p.add_argument("--aspect_ratio", type=float, default=1.0)
    p.add_argument("--phase", default="test")
    p.add_argument("--eval", action="store_true",
                   help="accepted for compatibility: the nets always run "
                   "in inference mode")
    p.add_argument("--num_test", type=int, default=50)
    p.add_argument("--imagefolder", default="images")
    # flags the test model adds (geomcgt_ifw_test_model.py:176-186)
    p.add_argument("--draw_op", type=int, default=0,
                   help="landmark image style: 0 dots / 1 +lines / 2 "
                   "coloured polygons (umlvdfw_test_dataset.py:34-65)")
    p.add_argument("--blendbg", type=int, default=0,
                   help="accepted for compatibility (the test model never "
                   "reads it; the blend always runs)")
    p.add_argument("--truncate", type=float, default=0.0,
                   help="accepted for compatibility (never read)")
    # the port's own
    p.add_argument("--frame_batch", type=int, default=8,
                   help="frames per batch of the renderer")
    p.add_argument("--warp_mode", default="linear", choices=["linear", "tps"],
                   help="'linear': the reference's griddata-linear grids "
                   "(host Delaunay); 'tps': the on-device thin-plate spline")
    p.add_argument("--device", default="cuda",
                   help="torch device for every net (default cuda)")
    return p


def resolve_lists(dataroot: str, phase: str,
                  max_size: float) -> tuple[list[str], list[str]]:
    """The A/B image lists (umlvdfw_test_dataset.py:93-105): the driver's
    list files when both are there, else the images under
    <dataroot>/{phase}A|B."""
    la = os.path.join("datasets", "list", phase + "A", dataroot + ".txt")
    lb = os.path.join("datasets", "list", phase + "B", dataroot + ".txt")
    if os.path.exists(la) and os.path.exists(lb):
        with open(la) as fa, open(lb) as fb:
            A, B = sorted(fa.read().splitlines()), sorted(fb.read().splitlines())
    else:
        exts = (".png", ".jpg", ".jpeg")

        def walk(d):
            return sorted(os.path.join(r, f) for r, _, files in os.walk(d)
                          for f in files if f.lower().endswith(exts))

        A = walk(os.path.join(dataroot, phase + "A"))
        B = walk(os.path.join(dataroot, phase + "B"))
    if np.isfinite(max_size):
        A, B = A[:int(max_size)], B[:int(max_size)]
    return A, B


def lm_txt_for(path: str) -> str:
    """The landmark txt of an A photo or a B landmark-frame image
    (umlvdfw_test_dataset.py:125-130)."""
    if "/Alm/MTCNN/" in path or os.sep + "Alm" + os.sep in path:
        base = path.replace("/Alm/MTCNN/", "/Alm_txt/MTCNN/")
    elif "/Photo/" in path:
        base = path.replace("/Photo/", "/Alm_txt/MTCNN/")
    else:
        base = path.replace("/Drawing/", "/Blm_txt/MTCNN/")
    return os.path.splitext(base)[0] + ".txt"


def read_lm(path: str) -> np.ndarray:
    """(N, 2) float32 from a txt of "x y ..." rows."""
    with open(path) as f:
        rows = f.read().splitlines()
    return np.array([[float(r.split()[0]), float(r.split()[1])] for r in rows],
                    np.float32)


def tensor2im(arr: np.ndarray) -> np.ndarray:
    """[-1, 1] float (H, W, C) -> uint8 RGB (util/util.py:9-30): scaled,
    clipped and truncated; one channel repeated to three."""
    a = np.asarray(arr, np.float32)
    if a.ndim == 4:
        a = a[0]
    a = np.clip((a + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    return a


def build_renderer(args, device: torch.device):
    """The renderer from checkpoints in the reference layout: G_A at
    <checkpoints_dir>/<name>/<epoch>_net_G_A.pth, the frozen nets at
    <checkpoints_dir>/{modnet...ckpt, static/, FlowReg_id_flow_faces/}
    (geomcgt_ifw_test_model.py:202-229)."""
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.models import photo2cartoon
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    cd = args.checkpoints_dir
    style = "cartoon" if "cartoon" in args.name else "drawing"
    if "drawing" not in args.name and "cartoon" not in args.name:
        print(f"[test] WARNING: --name {args.name} names neither 'drawing' "
              "nor 'cartoon'; the static stylizer defaults to drawing (the "
              "reference would fail here)", file=sys.stderr)
    generator = load_or_init(
        os.path.join(cd, args.name, f"{args.epoch}_net_G_A.pth"),
        TridentGeneratorFullIFW(output_nc=args.output_nc, ngf=args.ngf,
                                div=args.netg_resb_div,
                                disp=args.netg_resb_disp),
        f"generator {args.name}")
    flow = load_or_init(
        os.path.join(cd, "FlowReg_id_flow_faces", "best_net_netF.pth"),
        FlowUnet(), "flow regressor")
    modnet = load_or_init(
        os.path.join(cd, "modnet_photographic_portrait_matting.ckpt"),
        MODNet(), "modnet", drop=MODNET_TRAINING_HEADS)
    static_g = cartoon_g = None
    if style == "drawing":
        static_g = load_or_init(os.path.join(cd, "static", "drawing.pth"),
                                ResnetStyle2Generator(), "static drawing net")
    else:
        cartoon_g = load_or_init(
            os.path.join(cd, "static", "cartoon.pt"),
            photo2cartoon.Photo2CartoonGenerator(), "photo2cartoon",
            unwrap="genA2B", drop=photo2cartoon.UNUSED_KEY)
    return Module2Renderer(generator, flow, modnet, static_g,
                           frame_batch=args.frame_batch, device=device,
                           style=style, cartoon_g=cartoon_g,
                           motion_mode=args.warp_mode,
                           crop_size=args.crop_size)


@dataclasses.dataclass
class TestResult:
    index: str                       # the HTML index written
    image_dir: str
    names: list[str]                 # "<nameA>-><nameB>" per frame
    render_seconds: float            # render_visuals calls, synchronized
    seconds: float                   # the whole main, nets built included


def _write_html(path: str, args, rows) -> None:
    """index<folder>.html as util/html.py writes it."""
    folder = args.imagefolder
    with open(path, "w") as f:
        f.write(f"<html><head><title>Experiment = {args.name}, Phase = "
                f"{args.phase}, Epoch = {args.epoch}</title></head><body>\n")
        for name, row in rows:
            f.write(f"<h3>{name}</h3>\n"
                    "<table border='1' style='table-layout: fixed;'><tr>\n")
            for label, fn in row:
                src = f"{folder}/{fn}"
                f.write(f"<td style='word-wrap: break-word;' valign='top'>"
                        f"<p><a href='{src}'><img style='width:"
                        f"{args.display_winsize}px' src='{src}'></a><br>"
                        f"<p>{label}</p></p></td>\n")
            f.write("</tr></table>\n")
        f.write("</body></html>\n")


def load_group(args, A_path: str, B_paths: list[str]):
    """One photo and its landmark frames as the test dataset gives them
    (umlvdfw_test_dataset.py:107-160): the photo read as PIL reads it,
    resized bicubic to ``--load_size`` and cropped, in [-1, 1] (cs, cs, C);
    its 68 points and each frame's through the same resize and crop
    (a frame is sized by the photo, :136), each frame's face window, and
    the "<nameA>-><nameB>" names. test.py forces no_flip; with load_size
    == crop_size (the test options' default) the crop is (0, 0)."""
    from animateportrait_tpu_torch.data.umlvd_ifw import (
        DataConfig, _get_params2, trans_lm)
    from animateportrait_tpu_torch.utils.image import (
        image_size, load_image, resize_bicubic_pil)

    cs = args.crop_size
    cfg = DataConfig(root="", load_size=args.load_size, crop_size=cs,
                     no_flip=True, output_nc=args.output_nc)
    size = image_size(A_path)
    A_img = load_image(A_path, grayscale=args.input_nc == 1)
    pA = _get_params2(cfg, size, np.random.default_rng(0))
    x0, y0 = pA["crop_pos"]
    A_res = resize_bicubic_pil(A_img, (args.load_size, args.load_size))
    A_arr = A_res[y0:y0 + cs, x0:x0 + cs].astype(np.float32) / 255.0 * 2 - 1
    if A_arr.ndim == 2:
        A_arr = A_arr[..., None]
    a68, _ = trans_lm(read_lm(lm_txt_for(A_path)), pA, cfg, size)
    tb68s, wins, names = [], [], []
    nameA = os.path.splitext(os.path.basename(A_path))[0]
    for B_path in B_paths:
        pB = _get_params2(cfg, size, np.random.default_rng(0))
        lm, win = trans_lm(read_lm(lm_txt_for(B_path)), pB, cfg, size)
        tb68s.append(lm)
        wins.append(win)
        names.append(f"{nameA}->{os.path.splitext(os.path.basename(B_path))[0]}")
    return A_arr, a68, np.stack(tb68s), wins, names


def main(argv=None) -> TestResult:
    from animateportrait_tpu_torch.utils.image import (
        draw_landmarks, resize_bicubic_pil, write_png)
    from animateportrait_tpu_torch.utils.observe import draw_lm_overlay
    from animateportrait_tpu_torch.utils.options import archive_options

    t_start = time.perf_counter()
    args = build_test_argparser().parse_args(argv)
    if args.suffix:
        args.name = args.name + "_" + args.suffix.format(**vars(args))
    if args.preprocess != "resize_and_crop":
        raise SystemExit(f"--preprocess {args.preprocess}: only "
                         "resize_and_crop is supported")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device "
                             "(torch.cuda.is_available() is False)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(archive_options(args))

    A_paths, B_paths = resolve_lists(args.dataroot, args.phase,
                                     args.max_dataset_size)
    if not A_paths or not B_paths:
        raise SystemExit(f"no test images: A={len(A_paths)} "
                         f"B={len(B_paths)} (dataroot {args.dataroot}, "
                         f"phase {args.phase})")
    n = int(min(len(B_paths) if args.serial_batches
                else max(len(A_paths), len(B_paths)),
                args.num_test, args.ntest))

    renderer = build_renderer(args, device)
    cs = args.crop_size
    prng = np.random.default_rng(0)
    web_dir = os.path.join(args.results_dir, args.name,
                           f"{args.phase}_{args.epoch}")
    img_dir = os.path.join(web_dir, args.imagefolder)
    os.makedirs(img_dir, exist_ok=True)
    radius = 5 if cs == 512 else 3
    thickness = 4 if cs == 512 else 2

    items = []
    for i in range(n):
        b = (B_paths[i % len(B_paths)] if args.serial_batches
             else B_paths[int(prng.integers(0, len(B_paths)))])
        items.append((A_paths[i % len(A_paths)], b))

    rows, names_all, render_s = [], [], 0.0
    i = 0
    while i < n:
        A_path = items[i][0]
        j = i
        while j < n and items[j][0] == A_path:
            j += 1
        # one photo's frames [i, j)
        A_arr, a68, tb68s, wins, names = load_group(
            args, A_path, [items[k][1] for k in range(i, j)])
        T = tb68s.shape[0]
        t0 = time.perf_counter()
        with torch.inference_mode():
            vis = renderer.render_visuals(A_arr, a68, tb68s)
        render_s += time.perf_counter() - t0

        a_lm_img = draw_landmarks(cs, cs, a68, radius, thickness,
                                  op=args.draw_op)
        for t in range(T):
            visuals = {
                "real_A": vis["real_A"][t],
                "real_A_lm": a_lm_img,
                "target_B_lm": draw_landmarks(cs, cs, tb68s[t], radius,
                                              thickness, op=args.draw_op),
                "fake_B": vis["fake_B"][t],
                "fake_B_vis": draw_lm_overlay(vis["fake_B"][t], tb68s[t],
                                              wins[t], hradius=3),
                "fg_mask": vis["fg_mask"][t],
                "fakeB_static": vis["fakeB_static"][t],
                "fake_B_fore": vis["fake_B_fore"][t],
                "fg_mask1": vis["fg_mask1"][t],
            }
            row = []
            for label, im in visuals.items():
                rgb = tensor2im(im)
                if args.aspect_ratio != 1.0:
                    hh, ww = rgb.shape[:2]
                    if args.aspect_ratio > 1.0:
                        out = (int(ww * args.aspect_ratio), hh)
                    else:
                        out = (ww, int(hh / args.aspect_ratio))
                    rgb = resize_bicubic_pil(rgb, out)
                fn = f"{names[t]}_{label}.png"
                write_png(os.path.join(img_dir, fn), rgb)
                row.append((label, fn))
            rows.append((names[t], row))
        names_all += names
        print(f"[test] {j}/{n} frames rendered", file=sys.stderr)
        i = j

    folder = args.imagefolder
    suffix = folder[6:] if folder.startswith("images") else folder
    index = os.path.join(web_dir, f"index{suffix}.html")
    _write_html(index, args, rows)
    print(f"[test] wrote {index}")
    return TestResult(index=index, image_dir=img_dir, names=names_all,
                      render_seconds=render_s,
                      seconds=time.perf_counter() - t_start)


if __name__ == "__main__":
    main()
