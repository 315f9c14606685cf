"""The reference trainer's options (``Module2/train.py``: base_options.py,
train_options.py and the flags geomgm_ifw_fore_model injects) mapped onto
the port's configs, so the readme's training commands (readme.md:65-67)
drive ``python -m animateportrait_tpu_torch.train_cli``. Port of
``animateportrait_tpu/utils/options.py``; the parsed options are archived
to ``<checkpoints_dir>/<name>/<phase>_opt.txt`` as the reference does
(base_options.py:89-112).

``--data_parallel N`` trains on N ranks, one card each (``data_parallel_
world``: 0, the JAX default, takes every visible card, or one rank on
``--device cpu``; more ranks than cards is an error). ``--device``
(default ``cuda``) is where the step runs; ``--compute_dtype bfloat16``
trains in the JAX package's mixed precision (``train/module2.py``).
"""
from __future__ import annotations

import argparse
import os

from animateportrait_tpu_torch.data.umlvd_ifw import DataConfig
from animateportrait_tpu_torch.train.module2 import Module2Config


def build_train_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("animateportrait-train")
    # base options (base_options.py)
    p.add_argument("--dataroot", required=True)
    p.add_argument("--name", default="experiment_name")
    p.add_argument("--model", default="geomgm_ifw_fore")
    p.add_argument("--netG", default="resnet_9blocks_rcatland32_full_ifw")
    p.add_argument("--netD", default="basic")
    p.add_argument("--n_layers_D", type=int, default=3)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--input_nc", type=int, default=3)
    p.add_argument("--output_nc", type=int, default=3)
    p.add_argument("--norm", default="instance")
    p.add_argument("--init_type", default="normal")
    p.add_argument("--init_gain", type=float, default=0.02)
    p.add_argument("--no_dropout", action="store_true")
    p.add_argument("--load_size", type=int, default=286)
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--no_flip", action="store_true")
    p.add_argument("--dataset_mode", default="umlvd_ifw")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--netg_resb_div", type=int, default=3)
    p.add_argument("--netg_resb_disp", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_threads", type=int, default=4,
                   help="data-loader worker threads (base_options.py)")
    p.add_argument("--phase", default="train")
    p.add_argument("--serial_batches", action="store_true",
                   help="deterministic A/B pairing (index % size) instead "
                   "of random B sampling (umlvd_ifw_dataset.py:151-155)")
    p.add_argument("--max_dataset_size", type=int, default=float("inf"),
                   help="cap on each image list (base_options.py:45)")
    p.add_argument("--direction", default="AtoB",
                   choices=["AtoB", "BtoA"],
                   help="BtoA swaps the datasets' input/output channel "
                   "bookkeeping (umlvd_ifw_dataset.py:145-147)")
    p.add_argument("--preprocess", default="resize_and_crop",
                   help="only resize_and_crop is supported: the umlvd "
                   "datasets' landmark/TPS arithmetic assumes the "
                   "load_size resize + crop_size crop geometry")
    p.add_argument("--suffix", default="",
                   help="opt.name += '_' + suffix.format(**vars(opt)) "
                   "(base_options.py:119-122)")
    p.add_argument("--verbose", action="store_true",
                   help="print per-network parameter counts")
    # visdom server knobs: accepted for reference-CLI compatibility; the
    # live visdom dashboard is replaced by the HTML gallery + loss log
    # (--display_freq/--update_html_freq/--no_html act on those)
    p.add_argument("--display_id", type=int, default=1)
    p.add_argument("--display_ncols", type=int, default=4)
    p.add_argument("--display_port", type=int, default=8097)
    p.add_argument("--display_server", default="http://localhost")
    p.add_argument("--display_winsize", type=int, default=256)
    p.add_argument("--display_env", default="main")
    p.add_argument("--gpu_ids", default="0")    # placement is --device
    p.add_argument("--gpu_ids_p", default="-2")
    # train options (train_options.py)
    p.add_argument("--niter", type=int, default=100)
    p.add_argument("--niter_decay", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.0002)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--gan_mode", default="lsgan")
    p.add_argument("--pool_size", type=int, default=50)
    p.add_argument("--lr_policy", default="linear",
                   choices=["linear", "step", "plateau", "cosine"])
    p.add_argument("--lr_decay_iters", type=int, default=50)
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--epoch", default="latest")
    p.add_argument("--epoch_count", type=int, default=1,
                   help="starting epoch (train_options.py:27): shifts "
                   "the epoch loop and the linear-lr decay onset")
    p.add_argument("--load_iter", type=int, default=0,
                   help="with --continue_train, resume from this exact "
                   "step instead of the latest checkpoint "
                   "(base_options.py load_iter)")
    p.add_argument("--save_epoch_freq", type=int, default=5)
    p.add_argument("--print_freq", type=int, default=100)
    # visual-dashboard / latest-save cadence (train_options.py:13-24)
    p.add_argument("--display_freq", type=int, default=400,
                   help="steps between visual snapshots (0 = off)")
    p.add_argument("--update_html_freq", type=int, default=1000,
                   help="steps between HTML gallery refreshes")
    p.add_argument("--no_html", action="store_true",
                   help="do not write <ckpt>/<name>/web/ galleries")
    p.add_argument("--save_latest_freq", type=int, default=5000,
                   help="steps between latest-state checkpoints (0 = off)")
    p.add_argument("--save_by_iter", action="store_true",
                   help="keep every latest-save as its own step instead "
                   "of pruning to the most recent few")
    # model-injected flags (geomgm_ifw_fore_model.py:162-209)
    p.add_argument("--lambda_geom", type=float, default=5.0)
    p.add_argument("--lambda_geom_lipline", type=float, default=0.0)
    p.add_argument("--lambda_G_A_l", type=float, default=0.5)
    p.add_argument("--lambda_face", type=float, default=5.0)
    p.add_argument("--lambda_warp", type=float, default=5.0)
    p.add_argument("--lambda_warp_inter", type=float, default=5.0)
    p.add_argument("--lambda_G_A_coh", type=float, default=0.5)
    p.add_argument("--use_mask", type=int, default=1)
    p.add_argument("--use_eye_mask", type=int, default=1)
    p.add_argument("--use_lip_mask", type=int, default=1)
    p.add_argument("--mask_type", type=int, default=3)
    p.add_argument("--blendbg", type=int, default=0)
    p.add_argument("--coherent", type=int, default=1)
    p.add_argument("--coh_use_more", type=int, default=2)
    p.add_argument("--check_fakeb2_in_backwardD", type=int, default=1)
    p.add_argument("--identity_loss", type=int, default=2)
    p.add_argument("--warp_loss", type=int, default=2)
    p.add_argument("--more_weight_for_lip", type=int, default=2)
    p.add_argument("--select_target12_thre", type=float, default=0.0)
    p.add_argument("--select_noniden_thre", type=float, default=0.9)
    p.add_argument("--max_offset", type=float, default=3.0)
    p.add_argument("--face_recog_model",
                   default="./checkpoints/sphere20a_20171020.pth",
                   help="FaceLoss backbone checkpoint; a path containing "
                   "'senet' selects the 224x224 SENet50 variant "
                   "(geomgm_ifw_fore_model.py:185, networks.py:2862-2876)")
    # crop-window flags (geomgm_ifw_fore_model.py:203-205). Reference
    # quirk: it registers these but get_params2 is always called without
    # forwarding them (base_dataset.py:81, umlvd_ifw_dataset.py:181-182),
    # so they are dead there; here they actually drive the face-region
    # crop window.
    p.add_argument("--rx", type=float, default=0.15, help="rx for win")
    p.add_argument("--ry", type=float, default=0.2, help="ry for win")
    p.add_argument("--rs", type=float, default=0.7, help="rs for win")
    # the JAX package's extras
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16: every network forward/backward in bf16 "
                        "(fp32 master params, optimizer, losses and TPS "
                        "solves)")
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="data-parallel ranks, one card each (0 = every "
                        "visible card; one rank on --device cpu)")
    p.add_argument("--remat", type=int, default=0,
                   help="recompute the generator forwards in the backward "
                        "(torch.utils.checkpoint): memory for larger "
                        "batches")
    p.add_argument("--device", default="cuda",
                   help="torch device of the step (default cuda)")
    return p


def to_configs(args: argparse.Namespace
               ) -> tuple[Module2Config, DataConfig]:
    if getattr(args, "suffix", ""):
        # base_options.py:119-122: opt.name = opt.name + '_' + suffix
        args.name = args.name + "_" + args.suffix.format(**vars(args))
        args.suffix = ""
    if getattr(args, "preprocess", "resize_and_crop") != "resize_and_crop":
        raise SystemExit(
            f"--preprocess {args.preprocess}: only resize_and_crop is "
            "supported (the umlvd datasets' landmark/TPS arithmetic is "
            "tied to the load_size->crop_size geometry; other modes "
            "mis-scale landmarks in the reference too)")
    btoA = getattr(args, "direction", "AtoB") == "BtoA"
    cartoon = "cartoon" in args.model or "cartoon" in args.dataset_mode
    m2 = Module2Config(
        crop_size=args.crop_size,
        output_nc=args.output_nc,
        ngf=args.ngf, ndf=args.ndf, n_layers_d=args.n_layers_D,
        netg_resb_div=args.netg_resb_div,
        netg_resb_disp=args.netg_resb_disp,
        lr=args.lr, beta1=args.beta1,
        niter=args.niter, niter_decay=args.niter_decay,
        lr_policy=args.lr_policy, lr_decay_iters=args.lr_decay_iters,
        init_type=args.init_type, init_gain=args.init_gain,
        compute_dtype=args.compute_dtype,
        remat=bool(args.remat),
        steps_per_epoch=args.steps_per_epoch,
        pool_size=args.pool_size, gan_mode=args.gan_mode,
        lambda_geom=args.lambda_geom,
        lambda_geom_lipline=args.lambda_geom_lipline,
        lambda_g_a_l=args.lambda_G_A_l,
        lambda_g_a_coh=args.lambda_G_A_coh,
        lambda_face=args.lambda_face,
        lambda_warp=args.lambda_warp,
        lambda_warp_inter=args.lambda_warp_inter,
        use_mask=bool(args.use_mask),
        use_eye_mask=bool(args.use_eye_mask),
        use_lip_mask=bool(args.use_lip_mask),
        mask_type=args.mask_type,
        blendbg=args.blendbg,
        coherent=0 if cartoon else args.coherent,
        coh_use_more=0 if cartoon else args.coh_use_more,
        check_fakeb2_in_backward_d=bool(args.check_fakeb2_in_backwardD),
        identity_loss=args.identity_loss,
        warp_loss=args.warp_loss,
        more_weight_for_lip=args.more_weight_for_lip,
        face_recog_model=getattr(
            args, "face_recog_model", "sphere20a"),
        # one stacked pass per discriminator from batch 2, as the JAX
        # package chooses
        batch_d_passes=getattr(args, "batch_size", 1) >= 2,
    )
    data = DataConfig(
        root=args.dataroot,
        style_dir="Cartoon" if cartoon else "Drawing",
        load_size=args.load_size, crop_size=args.crop_size,
        no_flip=args.no_flip,
        # BtoA swaps the datasets' channel bookkeeping only
        # (umlvd_ifw_dataset.py:145-147); the nets keep their own flags
        input_nc=args.output_nc if btoA else args.input_nc,
        output_nc=args.input_nc if btoA else args.output_nc,
        serial_batches=getattr(args, "serial_batches", False),
        max_dataset_size=float(getattr(args, "max_dataset_size",
                                       float("inf"))),
        max_offset=args.max_offset,
        rx=args.rx, ry=args.ry, rs=args.rs,
        select_target12_thre=args.select_target12_thre,
        select_noniden_thre=args.select_noniden_thre,
        coh_use_more=bool(args.coh_use_more) and not cartoon,
        use_clips=not cartoon,
    )
    return m2, data


def data_parallel_world(requested: int, device: str,
                        n_cards: int | None = None) -> int:
    """The ranks of ``--data_parallel requested`` on ``device``'s type: 0
    takes every visible card (one rank on the CPU). On CUDA, more ranks
    than ``n_cards`` (default: the visible cards) is an error that names
    both numbers, where the JAX package shrinks its mesh to the devices it
    has."""
    import torch

    if requested < 0:
        raise SystemExit(f"--data_parallel {requested}: a count of ranks")
    if torch.device(device).type != "cuda":
        return requested or 1
    n_cards = torch.cuda.device_count() if n_cards is None else n_cards
    if requested > n_cards:
        raise SystemExit(f"--data_parallel {requested}: more ranks than the "
                         f"{n_cards} visible CUDA cards")
    return requested or max(n_cards, 1)


def archive_options(args: argparse.Namespace) -> str:
    """Print + save the full option set (base_options.py:89-112)."""
    lines = ["----------------- Options ---------------"]
    for k, v in sorted(vars(args).items()):
        lines.append(f"{k}: {v}")
    lines.append("----------------- End -------------------")
    text = "\n".join(lines)
    expr_dir = os.path.join(args.checkpoints_dir, args.name)
    os.makedirs(expr_dir, exist_ok=True)
    path = os.path.join(expr_dir, f"{args.phase}_opt.txt")
    with open(path, "w") as f:
        f.write(text + "\n")
    return text
