"""Command line of the PyTorch/CUDA port, the reference driver's surface
(``main_end2end_module2.py``) as the JAX package's ``cli.py`` has it:

    python -m animateportrait_tpu_torch.cli --jpg photo.png \\
        --audio speech.wav --exp formal/cartoon --ckpt_dir checkpoints

writes ``<output>/<photo>-<audio>/output_<exp>.avi``: uncompressed RGB
frames and the 16-bit PCM speech (``utils/video.py``). The photo is PNG or
binary PPM/PGM (``utils/image.py:read_image``); JPEG is not read yet.

Checkpoints are the reference's torch files, loaded as they are: the same
wrapper keys as the JAX CLI (``model``, ``G``, ``model_g_face_id``,
``genA2B``), a leading ``module.`` stripped, then a strict
``load_state_dict``; the few reference keys no net of the port runs are
dropped by name (``io/reference.py``). A missing checkpoint gets seeded
random weights with a warning, as in the JAX CLI: the pipeline runs end to
end, but the output is no portrait animation. The MTCNN weights
(``<ckpt_dir>/mtcnn/{pnet,rnet,onet}.npy``) are required. FAN3D is not
ported yet, so a FAN checkpoint in ``--ckpt_dir`` is an error: the JAX CLI
would use it and give other output. Not ported either: ``--video``,
``--render_dp`` and ``--warp_mode tps``; argparse rejects them.
``--render_bf16`` runs the renderer's per-frame nets in bf16
(``pipeline/render.py``), through K2 in bf16 on the card.

``--device`` (default ``cuda``) is where every net runs; without a CUDA
device, ``cuda`` is an error, never a silent fall back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import pickle
import sys
import time

import numpy as np
import torch

from animateportrait_tpu_torch.io.reference import (
    MODNET_TRAINING_HEADS, load_or_init)

FAN_CKPT_NAMES = ("3DFAN4-4a694010b9.zip", "3DFAN4-7835d9f11d.pth.tar",
                  "3DFAN4.pth", "2DFAN4-cd938726ad.zip",
                  "2DFAN4-11f355bf06.pth.tar", "2DFAN4.pth")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("animateportrait_tpu_torch")
    p.add_argument("--jpg", help="input face photo (PNG or binary PPM/PGM)")
    p.add_argument("--audio", help="input speech wav")
    p.add_argument("--rerun", type=int, default=0,
                   help="accepted for reference-CLI parity; the pipeline "
                   "keeps no stage files to redo")
    p.add_argument("--epoch", default="70",
                   help="generator checkpoint epoch to load")
    p.add_argument("--exp", default="formal/drawing",
                   help="style: formal/drawing | formal/cartoon")
    p.add_argument("--output", default="output",
                   help="directory for the final video")
    p.add_argument("--output_folder", default=None,
                   help="also write pred_fls_<audio>_audio_embed.txt here "
                   "(train_audio2landmark.py:340-342)")
    p.add_argument("--dump_dir", default=None,
                   help="also write the random_val_{fl,au,gaze}.pickle "
                   "stage dumps here (main_end2end_module2.py:230-251)")
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--load_AUTOVC_name", default="ckpt_autovc.pth")
    p.add_argument("--load_a2l_G_name", default="ckpt_speaker_branch.pth")
    p.add_argument("--load_a2l_C_name", default="ckpt_content_branch.pth")
    p.add_argument("--emb_coef", type=float, default=3.0)
    p.add_argument("--reuse_train_emb_list", nargs="+", default=[],
                   help="render one output per key with the saved speaker "
                   "embedding <ckpt_dir>/emb.pickle[key] for the landmark "
                   "branch")
    p.add_argument("--amp_lip_x", type=float, default=2.0)
    p.add_argument("--amp_lip_y", type=float, default=2.0)
    p.add_argument("--amp_pos", type=float, default=0.5)
    p.add_argument("--gender", default="F", choices=["M", "F"])
    p.add_argument("--frame_batch", type=int, default=32,
                   help="frames per renderer batch")
    p.add_argument("--render_bf16", action="store_true",
                   help="run the per-frame nets (trident generator + "
                        "intrinsic-flow Unet) in bfloat16; the "
                        "once-per-photo nets stay fp32")
    p.add_argument("--warp_mode", default="linear", choices=["linear"],
                   help="per-frame warp grids: the reference's "
                   "griddata-linear semantics (the JAX CLI's 'tps' is not "
                   "ported)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device for every net (default cuda)")
    # net widths for small random-weight runs; the reference fixes them
    p.add_argument("--ngf", type=int, default=64,
                   help="trident generator width (reference: 64)")
    p.add_argument("--flow_nf", type=int, default=16,
                   help="intrinsic-flow Unet width (reference: 16)")
    p.add_argument("--static_ngf", type=int, default=64,
                   help="static drawing net width (reference: 64)")
    p.add_argument("--cartoon_ngf", type=int, default=32,
                   help="photo2cartoon generator width (reference: 32)")
    # Module1 trainer hyperparameters, accepted as the reference driver
    # accepts them (main_end2end_module2.py:147-158); inference fixes the
    # shipped architecture and ignores them
    for name, kind, default in (
            ("pos_dim", int, 7), ("transformer_d_model", int, 32),
            ("transformer_N", int, 2), ("transformer_heads", int, 2),
            ("spk_emb_enc_size", int, 16), ("init_content_encoder", str, ""),
            ("lr", float, 1e-3), ("reg_lr", float, 1e-6),
            ("segment_batch_size", int, 1),
            ("lambda_laplacian_smooth_loss", float, 1.0)):
        p.add_argument(f"--{name}", type=kind, default=default)
    return p


def find_fan_checkpoint(ckpt_dir: str) -> str | None:
    """A face_alignment FAN checkpoint under <ckpt_dir>[/face_alignment],
    looked up as the JAX package's ``models/fan3d.py`` does."""
    for root in (ckpt_dir, os.path.join(ckpt_dir, "face_alignment")):
        for n in FAN_CKPT_NAMES:
            if os.path.exists(os.path.join(root, n)):
                return os.path.join(root, n)
        found = sorted(glob.glob(os.path.join(root, "*FAN4*.pth*")))
        if found:
            return found[0]
    return None


def build_pipeline(args):
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkPos)
    from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.models import mtcnn
    from animateportrait_tpu_torch.models import photo2cartoon
    from animateportrait_tpu_torch.pipeline.audio import AudioPipeline
    from animateportrait_tpu_torch.pipeline.end2end import (
        TalkingPortraitPipeline)
    from animateportrait_tpu_torch.pipeline.landmark import LandmarkPredictor
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    device = torch.device(args.device)
    cd = args.ckpt_dir
    style = "drawing" if "drawing" in args.exp else "cartoon"

    fan = find_fan_checkpoint(cd)
    if fan:
        raise SystemExit(
            f"found the FAN checkpoint {fan}: FAN3D is not ported to "
            "animateportrait_tpu_torch yet, and without it the output would "
            "differ from the JAX CLI's on the same inputs. Move it out of "
            f"{cd} to use the 5-point canonical-face fit, or run the JAX "
            "CLI (animateportrait).")
    mtcnn_dir = os.path.join(cd, "mtcnn")
    paths = [os.path.join(mtcnn_dir, f"{n}.npy") for n in ("pnet", "rnet",
                                                            "onet")]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise SystemExit(f"MTCNN weights missing: {missing} (the "
                         "reference's MTCNN/weights/*.npy)")
    detector = mtcnn.MTCNNDetector(mtcnn.load_pnet(paths[0]),
                                   mtcnn.load_rnet(paths[1]),
                                   mtcnn.load_onet(paths[2]), device=device)
    print("[animateportrait_tpu_torch] WARNING: FAN3D is not ported; the 68 "
          "source landmarks come from the canonical-face 5-point fit, so "
          "the output does not track this face's own shape.",
          file=sys.stderr)

    autovc = load_or_init(os.path.join(cd, args.load_AUTOVC_name),
                          AutoVCGenerator(), "autovc", unwrap="model")
    pos = load_or_init(os.path.join(cd, args.load_a2l_G_name),
                       Audio2landmarkPos(), "speaker branch", unwrap="G")
    content = load_or_init(os.path.join(cd, args.load_a2l_C_name),
                           Audio2landmarkContent(), "content branch",
                           unwrap="model_g_face_id")
    generator = load_or_init(
        os.path.join(cd, args.exp, f"{args.epoch}_net_G_A.pth"),
        TridentGeneratorFullIFW(output_nc=1 if style == "drawing" else 3,
                                ngf=args.ngf, div=3, disp=3),
        f"generator {args.exp}")
    flow = load_or_init(
        os.path.join(cd, "FlowReg_id_flow_faces", "best_net_netF.pth"),
        FlowUnet(nf=args.flow_nf), "flow regressor")
    modnet = load_or_init(
        os.path.join(cd, "modnet_photographic_portrait_matting.ckpt"),
        MODNet(), "modnet", drop=MODNET_TRAINING_HEADS)
    static_g = cartoon_g = None
    if style == "drawing":
        static_g = load_or_init(os.path.join(cd, "static", "drawing.pth"),
                                ResnetStyle2Generator(ngf=args.static_ngf),
                                "static drawing net")
    else:
        cartoon_g = load_or_init(
            os.path.join(cd, "static", "cartoon.pt"),
            photo2cartoon.Photo2CartoonGenerator(ngf=args.cartoon_ngf),
            "photo2cartoon", unwrap="genA2B", drop=photo2cartoon.UNUSED_KEY)

    return TalkingPortraitPipeline(
        detector,
        LandmarkPredictor(pos, content, amp_pos=args.amp_pos,
                          amp_lip_x=args.amp_lip_x, amp_lip_y=args.amp_lip_y,
                          emb_coef=args.emb_coef, device=device),
        AudioPipeline(autovc, device=device),
        Module2Renderer(generator, flow, modnet, static_g,
                        frame_batch=args.frame_batch, output_uint8=True,
                        device=device, style=style, cartoon_g=cartoon_g,
                        use_bf16=args.render_bf16))


def load_train_embs(ckpt_dir: str) -> dict:
    """The saved train-speaker embeddings {name: (256,) array}:
    ``emb.pickle`` probed at two places (train_audio2landmark.py:89-94),
    or ``emb.npz``."""
    for cand in (os.path.join(ckpt_dir, "emb.pickle"),
                 os.path.join(ckpt_dir, "..", "emb.pickle")):
        if os.path.exists(cand):
            with open(cand, "rb") as fp:
                return {k: np.asarray(v, np.float32).reshape(-1)
                        for k, v in pickle.load(fp).items()}
    npz = os.path.join(ckpt_dir, "emb.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            return {k: z[k].astype(np.float32).reshape(-1) for k in z.files}
    raise SystemExit(
        f"--reuse_train_emb_list: no emb.pickle/emb.npz under {ckpt_dir}")


@dataclasses.dataclass
class RunResult:
    path: str                          # the last video written
    frames: int
    fps: float
    stage_seconds: dict[str, float]    # pipeline stages + "mux"


def main(argv=None) -> RunResult:
    from animateportrait_tpu_torch.pipeline.audio import load_wav
    from animateportrait_tpu_torch.utils.image import read_image
    from animateportrait_tpu_torch.utils.video import write_video_with_audio

    t_start = time.perf_counter()

    def stage(msg):
        dt = time.perf_counter() - t_start
        print(f"[animateportrait_tpu_torch +{dt:6.1f}s] {msg}",
              file=sys.stderr, flush=True)

    args = build_argparser().parse_args(argv)
    if not args.jpg or not args.audio:
        raise SystemExit("need --jpg and --audio")
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device "
                             "(torch.cuda.is_available() is False)")
        # fp32 as the JAX package computes it (matmul precision highest)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        img = read_image(args.jpg)
    except (OSError, ValueError) as e:
        raise SystemExit(f"cannot read {args.jpg}: {e}") from e
    wav = load_wav(args.audio)
    emb_runs: list[tuple[str, np.ndarray | None]] = [("", None)]
    if args.reuse_train_emb_list:
        embs = load_train_embs(args.ckpt_dir)
        missing = [k for k in args.reuse_train_emb_list if k not in embs]
        if missing:
            raise SystemExit(
                f"--reuse_train_emb_list: unknown keys {missing}; "
                f"available: {sorted(embs)[:20]}")
        emb_runs = [(k, embs[k]) for k in args.reuse_train_emb_list]

    stage("building the pipeline")
    pipeline = build_pipeline(args)
    stage("pipeline built")
    audio_name = os.path.splitext(os.path.basename(args.audio))[0]
    base = "{}-{}".format(os.path.splitext(os.path.basename(args.jpg))[0],
                          audio_name)
    os.makedirs(os.path.join(args.output, base), exist_ok=True)
    result = None
    for key, emb in emb_runs:
        with torch.inference_mode():
            out = pipeline(img, wav, gender=args.gender,
                           rng=np.random.default_rng(args.seed),
                           spk_emb_override=emb,
                           output_folder=args.output_folder,
                           dump_dir=args.dump_dir, audio_name=audio_name)
        stage("pipeline done, muxing the video")
        t = time.perf_counter()
        suffix = f"_{key}" if key else ""
        path = write_video_with_audio(
            os.path.join(args.output, base,
                         f"output_{args.exp.replace('/', '_')}{suffix}.avi"),
            out.frames, wav, fps=out.fps)
        result = RunResult(path=path, frames=out.frames.shape[0],
                           fps=out.fps,
                           stage_seconds=dict(out.stage_seconds,
                                              mux=time.perf_counter() - t))
        stages = ", ".join(f"{k} {v:.3f} s"
                           for k, v in result.stage_seconds.items())
        print(f"[animateportrait_tpu_torch] wrote {path} ({result.frames} "
              f"frames @ {out.fps} fps; {stages})")
    return result


if __name__ == "__main__":
    main()
