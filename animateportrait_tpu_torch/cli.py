"""Command line of the PyTorch/CUDA port, the reference driver's surface
(``main_end2end_module2.py``) as the JAX package's ``cli.py`` has it:

    python -m animateportrait_tpu_torch.cli --jpg photo.jpg \\
        --audio speech.wav --exp formal/drawing --ckpt_dir checkpoints \\
        --warp_mode tps

writes ``<output>/<photo>-<audio>/output_<exp>.avi``: uncompressed RGB
frames and the 16-bit PCM speech (``utils/video.py``). The photo is a
baseline JPEG, a PNG of any kind or a binary PPM/PGM, read as
``cv2.imread`` reads it, EXIF orientation included
(``utils/image.py:read_image``; progressive JPEGs are refused by name).

Checkpoints are the reference's torch files, loaded as they are: the same
wrapper keys as the JAX CLI (``model``, ``G``, ``model_g_face_id``,
``genA2B``), a leading ``module.`` stripped, then a strict
``load_state_dict``; the few reference keys no net of the port runs are
dropped by name (``io/reference.py``). A missing checkpoint gets seeded
random weights with a warning, as in the JAX CLI: the pipeline runs end to
end, but the output is no portrait animation. The MTCNN weights
(``<ckpt_dir>/mtcnn/{pnet,rnet,onet}.npy``) are required.

The 68 source landmarks come from face_alignment's FAN (``3DFAN4`` /
``2DFAN4``, ``models/fan3d.py``) when ``find_fan_checkpoints`` finds one
under ``--ckpt_dir`` (or its ``face_alignment/``), with z from its depth
net when that is there too (0 without it, which the pipeline does not
read); a FAN checkpoint that is found but does not load strictly is an
error. Without one, the CLI warns and uses the 5-point canonical-face
fit, as the JAX CLI does.

``--video clip.avi`` takes the photo from the clip's first frame and the
speech from its soundtrack, as the JAX CLI's ``_split_video`` does with
OpenCV and ffmpeg, without either (``utils/video.py``): the first frame
of a raw or Motion-JPEG AVI goes through the port's quality-95 JPEG
encoder and decoder (``utils/jpeg.py``), as ``cv2.imwrite`` then
``cv2.imread`` take it, under the name ``frame``; the soundtrack is read
when it is 16 kHz mono 16-bit PCM, which ffmpeg's ``-ar 16000 -ac 1``
passes through unchanged, under the name ``audio``. ``--audio`` wins over
the soundtrack; another container, codec or track is refused by name.

``--warp_mode tps`` builds each frame batch's motion grid with the
on-device thin-plate spline instead of the reference's griddata-linear
grid (``pipeline/render.py``). ``--render_bf16`` runs the renderer's
per-frame nets in bf16, through K2 in bf16 on the card. Not ported:
``--render_dp`` (one card); argparse rejects it.

``--device`` (default ``cuda``) is where every net runs; without a CUDA
device, ``cuda`` is an error, never a silent fall back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import time

import numpy as np
import torch

from animateportrait_tpu_torch.io.reference import (
    MODNET_TRAINING_HEADS, load_or_init)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("animateportrait_tpu_torch")
    p.add_argument("--jpg", help="input face photo (baseline JPEG, PNG or "
                   "binary PPM/PGM)")
    p.add_argument("--audio", help="input speech wav")
    p.add_argument("--video", help="input video (raw or Motion-JPEG AVI): "
                   "its first frame becomes the photo, its 16 kHz mono PCM "
                   "track the speech unless --audio is given")
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
    p.add_argument("--warp_mode", default="linear",
                   choices=["linear", "tps"],
                   help="per-frame warp grids: 'linear' is the reference's "
                   "griddata-linear grid (host Delaunay); 'tps' the "
                   "on-device thin-plate spline")
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


def build_landmark_fn(ckpt_dir: str, detector, device: torch.device):
    """The FAN3D landmark hook (``models/fan3d.py:make_fan_landmark_fn``)
    when ``find_fan_checkpoints`` finds a FAN checkpoint under
    ``ckpt_dir``, with the depth net when it finds that too; None, with
    the JAX CLI's warning, when there is no FAN. A checkpoint that is found
    and does not load is an error."""
    from animateportrait_tpu_torch.io.reference import (
        load_fa_state_dict, load_into)
    from animateportrait_tpu_torch.models import fan3d

    fan_path, depth_path = fan3d.find_fan_checkpoints(ckpt_dir)
    if fan_path is None:
        print("[animateportrait_tpu_torch] WARNING: no face_alignment FAN "
              f"checkpoint found under {ckpt_dir} (looked for "
              "3DFAN4*/2DFAN4*.pth). Falling back to the canonical-face "
              "5-pt fit: every subject gets the same jaw/brow/lip geometry "
              "up to a similarity transform, so output will NOT track this "
              "face's actual shape. Place a face_alignment checkpoint in "
              "the checkpoint dir to fix this.", file=sys.stderr)
        return None
    nets = []
    for path, net in ((fan_path, fan3d.FAN3D()),
                      (depth_path, fan3d.ResNetDepth())):
        if path is None:
            nets.append(None)
            continue
        try:
            nets.append(load_into(net, load_fa_state_dict(path)))
        except Exception as e:
            raise SystemExit(f"cannot load the face_alignment checkpoint "
                             f"{path}: {type(e).__name__}: {e}") from e
    if depth_path is None:
        print("[animateportrait_tpu_torch] FAN loaded without the depth "
              "net; z comes out 0 (the driver overwrites z anyway)",
              file=sys.stderr)
    return fan3d.make_fan_landmark_fn(
        fan3d.FaceAlignment3D(nets[0], nets[1], device=device), detector)


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
    landmark_fn = build_landmark_fn(cd, detector, device)

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
                        use_bf16=args.render_bf16,
                        motion_mode=args.warp_mode),
        landmark_fn=landmark_fn)


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


def split_video(video_path: str, audio_path: str | None
                ) -> tuple[np.ndarray, str, np.ndarray | None, str | None]:
    """``--video`` (JAX ``cli.py:_split_video``): the first frame through
    a quality-95 JPEG and back, as ``cv2.imwrite`` then ``cv2.imread``
    take it (BGR), and, without ``--audio``, the clip's soundtrack.
    Returns (photo, its name, the speech or None, its name or None)."""
    from animateportrait_tpu_torch.utils import jpeg, video

    try:
        frame = video.read_first_frame(video_path)
        img = jpeg.decode_jpeg(jpeg.encode_jpeg(frame))
        if audio_path:
            return img, "frame", None, None
        return img, "frame", video.read_pcm_track(video_path), "audio"
    except (OSError, ValueError) as e:
        raise SystemExit(f"--video {video_path}: {e}") from e


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
    if not (args.jpg or args.video) or not (args.audio or args.video):
        raise SystemExit("need --jpg and --audio (or --video)")
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device "
                             "(torch.cuda.is_available() is False)")
        # fp32 as the JAX package computes it (matmul precision highest)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    wav = None
    if args.video:
        img, photo_name, wav, audio_name = split_video(args.video, args.audio)
    else:
        try:
            img = read_image(args.jpg)
        except (OSError, ValueError) as e:
            raise SystemExit(f"cannot read {args.jpg}: {e}") from e
        photo_name = os.path.splitext(os.path.basename(args.jpg))[0]
    if wav is None:
        wav = load_wav(args.audio)
        audio_name = os.path.splitext(os.path.basename(args.audio))[0]
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
    base = f"{photo_name}-{audio_name}"
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
