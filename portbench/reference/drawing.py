"""The ``drawing_infer`` configuration's nets, checkpoints and plain
reference pipeline, and the comparison that decides ``correct``.

Every weight is made here from the seed (``inputs.fill_``) over the
frozen reference's nets. The port gets them as the checkpoint files its
CLI loads; the reference gets the same nets made again from the seed
after the port is freed. The reference follows the port stage by stage:
each stage of a clip runs on the inputs that the port's stage got (the
decoded photo, the aligned photo, the WAV, the landmark windows, the
renderer's photo and landmarks), and what the port's stage produced is
compared with what the reference's produces."""
from __future__ import annotations

import os

import numpy as np
import torch

from portbench import inputs

def make_nets(cfg: dict, seed: int, device) -> dict:
    """Every net of the configuration, on ``device``, its weights from
    ``seed``: the slice's nets as ``utils/smoke.py:full_width_nets`` fills
    them, and MTCNN's heads biased toward a face."""
    from portbench.reference.frozen.models import mtcnn
    from portbench.reference.frozen.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkPos)
    from portbench.reference.frozen.models.autovc import AutoVCGenerator
    from portbench.reference.frozen.models.flowunet import FlowUnet
    from portbench.reference.frozen.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from portbench.reference.frozen.models.modnet import MODNet

    ctors = {
        "autovc": (AutoVCGenerator, "smoke"),
        "pos": (Audio2landmarkPos, "smoke"),
        "content": (Audio2landmarkContent, "smoke"),
        "generator": (lambda: TridentGeneratorFullIFW(
            output_nc=cfg["output_nc"], ngf=cfg["ngf"],
            n_blocks=cfg["n_blocks"], div=cfg["div"], disp=cfg["disp"]),
            "smoke"),
        "flowunet": (lambda: FlowUnet(nf=cfg["flow_nf"]), "smoke"),
        "modnet": (MODNet, "smoke"),
        "static_g": (lambda: ResnetStyle2Generator(ngf=cfg["static_ngf"]),
                     "smoke"),
        "pnet": (mtcnn.PNet, "smoke"), "rnet": (mtcnn.RNet, "smoke"),
        "onet": (mtcnn.ONet, "smoke"),
    }
    nets = {name: inputs.build(ctor, inputs.sub_seed(seed, name), rule,
                               device)
            for name, (ctor, rule) in ctors.items()}
    with torch.no_grad():
        for name, head in (("pnet", "conv4_1"), ("rnet", "conv5_1"),
                           ("onet", "conv6_1")):
            layer = getattr(nets[name], head)
            layer.bias.add_(torch.tensor(
                [-inputs.MTCNN_FACE_BIAS, inputs.MTCNN_FACE_BIAS],
                device=layer.bias.device))
    return nets


def write_checkpoints(nets: dict, ckpt_dir: str, exp: str,
                      epoch: str = "70") -> str:
    """The nets as the files the port's CLI reads under ``ckpt_dir``
    (``cli.build_pipeline``): MTCNN's pickled ``.npy`` dicts and a state
    dict for each of the other nets. No FAN checkpoint: the CLI then takes
    its 5-point fit."""
    def sd(name):
        return {k: v.detach().cpu() for k, v in nets[name].state_dict()
                .items()}

    files = {
        "ckpt_autovc.pth": "autovc", "ckpt_speaker_branch.pth": "pos",
        "ckpt_content_branch.pth": "content",
        os.path.join(exp, f"{epoch}_net_G_A.pth"): "generator",
        os.path.join("FlowReg_id_flow_faces", "best_net_netF.pth"):
            "flowunet",
        "modnet_photographic_portrait_matting.ckpt": "modnet",
        os.path.join("static", "drawing.pth"): "static_g",
    }
    for rel, name in files.items():
        path = os.path.join(ckpt_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(sd(name), path)
    os.makedirs(os.path.join(ckpt_dir, "mtcnn"), exist_ok=True)
    for name in ("pnet", "rnet", "onet"):
        np.save(os.path.join(ckpt_dir, "mtcnn", f"{name}.npy"),
                {k: v.numpy() for k, v in sd(name).items()},
                allow_pickle=True)
    return ckpt_dir


def build_pipeline(cfg: dict, nets: dict, device):
    """The frozen reference's ``TalkingPortraitPipeline`` on the nets, as
    ``cli.build_pipeline`` assembles the port's without a FAN checkpoint
    (the CLI's default amplifiers, AutoVC without a voice encoder, the
    5-point fit)."""
    from portbench.reference.frozen.models import mtcnn
    from portbench.reference.frozen.pipeline.audio import AudioPipeline
    from portbench.reference.frozen.pipeline.end2end import (
        TalkingPortraitPipeline)
    from portbench.reference.frozen.pipeline.landmark import (
        LandmarkPredictor)
    from portbench.reference.frozen.pipeline.render import Module2Renderer

    device = torch.device(device)
    detector = mtcnn.MTCNNDetector(nets["pnet"], nets["rnet"], nets["onet"],
                                   device=device)
    return TalkingPortraitPipeline(
        detector,
        LandmarkPredictor(nets["pos"], nets["content"], amp_pos=0.5,
                          amp_lip_x=2.0, amp_lip_y=2.0, emb_coef=3.0,
                          device=device),
        AudioPipeline(nets["autovc"], device=device),
        Module2Renderer(nets["generator"], nets["flowunet"], nets["modnet"],
                        nets["static_g"], frame_batch=cfg["frame_batch"],
                        output_uint8=True, device=device,
                        motion_mode=cfg["warp_mode"]))


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def compare(cfg: dict, clips: list, photos: dict, device,
            nets: dict, render_sample: list[int]) -> dict:
    """The numbers compared for the clips the window finished. ``clips``:
    each clip's record (``drivers/clips.py``); ``photos``: each photo's
    path and the port's decoded pixels; ``render_sample``: the indices of
    the clips whose frames are rendered again. Each number is the worst
    over the clips checked."""
    from portbench.reference.frozen.pipeline.align import align_detections
    from portbench.reference.frozen.pipeline.audio import load_wav
    from portbench.reference.frozen.utils.image import read_image

    ref = build_pipeline(cfg, nets, device)
    out = {"photo_bytes_off": 0.0, "detect_px": 0.0,
           "aligned_off_share": 0.0, "audio_rel": 0.0,
           "landmarks_rel": 0.0, "frames_mean_levels": 0.0,
           "frames_off_share": 0.0}
    for path, port_img in photos.values():
        ref_img = read_image(path)
        off = (float(np.count_nonzero(ref_img != port_img))
               if ref_img.shape == port_img.shape else float(ref_img.size))
        out["photo_bytes_off"] = max(out["photo_bytes_off"], off)
    with torch.inference_mode():
        for i, c in enumerate(clips):
            boxes, lms = ref.detector(*c["detect_in"])
            got = np.concatenate([np.ravel(a) for a in c["detect"]])
            want = np.concatenate([np.ravel(boxes), np.ravel(lms)])
            out["detect_px"] = max(out["detect_px"], float(
                np.abs(got - want).max()) if got.shape == want.shape
                else float("inf"))
            aligned, _ = align_detections(c["img"], *c["detect"])
            out["aligned_off_share"] = max(
                out["aligned_off_share"],
                float((aligned != c["aligned"]).mean()))
            feats = ref.audio(load_wav(c["wav_path"]), c["gender"])
            out["audio_rel"] = max(out["audio_rel"], _rel(
                c["mel_autovc"], feats.mel_autovc))
            fl = ref.predictor(*c["predictor_in"])
            out["landmarks_rel"] = max(out["landmarks_rel"],
                                       _rel(c["landmarks"], fl))
            if i in render_sample:
                frames = ref.renderer(*c["render_in"])
                if frames.shape != c["frames"].shape:
                    out["frames_mean_levels"] = float("inf")
                    continue
                d = np.abs(frames.astype(np.int16)
                           - c["frames"].astype(np.int16))
                out["frames_mean_levels"] = max(out["frames_mean_levels"],
                                                float(d.mean()))
                out["frames_off_share"] = max(out["frames_off_share"],
                                              float((d > 2).mean()))
    return out
