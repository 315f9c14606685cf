"""The port's entry point: the AVI writer against the JAX muxer, the
OpenCV-free image reader against ``cv2.imread``, checkpoint loading
against the JAX CLI's loaders, and ``cli.main`` end to end on the CPU at
tiny widths (``--ngf 8 --flow_nf 4 --static_ngf 8 --cartoon_ngf 8``)."""
import os
import pickle
import struct
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu_torch import cli
from animateportrait_tpu_torch.io import from_jax, reference
from animateportrait_tpu_torch.utils import video
from animateportrait_tpu_torch.utils.image import read_image
from animateportrait_tpu_torch.utils.smoke import (
    make_wav, write_mtcnn_weights)
from animateportrait_tpu.utils.smoke import random_variables

K = jax.random.key(0)


# --- video -------------------------------------------------------------


def _frames(rng, n=5, h=256, w=256):
    return rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("w", [256, 250])   # 250: rows padded to 4 bytes
def test_avi_frames_fps_and_pcm_match_jax_muxer(tmp_path, w):
    from animateportrait_tpu.utils.video import mux_avi as jax_mux

    rng = np.random.default_rng(0)
    frames = _frames(rng, w=w)
    wav = make_wav(0.05, seed=1)              # 800 samples: 3 full chunks + 32
    path = video.mux_avi(str(tmp_path / "a.avi"), frames, wav)
    got = video.read_avi(path)
    np.testing.assert_array_equal(got["frames"], frames)
    assert got["fps"] == 62.5
    assert got["streams"] == [b"vids", b"auds"]
    # the JAX muxer's PCM chunks for the same WAV, byte for byte
    jpath = jax_mux(str(tmp_path / "j.avi"), [b"x"] * len(frames), wav)
    with open(jpath, "rb") as f:
        blob = f.read()
    want, pos, end = [], blob.index(b"movi") + 4, blob.index(b"idx1")
    while pos < end:
        tag, n = blob[pos: pos + 4], struct.unpack("<I", blob[pos + 4:
                                                               pos + 8])[0]
        if tag == b"01wb":
            want.append(blob[pos + 8: pos + 8 + n])
        pos += 8 + n + n % 2
    assert [len(a) for a in want] == [512, 512, 512, 64]
    assert got["audio_chunks"] == want
    pcm = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16).tobytes()
    assert got["pcm"] == pcm


def test_avi_reads_in_opencv(tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames = _frames(np.random.default_rng(1), n=4)
    path = video.write_video_with_audio(str(tmp_path / "a.avi"), frames,
                                        make_wav(0.1, seed=2))
    cap = cv2.VideoCapture(path)
    assert abs(cap.get(cv2.CAP_PROP_FPS) - 62.5) < 1e-6
    got = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        got.append(f[:, :, ::-1])
    cap.release()
    np.testing.assert_array_equal(np.stack(got), frames)


def test_avi_gray_float_frames_and_size_limit(tmp_path):
    x = np.random.default_rng(3).uniform(-1, 1, (3, 16, 24, 1)).astype(
        np.float32)
    path = video.write_video_with_audio(str(tmp_path / "g.avi"), x,
                                        np.zeros(800))
    want = np.repeat(np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8), 3,
                     axis=-1)
    np.testing.assert_array_equal(video.read_avi(path)["frames"], want)
    # 22000 frames of 256x256 pass the 32-bit RIFF size (~5.8 min at 62.5
    # fps): refused before a byte is written
    big = np.broadcast_to(np.zeros((1, 256, 256, 3), np.uint8),
                          (22000, 256, 256, 3))
    with pytest.raises(ValueError, match="AVI limit"):
        video.mux_avi(str(tmp_path / "big.avi"), big, np.zeros(16000))
    assert not (tmp_path / "big.avi").exists()


# --- image reader ------------------------------------------------------


def _write_png(path, px, color_type):
    """A PNG whose rows cycle through the five filter types."""
    h, w = px.shape[:2]
    bpp = px.shape[2] if px.ndim == 3 else 1
    rows = px.reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    prior = np.zeros(w * bpp, np.int64)
    for y in range(h):
        kind, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        raw += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba"])
def test_read_png_every_filter(tmp_path, kind):
    rng = np.random.default_rng(4)
    y, x = np.mgrid[0:37, 0:41]
    rgb = np.stack([x * 6, y * 5, (x * y) % 256], -1) + rng.integers(
        0, 9, (37, 41, 3))
    rgb = (rgb % 256).astype(np.uint8)
    px, ctype = {"gray": (rgb[:, :, 0], 0), "rgb": (rgb, 2),
                 "rgba": (np.concatenate([rgb, rgb[:, :, :1]], -1), 6)}[kind]
    path = str(tmp_path / f"{kind}.png")
    _write_png(path, px, ctype)
    got = read_image(path)
    want = np.repeat(px[:, :, None], 3, -1) if kind == "gray" else \
        px[:, :, 2::-1]
    np.testing.assert_array_equal(got, want)


def test_read_image_matches_opencv(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (29, 33, 3)).astype(np.uint8)
    rgba = np.concatenate([img, img[:, :, 1:2]], -1)
    for name, px in (("c.png", img), ("g.png", img[:, :, 0]),
                     ("a.png", rgba), ("c.ppm", img), ("g.pgm", img[:, :, 2])):
        path = str(tmp_path / name)
        assert cv2.imwrite(path, px)
        np.testing.assert_array_equal(read_image(path), cv2.imread(path),
                                      err_msg=name)
    _write_png(str(tmp_path / "f.png"), img, 2)     # every filter type
    np.testing.assert_array_equal(read_image(str(tmp_path / "f.png")),
                                  cv2.imread(str(tmp_path / "f.png")))
    jpg = str(tmp_path / "p.jpg")
    assert cv2.imwrite(jpg, img)
    np.testing.assert_array_equal(read_image(jpg), cv2.imread(jpg))


# --- checkpoints -------------------------------------------------------


def _checkpoint_cases():
    from animateportrait_tpu.models import audio2landmark as ja
    from animateportrait_tpu.models import autovc as jv
    from animateportrait_tpu.models import flowunet as jf
    from animateportrait_tpu.models import gan as jg
    from animateportrait_tpu.models import modnet as jmn
    from animateportrait_tpu.models import photo2cartoon as jp
    from animateportrait_tpu_torch.models.audio2landmark import (
        Audio2landmarkContent, Audio2landmarkPos)
    from animateportrait_tpu_torch.models.autovc import AutoVCGenerator
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet
    from animateportrait_tpu_torch.models.photo2cartoon import (
        Photo2CartoonGenerator, UNUSED_KEY)

    z = lambda *s: jnp.zeros(s)  # noqa: E731

    def rv(init_fn):            # built only for the case a test asks for
        return lambda: random_variables(init_fn)
    # (JAX variables, to reference state dict, JAX loader, port module,
    #  wrapper key, keys the JAX loader reads that no port net runs, drop)
    return {
        "autovc": (rv(lambda: jv.AutoVCGenerator().init(
            K, z(1, 32, 80), z(1, 256), z(1, 256), z(1, 32, 257))),
            from_jax.autovc_state_dict, jv.load_autovc_params,
            AutoVCGenerator, "model", {}, None),
        "pos": (rv(lambda: ja.Audio2landmarkPos().init(
            K, z(4, 18, 80), z(4, 256), z(1, 204), z(4, 128))),
            from_jax.pos_state_dict, ja.load_pos_params, Audio2landmarkPos,
            "G", {}, None),
        "content": (rv(lambda: ja.Audio2landmarkContent().init(
            K, z(4, 18, 80), z(1, 204))), from_jax.content_state_dict,
            ja.load_content_params, Audio2landmarkContent,
            "model_g_face_id", {}, None),
        # the CLI's generator: 9 blocks, div 3, disp 3
        "generator": (rv(lambda: jg.TridentGeneratorFullIFW(
            output_nc=3, ngf=4, div=3, disp=3).init(
            K, z(1, 16, 16, 3), z(1, 16, 16, 1), z(1, 16, 16, 1),
            z(1, 16, 16, 2), z(1, 16, 16, 2), z(1, 16, 16, 1))),
            lambda v: from_jax.trident_state_dict(v, 9, 3, 3),
            lambda sd: jg.load_trident_full_ifw_params(sd, 9, 3, 3),
            lambda: TridentGeneratorFullIFW(output_nc=3, ngf=4, div=3,
                                            disp=3), None, {}, None),
        "flowunet": (rv(lambda: jf.FlowUnet(nf=4).init(
            K, z(1, 32, 32, 136))), from_jax.flowunet_state_dict,
            jf.load_flowunet_params, lambda: FlowUnet(nf=4), None, {}, None),
        "modnet": (rv(lambda: jmn.MODNet().init(K, z(1, 32, 32, 3))),
                   from_jax.modnet_state_dict, jmn.load_modnet_params,
                   MODNet, None, {
                       "lr_branch.conv_lr.layers.0.weight": (1, 32, 3, 3),
                       "lr_branch.conv_lr.layers.0.bias": (1,),
                       **{f"hr_branch.conv_hr.0.layers.{k}": (32,) for k in (
                           "0.bias", "1.bnorm.weight", "1.bnorm.bias",
                           "1.bnorm.running_mean", "1.bnorm.running_var")},
                       "hr_branch.conv_hr.0.layers.0.weight": (32, 35, 3, 3),
                       "hr_branch.conv_hr.1.layers.0.weight": (1, 32, 1, 1),
                       "hr_branch.conv_hr.1.layers.0.bias": (1,)},
                   cli.MODNET_TRAINING_HEADS),
        "static_drawing": (rv(lambda: jg.ResnetStyle2Generator(ngf=4).init(
            K, z(1, 16, 16, 3), z(1, 4, 4, 3))), from_jax.style2_state_dict,
            jg.load_style2_params, lambda: ResnetStyle2Generator(ngf=4),
            None, {}, None),
        "photo2cartoon": (rv(lambda: jp.Photo2CartoonGenerator(ngf=8).init(
            K, z(1, 16, 16, 3))), from_jax.photo2cartoon_state_dict,
            jp.load_photo2cartoon_params,
            lambda: Photo2CartoonGenerator(ngf=8), "genA2B",
            {"HourGlass1.HG.0.ConvBlock1_1.ConvBlock4.2.weight": (8, 8, 1, 1),
             "HourGlass4.HG.1.ConvBlock4.2.weight": (8, 8, 1, 1)},
            UNUSED_KEY),
    }


@pytest.mark.parametrize("net", ["autovc", "pos", "content", "generator",
                                 "flowunet", "modnet", "static_drawing",
                                 "photo2cartoon"])
def test_checkpoint_loading_matches_jax_cli(tmp_path, net):
    from animateportrait_tpu.cli import _load_or_init as jax_load

    v, to_sd, jax_loader, make, wrap, extra, drop = _checkpoint_cases()[net]
    v = v()
    rng = np.random.default_rng(6)
    sd = dict(to_sd(v))
    sd.update({k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for k, s in extra.items()})
    # a DataParallel prefix, which both loaders strip
    sd = {f"module.{k}": t for k, t in sd.items()}
    obj = {wrap: sd, "epoch": 70} if wrap else sd
    path = str(tmp_path / f"{net}.pth")
    torch.save(obj, path)
    jv = jax_load(path, jax_loader, None, net, unwrap=wrap)
    want = to_sd(jv)
    got = reference.load_or_init(path, make(), net, unwrap=wrap,
                            drop=drop).state_dict()
    assert set(got) == set(want)
    for k, t in want.items():
        np.testing.assert_array_equal(got[k].numpy(), t.numpy(), err_msg=k)
    if drop is None:
        assert not extra
    else:
        with pytest.raises(RuntimeError, match="Unexpected key"):
            reference.load_or_init(path, make(), net, unwrap=wrap)


def test_missing_checkpoint_takes_seeded_random_init(capsys):
    from animateportrait_tpu_torch.models.photo2cartoon import (
        Photo2CartoonGenerator)

    a = reference.load_or_init("/nonexistent/cartoon.pt",
                          Photo2CartoonGenerator(ngf=8), "photo2cartoon")
    b = reference.load_or_init(None, Photo2CartoonGenerator(ngf=8), "p2c")
    err = capsys.readouterr().err
    assert "WARNING: no checkpoint for photo2cartoon" in err
    for k, t in a.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), b.state_dict()[k].numpy())


# --- the CLI -----------------------------------------------------------

TINY = ("--ngf", "8", "--flow_nf", "4", "--static_ngf", "8",
        "--cartoon_ngf", "8", "--frame_batch", "4", "--device", "cpu")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:160, 0:150]
    photo = np.stack([x * 1.5, y * 1.4, 128 + 60 * np.sin(x * y / 300.0)],
                     -1) + rng.integers(0, 30, (160, 150, 3))
    png = str(d / "face.png")
    _write_png(png, np.clip(photo, 0, 255).astype(np.uint8), 2)
    wav = video.write_wav(str(d / "clip.wav"), make_wav(0.6, seed=8))
    ckpt = str(d / "ckpt")
    write_mtcnn_weights(os.path.join(ckpt, "mtcnn"), seed=0)
    return d, png, wav, ckpt


def test_cli_main_writes_video_fls_and_dumps(inputs):
    from animateportrait_tpu.data.audio2landmark import Audio2landmarkDataset
    from animateportrait_tpu_torch.pipeline.audio import load_wav

    d, png, wav, ckpt = inputs
    argv = ["--jpg", png, "--audio", wav, "--exp", "formal/cartoon",
            "--ckpt_dir", ckpt, "--output", str(d / "out"),
            "--output_folder", str(d / "m1"), "--dump_dir", str(d / "dump"),
            *TINY]
    res = cli.main(argv)
    assert res.path == os.path.join(str(d / "out"), "face-clip",
                                    "output_formal_cartoon.avi")
    assert set(res.stage_seconds) == {"detect", "align", "audio",
                                      "landmarks", "render", "mux"}
    avi = video.read_avi(res.path)
    T = res.frames
    assert avi["frames"].shape == (T, 256, 256, 3) and avi["fps"] == 62.5
    pcm = np.clip(load_wav(wav) * 32768.0, -32768, 32767).astype(np.int16)
    assert avi["pcm"] == pcm[: T * 256].tobytes()

    fls = np.loadtxt(str(d / "m1" / "pred_fls_clip_audio_embed.txt"))
    assert fls.shape == (T, 204) and np.isfinite(fls).all()
    ds = Audio2landmarkDataset(str(d / "dump"), dump_name="random",
                               status="val")
    (fl_arr, _), (au_arr, info) = ds[0]
    assert au_arr.shape[-1] == 80 and fl_arr.shape[-1] == 204
    assert info[1] == "clip" and np.asarray(info[2]).shape == (256,)
    with open(str(d / "dump" / "random_val_gaze.pickle"), "rb") as fp:
        assert set(pickle.load(fp)) == {"rot_trans", "rot_quat",
                                        "anchor_t_shape"}

    # the frames are those of a direct pipeline call
    pipe = cli.build_pipeline(cli.build_argparser().parse_args(argv))
    with torch.inference_mode():
        out = pipe(read_image(png), load_wav(wav),
                   rng=np.random.default_rng(0))
    np.testing.assert_array_equal(avi["frames"], out.frames)



def test_cli_frames_depend_on_the_cpu_thread_count_only(inputs):
    """The cartoon pipeline's frames on the CPU at two torch thread
    counts: within one level on at most 0.1% of the values (torch's CPU
    kernels split their sums by thread; these frames measured 766 of
    3 932 160 values one level apart between 2 and 4 threads on an
    8-core x86 host). At one thread count two calls
    are bit-equal (``test_cli_main_writes_video_fls_and_dumps``), so a
    one-level difference between two calls in one process needs another
    thread count in effect."""
    from animateportrait_tpu_torch.pipeline.audio import load_wav

    d, png, wav, ckpt = inputs
    argv = ["--jpg", png, "--audio", wav, "--exp", "formal/cartoon",
            "--ckpt_dir", ckpt, "--output", str(d / "out_threads"), *TINY]
    pipe = cli.build_pipeline(cli.build_argparser().parse_args(argv))
    threads = torch.get_num_threads()

    def frames(n):
        torch.set_num_threads(n)
        with torch.inference_mode():
            return pipe(read_image(png), load_wav(wav),
                        rng=np.random.default_rng(0)).frames.astype(int)

    try:
        a, b = frames(2), frames(4)
    finally:
        torch.set_num_threads(threads)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size

def test_cli_drawing_output_name_and_gray_frames(inputs):
    d, png, wav, ckpt = inputs
    res = cli.main(["--jpg", png, "--audio", wav, "--exp", "formal/drawing",
                    "--ckpt_dir", ckpt, "--output", str(d / "out"), *TINY])
    assert os.path.basename(res.path) == "output_formal_drawing.avi"
    f = video.read_avi(res.path)["frames"]
    assert f.shape == (res.frames, 256, 256, 3)
    np.testing.assert_array_equal(f[..., 0], f[..., 2])


def test_cli_rejects_what_it_does_not_run(inputs, tmp_path, capsys):
    d, png, wav, ckpt = inputs
    base = ["--audio", wav, "--ckpt_dir", ckpt, "--output", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        cli.main(["--jpg", png, *base, "--warp_mode", "cubic", *TINY])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "invalid choice: 'cubic'" in err
    # --render_dp is run now, and parses as the JAX CLI parses it; on the
    # CPU the renderer has one replica (tests/test_torch_parallel.py
    # renders with two)
    from animateportrait_tpu.cli import build_argparser as jax_argparser

    shared = ["--jpg", png, *base, *TINY[:-2]]       # all but --device
    for flag, want in (([], False), (["--render_dp"], True)):
        targs = cli.build_argparser().parse_args(
            [*shared, *flag, "--device", "cpu"])
        jargs = jax_argparser().parse_args([*shared, *flag])
        assert targs.render_dp is jargs.render_dp is want
    assert len(cli.build_pipeline(targs).renderer.replicas) == 1
    jpg = str(tmp_path / "face.jpg")
    with open(jpg, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(SystemExit, match="cannot read .*face.jpg.*corrupt "
                       "JPEG"):
        cli.main(["--jpg", jpg, *base, *TINY])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(["--jpg", png, *base, "--device", "cuda"])
    with pytest.raises(SystemExit, match="MTCNN weights missing"):
        cli.main(["--jpg", png, "--audio", wav, "--ckpt_dir",
                  str(tmp_path / "empty"), "--output", str(tmp_path), *TINY])
    fan_dir = tmp_path / "fan"
    write_mtcnn_weights(str(fan_dir / "mtcnn"))
    (fan_dir / "3DFAN4.pth").write_bytes(b"")
    with pytest.raises(SystemExit, match="cannot load the face_alignment "
                       "checkpoint .*3DFAN4.pth"):
        cli.main(["--jpg", png, "--audio", wav, "--ckpt_dir", str(fan_dir),
                  "--output", str(tmp_path), *TINY])
