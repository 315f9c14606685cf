"""The benchmark's four readers of the port's spans
(``portbench/metrics/{triangulate_ms_per_clip, avi_pack_ms_per_clip,
host_ms_per_step.train, sync_ms_per_step.train}.py``), each loaded by its
file path as ``portbench/harness.py:read_metric`` loads it: its value over
a hand-built record, None on an empty record and None on a port without
the registry. Then the spans themselves, at small widths on the CPU under
a profiler: a drawing clip through the CLI's calls (``--ngf 8 --flow_nf 4
--static_ngf 8 --frame_batch 4``, as ``test_torch_cli.py`` runs it) and
two Module2 steps (crop 64, ngf = ndf = 8, pool 4, as
``test_torch_train.py`` runs it) give exactly the spans of the table in
``observe.py``'s callers, a clip's and a step's, with their request ids."""
import importlib.util
import os
import pathlib
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from animateportrait_tpu_torch.utils import observe

REPO = pathlib.Path(__file__).resolve().parents[1]
READERS = ("triangulate_ms_per_clip", "avi_pack_ms_per_clip",
           "host_ms_per_step.train", "sync_ms_per_step.train")
MS = 1_000_000


def read(name: str, run: dict):
    """``metrics/<name>.py``'s ``read(run)``, loaded as the harness loads
    it."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    path = REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def hand_built(monkeypatch, spans, counters=None):
    monkeypatch.setattr(observe, "spans", lambda: list(spans))
    monkeypatch.setattr(observe, "counters", lambda: dict(counters or {}))


CLIPS = {"units": [{}, {}]}
STEPS = {"steps": 3}
RECORD = [
    # two clips: triangulations of 3 and 2 ms, AVI writes of 100 and 50
    ("clip", 0, None, 0, 400 * MS),
    ("render.triangulate", 0, 0, 10 * MS, 13 * MS),
    ("clip", 1, None, 500 * MS, 900 * MS),
    ("render.triangulate", 1, 2, 510 * MS, 512 * MS),
    ("video.write", 1, None, 1000 * MS, 1100 * MS),
    ("video.write", 1, None, 1200 * MS, 1250 * MS),
    # three steps of 100 ms, each with two pool reads of 5 ms
    *[r for k in range(3) for r in (
        ("m2.step", k, None, (2000 + 100 * k) * MS, (2100 + 100 * k) * MS),
        ("m2.pool_fetch", k, None, (2050 + 100 * k) * MS,
         (2055 + 100 * k) * MS),
        ("m2.pool_fetch", k, None, (2060 + 100 * k) * MS,
         (2065 + 100 * k) * MS))],
    ("m2.step", 3, None, 3000 * MS, None),          # still open: left out
]


@pytest.mark.parametrize("name,run,want", [
    ("triangulate_ms_per_clip", CLIPS, 2.5),
    ("avi_pack_ms_per_clip", CLIPS, 60.0),      # (150 - 30 written) / 2
    ("host_ms_per_step.train", STEPS, 90.0),    # (300 - 30) / 3
    ("sync_ms_per_step.train", STEPS, 10.0)])
def test_reader_value_over_a_hand_built_record(monkeypatch, name, run, want):
    hand_built(monkeypatch, RECORD, {"video.file_write_ns": 30 * MS})
    assert read(name, run) == pytest.approx(want, rel=1e-12)
    # a run of the other kind holds nothing this reader reads
    other = STEPS if run is CLIPS else CLIPS
    assert read(name, other) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_on_an_empty_record(monkeypatch, name):
    hand_built(monkeypatch, [])
    run = CLIPS if "clip" in name else STEPS
    assert read(name, run) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_the_registry(monkeypatch, name):
    """A port before the registry (the parent of the commit that brought
    it): its ``observe`` has no ``spans``."""
    bare = types.ModuleType("animateportrait_tpu_torch.utils.observe")
    bare.profile_trace = observe.profile_trace
    monkeypatch.setitem(sys.modules, bare.__name__, bare)
    run = CLIPS if "clip" in name else STEPS
    assert read(name, run) is None


def fresh_session():
    """A profiler session with a new record (a span with none comes
    first, as set-up's spans come before a traced window)."""
    with observe.span("no session"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


def shape(rec):
    """(name, rid, parent's name) a span."""
    return [(n, r, None if p is None else rec[p][0])
            for n, r, p, _, _ in rec]


def test_a_drawing_clip_gives_the_tables_spans(tmp_path):
    from animateportrait_tpu_torch import cli
    from animateportrait_tpu_torch.pipeline.audio import load_wav
    from animateportrait_tpu_torch.utils import video
    from animateportrait_tpu_torch.utils.image import read_image, write_png
    from animateportrait_tpu_torch.utils.smoke import (make_wav,
                                                       write_mtcnn_weights)

    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:160, 0:150]
    photo = np.stack([x * 1.5, y * 1.4, 128 + 60 * np.sin(x * y / 300.0)],
                     -1) + rng.integers(0, 30, (160, 150, 3))
    png = str(tmp_path / "face.png")
    write_png(png, np.clip(photo, 0, 255).astype(np.uint8))
    wav_path = video.write_wav(str(tmp_path / "clip.wav"),
                               make_wav(0.6, seed=8))
    ckpt = str(tmp_path / "ckpt")
    write_mtcnn_weights(os.path.join(ckpt, "mtcnn"), seed=0)
    args = cli.build_argparser().parse_args([
        "--jpg", png, "--audio", wav_path, "--exp", "formal/drawing",
        "--ckpt_dir", ckpt, "--ngf", "8", "--flow_nf", "4",
        "--static_ngf", "8", "--frame_batch", "4", "--device", "cpu"])
    pipe = cli.build_pipeline(args)
    img, wav = read_image(png), load_wav(wav_path)

    def clip():
        with torch.inference_mode():
            out = pipe(img, wav, rng=np.random.default_rng(0))
        video.write_video_with_audio(str(tmp_path / "out.avi"), out.frames,
                                     wav, fps=out.fps)
        return out

    clip()                                  # clip 0, untraced
    with fresh_session():
        out = clip()                        # clip 1
    batches = -(-out.frames.shape[0] // 4)
    assert batches >= 2
    rec = observe.spans()
    want = ([("clip", 1, None), ("clip.align", 1, "clip"),
             ("clip.post", 1, "clip"), ("render.triangulate", 1, "clip")]
            + [("render.launch", 1, "clip"), ("render.fetch", 1, "clip")]
            * batches
            # the write, after the clip, carries the clip's request id
            + [("video.write", 1, None), ("video.rgb", 1, "video.write"),
               ("video.mux", 1, "video.write")])
    assert shape(rec) == want
    assert all(e is not None and s <= e for _, _, _, s, e in rec)
    # the file writes happen inside the mux, which also packs the frames
    mux_ns = sum(e - s for n, _, _, s, e in rec if n == "video.mux")
    assert 0 < observe.counters()["video.file_write_ns"] < mux_ns
    run = {"units": [{"frames_n": out.frames.shape[0]}]}
    assert read("triangulate_ms_per_clip", run) > 0
    assert read("avi_pack_ms_per_clip", run) > 0


def test_two_module2_steps_give_the_tables_spans():
    from animateportrait_tpu_torch.train import module2 as m2

    cfg = m2.Module2Config(crop_size=64, ngf=8, ndf=8, pool_size=4)
    state = m2.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    frozen = m2.init_frozen_random(torch.Generator().manual_seed(1), "cpu")
    batch = m2.make_random_batch(cfg, 1, torch.Generator().manual_seed(2),
                                 "cpu")
    step = m2.build_train_step(cfg)
    gen = torch.Generator().manual_seed(3)
    with fresh_session():
        for _ in range(2):
            step.step(state, batch, frozen, gen)
    rec = observe.spans()
    want = []
    for k in range(2):
        # both pool queries of a step drawn and planned on the host in one
        # span, before the forward
        want += [("m2.step", k, None)] + [
            (n, k, "m2.step") for n in (
                "m2.pool_fetch", "m2.forward_shared", "m2.g_loss",
                "m2.g_grad", "m2.pool", "m2.d_loss", "m2.d_grad", "m2.adam")]
    assert shape(rec) == want
    assert state.step == 2
    run = {"steps": 2}
    host, sync = (read("host_ms_per_step.train", run),
                  read("sync_ms_per_step.train", run))
    assert host > 0 and sync > 0
    steps_ms = sum(e - s for n, _, _, s, e in rec if n == "m2.step") / MS
    assert host + sync == pytest.approx(steps_ms / 2, rel=1e-9)
