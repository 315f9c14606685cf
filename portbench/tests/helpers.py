"""A temporary copy of the benchmark's data at sizes a CPU test can run:
the configurations at small widths and short traffic, as new files
beside the real ones, so that no existing file is edited."""
from __future__ import annotations

import json
import os
import shutil

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2 ** 31 + 977

TINY_DRAWING = dict(ngf=8, flow_nf=4, static_ngf=8, frame_batch=4)
TINY_TRAIN = dict(ngf=8, ndf=8, pool_size=3)


def copy_benchmark(dest: str) -> str:
    """BENCHMARK.json and portbench/ (its data files and readers) under
    ``dest``; returns the copy's root."""
    root = os.path.join(dest, "root")
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "frozen",
                                                  "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    return root


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def add_cell(root: str, name: str, config: str, new_config: dict,
             traffic: str, mix: dict) -> None:
    """Add a configuration file, a traffic file and their entries: no
    existing file but BENCHMARK.json's lists changes."""
    _dump(new_config, os.path.join(root, "portbench", "configs",
                                   f"{config}.json"))
    _dump(mix, os.path.join(root, "portbench", "traffic", f"{traffic}.json"))
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    if config not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({
            "name": config, "source": "https://example.org/tiny",
            "file": f"portbench/configs/{config}.json", "reduced": [],
            "why": "a small copy for CPU tests"})
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a CPU test"})
    sibling = {"clips": "drawing.clips",
               "train_step": "module2.step"}[new_config["driver"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if sibling in m.get("workloads", []):
            m["workloads"].append(name)
    _dump(bench, os.path.join(root, "BENCHMARK.json"))


def tiny_train_cell(root: str, name: str = "tiny.step", **sizes) -> str:
    """The training cell at small widths; ``sizes`` overrides more keys
    (the configuration's own batch unless ``batch_size`` is given)."""
    cfg = _load(os.path.join(REPO, "portbench", "configs",
                             "module2_train.json"))
    cfg.update(TINY_TRAIN, **sizes)
    add_cell(root, name, "module2_tiny", cfg, "tiny_steps",
             {"loop": "closed", "clients": 1, "resident_batches": 3})
    return name


def tiny_drawing_cell(root: str, name: str = "tiny.clips") -> str:
    cfg = _load(os.path.join(REPO, "portbench", "configs",
                             "drawing_infer.json"))
    cfg.update(TINY_DRAWING)
    add_cell(root, name, "drawing_tiny", cfg, "tiny_clips",
             {"loop": "closed", "clients": 1,
              "speech_seconds": [0.6, 0.9], "photos": 2,
              "replies_per_photo": 1, "jpeg_quality": 90,
              "render_checks": 2})
    return name


def few_threads() -> None:
    torch.set_num_threads(min(4, torch.get_num_threads()))
