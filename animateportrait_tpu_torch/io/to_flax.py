"""State dicts of this package's frozen perception nets -> the JAX package's
flax variable trees, for ``io/checkpoint.py:save_flax_npz``.

The inverses of ``io/from_jax.py:mobilefacenet_state_dict`` and
``sphere20a_state_dict`` (the maps of the JAX package's
``load_mobilefacenet_params`` and ``load_sphere20a_params``, in numpy):
conv OIHW -> HWIO, Linear (out, in) -> Dense (in, out), BatchNorm
weight/bias/running_mean/running_var -> scale/bias and mean/var. A
``<role>.flax.npz`` written from them is read by the port
(``io/reference.py:load_frozen``) and by the JAX ``train_cli``'s
``--frozen_dir`` alike.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

StateDict = Mapping[str, torch.Tensor]


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t,
                      np.float32)


def _conv(sd: StateDict, name: str, bias: bool) -> dict:
    p = {"kernel": np.transpose(_np(sd[f"{name}.weight"]), (2, 3, 1, 0))}
    if bias:
        p["bias"] = _np(sd[f"{name}.bias"])
    return p


def _bn(sd: StateDict, name: str) -> tuple[dict, dict]:
    return ({"scale": _np(sd[f"{name}.weight"]),
             "bias": _np(sd[f"{name}.bias"])},
            {"mean": _np(sd[f"{name}.running_mean"]),
             "var": _np(sd[f"{name}.running_var"])})


def mobilefacenet_variables(sd: StateDict) -> dict:
    """MobileFaceNet's state dict -> {"params", "batch_stats"}."""
    params: dict = {}
    stats: dict = {}

    def insert(tree: dict, path: list, leaf: dict) -> None:
        for seg in path[:-1]:
            tree = tree.setdefault(seg, {})
        tree[path[-1]] = leaf

    def cb(ours: str, theirs: str) -> None:
        p: dict = {"conv": _conv(sd, f"{theirs}.conv", bias=False)}
        bn_p, bn_s = _bn(sd, f"{theirs}.bn")
        p["bn"] = {"bn": bn_p}
        if f"{theirs}.prelu.weight" in sd:
            p["prelu"] = {"alpha": _np(sd[f"{theirs}.prelu.weight"])}
        insert(params, ours.split("."), p)
        insert(stats, ours.split("."), {"bn": {"bn": bn_s}})

    def dw(ours: str, theirs: str) -> None:
        for sub in ("conv", "conv_dw", "project"):
            cb(f"{ours}.{sub}", f"{theirs}.{sub}")

    cb("conv1", "conv1")
    cb("conv2_dw", "conv2_dw")
    for stage, blocks in (("3", 4), ("4", 6), ("5", 2)):
        dw(f"conv_{int(stage) - 1}{stage}", f"conv_{int(stage) - 1}{stage}")
        for i in range(blocks):
            dw(f"conv_{stage}_{i}", f"conv_{stage}.model.{i}")
    cb("conv_6_sep", "conv_6_sep")
    cb("conv_6_dw", "output_layer.conv_6_dw")
    params["linear"] = {"kernel": _np(sd["output_layer.linear.weight"]).T}
    params["out_bn"], stats["out_bn"] = _bn(sd, "output_layer.bn")
    return {"params": params, "batch_stats": stats}


def sphere20a_variables(sd: StateDict) -> dict:
    """Sphere20a's state dict (no classifier) -> {"params"}."""
    params: dict = {}
    for key in sd:
        name = key.rsplit(".", 1)[0]
        if name.startswith("conv") and name not in params:
            params[name] = _conv(sd, name, bias=True)
        elif name.startswith("relu"):
            params[name] = {"alpha": _np(sd[key])}
    params["fc5"] = {"kernel": _np(sd["fc5.weight"]).T,
                     "bias": _np(sd["fc5.bias"])}
    return {"params": params}
