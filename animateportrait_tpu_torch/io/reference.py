"""The reference's checkpoint files, loaded into the port's nets as they
are: the counterpart of the JAX package's ``io/torch_convert.py:
load_torch_statedict`` and of the frozen-net loading of its ``train_cli.py``
(:117-181).

A torch checkpoint is unwrapped as the JAX CLIs unwrap it (a module's
``state_dict()``, a lone ``state_dict`` entry, a named wrapper key), loses
a leading ``module.``, and goes into the net by a strict
``load_state_dict``, less the keys a ``drop`` pattern names. Both CLIs load
through ``load_or_init``: a missing file gives seeded random weights and a
warning, as in the JAX package. face_alignment's FAN and depth checkpoints
(``.pth.tar`` state dicts or torchscript ``.zip`` archives) load through
``load_fa_state_dict``, strictly, and are never replaced by random
weights.

``load_frozen`` fills the training step's four frozen nets from
``--frozen_dir``: a ``<role>.flax.npz`` that the JAX package's
``save_flax_npz`` wrote wins over the reference file of the same role; it
is read with numpy alone and converted by ``io/from_jax.py``.
"""
from __future__ import annotations

import os
import pickle
import re
import sys

import numpy as np
import torch

# MODNet's training heads: the JAX loader reads them when present, but
# the matte never runs them and the port's MODNet has none
MODNET_TRAINING_HEADS = re.compile(
    r"^(lr_branch\.conv_lr|hr_branch\.conv_hr)\.")
# Sphere20a's classifier, which the FaceLoss drops (networks.py:3044-3053)
SPHERE_CLASSIFIER = re.compile(r"^fc6\.")


def load_state_dict(path: str, unwrap: str | None = None) -> dict:
    """A reference torch checkpoint -> {key: tensor}, unwrapped as the JAX
    CLI unwraps it (``io/torch_convert.py:load_torch_statedict`` and
    ``cli.py:_load_or_init``)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj and all(
            not torch.is_tensor(v) for k, v in obj.items()
            if k != "state_dict"):
        obj = obj["state_dict"]
    if unwrap and unwrap in obj:
        obj = obj[unwrap]
    return {(k[len("module."):] if k.startswith("module.") else k):
            torch.as_tensor(v) for k, v in obj.items()
            if torch.is_tensor(v) or isinstance(v, np.ndarray)}


def load_fa_state_dict(path: str) -> dict:
    """A face_alignment checkpoint -> {key: tensor}: a torchscript ``.zip``
    archive (the package's newer releases) through ``torch.jit.load``, a
    ``.pth.tar`` / ``.pth`` state dict through ``load_state_dict``, as the
    JAX CLI reads them (``cli.py:_load_fa_statedict``)."""
    if path.endswith(".zip"):
        sd = torch.jit.load(path, map_location="cpu").state_dict()
        return {(k[len("module."):] if k.startswith("module.") else k):
                v.detach() for k, v in sd.items()}
    return load_state_dict(path)


def load_into(net: torch.nn.Module, sd: dict,
              drop: re.Pattern | None = None) -> torch.nn.Module:
    """``net.load_state_dict(sd, strict=True)`` without the keys ``drop``
    matches."""
    if drop is not None:
        sd = {k: v for k, v in sd.items() if not drop.search(k)}
    net.load_state_dict(sd, strict=True)
    return net


def load_or_init(path: str | None, net: torch.nn.Module, name: str,
                 unwrap: str | None = None,
                 drop: re.Pattern | None = None) -> torch.nn.Module:
    """Load ``path`` into ``net`` (strict), without the keys ``drop``
    matches; seeded random weights when there is no file."""
    if path and os.path.exists(path):
        return load_into(net, load_state_dict(path, unwrap), drop)
    print(f"[animateportrait_tpu_torch] WARNING: no checkpoint for {name} "
          f"({path}); using random init", file=sys.stderr)
    from animateportrait_tpu_torch.utils.smoke import init_random_

    return init_random_(net, torch.Generator().manual_seed(0))


def senet50_state_dict(path: str, net: torch.nn.Module) -> dict:
    """The reference's SENet50 weights, a pickled {name: numpy array} with
    torch-style names (senet50_ft, VGGFace2), as a state dict of ``net``:
    ``module.`` stripped, the classifier ``fc`` dropped (as
    FaceLoss.load_senet_model, networks.py:3030-3042), and the BatchNorm
    counters the pickle lacks taken from ``net``."""
    with open(path, "rb") as f:
        weights = pickle.load(f, encoding="latin1")
    sd = {}
    for k, v in weights.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not k.startswith("fc"):
            sd[k] = torch.as_tensor(np.asarray(v))
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = v.clone()
    return sd


def flax_npz_state_dict(path: str, role: str) -> dict:
    """A ``<role>.flax.npz`` of the JAX package's ``save_flax_npz`` as the
    state dict of the port's net for ``role``."""
    from animateportrait_tpu_torch.io import from_jax
    from animateportrait_tpu_torch.io.checkpoint import load_flax_npz

    convert = {"modnet": from_jax.modnet_state_dict,
               "mobilefacenet": from_jax.mobilefacenet_state_dict,
               "sphere": from_jax.sphere20a_state_dict,
               "senet": from_jax.senet50_state_dict,
               "flowunet": from_jax.flowunet_state_dict}[role]
    return convert(load_flax_npz(path))


def load_frozen(frozen_dir: str, cfg, gen: torch.Generator,
                device: torch.device | str):
    """The training step's frozen nets (``train/module2.py:FrozenNets``)
    for ``cfg`` (a ``Module2Config``) from the reference's files in
    ``frozen_dir``, as the JAX ``train_cli`` loads them: a native
    ``<role>.flax.npz`` first, else the reference checkpoint, else the
    seeded random net of ``init_frozen_random(gen)`` with a warning. With a
    senet ``face_recog_model`` the FaceLoss slot is SENet50, read from that
    path (relative paths by their base name under ``frozen_dir``)."""
    from animateportrait_tpu_torch.train import module2 as m2

    frozen = m2.init_frozen_random(gen, device, cfg.face_recog_model)
    fd = frozen_dir
    if cfg.use_senet:
        face_path = (cfg.face_recog_model
                     if os.path.isabs(cfg.face_recog_model)
                     else os.path.join(fd, os.path.basename(
                         cfg.face_recog_model)))
        face = ("senet", face_path,
                lambda p, net: senet50_state_dict(p, net), None)
    else:
        face = ("sphere", os.path.join(fd, "sphere20a_20171020.pth"),
                lambda p, net: load_state_dict(p), SPHERE_CLASSIFIER)
    roles = {
        "modnet": ("modnet", os.path.join(
            fd, "modnet_photographic_portrait_matting.ckpt"),
            lambda p, net: load_state_dict(p), MODNET_TRAINING_HEADS),
        "mobilefacenet": ("mobilefacenet", os.path.join(
            fd, "mobilefacenet_model_best.pth.tar"),
            lambda p, net: load_state_dict(p), None),
        "sphere": face,
        "flowunet": ("flowunet", os.path.join(
            fd, "FlowReg_id_flow_faces", "best_net_netF.pth"),
            lambda p, net: load_state_dict(p), None),
    }
    for slot, (native_key, path, read, drop) in roles.items():
        net = getattr(frozen, slot)
        native = os.path.join(fd, f"{native_key}.flax.npz")
        if os.path.exists(native):
            print(f"[train] frozen {native_key}: native {native}")
            load_into(net, flax_npz_state_dict(native, native_key))
        elif os.path.exists(path):
            load_into(net, read(path, net), drop)
        else:
            print(f"[train] WARNING: missing frozen ckpt {path}; random "
                  "init", file=sys.stderr)
    return frozen
