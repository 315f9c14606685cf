"""JAX package variables -> state dicts of this package's modules.

Each function is the inverse of one of the JAX package's checkpoint
loaders (``load_*_params``, which map a reference torch state dict to
flax variables); the port's modules use the reference's key names, so the
result loads with ``module.load_state_dict(sd)``:

- conv HWIO -> OIHW, Conv1d WIO -> OIW, Dense (in, out) -> (out, in);
- the ``ConvTranspose2dTorch`` kernel (H, W, O, I) -> ``ConvTranspose2d``
  weight (I, O, H, W);
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
- FlowUnet's packed convs and ``OutConv7`` hold plain HWIO kernels, so they
  convert like any conv;
- LSTM gates are already in torch order.

Inputs are the variables as (nested dicts of) arrays; outputs are
``{key: torch.Tensor}``.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

Tree = Mapping[str, Any]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _conv2d(sd: dict, name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                           (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _conv1d(sd: dict, name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    sd[f"{name}.bias"] = _t(p["bias"])


def _conv_transpose(sd: dict, name: str, p: Tree) -> None:
    # (H, W, O, I) -> (I, O, H, W)
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                           (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _dense(sd: dict, name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _affine(sd: dict, name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _batchnorm(sd: dict, name: str, p: Tree, s: Tree) -> None:
    _affine(sd, name, p)
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _lstm(sd: dict, prefix: str, p: Tree, num_layers: int,
          bidirectional: bool = False) -> None:
    for layer in range(num_layers):
        dirs = [("", f"layer{layer}")]
        if bidirectional:
            dirs.append(("_reverse", f"layer{layer}_rev"))
        for suffix, scope in dirs:
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                sd[f"{prefix}{theirs}_l{layer}{suffix}"] = _t(p[scope][ours])


def trident_state_dict(variables: Tree, n_blocks: int = 9, div: int = 3,
                       disp: int = 1) -> dict[str, torch.Tensor]:
    """Inverse of ``load_trident_full_ifw_params``."""
    p = variables["params"]
    sd: dict = {}
    for ours in (f"tri{b}{k}" for b in range(3) for k in range(3)):
        idx = 1 if ours.endswith("0") else 0   # stems sit after their pad
        _conv2d(sd, f"model_{ours}.{idx}", p[ours]["conv"])
    _conv2d(sd, "model_tri_merge", p["merge"])
    for j, idx in enumerate((0, 3, 6)):
        _conv2d(sd, f"model_landmark_trans.{idx}",
                p["landmark_trans"][f"conv{j}"]["conv"])
    for i in range(n_blocks):
        b = p[f"block{i}"]
        _conv2d(sd, f"model2.{i}.conv_block.1", b["conv0"])
        _conv2d(sd, f"model2.{i}.conv_block.5", b["conv1"])
        if (i + disp) % div == 0:
            _conv2d(sd, f"model2.{i}.shortcut.0", b["shortcut"])
    _conv_transpose(sd, "model3.0", p["up0"]["deconv"])
    _conv_transpose(sd, "model3.3", p["up1"]["deconv"])
    _conv2d(sd, "model3.7", p["out"])
    return sd


def style2_state_dict(variables: Tree, n_blocks: int = 9
                      ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_style2_params`` (model0_res = 0)."""
    p = variables["params"]
    sd: dict = {}
    _conv2d(sd, "model0.1", p["stem"]["conv"])
    _conv2d(sd, "model0.4", p["down0"]["conv"])
    _conv2d(sd, "model0.7", p["down1"]["conv"])
    _conv2d(sd, "model.0", p["merge"]["conv"])
    for i in range(n_blocks):
        _conv2d(sd, f"model.{3 + i}.conv_block.1", p[f"block{i}"]["conv0"])
        _conv2d(sd, f"model.{3 + i}.conv_block.5", p[f"block{i}"]["conv1"])
    _conv_transpose(sd, f"model.{3 + n_blocks}", p["up0"]["deconv"])
    _conv_transpose(sd, f"model.{6 + n_blocks}", p["up1"]["deconv"])
    _conv2d(sd, f"model.{10 + n_blocks}", p["out"])
    return sd


def flowunet_state_dict(variables: Tree, num_scale: int = 4
                        ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_flowunet_params``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}

    def bn(name, ours):
        _batchnorm(sd, name, p[ours]["bn"], s[ours]["bn"])

    _conv2d(sd, "conv_downsample.0", p["stem"])
    bn("conv_downsample.1", "stem_bn")
    _conv2d(sd, "conv_downsample.3", p["down_pre"])
    bn("conv_downsample.4", "down_pre_bn")
    prefix = "unet_block."
    for level in range(num_scale):
        outermost = level == 0
        innermost = level == num_scale - 1
        _conv2d(sd, f"{prefix}down.{0 if outermost else 1}", p[f"down{level}"])
        if not innermost:
            bn(f"{prefix}down.{1 if outermost else 2}", f"down{level}_bn")
        _conv_transpose(sd, f"{prefix}up.1", p[f"up{level}"])
        bn(f"{prefix}up.2", f"up{level}_bn")
        _conv2d(sd, f"{prefix}predict_flow.1", p[f"flow{level}"]["conv"])
        prefix += "submodule."
    _conv2d(sd, "predict_vis.1", p["vis_conv"])
    return sd


_MOBILENET_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                      (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                      (6, 320, 1, 1))
_MODNET_CIBR = (
    ("conv_lr16x", "lr_branch.conv_lr16x", True),
    ("conv_lr8x", "lr_branch.conv_lr8x", True),
    ("tohr_enc2x", "hr_branch.tohr_enc2x", True),
    ("conv_enc2x", "hr_branch.conv_enc2x", True),
    ("tohr_enc4x", "hr_branch.tohr_enc4x", True),
    ("conv_enc4x", "hr_branch.conv_enc4x", True),
    *((f"conv_hr4x_{i}", f"hr_branch.conv_hr4x.{i}", True) for i in range(3)),
    *((f"conv_hr2x_{i}", f"hr_branch.conv_hr2x.{i}", True) for i in range(4)),
    ("conv_lr4x", "f_branch.conv_lr4x", True),
    ("conv_f2x", "f_branch.conv_f2x", True),
    ("conv_f_0", "f_branch.conv_f.0", True),
    ("conv_f_1", "f_branch.conv_f.1", False),
)


def modnet_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_modnet_params`` (inference heads only)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    bb = "lr_branch.backbone.model.features"
    pb, sb = p["backbone"], s["backbone"]

    def conv_bn(name, ours, conv, norm):
        _conv2d(sd, f"{name}.{conv[1]}", pb[ours][conv[0]])
        _batchnorm(sd, f"{name}.{norm[1]}", pb[ours][norm[0]]["bn"],
                   sb[ours][norm[0]]["bn"])

    conv_bn(f"{bb}.0", "feat0", ("conv", 0), ("norm", 1))
    idx = 1
    for t, _, n, _ in _MOBILENET_SETTING:
        for _ in range(n):
            for j, ci in enumerate((0, 3, 6) if t != 1 else (0, 3)):
                conv_bn(f"{bb}.{idx}.conv", f"feat{idx}", (f"conv{j}", ci),
                        (f"norm{j}", ci + 1))
            idx += 1
    conv_bn(f"{bb}.{idx}", f"feat{idx}", ("conv", 0), ("norm", 1))
    sd["lr_branch.se_block.fc.0.weight"] = _t(
        np.asarray(p["se_block"]["fc0"]["kernel"]).T)
    sd["lr_branch.se_block.fc.2.weight"] = _t(
        np.asarray(p["se_block"]["fc1"]["kernel"]).T)
    for ours, theirs, with_ibn in _MODNET_CIBR:
        _conv2d(sd, f"{theirs}.layers.0", p[ours]["conv"])
        if with_ibn:
            _batchnorm(sd, f"{theirs}.layers.1.bnorm",
                       p[ours]["ibn"]["bnorm"]["bn"],
                       s[ours]["ibn"]["bnorm"]["bn"])
    return sd


def autovc_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_autovc_params``."""
    p = variables["params"]
    sd: dict = {}
    for i in range(3):
        _conv1d(sd, f"encoder.convolutions.{i}.0.conv", p["encoder"][f"conv{i}"])
        _affine(sd, f"encoder.convolutions.{i}.1", p["encoder"][f"gn{i}"])
    _lstm(sd, "encoder.lstm.", p["encoder"]["lstm"], 2, bidirectional=True)
    _lstm(sd, "decoder.lstm.", p["decoder"]["lstm"], 3)
    _dense(sd, "decoder.linear_projection.linear_layer", p["decoder"]["proj"])
    for i in range(5):
        _conv1d(sd, f"postnet.convolutions.{i}.0.conv", p["postnet"][f"conv{i}"])
        _affine(sd, f"postnet.convolutions.{i}.1", p["postnet"][f"gn{i}"])
    return sd


def content_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_content_params``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _dense(sd, "fc_prior.0", p["prior_l0"])
    _dense(sd, "fc_prior.3", p["prior_l1"])
    _lstm(sd, "bilstm.", p["lstm"], 3)
    _dense(sd, "fc.0", p["fc_l0"])
    _dense(sd, "fc.3", p["fc_l1"])
    _dense(sd, "fc.6", p["fc_l2"])
    for ours, theirs in (("prior_bn0", "fc_prior.1"), ("fc_bn0", "fc.1"),
                         ("fc_bn1", "fc.4")):
        _batchnorm(sd, theirs, p[ours]["bn"], s[ours]["bn"])
    return sd


def pos_state_dict(variables: Tree, num_layers: int = 2
                   ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_pos_params``."""
    p = variables["params"]
    sd: dict = {}
    _lstm(sd, "audio_content_encoder.", p["audio_content_encoder"], 3)
    for ours, idx in (("spk_l0", 0), ("spk_l1", 2), ("spk_l2", 4)):
        _dense(sd, f"spk_emb_encoder.{idx}", p[ours])
    enc = p["encoder"]
    _dense(sd, "encoder.embed.embed", enc["embed"])
    for i in range(num_layers):
        lp, le = f"encoder.layers.{i}", enc[f"layer{i}"]
        for ours, theirs in (("norm1", "norm_1"), ("norm2", "norm_2")):
            sd[f"{lp}.{theirs}.alpha"] = _t(le[ours]["alpha"])
            sd[f"{lp}.{theirs}.bias"] = _t(le[ours]["bias"])
        for ours, theirs in (("q", "q_linear"), ("k", "k_linear"),
                             ("v", "v_linear"), ("out", "out")):
            _dense(sd, f"{lp}.attn.{theirs}", le["attn"][ours])
        _dense(sd, f"{lp}.ff.linear_1", le["ff"]["l1"])
        _dense(sd, f"{lp}.ff.linear_2", le["ff"]["l2"])
    sd["encoder.norm.alpha"] = _t(enc["norm"]["alpha"])
    sd["encoder.norm.bias"] = _t(enc["norm"]["bias"])
    for ours, idx in (("out_l0", 0), ("out_l1", 2), ("out_l2", 4)):
        _dense(sd, f"out.{idx}", p[ours])
    return sd


def _mtcnn(variables: Tree, convs, denses, prelus, heads
           ) -> dict[str, torch.Tensor]:
    p = variables["params"]
    sd: dict = {}
    for i in convs:
        _conv2d(sd, f"features.conv{i}", p[f"conv{i}"])
    for i in denses:
        _dense(sd, f"features.conv{i}", p[f"conv{i}"])
    for i in prelus:
        sd[f"features.prelu{i}.weight"] = _t(p[f"prelu{i}"]["alpha"])
    for name in heads:
        (_conv2d if np.ndim(p[name]["kernel"]) == 4 else _dense)(
            sd, name, p[name])
    return sd


def pnet_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_pnet_params`` (keys of the reference pnet.npy)."""
    return _mtcnn(variables, (1, 2, 3), (), (1, 2, 3), ("conv4_1", "conv4_2"))


def rnet_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_rnet_params``."""
    return _mtcnn(variables, (1, 2, 3), (4,), (1, 2, 3, 4),
                  ("conv5_1", "conv5_2"))


def onet_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_onet_params``."""
    return _mtcnn(variables, (1, 2, 3, 4), (5,), (1, 2, 3, 4, 5),
                  ("conv6_1", "conv6_2", "conv6_3"))


def photo2cartoon_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_photo2cartoon_params`` (the ``genA2B`` keys; the
    reference's per-channel vectors are (1, C) or (1, C, 1, 1))."""
    p = variables["params"]
    sd: dict = {}

    def vec(name, a, *shape):
        sd[name] = _t(np.asarray(a).reshape(*shape))

    def block(theirs, ours):
        for j in (1, 2, 3):
            _conv2d(sd, f"{theirs}.ConvBlock{j}.3", ours[f"conv{j}"])

    def hourglass(theirs, ours):
        hg = ours["hg"]
        for i in range(1, 5):
            for j in (1, 2):
                block(f"{theirs}.HG.0.ConvBlock{i}_{j}", hg[f"conv{i}_{j}"])
        for i in range(5, 10):
            block(f"{theirs}.HG.0.ConvBlock{i}", hg[f"conv{i}"])
        block(f"{theirs}.HG.1", ours["hg_conv"])
        _conv2d(sd, f"{theirs}.HG.2", ours["hg_conv1x1"])
        for j in (1, 2, 3):
            if f"conv{j}" in ours:
                _conv2d(sd, f"{theirs}.Conv{j}", ours[f"conv{j}"])

    def soft_adalin(theirs, ours):
        vec(f"{theirs}.w_gamma", ours["w_gamma"], 1, -1)
        vec(f"{theirs}.w_beta", ours["w_beta"], 1, -1)
        for head in ("gamma", "beta"):
            _dense(sd, f"{theirs}.c_{head}.0", ours[f"c_{head}_0"])
            _dense(sd, f"{theirs}.c_{head}.2", ours[f"c_{head}_1"])
            _dense(sd, f"{theirs}.s_{head}", ours[f"s_{head}"])
        vec(f"{theirs}.norm.rho", ours["norm"]["rho"], 1, -1, 1, 1)

    _conv2d(sd, "ConvBlock1.1", p["conv_in"])
    for i in range(1, 5):
        hourglass(f"HourGlass{i}", p[f"hourglass{i}"])
    _conv2d(sd, "DownBlock1.1", p["down1"])
    _conv2d(sd, "DownBlock2.1", p["down2"])
    for i in range(1, 5):
        _conv2d(sd, f"EncodeBlock{i}.conv_block.1", p[f"encode{i}"]["conv1"])
        _conv2d(sd, f"EncodeBlock{i}.conv_block.5", p[f"encode{i}"]["conv2"])
    for fc in ("gap_fc", "gmp_fc"):
        sd[f"{fc}.weight"] = _t(np.asarray(p[f"{fc}_kernel"]).T)
        sd[f"{fc}.bias"] = _t(p[f"{fc}_bias"])
    _conv2d(sd, "conv1x1", p["conv1x1"])
    _dense(sd, "FC.0", p["fc0"])
    _dense(sd, "FC.2", p["fc1"])
    for i in range(1, 5):
        d = p[f"decode{i}"]
        _conv2d(sd, f"DecodeBlock{i}.conv1", d["conv1"])
        _conv2d(sd, f"DecodeBlock{i}.conv2", d["conv2"])
        soft_adalin(f"DecodeBlock{i}.norm1", d["norm1"])
        soft_adalin(f"DecodeBlock{i}.norm2", d["norm2"])
    for i in (1, 2):
        _conv2d(sd, f"UpBlock{i}.2", p[f"up{i}"])
        for k in ("rho", "gamma", "beta"):
            vec(f"UpBlock{i}.3.{k}", p[f"up{i}_lin"][k], 1, -1, 1, 1)
    _conv2d(sd, "ConvBlock2.1", p["conv_out"])
    return sd


def voice_encoder_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_voice_encoder_params`` (resemblyzer keys)."""
    p = variables["params"]
    sd: dict = {}
    _lstm(sd, "lstm.", p["lstm"], 3)
    _dense(sd, "linear", p["linear"])
    return sd


def nlayer_d_state_dict(variables: Tree, n_layers: int = 3
                        ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_nlayer_d_params``: conv0 at ``model.0``, then a
    conv at every third index from ``model.2``, the output conv last."""
    p = variables["params"]
    sd: dict = {}
    _conv2d(sd, "model.0", p["conv0"])
    for n in range(1, n_layers + 1):
        _conv2d(sd, f"model.{3 * n - 1}", p[f"conv{n}"])
    _conv2d(sd, f"model.{3 * n_layers + 2}", p["out"])
    return sd


def mobilefacenet_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_mobilefacenet_params`` (params and batch_stats)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}

    def cb(ours: str, theirs: str) -> None:
        pp, ss = p, s
        for seg in ours.split("."):
            pp, ss = pp[seg], ss[seg]
        _conv2d(sd, f"{theirs}.conv", pp["conv"])
        _batchnorm(sd, f"{theirs}.bn", pp["bn"]["bn"], ss["bn"]["bn"])
        if "prelu" in pp:
            sd[f"{theirs}.prelu.weight"] = _t(pp["prelu"]["alpha"])

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
    _dense(sd, "output_layer.linear", p["linear"])
    _batchnorm(sd, "output_layer.bn", p["out_bn"], s["out_bn"])
    return sd


def sphere20a_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_sphere20a_params`` (without the dropped fc6)."""
    p = variables["params"]
    sd: dict = {}
    for name, leaf in p.items():
        if name.startswith("conv"):
            _conv2d(sd, name, leaf)
        elif name.startswith("relu"):
            sd[f"{name}.weight"] = _t(leaf["alpha"])
    _dense(sd, "fc5", p["fc5"])
    return sd


def senet50_state_dict(variables: Tree, layers: tuple = (3, 4, 6, 3)
                       ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_senet50_params`` (params and batch_stats; the
    pickle's ``fc`` is dropped there)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _conv2d(sd, "conv1", p["conv1"])
    _batchnorm(sd, "bn1", p["bn1"]["bn"], s["bn1"]["bn"])
    for li, blocks in enumerate(layers):
        for bi in range(blocks):
            ours, theirs = f"layer{li + 1}_{bi}", f"layer{li + 1}.{bi}"
            pb, sb = p[ours], s[ours]
            for k in range(1, 6):
                _conv2d(sd, f"{theirs}.conv{k}", pb[f"conv{k}"])
            for k in range(1, 4):
                _batchnorm(sd, f"{theirs}.bn{k}", pb[f"bn{k}"]["bn"],
                           sb[f"bn{k}"]["bn"])
            if "down_conv" in pb:
                _conv2d(sd, f"{theirs}.downsample.0", pb["down_conv"])
                _batchnorm(sd, f"{theirs}.downsample.1",
                           pb["down_bn"]["bn"], sb["down_bn"]["bn"])
    return sd


def _fa_convblock(sd: dict, name: str, p: Tree, s: Tree) -> None:
    """face_alignment ConvBlock: conv1-3 without bias, bn1-3, and the
    shortcut ``downsample`` = Sequential(BN, ReLU, Conv1x1) when present."""
    for i in (1, 2, 3):
        _conv2d(sd, f"{name}.conv{i}", p[f"conv{i}"])
        _batchnorm(sd, f"{name}.bn{i}", p[f"bn{i}"]["bn"], s[f"bn{i}"]["bn"])
    if "ds_conv" in p:
        _batchnorm(sd, f"{name}.downsample.0", p["ds_bn"]["bn"],
                   s["ds_bn"]["bn"])
        _conv2d(sd, f"{name}.downsample.2", p["ds_conv"])


def fan3d_state_dict(variables: Tree, num_modules: int = 4
                     ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_fan3d_params``: FAN3D variables -> a face_alignment
    2DFAN4/3DFAN4 state dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _conv2d(sd, "conv1", p["conv1"])
    _batchnorm(sd, "bn1", p["bn1"]["bn"], s["bn1"]["bn"])
    for name in ("conv2", "conv3", "conv4"):
        _fa_convblock(sd, name, p[name], s[name])
    for m in range(num_modules):
        hp, hs = p[f"m{m}"], s[f"m{m}"]
        for block in hp:
            _fa_convblock(sd, f"m{m}.{block}", hp[block], hs[block])
        _fa_convblock(sd, f"top_m_{m}", p[f"top_m_{m}"], s[f"top_m_{m}"])
        _conv2d(sd, f"conv_last{m}", p[f"conv_last{m}"])
        _batchnorm(sd, f"bn_end{m}", p[f"bn_end{m}"]["bn"],
                   s[f"bn_end{m}"]["bn"])
        _conv2d(sd, f"l{m}", p[f"l{m}"])
        if m < num_modules - 1:
            _conv2d(sd, f"bl{m}", p[f"bl{m}"])
            _conv2d(sd, f"al{m}", p[f"al{m}"])
    return sd


def depth_state_dict(variables: Tree, layers: tuple = (3, 8, 36, 3)
                     ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_depth_params``: ResNetDepth variables -> a
    face_alignment ``depth`` state dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _conv2d(sd, "conv1", p["conv1"])
    _batchnorm(sd, "bn1", p["bn1"]["bn"], s["bn1"]["bn"])
    for li, blocks in enumerate(layers):
        for b in range(blocks):
            ours, theirs = f"layer{li + 1}_{b}", f"layer{li + 1}.{b}"
            pb, sb = p[ours], s[ours]
            for i in (1, 2, 3):
                _conv2d(sd, f"{theirs}.conv{i}", pb[f"conv{i}"])
                _batchnorm(sd, f"{theirs}.bn{i}", pb[f"bn{i}"]["bn"],
                           sb[f"bn{i}"]["bn"])
            if "ds_conv" in pb:
                _conv2d(sd, f"{theirs}.downsample.0", pb["ds_conv"])
                _batchnorm(sd, f"{theirs}.downsample.1", pb["ds_bn"]["bn"],
                           sb["ds_bn"]["bn"])
    _dense(sd, "fc", p["fc"])
    return sd
