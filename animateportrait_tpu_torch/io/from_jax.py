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
- a module the reference registers under two names (DualUnetGenerator's
  shared downsamples) is written under both.

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


def _transformer_encoder(sd: dict, prefix: str, enc: Tree,
                         num_layers: int) -> None:
    _dense(sd, f"{prefix}.embed.embed", enc["embed"])
    for i in range(num_layers):
        lp, le = f"{prefix}.layers.{i}", enc[f"layer{i}"]
        for ours, theirs in (("norm1", "norm_1"), ("norm2", "norm_2")):
            sd[f"{lp}.{theirs}.alpha"] = _t(le[ours]["alpha"])
            sd[f"{lp}.{theirs}.bias"] = _t(le[ours]["bias"])
        for ours, theirs in (("q", "q_linear"), ("k", "k_linear"),
                             ("v", "v_linear"), ("out", "out")):
            _dense(sd, f"{lp}.attn.{theirs}", le["attn"][ours])
        _dense(sd, f"{lp}.ff.linear_1", le["ff"]["l1"])
        _dense(sd, f"{lp}.ff.linear_2", le["ff"]["l2"])
    sd[f"{prefix}.norm.alpha"] = _t(enc["norm"]["alpha"])
    sd[f"{prefix}.norm.bias"] = _t(enc["norm"]["bias"])


def _mlp3(sd: dict, name: str, p: Tree, ours: str) -> None:
    """A Sequential(Linear, LeakyReLU, Linear, LeakyReLU, Linear) from the
    Dense layers ``{ours}0..2``."""
    for j, idx in enumerate((0, 2, 4)):
        _dense(sd, f"{name}.{idx}", p[f"{ours}{j}"])


def pos_state_dict(variables: Tree, num_layers: int = 2
                   ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_pos_params``."""
    p = variables["params"]
    sd: dict = {}
    _lstm(sd, "audio_content_encoder.", p["audio_content_encoder"], 3)
    _mlp3(sd, "spk_emb_encoder", p, "spk_l")
    _transformer_encoder(sd, "encoder", p["encoder"], num_layers)
    _mlp3(sd, "out", p, "out_l")
    return sd


def speaker_aware_state_dict(variables: Tree, num_layers: int = 2
                             ) -> dict[str, torch.Tensor]:
    """``Audio2landmarkSpeakerAware`` variables -> the port's module (the
    JAX package has no loader for it: the keys are the pos branch's, with
    the landmark head at ``fls_out`` and the pose head at ``pos_out``)."""
    p = variables["params"]
    sd: dict = {}
    _lstm(sd, "audio_content_encoder.", p["audio_content_encoder"], 3)
    _mlp3(sd, "spk_emb_encoder", p, "spk_l")
    _transformer_encoder(sd, "encoder", p["encoder"], num_layers)
    _mlp3(sd, "fls_out", p, "fls_l")
    _mlp3(sd, "pos_out", p, "pos_l")
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


def _pair(p: Tree, s: Tree, key: str) -> tuple[Tree, Tree]:
    return p[key], (s or {}).get(key, {})


def _convnorm(sd: dict, name: str, p: Tree, s: Tree) -> None:
    """conv(): Sequential(Conv2d, BatchNorm2d), or the biased conv alone."""
    _conv2d(sd, f"{name}.0", p["conv"])
    if "norm" in p:
        _batchnorm(sd, f"{name}.1", p["norm"]["bn"], s["norm"]["bn"])


def _resblock(sd: dict, name: str, p: Tree, s: Tree) -> None:
    _convnorm(sd, f"{name}.conv", *_pair(p, s, "conv"))
    if "conv_a" in p:
        _convnorm(sd, f"{name}.conv_a", *_pair(p, s, "conv_a"))


def _seq_conv_norm(sd: dict, name: str, p: Tree, s: Tree, norm_idx: int
                   ) -> None:
    """[act, Conv2d, (PixelShuffle,) norm]: the conv at 1, the norm at
    ``norm_idx``."""
    _conv2d(sd, f"{name}.1", p["conv"])
    _batchnorm(sd, f"{name}.{norm_idx}", p["norm"]["bn"], s["norm"]["bn"])


def _unet_scales(sd: dict, p: Tree, s: Tree, num_scales: int, n_res: int,
                 enc: tuple = ("enc",)) -> None:
    """The per-scale blocks the three residual Unets share: each encoder's
    residual blocks (one encoder per prefix of ``enc``) and downsamples
    (the one ``enc_{l}_down`` written under each prefix), the decoder's
    upsamples and residual blocks."""
    for l in range(num_scales):
        for e in enc:
            _seq_conv_norm(sd, f"{e}_{l}_downsample",
                           *_pair(p, s, f"enc_{l}_down"), 2)
        _seq_conv_norm(sd, f"dec_{l}_upsample", *_pair(p, s, f"dec_{l}_up"),
                       3)
        for i in range(n_res):
            for e in enc:
                _resblock(sd, f"{e}_{l}_res_{i}",
                          *_pair(p, s, f"{e}_{l}_res_{i}"))
            _resblock(sd, f"dec_{l}_res_{i}", *_pair(p, s, f"dec_{l}_res_{i}"))


def flowunet_v2_state_dict(variables: Tree, start_scale: int = 2,
                           num_scales: int = 7, n_residual_blocks: int = 2
                           ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_flowunet_v2_params``."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}
    _convnorm(sd, "pre_conv.0", *_pair(p, s, "pre_map"))
    for i in range(start_scale.bit_length() - 1):
        base = 1 + i * 4
        _resblock(sd, f"pre_conv.{base}", *_pair(p, s, f"pre_res{i}"))
        _conv2d(sd, f"pre_conv.{base + 2}", p[f"pre_down{i}"])
        _batchnorm(sd, f"pre_conv.{base + 3}", p[f"pre_down{i}_bn"]["bn"],
                   s[f"pre_down{i}_bn"]["bn"])
    _unet_scales(sd, p, s, num_scales, n_residual_blocks)
    for l in range(num_scales):
        _conv2d(sd, f"pred_flow_{l}.1", p[f"flow_{l}"]["conv"])
    _conv2d(sd, "pred_vis.1", p["vis"]["conv"])
    return sd


def if_unet_state_dict(variables: Tree, num_scales: int = 7,
                       n_residual_blocks: int = 2, multi_output_nc: tuple = ()
                       ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_if_unet_params`` (UnetGenerator, or with
    ``multi_output_nc`` UnetGenerator_MultiOutput)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}
    _convnorm(sd, "pre_conv", *_pair(p, s, "pre_conv"))
    _unet_scales(sd, p, s, num_scales, n_residual_blocks)
    if multi_output_nc:
        for i in range(len(multi_output_nc)):
            _convnorm(sd, f"dec_output_{i}.0", *_pair(p, s, f"out_{i}_map"))
            _conv2d(sd, f"dec_output_{i}.3", p[f"out_{i}_conv"])
    else:
        _conv2d(sd, "dec_output.1", p["dec_output"])
    return sd


def dual_unet_state_dict(variables: Tree, num_scales: int = 7,
                         num_warp_scales: int = 5, n_residual_blocks: int = 2,
                         vis_mode: str = "none", aux_outputs: int = 0
                         ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_dual_unet_params``; the shared downsamples under
    both the pose and the appearance name."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}
    for ours, theirs in (("encp_pre", "encp_pre_conv"),
                         ("enca_pre", "enca_pre_conv"),
                         ("dec_fuse", "dec_fuse")):
        _convnorm(sd, theirs, *_pair(p, s, ours))
    _unet_scales(sd, p, s, num_scales, n_residual_blocks,
                 enc=("encp", "enca"))
    for l in range(min(num_warp_scales, num_scales)):
        for i in range(n_residual_blocks):
            name = f"enca_{l}_vis_{i}"
            if vis_mode == "soft_gate":
                _conv2d(sd, f"{name}.conv", p[name]["conv"])
            elif vis_mode in ("residual", "res_no_vis"):
                _resblock(sd, name, *_pair(p, s, name))
    _conv2d(sd, "dec_output.1", p["dec_output"])
    for i in range(aux_outputs):
        _conv2d(sd, f"dec_aux_output_{i}.1", p[f"dec_aux_{i}"])
    return sd


def resunet_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """``ResUnetGenerator`` variables -> the port's module (the JAX package
    has no loader for it; the keys are the JAX tree's, each block's
    convs ``down``/``up``, norms ``down_bn``/``up_bn`` and residual
    blocks ``{down,up}_res{0,1}`` with ``conv{0,1}``/``bn{0,1}``)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for block, pb in p.items():
        sb = s.get(block, {})
        for conv in ("down", "up"):
            _conv2d(sd, f"{block}.{conv}", pb[conv])
            if f"{conv}_bn" in pb:
                _batchnorm(sd, f"{block}.{conv}_bn", pb[f"{conv}_bn"]["bn"],
                           sb[f"{conv}_bn"]["bn"])
        for res in (k for k in pb if "_res" in k):
            for j in (0, 1):
                _conv2d(sd, f"{block}.{res}.conv{j}", pb[res][f"conv{j}"])
                _batchnorm(sd, f"{block}.{res}.bn{j}",
                           pb[res][f"bn{j}"]["bn"], sb[res][f"bn{j}"]["bn"])
    return sd


def vgg19_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_vgg19_params``: ``conv{i}`` -> torchvision's
    ``features.{i}``."""
    sd: dict = {}
    for name, leaf in variables["params"].items():
        _conv2d(sd, f"features.{name[4:]}", leaf)
    return sd


def gmm_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of ``load_gmm_params``: the extractors' ``model.{i}``
    (conv, ReLU, BN triples) and the regressor's ``conv.{i}`` and
    ``linear``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for ext in ("extractionA", "extractionB"):
        for i, t in enumerate((0, 3, 6, 9, 12, 15)):
            _conv2d(sd, f"{ext}.model.{t}", p[ext][f"conv{i}"])
        for i, t in enumerate((2, 5, 8, 11, 14)):
            _batchnorm(sd, f"{ext}.model.{t}", p[ext][f"bn{i}"],
                       s[ext][f"bn{i}"])
    for i, t in enumerate((0, 3, 6, 9)):
        _conv2d(sd, f"regression.conv.{t}", p["regression"][f"conv{i}"])
        _batchnorm(sd, f"regression.conv.{t + 1}",
                   p["regression"][f"bn{i}"], s["regression"][f"bn{i}"])
    # the regressor's input is flattened channel-major in both packages
    _dense(sd, "regression.linear", p["regression"]["linear"])
    return sd


def bn_patch_d_state_dict(variables: Tree, n_layers: int = 3
                          ) -> dict[str, torch.Tensor]:
    """``BNPatchDiscriminator`` variables -> the port's module (the JAX
    package has no loader for it; the keys are networks.py's
    NLayerDiscriminator's: conv0 at ``model.0``, conv n at
    ``model.{3n - 1}`` with its BatchNorm at ``model.{3n}``, the output
    conv at ``model.{3 n_layers + 2}``)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _conv2d(sd, "model.0", p["conv0"])
    for n in range(1, n_layers + 1):
        _conv2d(sd, f"model.{3 * n - 1}", p[f"conv{n}"])
        _batchnorm(sd, f"model.{3 * n}", p[f"norm{n}"]["bn"],
                   s[f"norm{n}"]["bn"])
    _conv2d(sd, f"model.{3 * n_layers + 2}", p["out"])
    return sd


def _fan_block(sd: dict, name: str, p: Tree, s: Tree) -> None:
    """A FAN ConvBlock: bn1-3 and conv1-3, and the 1x1 ``downsample``
    (BatchNorm at 0, conv at 2) where the widths differ."""
    for j in (1, 2, 3):
        _batchnorm(sd, f"{name}.bn{j}", p[f"bn{j}"]["bn"], s[f"bn{j}"]["bn"])
        _conv2d(sd, f"{name}.conv{j}", p[f"conv{j}"])
    if "down_conv" in p:
        _batchnorm(sd, f"{name}.downsample.0", p["down_bn"]["bn"],
                   s["down_bn"]["bn"])
        _conv2d(sd, f"{name}.downsample.2", p["down_conv"])


def fan_state_dict(variables: Tree, num_modules: int = 4
                   ) -> dict[str, torch.Tensor]:
    """The AdaptiveWingLoss ``FAN`` variables -> the port's module (the JAX
    package has no loader for it; the keys are the reference's
    models.py names)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _conv2d(sd, "conv1.conv", p["conv1"]["conv"])
    _batchnorm(sd, "bn1", p["bn1"]["bn"], s["bn1"]["bn"])
    for k in ("conv2", "conv3", "conv4"):
        _fan_block(sd, k, p[k], s[k])
    for i in range(num_modules):
        m, ms = p[f"m{i}"], s[f"m{i}"]
        _conv2d(sd, f"m{i}.coordconv.conv", m["coordconv"]["conv"])
        for k in m:
            if k != "coordconv":
                _fan_block(sd, f"m{i}.{k}", m[k], ms[k])
        _fan_block(sd, f"top_m_{i}", p[f"top_m_{i}"], s[f"top_m_{i}"])
        _conv2d(sd, f"conv_last{i}", p[f"conv_last{i}"])
        _batchnorm(sd, f"bn_end{i}", p[f"bn_end{i}"]["bn"],
                   s[f"bn_end{i}"]["bn"])
        _conv2d(sd, f"l{i}", p[f"l{i}"])
        if i < num_modules - 1:
            _conv2d(sd, f"bl{i}", p[f"bl{i}"])
            _conv2d(sd, f"al{i}", p[f"al{i}"])
    return sd


# --- models/gan.py's ResnetGenerator and PixelDiscriminator, and
# models/gan_extra.py ----------------------------------------------------


def resnet_block_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """One ``models/gan.py:ResnetBlock`` (its two reflect-padded convs)."""
    p = variables["params"]
    sd = {}
    _conv2d(sd, "conv_block.1", p["conv0"])
    _conv2d(sd, "conv_block.5", p["conv1"])
    return sd


def resnet_g_state_dict(variables: Tree, n_blocks: int = 9
                        ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_resnet_g_params``: the reference's ``model``
    Sequential."""
    p = variables["params"]
    sd: dict = {}
    _conv2d(sd, "model.1", p["stem"]["conv"])
    _conv2d(sd, "model.4", p["down0"]["conv"])
    _conv2d(sd, "model.7", p["down1"]["conv"])
    _resnet_blocks(sd, "model", p, [f"block{i}" for i in range(n_blocks)],
                   start=10)
    base = 10 + n_blocks
    _conv_transpose(sd, f"model.{base}", p["up0"]["deconv"])
    _conv_transpose(sd, f"model.{base + 3}", p["up1"]["deconv"])
    _conv2d(sd, f"model.{base + 7}", p["out"])
    return sd


def pixel_d_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """``PixelDiscriminator`` variables -> the reference's ``net`` keys."""
    p = variables["params"]
    sd: dict = {}
    for ours, idx in (("conv0", 0), ("conv1", 2), ("out", 5)):
        _conv2d(sd, f"net.{idx}", p[ours])
    return sd


def _resnet_blocks(sd: dict, name: str, p: Tree, keys: list,
                   start: int = 0) -> None:
    """ResNet blocks ``keys`` of ``p`` at ``{name}.{start + i}``: their two
    convs at ``conv_block.1`` / ``.5``, a ``ResnetBlock2``'s shortcut at
    ``shortcut.0``."""
    for i, key in enumerate(keys):
        b = p[key]
        _conv2d(sd, f"{name}.{start + i}.conv_block.1", b["conv0"])
        _conv2d(sd, f"{name}.{start + i}.conv_block.5", b["conv1"])
        if "shortcut" in b:
            _conv2d(sd, f"{name}.{start + i}.shortcut.0", b["shortcut"])


def _blocks_of(p: Tree, prefix: str = "") -> list:
    n = sum(1 for k in p if k.startswith(prefix + "block"))
    return [f"{prefix}block{i}" for i in range(n)]


def _encoder_decoder(sd: dict, p: Tree, prefix: str = "",
                     model2: str = "model2", model3: str = "model3") -> None:
    """The stem and two strided convs (when ``prefix`` is empty), the block
    stack ``{prefix}block{i}`` -> ``model2`` and the two upsamples and the
    7x7 head -> ``model3``."""
    if not prefix:
        _conv2d(sd, "stem.1", p["stem"]["conv"])
        _conv2d(sd, "down0.0", p["down0"]["conv"])
        _conv2d(sd, "down1.0", p["down1"]["conv"])
    _resnet_blocks(sd, model2, p, _blocks_of(p, prefix))
    _conv_transpose(sd, f"{model3}.0", p[f"{prefix}up0"]["deconv"])
    _conv_transpose(sd, f"{model3}.3", p[f"{prefix}up1"]["deconv"])
    _conv2d(sd, f"{model3}.7", p[f"{prefix}out"])


def _landmark_encoder(sd: dict, name: str, p: Tree) -> None:
    for j, idx in enumerate((0, 3, 6)):
        _conv2d(sd, f"{name}.{idx}", p[f"conv{j}"]["conv"])


def conditional_resnet_state_dict(variables: Tree
                                  ) -> dict[str, torch.Tensor]:
    """``ConditionalResnetGenerator`` variables (any mode) -> the port's
    module (the JAX package has no loader for it)."""
    p = variables["params"]
    sd: dict = {}
    _encoder_decoder(sd, p)
    _landmark_encoder(sd, "model_landmark_trans", p["landmark_trans"])
    return sd


def dual_head_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """``ConditionalResnetDualHead`` variables -> the port's module."""
    p = variables["params"]
    sd: dict = {}
    _conv2d(sd, "stem.1", p["stem"]["conv"])
    _conv2d(sd, "down0.0", p["down0"]["conv"])
    _conv2d(sd, "down1.0", p["down1"]["conv"])
    _landmark_encoder(sd, "model_landmark_trans", p["landmark_trans"])
    for head in ("a_", "b_"):
        _encoder_decoder(sd, p, head, f"{head}model2", f"{head}model3")
    return sd


def warped_resnet_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """``ConditionalResnetWarped`` variables -> the port's module."""
    sd: dict = {}
    _encoder_decoder(sd, variables["params"])
    return sd


def _unet_chain(p: Tree) -> list:
    """The flax names of a U-Net's levels, outermost first."""
    mids = sorted((k for k in p if k.startswith("mid")),
                  key=lambda k: -int(k[3:]))
    return ["outer", "up1", "up2", "up4", *mids, "inner"]


def unet_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """``UnetGenerator`` variables -> the port's module: each level's
    ``down`` and ``up`` under ``model`` + ``.inner`` per level."""
    p = variables["params"]
    sd: dict = {}
    name = "model"
    for key in _unet_chain(p):
        _conv2d(sd, f"{name}.down", p[key]["down"])
        _conv_transpose(sd, f"{name}.up", p[key]["up"])
        name += ".inner"
    return sd


def unet_parse_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """``UnetParseGenerator`` variables -> the port's module, as
    ``unet_state_dict`` with each level's ``down_bn`` / ``up_bn``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    name = "model"
    for key in _unet_chain(p):
        _conv2d(sd, f"{name}.down", p[key]["down"])
        _conv_transpose(sd, f"{name}.up", p[key]["up"])
        for bn in ("down_bn", "up_bn"):
            if bn in p[key]:
                _batchnorm(sd, f"{name}.{bn}", p[key][bn], s[key][bn])
        name += ".inner"
    return sd


def flat_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """A net whose convs and denses all sit at the top of its params under
    the port's names (``Regressor``, ``NLayerDiscriminatorCls``, ``HED``,
    ``ULP``): 4-d kernels as convs, 2-d as denses."""
    sd: dict = {}
    for k, v in variables["params"].items():
        (_conv2d if np.ndim(v["kernel"]) == 4 else _dense)(sd, k, v)
    return sd


def combiner_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """``Combiner`` variables -> the port's ``model`` Sequential: the stem
    conv at 1, block i at 4 + i, the head conv after the blocks' pad."""
    p = variables["params"]
    sd: dict = {}
    keys = _blocks_of(p)
    _conv2d(sd, "model.1", p["stem"]["conv"])
    _resnet_blocks(sd, "model", p, keys, start=4)
    _conv2d(sd, f"model.{5 + len(keys)}", p["out"])
    return sd


# --- models/lpips.py ----------------------------------------------------

_VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_ALEX_CONVS = (0, 3, 6, 8, 10)
_SQUEEZE_FIRES = (3, 4, 6, 7, 9, 10, 11, 12)


def lpips_backbone_state_dict(variables: Tree, pnet_type: str = "vgg"
                              ) -> dict[str, torch.Tensor]:
    """Inverse of ``load_vgg16_features`` / ``load_alexnet_features`` /
    ``load_squeezenet_features``: torchvision's ``features.N`` keys."""
    p = variables["params"]
    sd: dict = {}
    if pnet_type == "squeeze":
        _conv2d(sd, "features.0", p["conv0"])
        for t in _SQUEEZE_FIRES:
            for part in ("squeeze", "expand1x1", "expand3x3"):
                _conv2d(sd, f"features.{t}.{part}", p[f"fire{t}"][part])
        return sd
    idx = _ALEX_CONVS if pnet_type == "alex" else _VGG16_CONVS
    for i, t in enumerate(idx):
        _conv2d(sd, f"features.{t}", p[f"conv{i}"])
    return sd


def pnetlin_state_dicts(variables: Tree, pnet_type: str = "vgg"
                        ) -> tuple[dict, dict]:
    """Inverse of ``load_pnetlin_params``: (the backbone's torchvision
    state dict, the LPIPS heads' ``lin{k}.model.1.weight``)."""
    p = variables["params"]
    lins: dict = {}
    k = 0
    while f"lin{k}" in p:
        _conv2d(lins, f"lin{k}.model.1", p[f"lin{k}"])
        k += 1
    return lpips_backbone_state_dict({"params": p["net"]}, pnet_type), lins


def dist2logit_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """``Dist2LogitLayer`` variables -> the reference's ``model`` keys."""
    p = variables["params"]
    sd: dict = {}
    for j in range(3):
        _conv2d(sd, f"model.{2 * j}", p[f"conv{j}"])
    return sd


# --- models/face_of_art.py ----------------------------------------------


def artistic_heatmap_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """``ArtisticHeatmapNet`` variables -> the port's module: the convs by
    their TF scopes, the deconv's (h, w, out, in) kernel as
    ``ConvTranspose2d``'s (in, out, h, w) weight. The port's
    ``foa_state_dict`` takes the reference's TF variables to the same
    keys (the inverse of ``load_foa_params`` through them)."""
    p = variables["params"]
    sd: dict = {}
    for scope, node in p.items():
        if scope == "deconv_1":
            _conv_transpose(sd, scope, node)
        else:
            _conv2d(sd, scope, node.get("conv", node))
    return sd


def discriminator_mlp_state_dict(variables: Tree
                                 ) -> dict[str, torch.Tensor]:
    """``DiscriminatorMLP`` variables -> the port's module (the JAX package
    has no loader for the discriminators)."""
    sd: dict = {}
    _mlp3(sd, "fl_DL", variables["params"], "l")
    return sd


def transformer_dt_state_dict(variables: Tree, num_layers: int = 2
                              ) -> dict[str, torch.Tensor]:
    """``TransformerDT`` variables -> the port's module."""
    p = variables["params"]
    sd: dict = {}
    _transformer_encoder(sd, "encoder", p["encoder"], num_layers)
    _mlp3(sd, "out", p, "l")
    return sd


def discriminator_gru_state_dict(variables: Tree
                                 ) -> dict[str, torch.Tensor]:
    """``DiscriminatorGRU`` variables -> the port's module: the JAX GRU's
    gates are in torch's order (r, z, n), as its LSTM's are."""
    p = variables["params"]
    sd: dict = {}
    _lstm(sd, "fl_DT.", p["gru"], 3)
    _mlp3(sd, "projection", p, "l")
    return sd
