"""The port covers the JAX package: every public top-level ``def`` and
``class`` of each ``animateportrait_tpu/**/*.py`` (and ``entry`` and
``dryrun_multichip`` of ``__graft_entry__.py``), listed with ``ast``
without importing JAX, has a counterpart in ``animateportrait_tpu_torch``:

- the same name in the port's module of the same path; or
- an entry of ``RENAMED``: the name the port has it under, as ``path.py:
  Name[.attr]`` of a port module or ``module:Name`` of torch, which must
  resolve; or
- an entry of ``LEFT_BEHIND`` (a name, or a whole module), with the reason
  the port has no counterpart.

Both tables name only what the JAX package defines and the port's module
of the same path does not, so a name ported later fails here until its
entry goes. ROADMAP Queue 1 lists the same.
"""
import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "animateportrait_tpu"
PORT_PKG = REPO / "animateportrait_tpu_torch"
# the driver hooks at the repository's root, and their port modules
GRAFT = {"__graft_entry__.py": ("entry.py", ("entry", "dryrun_multichip"))}

RENAMED = {
    "__graft_entry__.py:dryrun_multichip": "multichip.py:dryrun_multichip",
    "data/av2flau.py:read_video_frames": "utils/video.py:read_video_frames",
    "data/umlvd_ifw.py:draw_dots": "utils/image.py:draw_dots",
    "io/checkpoint.py:save": "io/checkpoint.py:CheckpointManager.save",
    "io/checkpoint.py:restore": "io/checkpoint.py:CheckpointManager.restore",
    "io/torch_convert.py:load_torch_statedict":
        "io/reference.py:load_state_dict",
    # load_state_dict drops a leading "module." itself
    "io/torch_convert.py:strip_module_prefix":
        "io/reference.py:load_state_dict",
    "models/audio2landmark.py:BatchNorm1dTorch": "nn.py:BatchNorm1d",
    "models/audio2landmark.py:TorchNorm": "models/audio2landmark.py:Norm",
    "models/audio2landmark.py:TransformerEncoder":
        "models/audio2landmark.py:Encoder",
    "models/fan.py:CoordConv": "models/fan.py:CoordConvTh",
    "models/fan.py:FANConvBlock": "models/fan.py:ConvBlock",
    "models/fan.py:FANHourGlass": "models/fan.py:HourGlass",
    # the block's predict_flow head
    "models/flowunet.py:PredictFlow":
        "models/flowunet.py:FlowUnetSkipConnectionBlock",
    "models/flowunet.py:FlowNetworkWarp": "train/module2.py:flow_warp_fields",
    "models/flowunet_extra.py:pixel_shuffle":
        "torch.nn.functional:pixel_shuffle",
    "models/gan.py:ConvINReLU": "nn.py:conv_in_relu",
    "models/gan.py:StemConv7": "models/gan.py:_stem",
    "models/gan.py:Upsample2x": "models/gan.py:_up2x",
    "models/gan.py:OutConv7": "models/gan.py:_out_conv7",
    "models/gan.py:LandmarkEncoder": "models/gan.py:landmark_encoder",
    "models/gan.py:init_weights_normal": "models/gan.py:init_weights",
    "models/modnet.py:ConvBN": "models/modnet.py:_conv_bn",
    "models/modnet.py:ConvIBNRelu": "models/modnet.py:Conv2dIBNormRelu",
    "models/perception.py:LinearBlock": "models/perception.py:_linear_block",
    "nn.py:PReLU": "torch.nn:PReLU",
    "nn.py:max_pool_ceil": "torch.nn.functional:max_pool2d",
    "nn.py:InstanceNorm": "nn.py:InstanceNorm2d",
    "nn.py:GroupNorm": "torch.nn:GroupNorm",
    "nn.py:reflect_pad_2d": "torch.nn:ReflectionPad2d",
    "nn.py:replicate_pad_2d": "torch.nn:ReplicationPad2d",
    "nn.py:Conv2dReflect": "torch.nn:Conv2d",
    "nn.py:ConvTranspose2dTorch": "torch.nn:ConvTranspose2d",
    "nn.py:interpolate_bilinear": "torch.nn.functional:interpolate",
    "nn.py:LSTMLayerTorch": "torch.nn:LSTM",
    "nn.py:LSTM": "torch.nn:LSTM",
    "nn.py:GRULayerTorch": "torch.nn:GRU",
    "nn.py:GRU": "torch.nn:GRU",
    "ops/pallas_instnorm.py:instance_norm": "ops/instnorm.py:instance_norm",
    "ops/pallas_instnorm.py:instance_norm_fused":
        "ops/instnorm.py:instance_norm",
    "ops/pallas_stft.py:stft_magnitude_pallas": "ops/stft.py:stft_magnitude",
    "ops/pallas_stft.py:stft_magnitude_best": "ops/stft.py:stft_magnitude",
    # F.grid_sample, whose nearest mode is the JAX function's
    # (tests/test_torch_last_functions.py)
    "ops/warp.py:grid_sample": "ops/warp.py:grid_sample_features",
    "parallel.py:stack_stage_params": "parallel.py:stage_blocks",
    "parallel.py:resnet_stage_fn": "parallel.py:resnet_stage",
    "pipeline/render.py:draw_landmarks": "utils/image.py:draw_landmarks",
    "train/face_of_art.py:FOATrainState": "train/face_of_art.py:FOATrainer",
    "train/face_of_art.py:init_foa_state": "train/face_of_art.py:FOATrainer",
    "train/face_of_art.py:build_foa_train_step":
        "train/face_of_art.py:FOATrainer.step",
    "train/fan.py:FANTrainState": "train/fan.py:FANTrainer",
    "train/fan.py:init_fan_state": "train/fan.py:FANTrainer",
    "train/fan.py:build_fan_train_step": "train/fan.py:FANTrainer.step",
    "train/flow_regression.py:FlowRegTrainState":
        "train/flow_regression.py:FlowRegTrainer",
    "train/flow_regression.py:init_flow_state":
        "train/flow_regression.py:FlowRegTrainer",
    "train/flow_regression.py:build_flow_train_step":
        "train/flow_regression.py:FlowRegTrainer.step",
    "train/image_translation.py:ImageTranslationState":
        "train/image_translation.py:ImageTranslationTrainer",
    "train/image_translation.py:init_image_translation_state":
        "train/image_translation.py:ImageTranslationTrainer",
    "train/image_translation.py:build_image_translation_train_step":
        "train/image_translation.py:ImageTranslationTrainer.step",
    "train/module1.py:ContentTrainState": "train/module1.py:ContentTrainer",
    "train/module1.py:init_content_state": "train/module1.py:ContentTrainer",
    "train/module1.py:build_content_train_step":
        "train/module1.py:ContentTrainer.step",
    "train/module1.py:SpeakerAwareTrainState":
        "train/module1.py:SpeakerAwareTrainer",
    "train/module1.py:init_speaker_aware_state":
        "train/module1.py:SpeakerAwareTrainer",
    "train/module1.py:build_speaker_aware_train_step":
        "train/module1.py:SpeakerAwareTrainer.step",
    "train/module2.py:fsdp_param_shardings":
        "train/fsdp.py:fsdp_param_shardings",
    "train/module2.py:shard_state_fsdp": "train/fsdp.py:shard_state_fsdp",
    # a placed state's shardings for jit; the port's checkpoint writer
    # gathers a sharded state whole instead
    "train/module2.py:state_shardings": "train/fsdp.py:gather_state",
    "train/pose_transfer.py:PTTrainState":
        "train/pose_transfer.py:PoseTransferTrainer",
    "train/pose_transfer.py:init_pt_state":
        "train/pose_transfer.py:PoseTransferTrainer",
    "train/pose_transfer.py:build_pt_train_step":
        "train/pose_transfer.py:PoseTransferTrainer.step",
    "train/pose_transfer.py:build_pt_test_step":
        "train/pose_transfer.py:PoseTransferTrainer.test",
    "utils/smoke.py:random_variables": "utils/smoke.py:init_random_",
}

_LOADER = ("loads a reference torch checkpoint into flax variables; the "
           "port's modules keep the reference's state-dict keys, so "
           "io/reference.py loads the files as they are, and io/from_jax.py "
           "holds each loader's inverse for the tests")
_LOADERS = {
    "models/audio2landmark.py": ("load_content_params", "load_pos_params"),
    "models/autovc.py": ("load_autovc_params",),
    "models/face_of_art.py": ("load_foa_params",),
    "models/fan3d.py": ("load_fan3d_params", "load_depth_params"),
    "models/flowunet.py": ("load_flowunet_params",),
    "models/flowunet_extra.py": ("load_flowunet_v2_params",
                                 "load_if_unet_params",
                                 "load_dual_unet_params"),
    "models/gan.py": ("load_trident_full_ifw_params", "load_style2_params",
                      "load_nlayer_d_params", "load_resnet_g_params"),
    "models/image_translation.py": ("load_vgg19_params", "load_gmm_params"),
    "models/lpips.py": ("load_vgg16_features", "load_alexnet_features",
                        "load_squeezenet_features", "load_pnetlin_params"),
    "models/modnet.py": ("load_modnet_params",),
    "models/mtcnn.py": ("load_pnet_params", "load_rnet_params",
                        "load_onet_params"),
    "models/perception.py": ("load_mobilefacenet_params",
                             "load_sphere20a_params", "load_senet50_params"),
    "models/photo2cartoon.py": ("load_photo2cartoon_params",),
    "models/speaker_encoder.py": ("load_voice_encoder_params",),
}
_TORCH_LAYOUT = ("converts a torch weight to its flax layout; the port keeps "
                 "torch layouts, and io/from_jax.py converts the other way")

LEFT_BEHIND = {
    **{f"{path}:{name}": _LOADER
       for path, names in _LOADERS.items() for name in names},
    **{f"io/torch_convert.py:{name}": _TORCH_LAYOUT for name in (
        "conv2d_kernel", "conv1d_kernel", "conv_transpose2d_kernel",
        "conv_transpose2d", "linear_kernel", "lstm_params", "gru_params",
        "dense", "conv1d", "conv2d", "norm_affine", "batchnorm")},
    "ops/pack.py": "TPU conv packing (space-to-depth for the MXU); cuDNN "
                   "takes the plain convs",
    "utils/native.py": "a ctypes binding to libpng and libjpeg, which the "
                       "card machine is not known to have; the port decodes "
                       "on its own (utils/jpeg.py, utils/image.py)",
    "nn.py:env_choice": "reads the TPU lowering selectors (AP_* env knobs)",
    "nn.py:reflect_conv_mode": "the AP_REFLECT_CONV lowering selector",
    "nn.py:conv2d_reflect_same": "a TPU lowering of a reflect-padded conv "
                                 "without the padded copy; the port pads "
                                 "(torch.nn.ReflectionPad2d) and convolves",
    "nn.py:add_reflect_border_corrections": "part of conv2d_reflect_same's "
                                            "TPU lowering",
    "ops/pallas_instnorm.py:eligible": "the AP_PALLAS_IN switch and the "
                                       "VMEM fit of the TPU kernel; K2's "
                                       "wrapper takes every 4-D fp32 or "
                                       "bf16 CUDA tensor",
    "ops/warp.py:sample_bilinear_multi": "a TPU gather workaround: several "
                                         "samplings share one padded copy "
                                         "of the image; the port calls "
                                         "F.grid_sample for each",
    "pipeline/render.py:RendererVariables": "holds the nets' flax variables; "
                                            "the port's torch modules carry "
                                            "their weights",
    "train/flow_regression.py:psnr": "nothing in the JAX package calls it; "
                                     "its trainers report "
                                     "utils/metrics.py:psnr_ref, ported",
    "utils/observe.py:enable_compile_cache": "configures XLA's persistent "
                                             "compilation cache; the port "
                                             "builds its kernels once into "
                                             "its build directory",
}


def _public_defs(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _all_defs(path: pathlib.Path) -> set[str]:
    if not path.exists():
        return set()
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def _jax_modules() -> dict[str, tuple[pathlib.Path, set[str]]]:
    """rel path -> (the port's module of that path, the JAX names)."""
    out = {str(p.relative_to(JAX_PKG)): (PORT_PKG / p.relative_to(JAX_PKG),
                                         _public_defs(p))
           for p in sorted(JAX_PKG.rglob("*.py"))}
    for rel, (port_rel, names) in GRAFT.items():
        out[rel] = (PORT_PKG / port_rel,
                    set(names) & _public_defs(REPO / rel))
    return out


def _resolve(target: str):
    where, attrs = target.split(":")
    if where.endswith(".py"):
        where = "animateportrait_tpu_torch." + where[:-3].replace("/", ".")
    obj = importlib.import_module(where)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return obj


MODULES = _jax_modules()


@pytest.mark.parametrize("rel", sorted(MODULES))
def test_every_jax_name_has_a_counterpart(rel):
    port_path, names = MODULES[rel]
    ported = _all_defs(port_path)
    missing = []
    for name in sorted(names):
        key = f"{rel}:{name}"
        if name in ported or rel in LEFT_BEHIND or key in LEFT_BEHIND:
            continue
        if key in RENAMED:
            assert callable(_resolve(RENAMED[key])), key
            continue
        missing.append(name)
    assert not missing, (f"{rel}: no counterpart in the port for {missing}; "
                         "port them, or add them to RENAMED or LEFT_BEHIND")


def test_tables_name_what_the_port_lacks():
    """Each entry names a JAX name (or module) that the port's module of
    the same path does not define, and no name is in both tables."""
    assert not set(RENAMED) & set(LEFT_BEHIND)
    for key in (*RENAMED, *LEFT_BEHIND):
        rel, _, name = key.partition(":")
        assert rel in MODULES, key
        port_path, names = MODULES[rel]
        if name:
            assert name in names, f"{key}: not a JAX name"
            assert name not in _all_defs(port_path), f"{key}: ported"
        else:
            assert not port_path.exists(), f"{key}: the port has the module"
