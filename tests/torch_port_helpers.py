"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py):
layout conversions, differences, PSNR, the fixture that skips the
card-only tests on a machine without a CUDA device, the thread count of a
pytest-xdist worker, and the biases whose gradient an InstanceNorm
cancels."""
import os

import numpy as np
import pytest
import torch

# Each pytest-xdist worker is a process of its own, and torch starts one
# intra-op thread per core in each: six workers on eight cores then run ~50
# spinning OpenMP threads, and the port's end-to-end tests took up to eight
# times as long as alone.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2) \
        .contiguous()


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()


def maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def psnr(a, b, peak: float = 2.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(peak ** 2 / mse)


@pytest.fixture
def cuda_device():
    """The CUDA device for a test marked ``cuda``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def in_cancelled_biases(net) -> set:
    """The names of the biases of convs (and linears) that an InstanceNorm
    follows: their gradient is 0 in exact arithmetic (the norm removes any
    constant), and rounding noise in fp32."""
    from animateportrait_tpu_torch.nn import InstanceNorm2d
    from animateportrait_tpu_torch.utils.smoke import cancelled_biases

    return cancelled_biases(net, norms=(InstanceNorm2d,))


def adam_grads(opt_state, b1: float = 0.9):
    """A JAX step's gradients from its Adam state after one step: optax's
    first moment is then (1 - b1) * g."""
    import jax

    mus = [s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - b1),
                                  mus[0])


def module_grads(module: torch.nn.Module) -> dict:
    """The ``.grad`` of every parameter of ``module`` by state-dict key."""
    return {k: p.grad for k, p in module.named_parameters()
            if p.grad is not None}


def random_jax_variables(init_fn, seed: int = 0, stats_seed: int = 1):
    """Seeded random variables of a flax module (the JAX package's
    ``random_variables``: weights N(0, 0.05^2), unit scales, zero biases)
    with non-trivial BatchNorm statistics: running means in [-0.5, 0.5],
    variances in [0.5, 2]."""
    import jax

    from animateportrait_tpu.utils.smoke import random_variables

    rng = np.random.default_rng(stats_seed)
    v = random_variables(init_fn, seed=seed)

    def fill(path, a):
        last = str(path[-1])
        if "var" in last and "batch_stats" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 2.0, a.shape).astype(a.dtype)
        if "mean" in last and "batch_stats" in jax.tree_util.keystr(path):
            return rng.uniform(-0.5, 0.5, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(fill, v)


def port_stats_match(net: torch.nn.Module, ref_sd: dict, rtol: float = 1e-4
                     ) -> None:
    """Every running statistic of ``net`` within ``rtol`` of the largest
    |value| of its reference leaf."""
    for k, t in net.state_dict().items():
        if "running" in k:
            r = ref_sd[k]
            assert maxdiff(t, r) <= rtol * float(r.abs().max()), k


def f64_run(net: torch.nn.Module, *inputs, train: bool | None = None):
    """``net`` (a float64 copy of it, in its mode or ``train``'s) on the
    float64 inputs: an exact-arithmetic stand-in for both packages' fp32
    sums."""
    import copy

    net64 = copy.deepcopy(net).double()
    if train is not None:
        net64.train(train)
    return net64(*(x.double() if torch.is_tensor(x) and x.is_floating_point()
                   else x for x in inputs))


def assert_as_exact_as_jax(got, ref, f64, bound: float) -> None:
    """``got`` within ``bound`` of the JAX package's ``ref``; or, where the
    two fp32 results scatter around the float64 one by more than that
    (BatchNorm on a few values per channel), ``got`` no farther from the
    float64 result than 3x JAX's own distance from it + bound / 10."""
    d = maxdiff(got, ref)
    if d <= bound:
        return
    mine, theirs = maxdiff(got, f64), maxdiff(ref, f64)
    assert mine <= 3 * theirs + bound / 10, (d, mine, theirs)


def jax_tool_run(name: str, steps: int, monkeypatch):
    """``tools/module1_convergence.py``'s run of ``name`` for ``steps``
    steps, with the initial variables its init functions drew captured
    and carried to the port's nets: (the tool's result, the port's
    ``weights`` for ``train/convergence.py``, the speaker run's
    ``z_of_step`` or None)."""
    import sys

    import jax

    from animateportrait_tpu_torch.io import from_jax

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    import module1_convergence as tool

    seen: dict = {}

    def capture(module, fn_name, key=None):
        fn = getattr(module, fn_name)

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen[key or fn_name] = (a, out)
            return out
        monkeypatch.setattr(module, fn_name, wrapped)

    if name in ("content", "speaker"):
        from animateportrait_tpu.train import module1 as m
        capture(m, "init_content_state" if name == "content"
                else "init_speaker_aware_state", "init")
    elif name == "flow":
        from animateportrait_tpu.train import flow_regression as m
        capture(m, "init_flow_state", "init")
    elif name == "imtrans":
        from animateportrait_tpu.train import image_translation as m
        capture(m, "init_image_translation_state", "init")
        capture(m, "build_image_translation_train_step", "build")
    elif name == "foa":
        from animateportrait_tpu.train import face_of_art as m
        capture(m, "init_foa_state", "init")
    elif name == "fan":
        from animateportrait_tpu.train import fan as m
        capture(m, "init_fan_state", "init")
    else:
        from animateportrait_tpu.train import pose_transfer as m
        capture(m, "init_pt_state", "init")
    run = {"content": tool.run_content, "speaker": tool.run_speaker_aware,
           "flow": tool.run_flow, "imtrans": tool.run_image_translation,
           "pose": tool.run_pose_transfer, "foa": tool.run_foa,
           "fan": tool.run_fan}[name]
    result = run(steps)
    state = seen["init"][1]
    z_of_step = None
    if name == "content":
        weights = {"content": from_jax.content_state_dict(state.variables)}
    elif name == "speaker":
        from animateportrait_tpu.models.audio2landmark import (
            Audio2landmarkSpeakerAware as J)
        weights = {"speaker": from_jax.speaker_aware_state_dict(
            {"params": state.params})}

        def z_of_step(i, params=state.params):
            k = J().apply({"params": params},
                          method=lambda mod: mod.make_rng("z_spk"),
                          rngs={"z_spk": jax.random.key(i)})
            return np.asarray(jax.random.normal(k, (140, 128)))
    elif name == "flow":
        weights = {"flow": from_jax.flowunet_state_dict(state.variables,
                                                        num_scale=3)}
    elif name == "foa":
        weights = {"foa": from_jax.artistic_heatmap_state_dict(
            {"params": state.params})}
    elif name == "fan":
        weights = {"fan": from_jax.fan_state_dict(state[0].variables,
                                                  num_modules=1)}
    elif name == "imtrans":
        weights = {"imtrans": from_jax.resunet_state_dict(state.variables),
                   "vgg": from_jax.vgg19_state_dict(seen["build"][0][1])}
    else:
        weights = {
            "pose_g": from_jax.dual_unet_state_dict(
                state.g, num_scales=3, num_warp_scales=2,
                vis_mode="residual"),
            "pose_d": from_jax.bn_patch_d_state_dict(state.d, n_layers=2),
            "pose_netf": from_jax.flowunet_state_dict(state.netf),
            "pose_vgg": from_jax.vgg19_state_dict(state.vgg)}
    return result, weights, z_of_step
