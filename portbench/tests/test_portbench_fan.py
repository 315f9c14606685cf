"""The ``fan_awing_train`` configuration on the CPU at its published widths
narrowed by size and batch (4 stacks of 256 features, 98 landmarks,
128^2, batch 2): the port's ``FANTrainer`` against the plain reference
over three seeded steps; a run of a small copy of the cell through the
harness (256^2, batch 2), sound and with each planted fault; the frozen target builder
against the port's; the 98-point face; the configuration file; the FLOP
count; and the two readers of the cell's own per-layer metrics on
hand-built records.

At 64^2 the hourglasses' innermost level is 1 x 1, where each
BatchNorm normalizes two values a channel at batch 2: the first
gradients reach 1e7 and Adam's steps turn rounding into differences of
percent, in float64 as in float32. At 128^2 that level holds eight values
a channel and the gradients are of order 1."""
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from portbench import fan_faults, faults, harness, program_spans
from portbench.counts import fan_flops
from portbench.drivers.fan_step import build_port
from portbench.reference import fan as ref_fan
from portbench.reference.pose import _stats_gaps
from portbench.tests import helpers

CONFIG = os.path.join(helpers.REPO, "portbench", "configs",
                      "fan_awing_train.json")
SMALL = dict(size=128, batch_size=2)
# the harness's runs compare by the cell's own limits, set at batch 16:
# at 128^2 the worst leaf's change reads 6.6e-3 against 2.2e-3 (eight
# values a channel at the innermost level), at 256^2 1.2e-3
HARNESS = dict(size=256, batch_size=2)


def config(**sizes) -> dict:
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg.update(sizes)
    return cfg


@pytest.fixture(scope="module")
def three_steps():
    """(config, the port's trainer, the reference step, the first
    gradients of each, the records of the two steps after)."""
    helpers.few_threads()
    cfg = config(**SMALL)
    batches = ref_fan.make_batches(cfg, helpers.SEED, 3, "cpu")
    weights = ref_fan.make_weights(cfg, helpers.SEED, "cpu")
    port = build_port(cfg, weights, "cpu")
    net = ref_fan.make_net(cfg, "cpu")
    net.load_state_dict(weights)
    ref = ref_fan.FANStep(cfg, net)
    grads = []
    for trainer in (port, ref):
        trainer.step(*ref_fan.batch_args(batches[0]))
        grads.append({k: p.grad.clone() for k, p in
                      trainer.model.named_parameters()})
    got = ref_fan.run_steps(port, port.model, batches[1:], 2)
    want = ref_fan.run_steps(ref, ref.model, batches[1:], 2)
    return cfg, port, ref, grads, got, want


def test_losses_match(three_steps):
    """The same ops in the same order up to the loss (the reference
    writes out BatchNorm and Adam): the first step's loss within 1e-6,
    the later ones, after Adam's updates, within 1e-4."""
    cfg = config(**SMALL)
    batches = ref_fan.make_batches(cfg, helpers.SEED + 1, 3, "cpu")
    weights = ref_fan.make_weights(cfg, helpers.SEED + 1, "cpu")
    port = build_port(cfg, weights, "cpu")
    got = ref_fan.run_steps(port, port.model, batches, 3)
    want = ref_fan.reference_steps(cfg, helpers.SEED + 1, batches, "cpu")
    for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        assert a.keys() == b.keys() == set(ref_fan.LOSSES)
        assert a["loss"] == pytest.approx(b["loss"],
                                          rel=1e-6 if i == 0 else 1e-4), i


def test_first_gradients_match_leaf_by_leaf(three_steps):
    """Each leaf's whole first gradient within 1e-5 of max(its norm, the
    median leaf's): no Adam update has yet turned rounding into steps.
    The biases that a BatchNorm cancels (the CoordConvs', ``bl``'s,
    ``al``'s) have gradients of rounding alone, under 1% of the median
    leaf's; theirs within 2e-4 of the median's (the stem's, whose
    BatchNorm sums 8192 values a channel, reads 1.0e-4)."""
    _, _, _, (got, want), _, _ = three_steps
    assert got.keys() == want.keys()
    scale = sorted(float(g.norm()) for g in want.values())[len(want) // 2]
    for k in want:
        gap = float((got[k] - want[k]).norm())
        norm = float(want[k].norm())
        tol = 1e-5 if norm >= 0.01 * scale else 2e-4
        assert gap <= tol * max(norm, scale), k


def test_statistics_and_parameters_match_after_three_steps(three_steps):
    """The 184 BatchNorms' statistics (update counts exact) within 1e-3
    of their scale, the median within 1e-5: a cancelled bias moves by
    about lr a step in the direction its rounding gives, and the running
    mean of the BatchNorm after it follows it by the momentum (the
    worst, ``bn_end``'s and the hourglasses' first ``bn1``'s, read up to
    1.8e-4). Parameters: Adam
    moves an element by about lr a step whatever its gradient's size, so
    no element further apart than 6 lr (three steps of 2 lr), and the
    median leaf's change within 1e-3, the worst (cancelled biases left
    out) within 0.05 of its scale."""
    cfg, port, ref, _, got, want = three_steps
    stats = ref_fan.running_stats(port.model)
    assert len([k for k in stats if k.endswith("running_mean")]) == 184
    gaps = _stats_gaps(got["stats"], want["stats"])
    assert max(gaps) <= 1e-3 and float(np.median(gaps)) <= 1e-5
    pp = dict(port.model.named_parameters())
    rp = dict(ref.model.named_parameters())
    assert pp.keys() == rp.keys()
    worst = max(float((pp[k] - rp[k]).detach().abs().max()) for k in rp)
    assert worst <= 6 * cfg["lr"]
    nums = ref_fan.compare(got, want)
    assert nums["change3_median_gap"] <= 1e-3
    assert nums["change3_gap"] <= 0.05


def test_the_frozen_targets_are_the_ports():
    """``fan_targets`` is a copy of the port's ``make_fan_targets``: the
    same maps and weights, bit for bit, on the benchmark's faces."""
    from animateportrait_tpu_torch.train.fan import make_fan_targets
    from portbench.reference.frozen.models.fan import fan_targets

    rng = np.random.default_rng(helpers.SEED % 2 ** 32)
    for _ in range(3):
        lm = ref_fan.face_landmarks98(rng, 256)
        got, want = fan_targets(lm), make_fan_targets(lm)
        for a, b in zip(got, want):
            assert a.shape == b.shape == (99, 64, 64)
            assert np.array_equal(a, b)
        assert got[0][98].max() == 1.0      # the boundary map is drawn


def test_the_98_point_face_has_wflws_groups():
    """WFLW's layout: a 33-point contour from one side to the other past
    the chin; brows above the eyes, each a 5-point upper edge and 4 points
    under it; the nose bridge and base; each eye's upper lid above its
    lower one between shared corners, its pupil inside; the outer lips
    around the inner ones; the left parts on the left. Each curve of the
    boundary groups is drawn without a zero-length step."""
    from portbench.reference.frozen.models.fan import BOUNDARY_GROUPS_98

    p = ref_fan.face98()
    x, y = p[:, 0], p[:, 1]
    assert p.shape == (98, 2)
    contour = p[0:33]
    assert np.all(np.diff(x[0:33]) > 0)
    assert np.argmax(contour[:, 1]) == 16
    for brow, eye in ((range(33, 42), range(60, 68)),
                      (range(42, 51), range(68, 76))):
        brow, eye = list(brow), list(eye)
        assert y[brow].max() < y[eye].min()
        upper, lower = brow[:5], brow[5:]
        above = [upper[int(np.argmin(abs(x[upper] - x[j])))] for j in lower]
        assert np.all(y[lower] > y[above])
        assert np.all(np.diff(x[upper]) > 0) and np.all(np.diff(x[lower]) < 0)
        up, low = eye[:5], [eye[4]] + eye[5:] + [eye[0]]
        assert np.all(y[up[1:4]] < y[low[1:4][::-1]])
    for pupil, eye in ((96, range(60, 68)), (97, range(68, 76))):
        e = p[list(eye)]
        assert e[:, 0].min() < x[pupil] < e[:, 0].max()
        assert e[:, 1].min() < y[pupil] < e[:, 1].max()
    assert x[60:68].max() < x[68:76].min() and x[33:42].max() < x[42:51].min()
    assert np.all(np.diff(y[51:55]) > 0) and y[54] < y[55:60].min() + 0.1
    assert y[55:60].max() < y[76:96].min()
    assert x[76:88].min() < x[88:96].min() and x[88:96].max() < x[76:88].max()
    for name, inds in BOUNDARY_GROUPS_98.items():
        steps = np.linalg.norm(np.diff(p[inds], axis=0), axis=1)
        assert steps.min() > 0, name
    # a batch's faces lie inside the image
    rng = np.random.default_rng(5)
    faces = np.stack([ref_fan.face_landmarks98(rng, 256) for _ in range(64)])
    assert faces.min() > 8 and faces.max() < 248


def tiny_fan_cell(root: str) -> str:
    """A small copy of ``fan.step`` in the copy of the benchmark at
    ``root``, reporting what ``fan.step`` reports."""
    cfg = config(**HARNESS)
    with open(os.path.join(root, "portbench", "configs",
                           "fan_tiny.json"), "w") as f:
        json.dump(cfg, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "fan_tiny", "source": "https://example.org/tiny",
        "file": "portbench/configs/fan_tiny.json", "reduced": [],
        "why": "a small copy for CPU tests"})
    bench["workloads"].append({"name": "tiny.fan", "config": "fan_tiny",
                               "traffic": "steps", "chips": 1,
                               "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "fan.step" in m.get("workloads", []):
            m["workloads"].append("tiny.fan")
    with open(path, "w") as f:
        json.dump(bench, f)
    return "tiny.fan"


@pytest.fixture()
def root(tmp_path):
    helpers.few_threads()
    return helpers.copy_benchmark(str(tmp_path))


def run(root, name, trace=False):
    return harness.run_cell(harness.load_cell(name, root), helpers.SEED,
                            0.5, trace, device="cpu",
                            say=lambda *a, **k: None)


def test_a_sound_run_is_correct_and_reads_its_layers(root):
    r = run(root, tiny_fan_cell(root), trace=True)
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == set(config()["limits"])
    # no device kernels on the CPU: the non-convolution time finds nothing
    assert set(r["metrics"]) == {"mfu.train", "idle_share.train",
                                 "host_ms_per_step.fan"}
    assert 0 < r["metrics"]["mfu.train"]["value"] < 100
    steps = r["attempted"]
    assert 0 < r["metrics"]["host_ms_per_step.fan"]["value"] \
        <= 1e3 * r["device"]["window_s"] / steps


@pytest.mark.parametrize("fault", sorted(fan_faults.FAULTS))
def test_a_planted_fault_is_not_correct(root, monkeypatch, fault):
    name = tiny_fan_cell(root)
    monkeypatch.setitem(faults.FAULTS, fault, fan_faults.FAULTS[fault])
    with faults.planted(fault):
        r = run(root, name)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def helpers_bench() -> dict:
    with open(os.path.join(helpers.REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_config_states_its_source_cut_and_limits():
    cfg = config()
    bench = helpers_bench()
    entry = {c["name"]: c for c in bench["configs"]}["fan_awing_train"]
    cell = {w["name"]: w for w in bench["workloads"]}["fan.step"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "fan_awing_train", "steps", 1)
    assert entry["file"] == "portbench/configs/fan_awing_train.json"
    assert cfg["source"] == entry["source"]
    assert cfg["source"].startswith(
        "https://github.com/protossw512/AdaptiveWingLoss")
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["driver"] == "fan_step" and cfg["deployment"]
    assert (cfg["num_modules"], cfg["hg_depth"], cfg["features"],
            cfg["num_landmarks"], cfg["size"], cfg["batch_size"]) == (
        4, 4, 256, 98, 256, 16)
    for k in ("batch_size 16", "Adam", "seeded weights", "resident faces",
              "fp32 with TF32 off"):
        assert any(a.startswith(k) for a in cfg["assumed"]), k
    assert set(cfg["limits"]) == {"loss_gap", "grad1_gap",
                                  "grad1_median_gap", "change3_gap",
                                  "stats_gap", "stats_median_gap"}
    assert all(0 < v < 1 for v in cfg["limits"].values())
    assert (cfg["dtype"], cfg["tf32"]) == ("float32", False)
    ref_fan.check_config(cfg)
    with pytest.raises(ValueError):
        ref_fan.check_config(dict(cfg, features=128))


def _modules_after(code: str) -> list:
    import subprocess
    import sys

    p = subprocess.run(
        [sys.executable, "-c", "import json, sys\n" + code
         + "\nprint(json.dumps(sorted({m.split('.')[0] for m in "
         "sys.modules} & {'animateportrait_tpu_torch', "
         "'animateportrait_tpu', 'jax', 'flax'})))"],
        cwd=helpers.REPO, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": helpers.REPO})
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_port_and_a_run_no_jax():
    assert _modules_after(
        "import portbench.reference.fan, portbench.counts.fan_flops\n"
        "import portbench.reference.frozen.models.fan") == []
    assert _modules_after(
        "import portbench.drivers.fan_step, portbench.fan_faults\n"
        "import portbench.harness\n"
        "import animateportrait_tpu_torch.train.fan") == [
        "animateportrait_tpu_torch"]


def test_the_reference_step_sets_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        cfg = config(size=128, batch_size=1)
        batches = ref_fan.make_batches(cfg, helpers.SEED, 1, "cpu")
        ref_fan.reference_steps(cfg, helpers.SEED, batches, "cpu", n=1)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def test_the_flop_count():
    """53.4 GFLOP a 256^2 image forward; a step, forward and backward,
    about three times that, and linear in the batch."""
    cfg = config()
    one = fan_flops.step_work(dict(cfg, batch_size=1))
    fan_flops._step_work.cache_clear()
    again = fan_flops.step_work(dict(cfg, batch_size=1))
    two = fan_flops.step_work(dict(cfg, batch_size=2))
    assert one == again
    assert two["step_flops"] == 2 * one["step_flops"]
    assert one["forward_flops"] == pytest.approx(53.4e9, rel=1e-3)
    assert one["step_flops"] == pytest.approx(159.6e9, rel=1e-3)


def reader(name: str):
    path = os.path.join(helpers.REPO, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


MS = 1_000_000
# two steps of 40 and 60 ms, each with a phase inside; a step still open
RECORD = [("fan.step", 0, None, 0, 40 * MS),
          ("fan.forward", 0, 0, MS, 2 * MS),
          ("fan.step", 1, None, 50 * MS, 110 * MS),
          ("fan.step", 2, None, 120 * MS, None)]


@pytest.mark.parametrize("record, steps, want", [
    ((RECORD, {}), 2, 50.0),
    (([("pt.step", 0, None, 0, MS)], {}), 2, None),   # another cell's
    (None, 2, None),                                  # no record
    ((RECORD, {}), 0, None),
], ids=["steps", "other_spans", "no_record", "no_steps"])
def test_host_ms_per_step_reads_the_step_spans(monkeypatch, record, steps,
                                               want):
    monkeypatch.setattr(program_spans, "record", lambda: record)
    got = reader("host_ms_per_step.fan")({"steps": steps})
    assert got == (None if want is None else pytest.approx(want))


KERNELS = {
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw": 7.0,
    "void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>":
        3.0,
    "void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>": 2.0,
    "void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3>": 1.0,
    "void DSE::regular_fft_pad<0, 1, 256, 16, 16, 1, float>": 0.5,
    "sm90_xmma_gemm_f32f32_tf32f32_f32_nt_n": 0.25,
    "void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*)":
        1.5,
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float, float>": 0.3,
    "void flip_filter<float, float>(float*, float const*, int)": 0.2,
    "void at::native::batch_norm_collect_statistics_kernel<float>": 0.4,
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::CUDAFunctor_add<float>>": 0.6,
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>":
        0.2,
    "Memcpy HtoD (Pageable -> Device)": 0.1,
    "Memset (Device)": 0.1}


@pytest.mark.parametrize("run, want", [
    ({"steps": 40, "trace": {"kernel_s": KERNELS}}, 30.0),
    ({"steps": 40, "trace": {"kernel_s": {
        k: v for k, v in KERNELS.items()
        if "native" not in k}}}, None),                  # convs alone
    ({"steps": 40, "trace": {"kernel_s": {}}}, None),   # a CPU trace
    ({"steps": 40}, None),                               # untraced
    ({"steps": 0, "trace": {"kernel_s": KERNELS}}, None),
], ids=["kernels", "convs_only", "no_kernels", "no_trace", "no_steps"])
def test_nonconv_ms_per_step_reads_the_other_kernels(run, want):
    got = reader("nonconv_ms_per_step.fan")(run)
    assert got == (None if want is None else pytest.approx(want))
    assert want is None or math.isfinite(got)
