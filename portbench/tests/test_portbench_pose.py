"""The ``pose_transfer_train`` configuration on the CPU at the convergence
tool's small widths (G_nf 8, max 32, 3 scales, 2 warp scales, 6 joints,
32^2, D nf 8 and 2 layers, batch 2): the port's ``PoseTransferTrainer``
against the plain reference over three seeded steps; a run of a small
copy of the cell through the harness, sound and with each planted fault;
the configuration file; the FLOP count; and the two readers of the cell's
own per-layer metrics on hand-built records."""
import importlib.util
import json
import math
import os

import pytest

from portbench import faults, harness, pose_faults, program_spans
from portbench.counts import pose_flops
from portbench.drivers.pose_step import build_port
from portbench.reference import pose as ref_pose
from portbench.tests import helpers

CONFIG = os.path.join(helpers.REPO, "portbench", "configs",
                      "pose_transfer_train.json")
SMALL = dict(G_nf=8, G_max_nf=32, G_n_scale=3, G_n_warp_scale=2,
             joint_nc=6, size=32, D_nf=8, D_n_layers=2, batch_size=2)


def config(**sizes) -> dict:
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg.update(sizes)
    return cfg


@pytest.fixture(scope="module")
def three_steps():
    """(config, the port's nets and record, the reference's nets and
    record) after three steps from one seed's weights and batches."""
    helpers.few_threads()
    cfg = config(**SMALL)
    batches = ref_pose.make_batches(cfg, helpers.SEED, 3, "cpu")
    weights = ref_pose.make_weights(cfg, helpers.SEED, "cpu")
    port = build_port(cfg, weights, "cpu")
    nets = ref_pose.load(ref_pose.make_nets(cfg, "cpu"), weights)
    ref = ref_pose.PoseStep(cfg, nets)
    grads = []
    for trainer in (port, ref):
        trainer.step(batches[0])
        grads.append({k: p.grad.clone() for k, p in
                      ref_pose.named_leaves(trainer.g, trainer.d).items()})
    got = ref_pose.run_steps(port, port.g, port.d, batches[1:], 2)
    want = ref_pose.run_steps(ref, ref.g, ref.d, batches[1:], 2)
    return cfg, port, ref, grads, got, want


def test_losses_match(three_steps):
    """Rounding alone, in the same ops in the same order (the reference
    writes out the eval-mode BatchNorm and Adam): the first step's losses
    within 1e-6 of each other, the later ones, after Adam's updates, within
    1e-4."""
    cfg = config(**SMALL)
    batches = ref_pose.make_batches(cfg, helpers.SEED + 1, 3, "cpu")
    weights = ref_pose.make_weights(cfg, helpers.SEED + 1, "cpu")
    port = build_port(cfg, weights, "cpu")
    got = ref_pose.run_steps(port, port.g, port.d, batches, 3)
    want = ref_pose.reference_steps(cfg, helpers.SEED + 1, batches, "cpu")
    for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        assert a.keys() == b.keys() == set(ref_pose.LOSSES)
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-6 if i == 0 else 1e-4,
                                         abs=1e-7), (i, k)


def test_first_gradients_match_leaf_by_leaf(three_steps):
    """Each leaf's whole first gradient within 1e-5 of max(its norm, the
    median leaf's): no Adam update has yet turned rounding into steps."""
    _, _, _, (got, want), _, _ = three_steps
    assert got.keys() == want.keys()
    scale = sorted(float(g.norm()) for g in want.values())[len(want) // 2]
    for k in want:
        gap = float((got[k] - want[k]).norm())
        assert gap <= 1e-5 * max(float(want[k].norm()), scale), k


def test_statistics_and_parameters_match_after_three_steps(three_steps):
    """BatchNorm statistics (G's and D's, update counts exact) within 1e-5
    of their scale. Parameters: Adam moves an element by about lr a step
    whatever its gradient's size, so an element whose gradient rounding
    turns over moves the other way: no element further apart than 6 lr
    (three steps of 2 lr), and the median leaf's change within 1e-3, the
    worst within 0.05 of its scale (the small cell reads up to 0.013)."""
    cfg, port, ref, _, got, want = three_steps
    assert max(ref_pose._stats_gaps(got["stats"], want["stats"])) <= 1e-5
    pp = ref_pose.named_leaves(port.g, port.d)
    rp = ref_pose.named_leaves(ref.g, ref.d)
    assert pp.keys() == rp.keys()
    worst = max(float((pp[k] - rp[k]).detach().abs().max())
                for k in rp)
    assert worst <= 6 * cfg["lr"]
    nums = ref_pose.compare(got, want)
    assert nums["change3_median_gap"] <= 1e-3
    assert nums["change3_gap"] <= 0.05


def tiny_pose_cell(root: str) -> str:
    """A small copy of ``pose.step`` in the copy of the benchmark at
    ``root``, reporting what ``pose.step`` reports."""
    cfg = config(**SMALL)
    with open(os.path.join(root, "portbench", "configs",
                           "pose_tiny.json"), "w") as f:
        json.dump(cfg, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "pose_tiny", "source": "https://example.org/tiny",
        "file": "portbench/configs/pose_tiny.json", "reduced": [],
        "why": "a small copy for CPU tests"})
    bench["workloads"].append({"name": "tiny.pose", "config": "pose_tiny",
                               "traffic": "steps", "chips": 1,
                               "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "pose.step" in m.get("workloads", []):
            m["workloads"].append("tiny.pose")
    with open(path, "w") as f:
        json.dump(bench, f)
    return "tiny.pose"


@pytest.fixture()
def root(tmp_path):
    helpers.few_threads()
    return helpers.copy_benchmark(str(tmp_path))


def run(root, name, trace=False):
    return harness.run_cell(harness.load_cell(name, root), helpers.SEED,
                            0.5, trace, device="cpu",
                            say=lambda *a, **k: None)


def test_a_sound_run_is_correct_and_reads_its_layers(root):
    r = run(root, tiny_pose_cell(root), trace=True)
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == set(config()["limits"])
    # no device kernels on the CPU: the warps' device time finds nothing
    assert set(r["metrics"]) == {"mfu.train", "idle_share.train",
                                 "host_ms_per_step.pose"}
    assert 0 < r["metrics"]["mfu.train"]["value"] < 100
    steps = r["attempted"]
    assert 0 < r["metrics"]["host_ms_per_step.pose"]["value"] \
        <= 1e3 * r["device"]["window_s"] / steps


@pytest.mark.parametrize("fault", sorted(pose_faults.FAULTS))
def test_a_planted_fault_is_not_correct(root, monkeypatch, fault):
    name = tiny_pose_cell(root)
    monkeypatch.setitem(faults.FAULTS, fault, pose_faults.FAULTS[fault])
    with faults.planted(fault):
        r = run(root, name)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_config_states_its_source_cut_and_limits():
    cfg = config()
    bench = {c["name"]: c for c in helpers_bench()["configs"]}
    entry = bench["pose_transfer_train"]
    assert entry["file"] == "portbench/configs/pose_transfer_train.json"
    assert cfg["source"] == entry["source"]
    assert cfg["source"].startswith("https://github.com/ly015/intrinsic_flow")
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["driver"] == "pose_step" and cfg["deployment"]
    assert len(cfg["assumed"]) >= 4
    assert any(a.startswith("size 256") for a in cfg["assumed"])
    assert any(a.startswith("batch_size 8") for a in cfg["assumed"])
    assert set(cfg["limits"]) == {"loss_gap", "grad1_gap",
                                  "grad1_median_gap", "change3_gap",
                                  "stats_median_gap"}
    assert all(0 < v < 1 for v in cfg["limits"].values())
    assert set(ref_pose.TRAINER_KEYS) <= set(cfg)
    assert cfg["size"] % 2 ** cfg["G_n_scale"] == 0
    assert (cfg["dtype"], cfg["tf32"]) == ("float32", False)
    ref_pose.check_config(cfg)


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
        "import portbench.reference.pose, portbench.counts.pose_flops\n"
        "import portbench.reference.frozen.models.pose") == []
    assert _modules_after(
        "import portbench.drivers.pose_step, portbench.pose_faults\n"
        "import portbench.harness\n"
        "import animateportrait_tpu_torch.train.pose_transfer") == [
        "animateportrait_tpu_torch"]


def helpers_bench() -> dict:
    with open(os.path.join(helpers.REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_flop_count_repeats_and_scales_with_the_batch():
    cfg = config()
    one = pose_flops.step_work(dict(cfg, batch_size=1))["step_flops"]
    pose_flops._step_work.cache_clear()
    again = pose_flops.step_work(dict(cfg, batch_size=1))["step_flops"]
    two = pose_flops.step_work(dict(cfg, batch_size=2))["step_flops"]
    assert one == again and two == 2 * one
    # VGG19 on 256^2 (~50 GFLOP a pass) sets the scale: ~386 GFLOP a pair
    assert 3.5e11 < one < 4.2e11


def reader(name: str):
    path = os.path.join(helpers.REPO, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


MS = 1_000_000
# two steps of 40 and 60 ms, each with a phase inside; a step still open
RECORD = [("pt.step", 0, None, 0, 40 * MS), ("pt.g_grad", 0, 0, MS, 2 * MS),
          ("pt.step", 1, None, 50 * MS, 110 * MS),
          ("pt.step", 2, None, 120 * MS, None)]


@pytest.mark.parametrize("record, steps, want", [
    ((RECORD, {"pt.feature_warps": 22}), 2, 50.0),
    (([("m2.step", 0, None, 0, MS)], {}), 2, None),   # another cell's
    (None, 2, None),                                  # no record
    ((RECORD, {}), 0, None),
], ids=["steps", "other_spans", "no_record", "no_steps"])
def test_host_ms_per_step_reads_the_step_spans(monkeypatch, record, steps,
                                               want):
    monkeypatch.setattr(program_spans, "record", lambda: record)
    got = reader("host_ms_per_step.pose")({"steps": steps})
    assert got == (None if want is None else pytest.approx(want))


KERNELS = {
    "void at::native::(anonymous namespace)::grid_sampler_2d_kernel<float, "
    "int>(int, at::cuda::detail::TensorInfo<float, int>)": 0.3,
    "void at::native::(anonymous namespace)::grid_sampler_2d_backward_kernel"
    "<float, int>(int, at::cuda::detail::TensorInfo<float, int>)": 0.9,
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw": 7.0,
    "Memcpy HtoD (Pageable -> Device)": 0.1}


@pytest.mark.parametrize("run, want", [
    ({"steps": 40, "trace": {"kernel_s": KERNELS}}, 30.0),
    ({"steps": 40, "trace": {"kernel_s": {
        k: v for k, v in KERNELS.items() if "grid" not in k}}}, None),
    ({"steps": 40, "trace": {"kernel_s": {}}}, None),   # a CPU trace
    ({"steps": 40}, None),                               # untraced
    ({"steps": 0, "trace": {"kernel_s": KERNELS}}, None),
], ids=["warps", "no_warp_kernel", "no_kernels", "no_trace", "no_steps"])
def test_warp_ms_per_step_reads_the_grid_sample_kernels(run, want):
    got = reader("warp_ms_per_step.pose")(run)
    assert got == (None if want is None else pytest.approx(want))
    assert want is None or math.isfinite(got)
