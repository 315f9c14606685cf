"""Whole runs on the CPU at small widths, the harness's look for a card
skipped: an added traffic file becomes a runnable cell, a traced run
reads its layers, and a timed path broken underneath comes out not
correct, once for each fault a cell can have."""
import pytest

from portbench import faults, harness
from portbench.tests import helpers


@pytest.fixture()
def root(tmp_path):
    helpers.few_threads()
    return helpers.copy_benchmark(str(tmp_path))


def run(root, name, trace=False, seconds=0.5):
    return harness.run_cell(harness.load_cell(name, root), helpers.SEED,
                            seconds, trace, device="cpu",
                            say=lambda *a, **k: None)


def test_an_added_traffic_file_is_a_runnable_cell(root):
    name = helpers.tiny_train_cell(root)
    r = run(root, name)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert r["metrics"]["train_steps_per_s"]["value"] > 0
    assert set(r.pop("_numbers")) >= set(r["checks"])
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"loss_gap", "grad1_gap", "change3_gap",
                                "grad1_median_gap"}


def test_a_traced_run_reads_the_layers(root):
    name = helpers.tiny_train_cell(root)
    r = run(root, name, trace=True)
    assert {"mfu.train", "peak_gib.train"} - set(r["metrics"]) == {
        "peak_gib.train"}   # no device memory on the CPU
    assert 0 < r["metrics"]["mfu.train"]["value"] < 100
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault, sizes", [
    ("unchanged", {}),
    # the cell's batch of 1 cannot lose half of itself: a batch of 2 can
    ("half_batch", {"batch_size": 2, "batch_d_passes": True})])
def test_a_broken_step_is_not_correct(root, fault, sizes):
    name = helpers.tiny_train_cell(root, **sizes)
    with faults.planted(fault):
        assert run(root, name)["correct"] is False


def test_a_sound_drawing_run_is_correct(root):
    r = run(root, helpers.tiny_drawing_cell(root), trace=True)
    assert r["correct"] is True, r["checks"]
    assert {"io_ms_per_clip", "front_ms_per_clip", "render_ms_per_frame",
            "mfu.infer"} <= set(r["metrics"])


@pytest.mark.parametrize("fault", ["frame_altered", "landmarks_altered"])
def test_an_altered_answer_is_not_correct(root, fault):
    name = helpers.tiny_drawing_cell(root)
    with faults.planted(fault):
        assert run(root, name)["correct"] is False


def test_no_card_means_no_result(tmp_path):
    """run.py in a copy that holds only BENCHMARK.json and portbench/:
    no result, a non-zero exit."""
    import subprocess
    import sys

    root = helpers.copy_benchmark(str(tmp_path))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "drawing.clips", "--seed", "1", "--seconds", "1"],
                       cwd=root, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""
