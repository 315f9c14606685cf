"""What a run loads: no module whose top-level name, compared whole, is
jax, jaxlib, flax or animateportrait_tpu (the port's own
``animateportrait_tpu_torch`` passes); and the plain reference loads
nothing of the port."""
import json
import subprocess
import sys

from portbench.tests.helpers import REPO

RUN_MODULES = """
import portbench.harness, portbench.profiling, portbench.calibrate
import portbench.drivers.clips, portbench.drivers.train_step
import portbench.counts.flops, portbench.reference.drawing
import portbench.reference.train
import animateportrait_tpu_torch.cli
import animateportrait_tpu_torch.pipeline.audio
import animateportrait_tpu_torch.utils.image
import animateportrait_tpu_torch.utils.video
import animateportrait_tpu_torch.train.module2
from portbench.harness import forbidden_modules
print(json.dumps([forbidden_modules(),
                  "animateportrait_tpu_torch" in sys.modules]))
"""

REFERENCE_MODULES = """
import portbench.counts.flops, portbench.inputs
import portbench.reference.frozen.pipeline.end2end
import portbench.reference.frozen.train.module2
import portbench.reference.frozen.utils.image
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules}
                        & {"animateportrait_tpu_torch",
                           "animateportrait_tpu", "jax", "flax"})))
"""


def _run(code: str):
    p = subprocess.run([sys.executable, "-c",
                        "import json, sys\n" + code], cwd=REPO,
                       capture_output=True, text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": REPO})
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    bad, port = _run(RUN_MODULES)
    assert bad == [] and port is True


def test_the_reference_loads_nothing_of_the_port():
    assert _run(REFERENCE_MODULES) == []


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "animateportrait_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "animateportrait_tpu.ops", sys)
    assert harness.forbidden_modules() == ["animateportrait_tpu.ops"]
