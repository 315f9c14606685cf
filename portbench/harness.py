"""One run of one cell: set-up, a measured window, the per-layer readers
of a traced run, the comparison with the plain reference, and the result
line.

A cell is found by name: its entry in ``BENCHMARK.json`` names a
configuration and a traffic mix; the configuration's file
(``configs/<config>.json``) names its driver (``drivers/<driver>.py``),
the traffic mix is ``traffic/<traffic>.json``, and each per-layer metric
is read by ``metrics/<metric>.py``. A new cell, mix or metric is new
files and new entries; no file here changes."""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "animateportrait_tpu_torch"
# what no process that prints a result may hold, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "animateportrait_tpu")
# torch's host threads in a run (``run.py`` sets the BLAS libraries' too)
HOST_THREADS = 4


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic
    mix and metrics."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: str


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(os.path.join(root, conf["file"]))
    traffic = _load_json(os.path.join(root, "portbench", "traffic",
                                      f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in names
                                  else [])]
    return Cell(name, w, config, traffic, e2e, per_layer, root)


def driver_for(cell: Cell):
    return importlib.import_module(
        f"portbench.drivers.{cell.config['driver']}")


def read_metric(cell: Cell, name: str, run: dict):
    """The per-layer metric ``name`` of a traced run, by its reader
    ``metrics/<name>.py``, or None where the reader finds nothing."""
    path = os.path.join(cell.root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _program_importable(root: str) -> bool:
    """The port is there, and is the checkout's own."""
    if not os.path.isdir(os.path.join(root, PROGRAM)):
        return False
    mod = importlib.import_module(PROGRAM)
    return os.path.abspath(mod.__file__).startswith(
        os.path.join(os.path.abspath(root), ""))


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernels build under ``build/torch_kernels``)."""
    base = os.path.join(root, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device=None, control: bool = False, say=print) -> dict:
    """One run: set-up, the window, the readers, the comparison. Returns
    the result line's object, with the compared numbers under
    ``checks`` and every number the driver computed under
    ``_numbers``. ``control``: the plain reference, in the precision below
    the configuration's, takes the program's place."""
    import torch

    device = torch.device(device or "cuda")
    drv = driver_for(cell).Driver(cell, seed, device, control=control)
    try:
        return _run(cell, drv, device, seconds, trace, say)
    finally:
        drv.close()


def _run(cell: Cell, drv, device, seconds: float, trace: bool,
         say) -> dict:
    import torch

    from portbench import profiling

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    drv.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = profiling.Tracer(cuda) if trace else None
    win = drv.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu",
                   "count": cell.workload["chips"],
                   "memory_peak_bytes": int(max(peak, setup_peak))}
    values = dict(drv.end_to_end(win), setup_s=setup_s)
    metrics, breakdown = {}, None
    if trace:
        summary = tracer.summary()
        tracer = None
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
        run = dict(drv.records(win), trace=summary, peak_bytes=peak,
                   config=cell.config, traffic=cell.traffic)
        for m in cell.per_layer:
            v = read_metric(cell, m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    numbers = drv.check(win)
    say(f"[portbench] reference check {time.perf_counter() - t1:.1f} s",
        file=sys.stderr)
    limits = cell.config["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = (win["attempted"] > 0 and win["failed"] == 0
          and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()))
    result = {"correct": ok, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["_numbers"] = numbers
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not _program_importable(ROOT):
        print(f"[portbench] {PROGRAM} is not in the checkout {ROOT}",
              file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.workload["chips"]):
        print(f"[portbench] {args.workload} needs "
              f"{cell.workload['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    set_cache_dirs(ROOT)
    torch.set_num_threads(HOST_THREADS)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    del result["_numbers"]
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] the process holds forbidden modules: {bad}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"[portbench] check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
