"""One run of one cell, driven by data: ``BENCHMARK.json`` names the cell,
the cell names its configuration file and its traffic mix, the mix names
its driver (``perfbench/drivers/<driver>.py``), and each per-layer metric
is a reader of its own (``perfbench/metrics/<metric>.py``, a function
``read(ctx)`` that returns a number or ``None`` when the trace holds
nothing for it to read).  A ``--trace 1`` run times the driver's
``traced_window`` once without the profiler (``ctx.untraced_s``, the wall
that shares of the wall are taken over, since the profiler slows the
host) and then profiles it once more (``ctx.trace``, ``ctx.window``); a
driver's ``SPANS`` names the program functions the profiled pass wraps in
layer spans.  A new cell, configuration, mix or metric is new
files and new entries; nothing here names one.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from types import SimpleNamespace

import torch

from perfbench.harness import trace as tracing

PERFBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(entry: dict, cell: str) -> bool:
    """A metric reports in a cell that its ``workloads`` list names, or in
    every cell when it has none."""
    return "workloads" not in entry or cell in entry["workloads"]


def reader(name: str):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = PERFBENCH / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(bench: dict, name: str) -> SimpleNamespace:
    """The cell ``name`` with its configuration, mix, driver module and
    the metrics it reports."""
    cell = find(bench["workloads"], name, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    config = load_json(ROOT / conf["file"])
    mix = load_json(PERFBENCH / "traffic" / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"perfbench.drivers.{mix['driver']}")
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if applies(m, name)]
    return SimpleNamespace(cell=cell, config=config, mix=mix, driver=driver,
                           e2e=e2e, per_layer=per_layer)


def loaded_forbidden() -> list[str]:
    """Modules of ``sys.modules`` whose top-level name (before the first
    dot, compared whole) is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _timed(step, device) -> float:
    """Host seconds of ``step()``, ending in a synchronise of ``device``."""
    t = time.perf_counter()
    step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, control=None) -> dict:
    """:func:`run_resolved` of the cell ``name`` of ``bench``."""
    return run_resolved(resolve(bench, name), seed, seconds, trace, device,
                        t_start, control)


def run_resolved(c: SimpleNamespace, seed: int, seconds: float, trace: bool,
                 device, t_start: float, control=None) -> dict:
    """Set up, measure (or trace), free the program's state, compare with
    the reference.  Returns the result line's fields; ``checks`` maps each
    number compared to (value, limit).  ``control``, where given, is passed
    to the driver's ``check`` in the program's place (the driver's
    ``CONTROL``: the reference in the next lower precision)."""
    device = torch.device(device)
    run = c.driver.Run(c.config, c.mix, seed, device)
    stages = {"start_s": time.perf_counter() - t_start}
    if device.type == "cuda":
        t = time.perf_counter()
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
        stages["cuda_init_s"] = time.perf_counter() - t
    run.setup()
    setup_s = time.perf_counter() - t_start
    print("perfbench: set-up " + ", ".join(
        f"{k} {v:.3f}" for k, v in {"setup_s": setup_s, **stages,
                                    **run.stages}.items()),
          file=sys.stderr, flush=True)
    if trace:
        untraced_s = _timed(run.traced_window, device)
        with tracing.traced(getattr(c.driver, "SPANS", {}), device) as box:
            win = run.traced_window()
        ctx = SimpleNamespace(trace=box["trace"], window=win,
                              untraced_s=untraced_s, config=c.config,
                              mix=c.mix, cell=c.cell)
        metrics = {}
        for m in c.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        win = run.window(seconds)
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in c.e2e:
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": float(win["e2e"][m["name"]]),
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(c.cell["chips"]),
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    out = {"attempted": win["attempted"], "failed": win["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        t = box["trace"]
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        out["breakdown"] = {"device_ops": t.device_ops,
                            "idle_gaps": t.idle_gaps}
    run.release()
    gc.collect()
    t = time.perf_counter()
    checks = run.check() if control is None else run.check(control)
    print(f"perfbench: check {time.perf_counter() - t:.3f} s",
          file=sys.stderr, flush=True)
    out["correct"] = (win["failed"] == 0
                      and all(v <= lim for v, lim in checks.values()))
    out["checks"] = checks
    return out
