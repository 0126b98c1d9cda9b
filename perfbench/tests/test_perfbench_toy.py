"""A toy cell, configuration, traffic mix and metric added to a copy of
the benchmark as new files and new entries only is found and run by the
harness; the command refuses to run without a card or without the port."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from perfbench.tests import toy

RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import torch
torch.set_num_threads(2)
from perfbench.harness import cell
bench = cell.load_json(cell.ROOT / "BENCHMARK.json")
assert str(cell.ROOT) == {root!r}
out = cell.run_cell(bench, "toy_lm.prefill", 2 ** 31 + 11, 0.5, {trace},
                    "cpu", time.perf_counter())
out["checks"] = {{k: list(v) for k, v in out["checks"].items()}}
# and what the mapper cell's driver imports of the port
import repro_torch.core.gsampler, repro_torch.core.cost_model
import repro_torch.core.accel, repro_torch.workloads.layer
out["forbidden"] = cell.loaded_forbidden()
print(json.dumps(out))
"""


@pytest.mark.parametrize("trace", [False, True])
def test_toy_cell_from_new_files_only(tmp_path, trace):
    toy.copy_with_toy_files(tmp_path)
    res = subprocess.run([sys.executable, "-c",
                          RUN.format(root=str(tmp_path), trace=trace)],
                         capture_output=True, text=True, timeout=600,
                         cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["forbidden"] == []
    assert out["attempted"] > 0 and out["failed"] == 0
    if trace:
        assert out["metrics"]["toy_tokens"]["value"] > 0
        assert "breakdown" in out
    else:
        assert {"setup_s", "prefill_tok_s", "ttft_p95_ms"} == set(
            out["metrics"])


def test_command_refuses_without_a_card():
    res = subprocess.run([sys.executable, str(toy.ROOT / "perfbench/run.py"),
                          "--workload", "qwen3_8b.prefill_short", "--seed",
                          "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    if res.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_command_refuses_without_the_port(tmp_path):
    shutil.copytree(toy.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(toy.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "dnnfuser_paper.search_grid", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "port's package" in res.stderr
