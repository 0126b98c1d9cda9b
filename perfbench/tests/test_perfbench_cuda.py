"""Each cell runs on the card through the one command, comes out correct,
and reports every metric BENCHMARK.json lists for it (``-m cuda``; skips
without a card)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.harness import cell as harness

pytestmark = pytest.mark.cuda
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(card, name, trace):
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          name, "--seed", str(2 ** 31 + 3), "--seconds",
                          "3", "--trace", str(trace)], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    c = harness.resolve(BENCH, name)
    want = c.per_layer if trace else c.e2e
    assert {m["name"] for m in want} == set(out["metrics"])
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
