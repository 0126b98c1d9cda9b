"""Toy cells for the CPU tests: the benchmark's own configurations cut to
a size the CPU runs in seconds, as in-memory cells (the harness's
``resolve`` result) or as new files in a copy of the benchmark."""
from __future__ import annotations

import copy
import importlib
import json
import os
import pathlib
import shutil
from types import SimpleNamespace

ROOT = pathlib.Path(__file__).resolve().parents[2]
PERFBENCH = ROOT / "perfbench"


def load(path):
    with open(path) as f:
        return json.load(f)


def mapper_config(generations: int = 50) -> dict:
    cfg = load(PERFBENCH / "configs" / "dnnfuser_paper.json")
    cfg["gsampler"]["generations"] = generations
    return cfg


def lm_config() -> dict:
    cfg = load(PERFBENCH / "configs" / "qwen3_8b.json")
    cfg.update(name="toy_lm", hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, vocab_size=512)
    return cfg


SEARCH_MIX = {"driver": "search_grid", "conditions_per_round": 32,
              "budget_mb": {"dist": "log_uniform", "lo": 8, "hi": 64},
              "batch": {"dist": "choice", "values": [16, 64]},
              "check_answers": 32, "trace_rounds": 1}
PREFILL_MIX = {"driver": "lm_prefill", "batch": 2,
               "length": {"dist": "uniform", "lo": 16, "hi": 96,
                          "step": 16},
               "strata": 4, "cache_extra": 8, "check_per_stratum": 1}


def cell(kind: str, **over) -> SimpleNamespace:
    """A resolved toy cell: ``kind`` "search" or "prefill"."""
    if kind == "search":
        config, mix = mapper_config(**over), copy.deepcopy(SEARCH_MIX)
    else:
        config, mix = lm_config(), copy.deepcopy(PREFILL_MIX)
    driver = importlib.import_module(f"perfbench.drivers.{mix['driver']}")
    return SimpleNamespace(cell={"name": f"toy.{kind}", "chips": 1},
                           config=config, mix=mix, driver=driver, e2e=[],
                           per_layer=[])


def copy_with_toy_files(dst: pathlib.Path) -> None:
    """A copy of the benchmark in ``dst`` with a toy configuration, traffic
    mix, metric reader and cell added as new files and new entries only."""
    shutil.copytree(PERFBENCH, dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", dst / "src")
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    with open(dst / "perfbench/configs/toy_lm.json", "w") as f:
        json.dump(lm_config(), f)
    with open(dst / "perfbench/traffic/toy_prefill.json", "w") as f:
        json.dump(PREFILL_MIX, f)
    (dst / "perfbench/metrics/toy_tokens.py").write_text(
        'def read(ctx):\n    return ctx.window.get("tokens")\n')
    bench = load(dst / "BENCHMARK.json")
    bench["configs"].append({"name": "toy_lm", "source": "toy",
                             "file": "perfbench/configs/toy_lm.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "toy_lm.prefill", "config": "toy_lm",
                               "traffic": "toy_prefill", "chips": 1,
                               "why": "toy"})
    for m in bench["end_to_end"]:
        if m["name"] in ("prefill_tok_s", "ttft_p95_ms"):
            m["workloads"].append("toy_lm.prefill")
    bench["per_layer"].append({
        "name": "toy_tokens", "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "toy",
        "moves": "prefill_tok_s", "workloads": ["toy_lm.prefill"]})
    with open(dst / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
