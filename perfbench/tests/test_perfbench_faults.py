"""The comparison that decides ``correct`` fails what it must: the control
(the reference in the next lower precision, in the program's place) and
each fault a cell can have (``harness/faults.py``), planted under the
timed path of a whole toy run on the CPU, the look for a card skipped.  A
sound toy run of the same seed comes out correct."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench.harness import cell as harness, faults
from perfbench.tests import toy

SEED = 2 ** 31 + 5


def run(kind: str, control: bool = False, seconds: float = 0.0):
    c = toy.cell(kind)
    torch.manual_seed(0)
    out = harness.run_resolved(c, SEED, seconds, False, "cpu",
                               time.perf_counter(),
                               c.driver.CONTROL if control else None)
    return out["correct"], {k: v for k, (v, _) in out["checks"].items()}


def test_search_sound_run_is_correct():
    ok, checks = run("search")
    assert ok, checks


def test_search_control_fails():
    ok, checks = run("search", control=True)
    assert not ok
    assert checks["lat_gap"] > 1e-4


@pytest.mark.parametrize("fault,number", [
    ("ga_state_unchanged", "lat_vs_naive"),
    ("half_conditions", "lat_gap"),
    ("answer_altered", "lat_gap")])
def test_search_fault_fails(fault, number):
    with faults.FAULTS[fault]():
        ok, checks = run("search")
    assert not ok
    from perfbench.drivers.search_grid import LIMITS
    assert checks[number] > LIMITS[number], checks


def test_prefill_sound_run_is_correct():
    ok, checks = run("prefill", seconds=0.5)
    assert ok, checks


def test_prefill_control_fails():
    ok, checks = run("prefill", control=True, seconds=0.5)
    assert not ok, checks


@pytest.mark.parametrize("fault,number", [
    ("block_state_unchanged", "logit_err"),
    ("half_batch", "logit_err"),
    ("token_altered", "served_gap")])
def test_prefill_fault_fails(fault, number):
    with faults.FAULTS[fault]():
        ok, checks = run("prefill", seconds=0.5)
    assert not ok
    from perfbench.drivers.lm_prefill import LIMITS
    assert checks[number] > LIMITS[number], checks


@pytest.mark.parametrize("per_stratum", [1, 2])
def test_prefill_checks_every_length_served(per_stratum):
    """The reference re-derives ``check_per_stratum`` batches of every
    length the window served, the longest among them, drawn from the
    seed."""
    from perfbench.drivers import lm_prefill
    c = toy.cell("prefill")
    c.mix["check_per_stratum"] = per_stratum
    run = lm_prefill.Run(c.config, c.mix, SEED, "cpu")
    run.done = [{"S": S} for S in (16, 48, 96, 16, 48, 96, 16, 96)]
    pick = run.sample()
    lengths = [run.done[i]["S"] for i in pick]
    assert sorted(set(lengths)) == [16, 48, 96]
    assert all(lengths.count(S) == per_stratum for S in (16, 48, 96))
    assert pick == sorted(set(pick))
