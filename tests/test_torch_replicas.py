"""Port parity: data-parallel engine replicas (``repro_torch.serving.
replicas``), mirroring ``tests/test_replicas.py``.

The replica contract: cutting a formed tick's rows across replicas is a
placement decision, not a numeric one.  Every row's response is
bit-identical to the single-device engine's, whatever the replica count;
the signature accounting and the warmed set stay closed.  Without a card,
the CPU holds two replicas on ``devices=("cpu", "cpu")``: the same rows
cut and dispatched per replica as on several cards.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, MB, port_workload
from repro.core import model as jm
from repro.serving import replicas as jrep
from repro.workloads import tiny_cnn, vgg16
from repro_torch import serving as ts
from repro_torch.core import accel as taccel, model as tm
from repro_torch.core.infer import LANE_BLOCK

TZOO = taccel.ACCEL_ZOO
NETS = [port_workload(tiny_cnn()), port_workload(vgg16())]


@pytest.fixture(scope="module")
def model():
    return tm.dt_init(tm.DTConfig(max_steps=20), seed=2, device=CPU)


def _reqs(n):
    return [ts.MapRequest(NETS[i % 2] if NETS[i % 2].n < 20 else NETS[0],
                          1 + i % 3, (6 + i) * MB, TZOO["edge"])
            for i in range(n)]


def _same(a, b):
    assert np.array_equal(a.strategy, b.strategy)
    assert (a.latency, a.peak_mem, a.speedup, a.valid) == \
        (b.latency, b.peak_mem, b.speedup, b.valid)


def test_replica_group_validates_count():
    """The reference's checks: past the visible devices and 0 raise
    ("visible"), a non-power-of-two raises; on a host without a card no
    CUDA device is visible, so the default group raises too."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="visible"):
        ts.ReplicaGroup(avail + 1)
    with pytest.raises(ValueError, match="visible"):
        ts.ReplicaGroup(0)
    with pytest.raises(ValueError, match="visible"):
        ts.ReplicaGroup(0, devices=())
    with pytest.raises(ValueError, match="power of two"):
        ts.ReplicaGroup(devices=("cpu",) * 3)
    g = ts.ReplicaGroup(1, devices=("cpu",))
    assert g.n == 1 and g.pad_width(1) == 1
    s = g.stats()
    assert s["n_replicas"] == 1 and s["sharded_calls"] == 0


def test_stats_keys_equal_the_reference():
    g = ts.ReplicaGroup(devices=("cpu", "cpu"))
    ref = jrep.ReplicaGroup(1)
    assert set(g.stats()) == set(ref.stats())
    assert g.stats()["platform"] == "cpu" == ref.stats()["platform"]


def test_split_takes_whole_lane_blocks_on_the_card():
    """The cut's unit: whole ``LANE_BLOCK`` blocks on the card (a row's
    answer depends on its block's shape only), ``width / n`` rows on the
    CPU."""
    g = ts.ReplicaGroup(devices=("cpu",) * 4)
    assert g.split(16) == [(0, 4), (4, 8), (8, 12), (12, 16)]
    g.devices = [torch.device("cuda", 0)] * 4      # the card's unit, no card
    assert g.split(16) == [(0, 16), (16, 16), (16, 16), (16, 16)]
    assert g.split(5 * LANE_BLOCK + 3) == [
        (0, 2 * LANE_BLOCK), (2 * LANE_BLOCK, 4 * LANE_BLOCK),
        (4 * LANE_BLOCK, 5 * LANE_BLOCK + 3),
        (5 * LANE_BLOCK + 3, 5 * LANE_BLOCK + 3)]


def test_single_replica_engine_bit_identical(model):
    plain = ts.MapperEngine(model, device=CPU)
    rep = ts.MapperEngine(model, device=CPU, config=ts.ServingConfig(
        replicas=ts.ReplicaGroup(1, devices=("cpu",))))
    reqs = _reqs(5)
    base = [plain.serve_one(r) for r in reqs]
    for a, b in zip(rep.serve(reqs), base):
        _same(a, b)
    rs = rep.stats()["replicas"]
    assert rs["n_replicas"] == 1 and rs["sharded_calls"] >= 1
    assert sum(rs["rows_per_replica"]) >= len(reqs)


def test_two_cpu_replicas_bit_identical_to_no_replicas(model):
    """Every row of a mixed stream, served by two replicas, equals the
    plain engine's in all five fields; rows split evenly; a 1-request tick
    pads to one lane per replica; warmup then serving adds no signature;
    a hot swap re-replicates."""
    reqs = _reqs(11)
    plain = ts.MapperEngine(model, device=CPU)
    base = plain.serve(reqs)
    solo = [ts.MapperEngine(model, device=CPU).serve_one(r) for r in reqs]
    rep = ts.MapperEngine(model, device=CPU, config=ts.ServingConfig(
        replicas=ts.ReplicaGroup(devices=("cpu", "cpu"))))
    out = rep.serve(reqs)
    for a, b, c in zip(out, base, solo):
        _same(a, b)
        _same(a, c)
    rs = rep.stats()["replicas"]
    assert rs["n_replicas"] == 2 and len(rs["devices"]) == 2
    assert rs["sharded_calls"] >= 1
    assert rs["rows_per_replica"][0] == rs["rows_per_replica"][1] > 0
    calls = rep.device_calls
    one = ts.MapRequest(NETS[0], 4, 32 * MB, TZOO["edge"])
    _same(rep.serve([one])[0], plain.serve_one(one))
    assert rep.device_calls == calls + 1 and rep.rows_padded >= 1
    warm = ts.MapperEngine(model, device=CPU, config=ts.ServingConfig(
        replicas=ts.ReplicaGroup(devices=("cpu", "cpu")), max_coalesce=8))
    warm.warmup(NETS, TZOO["edge"])
    sigs = warm.compile_count
    warm.serve(_reqs(13))
    assert warm.compile_count == sigs
    other = tm.dt_init(tm.DTConfig(max_steps=20), seed=5, device=CPU)
    rep.swap_params(other)
    assert rep._models[0] is other or all(
        torch.equal(a, b) for a, b in zip(rep._models[0].parameters(),
                                          other.parameters()))
    fresh = ts.MapperEngine(other, device=CPU)
    new = [ts.MapRequest(NETS[0], 2, (40 + i) * MB, TZOO["mobile"])
           for i in range(3)]
    for a, b in zip(rep.serve(new), fresh.serve(new)):
        _same(a, b)


def test_engine_builds_the_group_from_a_count():
    """``ServingConfig(replicas=n)`` asks for ``n`` visible cards: on a
    host without one the engine refuses, naming them."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    m = tm.dt_init(tm.DTConfig(max_steps=20), seed=2, device=CPU)
    with pytest.raises(ValueError, match="visible"):
        ts.MapperEngine(m, device=CPU,
                        config=ts.ServingConfig(replicas=1))
