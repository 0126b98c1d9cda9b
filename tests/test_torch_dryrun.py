"""The dry-run (``repro_torch.launch.dryrun``) and its cost model
(``launch.cost_analysis``), on the CPU, without devices:

- the FLOP counter over reduced qwen3_8b's train step without remat lies
  within [1, 1.25] x the analytic ``6 * active_params * tokens`` (the
  attention products come on top; at 128 tokens they are a few per
  cent); at ``remat="full"`` (the dry-run's, as the train step's) it
  adds one forward of each block but its last product (the recompute
  stops once every tensor the backward saved is back, and the MLP's
  down projection's output is not one);
- the L = 1, L = 2 extrapolation equals a direct count at depth 3, FLOPs
  and the step's and the update's temporaries;
- the (4, 4) mini dry-run: collectives > 0 and 0 < temporaries < 16 GiB
  (the reference's ``test_mini_dryrun_16_devices`` assertions);
- the argument bytes at one device equal the real tensors' bytes;
- ``roofline_terms``' arithmetic, the CLI writing one JSON per cell,
  and its table: a row an arch, a column a shape.
"""
import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import Shape, get_config
from repro_torch.core.model import param_tree
from repro_torch.launch import cost_analysis as ca, dryrun, steps
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import get_model, registry

SHAPE = Shape("t", 128, 8, "train")
MESH44 = MeshSpec((4, 4), ("data", "model"))
ONE = MeshSpec((1, 1), ("data", "model"))


def _count(cfg, shape, remat="full"):
    args = steps.abstract_args(cfg, shape, dtype=torch.float32)
    with FlopCounterMode(display=False) as fc:
        dryrun._run_step(cfg, shape, args, torch.float32, remat=remat)
    return float(fc.get_total_flops())


def _forward(cfg, shape):
    """FLOPs of the train step's loss alone (no backward)."""
    model, _, batch = steps.abstract_args(cfg, shape, dtype=torch.float32)
    with FlopCounterMode(display=False) as fc:
        get_model(cfg).loss_fn(model, batch, impl="dense")
    return float(fc.get_total_flops())


def test_train_flops_near_six_n_d():
    cfg = get_config("qwen3_8b", reduced=True)
    got = _count(cfg, SHAPE, remat="none")
    want = 6.0 * cfg.active_param_count() * SHAPE.seq_len \
        * SHAPE.global_batch
    assert 1.0 <= got / want <= 1.25, got / want


def test_full_remat_adds_one_forward_of_the_blocks():
    cfg = dryrun.with_layers(get_config("qwen3_8b", reduced=True), 3)
    block = _forward(dryrun.with_layers(cfg, 2), SHAPE) \
        - _forward(dryrun.with_layers(cfg, 1), SHAPE)
    down = 2 * SHAPE.global_batch * SHAPE.seq_len * cfg.d_ff * cfg.d_model
    assert block > down > 0
    assert _count(cfg, SHAPE) - _count(cfg, SHAPE, remat="none") \
        == 3 * (block - down)


def test_extrapolation_is_exact_in_depth():
    cfg = dryrun.with_layers(get_config("qwen3_8b", reduced=True), 3)
    costs = dryrun.step_costs(cfg, SHAPE, ONE, dtype=torch.float32)
    assert costs["flops_total"] == _count(cfg, SHAPE)
    assert costs["flops_per_device"] == costs["flops_total"]
    step, update = dryrun._temporaries(cfg, SHAPE, torch.float32)
    assert 0 < step and 0 < update
    for got, want in ((costs["temp_step"], step),
                      (costs["temp_update"], update),
                      (costs["temp_bytes"], max(step, update))):
        assert abs(got - want) <= 1e-6 * want


def test_mini_dryrun_16_devices():
    cfg = get_config("qwen3_8b", reduced=True)
    rec = dryrun.lower_cell(None, None, mesh=MESH44, cfg=cfg, shape=SHAPE)
    assert rec["collectives"]["total"] > 0, \
        "a sharded train step must contain collectives"
    assert 0 < rec["memory"]["temp_size_in_bytes"] < 16 * 2 ** 30
    assert rec["n_devices"] == 16 and rec["prediction"]
    r = rec["roofline"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    # every leaf sharded 16 ways or replicated: the per-device FLOPs lie
    # between a sixteenth and a quarter of the whole step's
    tot = rec["flops_total"]
    assert tot / 16 <= rec["flops_per_device"] <= tot / 4


def test_argument_bytes_at_one_device_equal_the_tensors():
    cfg = get_config("gemma3_1b", reduced=True)
    got = dryrun.argument_bytes(cfg, SHAPE, ONE, dtype=torch.float32)
    model = get_model(cfg).init(cfg, seed=0, dtype=torch.float32,
                                device="cpu")
    params = sum(p.numel() * 4 for p in model.parameters())
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             registry.input_specs(cfg, SHAPE).items()}
    assert got["params"] == params and got["moments"] == 2 * params
    assert got["batch"] == sum(t.numel() * t.element_size()
                               for t in batch.values())
    assert got["total"] == got["params"] + got["moments"] + got["batch"]


def test_roofline_terms_arithmetic():
    r = ca.roofline_terms(flops=989e12, bytes_accessed=3.35e12,
                          coll_bytes=900e9, n_devices=4,
                          model_flops=2 * 989e12)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 1.0, 2.0)
    assert r.bottleneck == "collective" and r.useful_ratio == 0.5
    r = ca.roofline_terms(flops=67e12, bytes_accessed=0.0, coll_bytes=0.0,
                          n_devices=1, peak=ca.peak_flops(torch.float32))
    assert r.t_compute == 1.0 and r.bottleneck == "compute"
    assert ca.link_rate(MESH44) == ca.HW["ib_bw"]
    assert ca.link_rate(MeshSpec((8, 1), ("data", "model"))) == \
        ca.HW["nvlink_bw"]


def test_collectives_follow_the_plan():
    """Data-parallel only: FSDP gathers and scatters, no TP all-reduce of
    activations, no all-to-all; a 'model' axis brings them."""
    cfg = get_config("qwen3_moe_235b", reduced=True)
    leaves = param_tree(steps.abstract_model(cfg))
    from repro_torch.distributed.sharding import param_specs
    for mesh, tp in ((MeshSpec((4, 1), ("data", "model")), False),
                     (MESH44, True)):
        c = ca.collective_bytes(param_specs(leaves, mesh, cfg), leaves, cfg,
                                SHAPE, mesh, act_bytes=2)
        assert c["all-gather"] > 0 and c["reduce-scatter"] > 0
        assert (c["all-to-all"] > 0) == (tp and cfg.n_experts % 4 == 0)
        assert c["total"] == sum(c[k] for k in ca._COLLECTIVES)


def test_cli_writes_one_json_per_cell(tmp_path):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "whisper_base", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "whisper_base__decode_32k__16x16.json")
                     .read_text())
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["memory"]["arguments"]["state"] > 0
    assert rec["collectives"]["total"] > 0


def test_table_has_a_row_an_arch_and_a_column_a_shape(tmp_path, capsys):
    for shape in ("decode_32k", "prefill_32k"):
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "whisper_base", "--shape", shape,
                         "--both-meshes", "--out", str(tmp_path)])
    capsys.readouterr()
    dryrun.main(["--table", "--out", str(tmp_path)])
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows[0] == "| arch | prefill_32k | decode_32k |"
    assert len(rows) == 3 and rows[2].startswith("| whisper_base | ")
    cells = rows[2].split(" | ")[1:]
    rec = json.loads((tmp_path / "whisper_base__decode_32k__2x16x16.json")
                     .read_text())
    temp = rec["memory"]["temp_size_in_bytes"] / 2 ** 30
    assert all(c.count("/") >= 6 and " GiB; " in c for c in cells)
    assert f"/{temp:.2f} GiB; " in cells[1]
