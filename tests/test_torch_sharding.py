"""Port parity: the sharding plan (``repro_torch.distributed.sharding``)
against the reference's (``repro.distributed.sharding``).

For each of the 10 archs at full width (shapes only: the reference's from
``jax.eval_shape``, the port's from a ``meta`` model) on the (16, 16),
(2, 16, 16) and (4, 4) meshes, every leaf's spec equals the reference's
``PartitionSpec`` (the port's per-layer leaf against the reference's
stacked one, its layer axis's entry dropped).  The batch and decode-state
specs equal the reference's at every SHAPE, the long_500k sequence shard
included, and so do the per-device argument bytes of every cell.  The
reference reads only ``.shape`` and ``.axis_names`` of a mesh, so a
duck-typed mesh stands in for a device mesh.  The port's decode write
index is a host int, which has no spec and no bytes (the reference's is
an [L] int32 array, replicated).
"""
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as JSHAPES, get_config as jget
from repro.distributed import sharding as jsh
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.core.model import param_tree
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import registry as treg


class _FakeMesh:
    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x4": ((4, 4), ("data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return MeshSpec(shape, axes), _FakeMesh(**dict(zip(axes, shape)))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jget(arch)
    m = jreg.get_model(cfg)
    sds = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), cfg,
                                        dtype=jnp.bfloat16))
    flat, _ = jax.tree_util.tree_flatten_with_path(sds)
    return {jsh._path_str(p): v for p, v in flat}


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return param_tree(steps.abstract_model(get_config(arch)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_the_reference(arch, mesh):
    tmesh, jmesh = _meshes(mesh)
    ref = _ref_params(arch)
    port = _port_params(arch)
    specs = tsh.param_specs(port, tmesh, get_config(arch))
    seen = set()
    for k, t in port.items():
        path, stacked = tsh.stacked_path(k)
        seen.add(path)
        want = tuple(jsh.shard_spec_for_path(path, ref[path].shape, jmesh,
                                             jget(arch)))
        if stacked and want:
            assert want[0] is None, (path, want)
            want = want[1:]
        assert specs[k] == want, (k, specs[k], want)
        assert (tuple(ref[path].shape[1:]) if stacked
                else tuple(ref[path].shape)) == tuple(t.shape), k
    assert seen == set(ref)


def _jbatch(arch, shape):
    return jreg.input_specs(jget(arch), JSHAPES[shape])


def _jstate(arch, shape):
    return jreg.decode_state_specs(jget(arch), JSHAPES[shape])


def _flat_port(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, f"{pre}{k}/"))
        else:
            out[f"{pre}{k}"] = v
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_decode_state_specs_equal_the_reference(arch, shape):
    cfg = get_config(arch)
    tb = treg.input_specs(cfg, SHAPES[shape])
    jb = _jbatch(arch, shape)
    tstate = treg.decode_state_specs(cfg, SHAPES[shape])
    jstate = _jstate(arch, shape)
    for mesh in MESHES:
        tmesh, jmesh = _meshes(mesh)
        for seq in (False, True):
            got = tsh.batch_specs(tb, tmesh, shard_seq=seq)
            want = jsh.batch_specs(jb, jmesh, shard_seq=seq)
            assert got == {k: tuple(v) for k, v in want.items()}, (mesh, seq)
            got = _flat_port(tsh.decode_state_specs_sharded(
                tstate, tmesh, shard_seq=seq))
            flat, _ = jax.tree_util.tree_flatten_with_path(
                jsh.decode_state_specs_sharded(jstate, jmesh, shard_seq=seq),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            want = {jsh._path_str(p): tuple(v) for p, v in flat}
            assert set(got) == set(want)
            for k, v in want.items():
                if k.endswith("idx"):          # the port's is a host int
                    assert got[k] == () == v
                    continue
                assert got[k] == v, (mesh, seq, k, got[k], v)


def test_long_500k_shards_the_sequence():
    """Batch 1 at 512k: the cache's sequence axis over data x model."""
    cfg = get_config("gemma3_1b")
    state = treg.decode_state_specs(cfg, SHAPES["long_500k"])
    s = tsh.decode_state_specs_sharded(state, MeshSpec(*MESHES["16x16"]),
                                       shard_seq=True)
    assert s["k"] == (None, None, ("data", "model"), None, None)
    b = tsh.batch_specs({"tokens": torch.empty((1, 65536), device="meta")},
                        MeshSpec(*MESHES["16x16"]), shard_seq=True)
    assert b["tokens"] == (None, "data")


def _ref_bytes(arch, shape, jmesh):
    """Per-device argument bytes from the reference's own specs."""
    def shard(shape_, itemsize, spec):
        n = math.prod(shape_) * itemsize
        for e in tuple(spec):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    n //= jmesh.shape[a]
        return n
    cfg, sh = jget(arch), JSHAPES[shape]
    params = _ref_params(arch)
    specs = {k: jsh.shard_spec_for_path(k, v.shape, jmesh, cfg)
             for k, v in params.items()}
    total = sum(shard(v.shape, v.dtype.itemsize, specs[k])
                for k, v in params.items())
    if sh.kind == "train":
        total += 2 * sum(shard(v.shape, 4, specs[k])
                         for k, v in params.items())
    jb = _jbatch(arch, shape)
    bs = jsh.batch_specs(jb, jmesh)
    total += sum(shard(v.shape, v.dtype.itemsize, bs[k])
                 for k, v in jb.items())
    if sh.kind == "decode":
        st = _jstate(arch, shape)
        ss = jsh.decode_state_specs_sharded(st, jmesh,
                                            shard_seq=sh.global_batch == 1)
        fv, _ = jax.tree_util.tree_flatten_with_path(st)
        fs = jax.tree_util.tree_leaves(
            ss, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for (p, v), s in zip(fv, fs):
            if jsh._path_str(p).endswith("idx"):
                continue
            total += shard(v.shape, v.dtype.itemsize, s)
    return total


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_argument_bytes_equal_the_reference(arch, shape):
    cfg = get_config(arch)
    for mesh in MESHES:
        tmesh, jmesh = _meshes(mesh)
        got = dryrun.argument_bytes(cfg, SHAPES[shape], tmesh)
        assert got["total"] == _ref_bytes(arch, shape, jmesh), mesh


# --- the reference's rule tests (tests/test_sharding.py), on the port ------

MESH = MeshSpec((16, 16), ("data", "model"))


def test_rules_tp_and_fsdp():
    cfg = get_config("qwen3_8b")
    s = tsh.shard_spec_for_path("blocks/attn/q/w", (36, 4096, 4096), MESH,
                                cfg)
    assert s == (None, "data", "model")             # heads 32 % 16 == 0
    s = tsh.shard_spec_for_path("blocks/attn/k/w", (36, 4096, 1024), MESH,
                                cfg)
    assert "model" not in s                         # kv 8 % 16 != 0 -> repl
    s = tsh.shard_spec_for_path("embed/emb", (152064, 4096), MESH, cfg)
    assert s == ("model", "data")
    s = tsh.shard_spec_for_path("blocks/ln1/g", (36, 4096), MESH, cfg)
    assert s == ()


def test_rules_moe_ep_vs_expert_tp():
    qw = get_config("qwen3_moe_235b")               # 128 experts: EP
    s = tsh.shard_spec_for_path("blocks/moe/gate", (94, 128, 4096, 1536),
                                MESH, qw)
    assert s[1] == "model"
    gk = get_config("grok1_314b")                   # 8 experts: expert-TP
    s = tsh.shard_spec_for_path("blocks/moe/gate", (64, 8, 6144, 32768),
                                MESH, gk)
    assert s[-1] == "model" and "model" not in s[:-1]


def test_gemma_attention_fully_replicated_across_tp():
    cfg = get_config("gemma3_1b")                   # 4 q heads, 1 kv head
    for path, shape in [("blocks/attn/q/w", (26, 1152, 1024)),
                        ("blocks/attn/k/w", (26, 1152, 256)),
                        ("blocks/attn/o/w", (26, 1024, 1152))]:
        assert "model" not in tsh.shard_spec_for_path(path, shape, MESH,
                                                      cfg), path


def test_placements_and_leading_axis():
    """``to_placements`` on a 2-D mesh, and ``shard_leading_axis``'s
    blocks and its refusal (the reference's message)."""
    from torch.distributed.tensor import Replicate, Shard

    class _DM:                          # what to_placements reads of a mesh
        shape = (2, 4)
        mesh_dim_names = ("data", "model")
        axis_names = ("data", "model")
    assert tsh.to_placements(("data", "model"), _DM()) == (Shard(0),
                                                           Shard(1))
    assert tsh.to_placements((None, "data"), _DM()) == (Shard(1),
                                                        Replicate())
    assert tsh.to_placements((), _DM()) == (Replicate(), Replicate())
    x = torch.arange(12).reshape(6, 2)
    parts = tsh.shard_leading_axis({"x": x}, 3)
    assert [p["x"].tolist() for p in parts] == [x[i * 2:i * 2 + 2].tolist()
                                                for i in range(3)]
    with pytest.raises(ValueError, match="pad the tick to a multiple of 4"):
        tsh.shard_leading_axis({"x": x}, 4)
    two = tsh.replicate_tree({"a": x, "b": {"c": x}}, ["cpu", "cpu"])
    assert len(two) == 2 and two[1]["b"]["c"] is x


def test_logical_shard_and_no_silent_mesh():
    """``logical_shard`` passes its input through, a 'model' axis above
    1 ambient included (the layers make their collectives explicitly,
    ``distributed.tp``); a real mesh needs a process group of exactly its
    size."""
    from repro_torch.launch.mesh import init_mesh, mesh_ctx
    x = torch.ones(4, 4)
    assert tsh.logical_shard(x, "batch", "model") is x
    with mesh_ctx(MeshSpec((4, 1), ("data", "model"))):
        assert tsh.logical_shard(x, "batch", "model") is x
    with mesh_ctx(MESH):
        assert tsh.ambient_mesh() is MESH
        assert tsh.logical_shard(x, "batch", "model") is x
        assert tsh.logical_shard(x, None, "seq") is x
    assert tsh.ambient_mesh() is None
    with pytest.raises(RuntimeError, match="no process group"):
        init_mesh((2,), ("data",), "cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        tsh.data_parallel_mesh(device="cpu")
