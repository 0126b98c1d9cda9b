"""Port parity: the model registry's specs, and greedy serving of every
new family.

``input_specs`` and ``decode_state_specs`` (``meta`` tensors in the port,
``ShapeDtypeStruct`` in the reference) have the reference's keys, shapes
and dtypes in all 40 (arch, shape) cells, and ``decode_cache_len`` its
value.  The one structural difference is named: the port's decode-state
write index ``idx`` is a Python int (0), the reference's an int32 array
of shape [L].  Greedy serving of each new family is seeded (two runs of
one seed equal, another seed differs) and consistent: a teacher-forced
``forward`` over ``replay_batch`` reproduces the served logits (2e-4, the
model tolerance) and tokens.  For the MoE configs the forward reproduces
the prefill's row only (a forward over the prompt): the experts' capacity
is per routing group, so a longer group (prompt and generated tokens)
keeps and drops other tokens than the prefill's group and the one-token
decode groups do (``repro/nn/moe.py:74``), by the reference's semantics;
their decode rows are held to a serve at ``impl="dense"``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, TOL, to_np
from repro import configs as jconfigs
from repro.models import registry as jreg
from repro_torch import configs as tconfigs
from repro_torch.launch import replay_batch, serve_greedy
from repro_torch.models import get_model, registry as treg

_DT = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.int32): torch.int32}
CELLS = list(jconfigs.cells(include_skipped=True))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _same(got: dict, want: dict, *, idx_ok=False):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k, spec in w.items():
        if idx_ok and k.endswith("/idx"):
            assert g[k] == 0 and spec.dtype == jnp.int32
            continue
        assert g[k].device.type == "meta", k
        assert (tuple(g[k].shape), g[k].dtype) == \
            (tuple(spec.shape), _DT[jnp.dtype(spec.dtype)]), k


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _, _ in CELLS])
def test_specs_equal_the_reference(arch, shape):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    js, ts = jconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
    assert treg.decode_cache_len(tc, ts) == jreg.decode_cache_len(jc, js)
    _same(treg.input_specs(tc, ts), jreg.input_specs(jc, js))
    _same(treg.decode_state_specs(tc, ts), jreg.decode_state_specs(jc, js),
          idx_ok=True)


@pytest.mark.parametrize("name", ["qwen3_moe_235b", "grok1_314b",
                                  "qwen2_vl_72b", "hymba_15b",
                                  "whisper_base"])
def test_serve_greedy_new_family_seeded_and_consistent(name):
    kw = dict(batch=2, prompt_len=24, gen_len=5, reduced=True, device=CPU)
    a = serve_greedy(name, seed=3, keep_logits=True, **kw)
    b = serve_greedy(name, seed=3, impl="dense", keep_logits=True, **kw)
    c = serve_greedy(name, seed=4, **kw)
    cfg = tconfigs.get_config(name, reduced=True)
    assert a["tokens"].shape == (2, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    for k, v in a["inputs"].items():
        np.testing.assert_array_equal(v, b["inputs"][k])
        assert not np.array_equal(v, c["inputs"][k])
    if cfg.family == "encdec":
        assert a["inputs"]["tokens"].shape == (2, 8)    # max(24 // 8, 8)
        assert a["inputs"]["embeds"].shape == (2, 24, cfg.d_model)
    got = to_np(a["logits"])
    np.testing.assert_allclose(got, to_np(b["logits"]), **TOL)
    np.testing.assert_array_equal(got.argmax(-1), a["tokens"])
    batch, first = replay_batch(cfg, a)
    model = get_model(cfg).init(cfg, seed=3, dtype=torch.float32, device=CPU)
    if cfg.n_experts:                      # the prompt's group only
        batch, got = dict(tokens=batch["tokens"][:, :first + 1]), got[:, :1]
    fwd = get_model(cfg).forward(
        model, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(got, to_np(fwd[:, first:]), **TOL)
