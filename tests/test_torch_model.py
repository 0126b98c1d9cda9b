"""Port parity: the DT mapper against the JAX reference.

Weights come from the reference's ``dt_init``, saved with
``checkpoint.save_pytree`` and loaded through the port's numpy-only
``checkpoint/reference.py``.  Logits agree within atol 1e-5 with TF32 off
(small DT: 2 blocks, d=32, max_steps 16).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, to_np
from repro.checkpoint import save_pytree
from repro.core import model as jm
from repro_torch.checkpoint import dt_params_from_reference, load_reference
from repro_torch.core import model as tm

CFGS = {"plain": dict(n_blocks=2, n_heads=2, d_model=32, max_steps=16,
                      d_ff=64),
        "hw": dict(n_blocks=2, n_heads=2, d_model=32, max_steps=16, d_ff=64,
                   hw_dim=10)}


def _pair(tmp_path, kind, seed=0):
    jcfg = jm.DTConfig(**CFGS[kind])
    params = jm.dt_init(jax.random.PRNGKey(seed), jcfg)
    save_pytree(params, tmp_path / "ckpt")
    model = dt_params_from_reference(load_reference(tmp_path / "ckpt"),
                                     device=CPU)
    return jcfg, params, model


def _inputs(T, B=2, seed=0, hw_dim=0):
    rng = np.random.default_rng(seed)
    rtg = rng.random((B, T)).astype(np.float32)
    states = rng.random((B, T, 8)).astype(np.float32)
    actions = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    hw = rng.random((B, hw_dim)).astype(np.float32) if hw_dim else None
    return rtg, states, actions, hw


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_converted_config_and_parameters(tmp_path, kind):
    jcfg, params, model = _pair(tmp_path, kind)
    assert model.cfg == tm.DTConfig(**CFGS[kind])
    np.testing.assert_array_equal(to_np(model.blocks[1].attn.q.w),
                                  np.asarray(params["blocks"][1]["attn"]["q"]
                                             ["w"]))
    np.testing.assert_array_equal(to_np(model.type_.emb),
                                  np.asarray(params["type"]["emb"]))


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_dt_apply_matches_reference(tmp_path, kind):
    jcfg, params, model = _pair(tmp_path, kind)
    rtg, states, actions, hw = _inputs(jcfg.max_steps, hw_dim=jcfg.hw_dim)
    want = jm.dt_apply(params, jcfg, _j(rtg), _j(states), _j(actions),
                       hw=_j(hw))
    with torch.no_grad():
        got = tm.dt_apply(model, _t(rtg), _t(states), _t(actions), hw=_t(hw))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_dt_apply_window_offsets_match_and_poison(tmp_path):
    jcfg, params, model = _pair(tmp_path, "plain")
    rtg, states, actions, _ = _inputs(6)
    t0 = np.array([3, 12], np.int32)          # row 1 runs past max_steps
    want = np.asarray(jm.dt_apply(params, jcfg, _j(rtg), _j(states),
                                  _j(actions), t0=jnp.asarray(t0)))
    with torch.no_grad():
        got = to_np(tm.dt_apply(model, _t(rtg), _t(states), _t(actions),
                                t0=torch.as_tensor(t0)))
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_cached_decode_matches_reference_and_dt_apply(tmp_path, kind):
    """Prefill + cached decode steps against the reference's, and against
    the port's own full-sequence ``dt_apply``."""
    jcfg, params, model = _pair(tmp_path, kind)
    T = jcfg.max_steps
    rtg, states, actions, hw = _inputs(T, hw_dim=jcfg.hw_dim)
    with torch.no_grad():
        full = to_np(tm.dt_apply(model, _t(rtg), _t(states), _t(actions),
                                 hw=_t(hw)))
        cache = tm.dt_cache_init(model.cfg, 2)
        p, cache = tm.dt_prefill(model, cache, _t(rtg[:, 0]),
                                 _t(states[:, 0]), _t(hw))
        got = [to_np(p)]
        for t in range(1, T):
            p, cache = tm.dt_decode_step(model, cache, _t(rtg[:, t]),
                                         _t(states[:, t]),
                                         _t(actions[:, t - 1]), _t(hw))
            got.append(to_np(p))
    jcache = jm.dt_cache_init(jcfg, 2)
    p, jcache = jm.dt_prefill(params, jcfg, jcache, _j(rtg[:, 0]),
                              _j(states[:, 0]), _j(hw))
    want = [np.asarray(p)]
    for t in range(1, T):
        p, jcache = jm.dt_decode_step(params, jcfg, jcache, _j(rtg[:, t]),
                                      _j(states[:, t]),
                                      _j(actions[:, t - 1]), _j(hw))
        want.append(np.asarray(p))
    got, want = np.stack(got, 1), np.stack(want, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, full, atol=1e-5, rtol=0)


def test_reference_reader_checks_digest_and_leaves(tmp_path):
    _, params, _ = _pair(tmp_path, "plain")
    flat = load_reference(tmp_path / "ckpt")
    assert "blocks/0/attn/q/w" in flat and "time/emb" in flat
    meta_path = tmp_path / "ckpt" / "meta.json"
    meta = json.loads(meta_path.read_text())
    leaf = meta["leaves"]["head/w"]["file"]
    arr = np.load(tmp_path / "ckpt" / leaf)
    np.save(tmp_path / "ckpt" / leaf, arr + 1.0)
    with pytest.raises(IOError):
        load_reference(tmp_path / "ckpt")
    flat.pop("head/b")
    with pytest.raises(RuntimeError):
        dt_params_from_reference(flat, device=CPU)


def test_dt_init_is_seeded():
    cfg = tm.DTConfig(**CFGS["hw"])
    a = tm.dt_init(cfg, seed=3, device=CPU)
    b = tm.dt_init(cfg, seed=3, device=CPU)
    c = tm.dt_init(cfg, seed=4, device=CPU)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.0.attn.q.w"], sc["blocks.0.attn.q.w"])
