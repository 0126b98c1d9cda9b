"""Port parity: int8 gradient compression with error feedback
(``repro_torch.optim.compression``) against the reference's.

- ``quantize_int8``: ``q`` equal and scales bit-equal on the same f32 (or
  bf16) input: the same f32 operations, and both round half to even;
  ``dequantize_int8`` bit-equal;
- EF-SGD on the reference's quadratic converges as the reference's test
  asks (max error below 0.05 after 150 steps), and its parameters stay
  within 1e-6 of the reference's run (the same f32 operations);
- ``compressed(adamw)`` over 6 steps with the clip active: the residuals
  bit-equal (they depend on the gradients only), the parameters within
  rtol 1e-5, atol 1e-7 (AdamW's tolerance in ``test_torch_train.py``: the
  global norm is summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from repro import optim as joptim
from repro.optim import compression as jc
from repro_torch import optim as toptim

torch.set_num_threads(2)


@pytest.mark.parametrize("shape,block", [((1000,), 256), ((3, 7, 50), 256),
                                         ((64, 64), 256), ((130,), 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_equals_reference(shape, block, dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * rng.choice([1e-3, 1.0, 40.0], size=shape)
         ).astype(np.float32)
    x[..., :3] = 0.0
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s, sh, n = toptim.quantize_int8(tx, block)
    jq, js, jsh, jn = jc.quantize_int8(jx, block)
    np.testing.assert_array_equal(to_np(q), np.asarray(jq))
    assert to_np(s).tobytes() == np.asarray(js).tobytes()
    assert (tuple(sh), n) == (tuple(jsh), jn)
    back = toptim.dequantize_int8(q, s, sh, n)
    assert to_np(back).tobytes() == np.asarray(
        jc.dequantize_int8(jq, js, jsh, jn)).tobytes()
    assert back.shape == tuple(shape)


def test_all_zero_block_quantizes_to_zero():
    q, s, sh, n = toptim.quantize_int8(torch.zeros(300))
    assert not q.any() and not s.any()
    assert not toptim.dequantize_int8(q, s, sh, n).any()


def test_ef_sgd_converges_on_the_reference_quadratic():
    target = np.arange(8, dtype=np.float32)
    tx = toptim.compressed(toptim.sgd(lr=0.05, momentum=0.0))
    params = {"w": torch.full((8,), 5.0)}
    state = tx.init(params)
    jtx = jc.compressed(joptim.sgd(lr=0.05, momentum=0.0))
    jparams = {"w": jnp.full((8,), 5.0)}
    jstate = jtx.init(jparams)
    jt = jnp.asarray(target)
    for _ in range(150):
        g = {"w": 2 * (params["w"] - torch.as_tensor(target))}
        up, state = tx.update(g, state, params)
        toptim.apply_updates(params, up)
        jg = jax.grad(lambda p: jnp.sum((p["w"] - jt) ** 2))(jparams)
        jup, jstate = jtx.update(jg, jstate, jparams)
        jparams = joptim.apply_updates(jparams, jup)
    assert float((params["w"] - torch.as_tensor(target)).abs().max()) < 0.05
    np.testing.assert_allclose(to_np(params["w"]), np.asarray(jparams["w"]),
                               rtol=0, atol=1e-6)


def test_compressed_adamw_matches_reference():
    rng = np.random.default_rng(1)
    shapes = {"a": (40, 30), "b": (513,), "c": (2, 3, 4)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(weight_decay=0.01, max_grad_norm=0.5)
    tx = toptim.compressed(toptim.adamw(
        toptim.cosine_with_warmup(1e-2, 2, 6), **kw))
    jtx = jc.compressed(joptim.adamw(
        joptim.cosine_with_warmup(1e-2, 2, 6), **kw))
    params = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state, jstate = tx.init(params), jtx.init(jparams)
    for _ in range(6):
        g = {k: (rng.normal(size=s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        up, state = tx.update({k: torch.as_tensor(v) for k, v in g.items()},
                              state, params)
        toptim.apply_updates(params, up)
        jup, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jparams)
        jparams = joptim.apply_updates(jparams, jup)
        for k in shapes:
            assert to_np(state.err[k]).tobytes() == \
                np.asarray(jstate.err[k]).tobytes(), k
            np.testing.assert_allclose(to_np(params[k]),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert int(state.inner.step) == int(jstate.inner.step) == 6
