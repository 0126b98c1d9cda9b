"""Shared helpers for the parity tests of the PyTorch port (``repro_torch``)
against the JAX reference (``repro``).  Not collected by pytest.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU (its plain PyTorch paths) with two threads.
"""
import dataclasses

import numpy as np
import torch

import repro_torch  # noqa: F401  (sets the TF32-off policy)
from repro.core.accel import AccelConfig as JAccel
from repro_torch.core import accel as taccel
from repro_torch.workloads import Layer as TLayer, Workload as TWorkload

torch.set_num_threads(2)

CPU = "cpu"
MB = 2.0 ** 20


def port_workload(w) -> TWorkload:
    """The port's copy of a reference ``Workload``."""
    return TWorkload(w.name, [TLayer(**dataclasses.asdict(l))
                              for l in w.layers],
                     float(w.input_elems), tuple(w.input_shape6),
                     w.default_batch)


def port_accel(a: JAccel) -> taccel.AccelConfig:
    return taccel.AccelConfig(**dataclasses.asdict(a))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_costout_close(got, want, *, rtol=1e-5, mask_valid=True):
    """latency / peak_mem / traffic within ``rtol``; valid and n_groups
    equal."""
    for k in ("latency", "peak_mem", "traffic"):
        np.testing.assert_allclose(to_np(getattr(got, k)),
                                   to_np(getattr(want, k)), rtol=rtol,
                                   atol=0, err_msg=k)
    if mask_valid:
        np.testing.assert_array_equal(to_np(got.valid), to_np(want.valid))
    np.testing.assert_array_equal(to_np(got.n_groups), to_np(want.n_groups))


TOL = dict(rtol=2e-4, atol=2e-4)    # the reference's own model tolerance


def lm_pair(tmp_path, name, seed=0):
    """(reference cfg, reference model module, perturbed reference params,
    port model) for the reduced config ``name``: the reference's f32 init
    with every leaf perturbed by seeded numpy noise, saved with
    ``save_pytree`` and carried into the port by
    ``lm_params_from_reference``."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.checkpoint import save_pytree
    from repro.models import registry as jreg
    from repro_torch import configs as tconfigs
    from repro_torch.checkpoint import load_reference, lm_params_from_reference
    cfg = jconfigs.get_config(name, reduced=True)
    jmod = jreg.get_model(cfg)
    params = jmod.init(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0, 0.05, a.shape), a.dtype),
        params)
    save_pytree(params, tmp_path / name)
    model = lm_params_from_reference(load_reference(tmp_path / name),
                                     tconfigs.get_config(name, reduced=True),
                                     device=CPU)
    return cfg, jmod, params, model


def serve_pair(jmod, params, cfg, tmod, model, batch, max_len, steps,
               ref_impl, impl, step_batch=None):
    """Prefill ``batch`` (numpy) and ``steps`` greedy decode steps in both
    packages (the reference at ``ref_impl``, the port at ``impl``; f32
    caches).  ``step_batch(tok)`` makes a step's input from the greedy
    token [B, 1] (default ``{"tokens": tok}``).  Returns (reference
    logits, port logits), each [B, steps + 1, V] (numpy)."""
    import jax.numpy as jnp
    make = step_batch or (lambda t: {"tokens": t})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, state = jmod.prefill(params, cfg, jb, max_len, impl=ref_impl,
                                 cache_dtype=jnp.float32)
    want = [np.asarray(logits)]
    for _ in range(steps):
        tok = np.asarray(logits[:, -1]).argmax(-1)[:, None].astype(np.int32)
        sb = {k: jnp.asarray(v) for k, v in make(tok).items()}
        logits, state = jmod.decode_step(params, cfg, state, sb,
                                         impl=ref_impl)
        want.append(np.asarray(logits))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    logits, state = tmod.prefill(model, tb, max_len, impl=impl,
                                 cache_dtype=torch.float32)
    got = [to_np(logits)]
    for _ in range(steps):
        tok = logits[:, -1].argmax(-1)[:, None]
        sb = {k: torch.as_tensor(v) for k, v in make(tok.numpy()).items()}
        logits, state = tmod.decode_step(model, state, sb, impl=impl)
        got.append(to_np(logits))
    return np.concatenate(want, 1), np.concatenate(got, 1)
