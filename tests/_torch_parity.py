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
