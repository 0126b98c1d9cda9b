"""Checks of the port that need a CUDA card: the ``fusion_eval`` kernel
against its plain twin, and the main path through it.  Each skips without
a card (decided inside the fixture, never at import); on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import MB
from repro_torch.core import accel, cost_model as cm, gsampler as gs
from repro_torch.kernels import fusion_eval as fe
from repro_torch.workloads import resnet18, tiny_cnn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fe.compiled_backend_supported()
    return torch.device("cuda", torch.cuda.current_device())


def _grid(dev, pop):
    parts = sorted(accel.ACCEL_ZOO)
    ws = [resnet18(), tiny_cnn()]
    wl = cm.stack_workloads([cm.pack_workload(w, accel.PAPER_ACCEL, 32,
                                              device=dev)
                             for w in ws for _ in parts])
    hw = [accel.ACCEL_ZOO[p] for _ in ws for p in parts]
    rng = np.random.default_rng(0)
    s = torch.as_tensor(np.stack([np.stack([
        cm.random_strategy(rng, w.n, 32, 32, p_sync=0.3)
        for _ in range(pop)]) for w in ws for _ in parts]), device=dev)
    return wl, s, hw


@pytest.mark.parametrize("pop", [1, 40, 131])
def test_kernel_bit_equal_to_plain_twin(dev, pop):
    wl, s, hw = _grid(dev, pop)
    args = fe.kernel_args(wl, s, torch.full((s.shape[0],), 32.0, device=dev),
                          hw)
    before = fe.STATS.launches
    got = fe.fusion_eval_raw(*args)
    assert fe.STATS.launches == before + 1
    want = fe.fusion_eval_grid_stats_plain(*args)
    mask = wl["mask"][:, None, :].expand_as(got[6])
    assert torch.equal(got[6][mask], want[6][mask])
    for g, w in zip(got[:6], want[:6]):
        assert torch.equal(g, w)


def test_gsampler_on_card_is_deterministic_and_uses_kernel(dev):
    cfg = gs.GSamplerConfig(population=16, generations=5, seed=2)
    ws = [tiny_cnn(), resnet18()]
    fe.reset_launches()
    a = gs.gsampler_search_grid(ws, accel.PAPER_ACCEL, [32, 32],
                                [2 * MB, 8 * MB], nmax=32, cfg=cfg,
                                device=dev)
    assert fe.STATS.launches == 18 + 5 * (1 + cfg.repair_tries) + 1
    b = gs.gsampler_search_grid(ws, accel.PAPER_ACCEL, [32, 32],
                                [2 * MB, 8 * MB], nmax=32, cfg=cfg,
                                device=dev)
    np.testing.assert_array_equal(a.strategies, b.strategies)
    assert a.valid[:, 0].all()
