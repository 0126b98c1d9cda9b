"""Port parity: ``workloads.lm_workloads`` (the LM archs as fusion chains)
against the JAX reference.

Every ``Layer`` field and the ``Workload``'s own fields equal the
reference's for all ten configs in train, prefill and decode; a
``FusionEnv`` built on one (the PAPER_ACCEL condition of
``benchmarks/lm_mapping.py``, at a small search) is searched equally by
both packages' host G-Samplers: the same strategy and elites, costs
within rtol 1e-5 (the cost models agree in f32, not bit for bit).
"""
import dataclasses

import numpy as np
import pytest

from _torch_parity import CPU, MB
from repro import configs as jconfigs
from repro.core import env as jenv, gsampler as jgs
from repro.core.accel import PAPER_ACCEL as JACCEL
from repro.workloads.lm_workloads import lm_workload as jlm_workload
from repro_torch import configs as tconfigs
from repro_torch.core import accel as taccel, env as tenv, gsampler as tgs
from repro_torch.workloads import lm_workload


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_lm_workload_equals_reference(name, mode):
    want = jlm_workload(jconfigs.get_config(name), seq_len=4096, batch=32,
                        mode=mode)
    got = lm_workload(tconfigs.get_config(name), seq_len=4096, batch=32,
                      mode=mode)
    assert (got.name, got.input_elems, tuple(got.input_shape6),
            got.default_batch) == (want.name, want.input_elems,
                                   tuple(want.input_shape6),
                                   want.default_batch)
    assert [dataclasses.asdict(l) for l in got.layers] == \
        [dataclasses.asdict(l) for l in want.layers]
    assert got.n == want.n and got.n == len(want.layers)


@pytest.mark.parametrize("name,budget", [("qwen3_moe_235b", 48.0),
                                         ("hymba_15b", 48.0),
                                         ("whisper_base", 4.0)])
def test_lm_chain_searched_equally(name, budget):
    j = jenv.FusionEnv(jlm_workload(jconfigs.get_config(name),
                                    seq_len=4096, batch=32,
                                    mode="prefill"),
                       JACCEL, 32, budget * MB, nmax=128)
    t = tenv.FusionEnv(lm_workload(tconfigs.get_config(name), seq_len=4096,
                                   batch=32, mode="prefill"),
                       taccel.PAPER_ACCEL, 32, budget * MB, nmax=128,
                       device=CPU)
    cfg = dict(population=10, generations=4, repair_tries=3, seed=0)
    a = jgs.gsampler_search(j, jgs.GSamplerConfig(**cfg), top_k=4)
    b = tgs.gsampler_search(t, tgs.GSamplerConfig(**cfg), top_k=4)
    np.testing.assert_array_equal(b.strategy, a.strategy)
    for x, y in zip(b.elites, a.elites, strict=True):
        np.testing.assert_array_equal(x, y)
    assert b.valid == a.valid and b.n_evals == a.n_evals
    np.testing.assert_allclose([b.speedup, b.latency, b.peak_mem],
                               [a.speedup, a.latency, a.peak_mem],
                               rtol=1e-5)
