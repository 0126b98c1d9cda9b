"""Hygiene of the PyTorch port: it imports neither JAX nor the reference
package, its entry points refuse to run on the CPU unless asked, and the
kernel wrappers raise on what the kernels do not take."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import CPU, MB
import repro_torch
from repro_torch.core import accel, cost_model as cm, dataset, env, gsampler
from repro_torch.core import infer, model as dtm, polish, portfolio, train
from repro_torch.configs import get_config
from repro_torch.kernels import _build, fusion_eval as fe
from repro_torch.launch import serve_greedy
from repro_torch.models import lm, rwkv_lm
from repro_torch import serving
from repro_torch.workloads import tiny_cnn

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
     ROOT / "examples" / "quickstart_torch.py",
     ROOT / "examples" / "serve_mapper_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "_torch_parity")


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("module", ["nn", "models.lm", "kernels.flash_attention",
                                    "kernels.fusion_eval", "core", "launch",
                                    "models.rwkv_lm", "kernels.rwkv6_scan",
                                    "optim", "checkpoint", "core.train",
                                    "core.dataset", "serving", "core.polish",
                                    "core.portfolio"])
def test_each_layer_imports_first(module):
    """``nn`` imports the attention kernels, and ``kernels.fusion_eval``
    imports ``core``, whose DT imports ``nn``: each must import first in a
    fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", f"import repro_torch.{module}"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_tf32_is_off_after_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_resolve_device():
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.resolve_device()


_TINY_DT = dtm.DTConfig(n_blocks=1, d_model=8, d_ff=8, max_steps=8)


def _tiny_dataset():
    z = np.zeros((2, 8), np.float32)
    return dataset.TrajectoryDataset(z, np.zeros((2, 8, 8), np.float32), z,
                                     z + 1.0)


_ENTRY_POINTS = {
    "pack_workload": lambda: cm.pack_workload(tiny_cnn(), accel.PAPER_ACCEL),
    "FusionEnv": lambda: env.FusionEnv(tiny_cnn(), accel.PAPER_ACCEL, 32,
                                       8 * MB),
    "dt_init": lambda: dtm.dt_init(dtm.DTConfig(n_blocks=1, d_model=8,
                                                d_ff=8, max_steps=8)),
    "gsampler_search_grid": lambda: gsampler.gsampler_search_grid(
        [tiny_cnn()], accel.PAPER_ACCEL, [32], [8 * MB], nmax=8,
        cfg=gsampler.GSamplerConfig(population=4, generations=1)),
    "dnnfuser_infer_batch": lambda: infer.dnnfuser_infer_batch(
        dtm.dt_init(dtm.DTConfig(n_blocks=1, d_model=8, d_ff=8,
                                 max_steps=8), device=CPU),
        cm.pack_workload(tiny_cnn(), accel.PAPER_ACCEL, 8, device=CPU),
        [32], [8 * MB], accel.PAPER_ACCEL),
    "compiled_backend_supported": fe.compiled_backend_supported,
    "gsampler_search": lambda: gsampler.gsampler_search(
        env.FusionEnv(tiny_cnn(), accel.PAPER_ACCEL, 32, 8 * MB, nmax=8),
        gsampler.GSamplerConfig(population=4, generations=1)),
    "naive_uniform_mb": lambda: gsampler.naive_uniform_mb(
        env.FusionEnv(tiny_cnn(), accel.PAPER_ACCEL, 32, 8 * MB, nmax=8)),
    "generate_teacher_corpus": lambda: dataset.generate_teacher_corpus(
        [tiny_cnn()], accel.PAPER_ACCEL, budgets_mb=[8.0], max_steps=8,
        ga_cfg=gsampler.GSamplerConfig(population=4, generations=1)),
    "collect_teacher_data": lambda: dataset.collect_teacher_data(
        [tiny_cnn()], accel.PAPER_ACCEL, 32, [8.0], max_steps=8,
        ga_cfg=gsampler.GSamplerConfig(population=4, generations=1)),
    "train_model": lambda: train.train_model(
        dtm.dt_loss, dtm.dt_init(_TINY_DT, device=CPU), _tiny_dataset(),
        train.TrainConfig(steps=1, batch_size=2)),
    "fine_tune": lambda: train.fine_tune(
        dtm.dt_loss, dtm.dt_init(_TINY_DT, device=CPU), _tiny_dataset(),
        train.TrainConfig(steps=1, batch_size=2)),
    "dnnfuser_infer": lambda: infer.dnnfuser_infer(
        dtm.dt_init(_TINY_DT, device=CPU),
        env.FusionEnv(tiny_cnn(), accel.PAPER_ACCEL, 32, 8 * MB, nmax=8)),
    "lm.init": lambda: lm.init(get_config("qwen3_8b", reduced=True)),
    "lm.init_decode_state": lambda: lm.init_decode_state(
        get_config("qwen3_8b", reduced=True), 1, 8),
    "serve_greedy": lambda: serve_greedy("qwen3_8b", batch=1, prompt_len=4,
                                         gen_len=2),
    "rwkv_lm.init": lambda: rwkv_lm.init(get_config("rwkv6_3b", reduced=True)),
    "rwkv_lm.init_decode_state": lambda: rwkv_lm.init_decode_state(
        get_config("rwkv6_3b", reduced=True), 1, 8),
    "serve_greedy rwkv6_3b": lambda: serve_greedy("rwkv6_3b", batch=1,
                                                  prompt_len=4, gen_len=2),
    "MapperEngine": lambda: serving.MapperEngine(
        dtm.dt_init(_TINY_DT, device=CPU)),
    "serve": lambda: repro_torch.serve(dtm.dt_init(_TINY_DT, device=CPU)),
    "polish_grid": lambda: polish.polish_grid(
        cm.stack_workloads([cm.pack_workload(tiny_cnn(), accel.PAPER_ACCEL, 8,
                                             device=CPU)]),
        np.full((1, 8), 4, np.int32), [32.0], [8 * MB], accel.PAPER_ACCEL),
    "de_search_grid": lambda: portfolio.de_search_grid(
        [tiny_cnn()], accel.PAPER_ACCEL, [32.0], [8 * MB], nmax=8,
        cfg=portfolio.PortfolioConfig(population=4, generations=1)),
    "cmaes_search_grid": lambda: portfolio.cmaes_search_grid(
        [tiny_cnn()], accel.PAPER_ACCEL, [32.0], [8 * MB], nmax=8,
        cfg=portfolio.PortfolioConfig(population=4, generations=1)),
    "RefreshWorker": lambda: serving.RefreshWorker(serving.MapperEngine(
        dtm.dt_init(_TINY_DT, device=CPU))).refresh(
            [tiny_cnn()], [accel.PAPER_ACCEL], [8.0]),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_refuse_to_run_on_cpu_unasked(name):
    """Without a card and without device="cpu", an entry point raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError):
        _ENTRY_POINTS[name]()


def _small_args():
    wl = cm.stack_workloads([cm.pack_workload(tiny_cnn(), accel.PAPER_ACCEL,
                                              8, device=CPU)] * 2)
    rng = np.random.default_rng(0)
    s = torch.as_tensor(np.stack([np.stack([
        cm.random_strategy(rng, 6, 8, 32) for _ in range(3)])] * 2))
    return wl, s


def test_wrapper_rejects_what_the_kernel_does_not_take():
    wl, s = _small_args()
    fe.kernel_args(wl, s, [32.0, 32.0], accel.PAPER_ACCEL)   # accepted
    with pytest.raises(TypeError):
        fe.kernel_args(wl, s.long(), [32.0, 32.0], accel.PAPER_ACCEL)
    with pytest.raises(ValueError):
        fe.kernel_args(wl, s.transpose(1, 2).contiguous().transpose(1, 2),
                       [32.0, 32.0], accel.PAPER_ACCEL)
    with pytest.raises(ValueError):
        fe.kernel_args(wl, s, [32.0], accel.PAPER_ACCEL)
    bad = dict(wl, A=wl["A"].double())
    with pytest.raises(TypeError):
        fe.kernel_args(bad, s, [32.0, 32.0], accel.PAPER_ACCEL)
    with pytest.raises(KeyError):
        fe.kernel_args({k: v for k, v in wl.items() if k != "BPE"}, s,
                       [32.0, 32.0], accel.PAPER_ACCEL)


def test_cpu_wrapper_runs_plain_twin_and_counts_no_launch():
    wl, s = _small_args()
    before = fe.STATS.launches
    out, gid, M_g = fe.fusion_eval_grid_stats(wl, s, [32.0, 32.0],
                                              [8 * MB, 8 * MB],
                                              accel.PAPER_ACCEL)
    assert fe.STATS.launches == before
    assert out.latency.shape == (2, 3) and gid.dtype == torch.int32
    raw = fe.fusion_eval_raw(*fe.kernel_args(wl, s, [32.0, 32.0],
                                             accel.PAPER_ACCEL))
    assert torch.equal(raw[3], M_g)


def test_build_targets_hopper_without_fma_contraction():
    """Every source targets sm_90a; the kernels held bit for bit (or at f32
    tolerances) to their plain twins forbid FMA contraction, while
    flash_attention, whose bf16 path is held to a looser gate, allows it."""
    for src in ("fusion_eval", "flash_decode", "wkv6", "flash_attention"):
        flags = " ".join(_build.flags(src))
        assert "arch=compute_90a,code=sm_90a" in flags
        assert ("-fmad=false" in flags) == (src != "flash_attention")
        assert "-lcuda" not in flags
    for src in ("fusion_eval", "flash_attention", "flash_decode", "wkv6"):
        assert (_build.CSRC / f"{src}.cu").is_file()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")
