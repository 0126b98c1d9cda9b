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
from repro_torch.core import a2c, baselines, optimal, seq2seq
from repro_torch.configs import get_config
from repro_torch.kernels import _build, fusion_eval as fe
from repro_torch.launch import serve_greedy, train as launch_train
from repro_torch.models import encdec, hymba, lm, rwkv_lm
from repro_torch import serving
from repro_torch.workloads import tiny_cnn

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
     ROOT / "examples" / "quickstart_torch.py",
     ROOT / "examples" / "serve_mapper_torch.py",
     ROOT / "examples" / "serve_llm_torch.py",
     ROOT / "examples" / "train_with_mapper_torch.py",
     ROOT / "examples" / "transfer_new_workload_torch.py",
     ROOT / "tests" / "_torch_dist_workers.py"]
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
                                    "core.portfolio", "core.optimal",
                                    "core.baselines", "core.seq2seq",
                                    "core.a2c", "models.hymba",
                                    "models.encdec", "models.registry",
                                    "nn.moe", "nn.ssm", "nn.losses",
                                    "workloads.lm_workloads",
                                    "launch.serve", "launch.train", "data",
                                    "runtime", "optim.compression",
                                    "distributed", "distributed.pipeline",
                                    "launch.mesh", "launch.steps",
                                    "launch.dryrun", "launch.cost_analysis",
                                    "serving.replicas", "runtime.obs"])
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
    "launch.train": lambda: launch_train.train(
        "gemma3_1b", steps=1, ckpt_dir="/nonexistent"),
    "mapper_microbatch": lambda: launch_train.mapper_microbatch(
        get_config("gemma3_1b", reduced=True), seq_len=8, global_batch=2,
        act_budget_mb=8.0),
    "rwkv_lm.init": lambda: rwkv_lm.init(get_config("rwkv6_3b", reduced=True)),
    "rwkv_lm.init_decode_state": lambda: rwkv_lm.init_decode_state(
        get_config("rwkv6_3b", reduced=True), 1, 8),
    "serve_greedy rwkv6_3b": lambda: serve_greedy("rwkv6_3b", batch=1,
                                                  prompt_len=4, gen_len=2),
    "lm.init qwen3_moe_235b": lambda: lm.init(
        get_config("qwen3_moe_235b", reduced=True)),
    "hymba.init": lambda: hymba.init(get_config("hymba_15b", reduced=True)),
    "hymba.init_decode_state": lambda: hymba.init_decode_state(
        get_config("hymba_15b", reduced=True), 1, 8),
    "encdec.init": lambda: encdec.init(get_config("whisper_base",
                                                  reduced=True)),
    "encdec.init_decode_state": lambda: encdec.init_decode_state(
        get_config("whisper_base", reduced=True), 1, 8),
    "serve_greedy whisper_base": lambda: serve_greedy(
        "whisper_base", batch=1, prompt_len=64, gen_len=2),
    "serve_greedy qwen2_vl_72b": lambda: serve_greedy(
        "qwen2_vl_72b", batch=1, prompt_len=4, gen_len=2),
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
    "run_baseline": lambda: baselines.run_baseline(
        env.FusionEnv(tiny_cnn(), accel.PAPER_ACCEL, 32, 8 * MB, nmax=8),
        "PSO", budget=80),
    "a2c_search": lambda: a2c.a2c_search(
        env.FusionEnv(tiny_cnn(), accel.PAPER_ACCEL, 32, 8 * MB, nmax=8),
        budget=1),
    "optimal_mapping": lambda: optimal.optimal_mapping(
        env.FusionEnv(tiny_cnn(), accel.PAPER_ACCEL, 32, 8 * MB, nmax=8)),
    "optimal_grid": lambda: optimal.optimal_grid(
        [tiny_cnn()], [accel.PAPER_ACCEL], [32], [8 * MB], nmax=8),
    "s2s_init": lambda: seq2seq.s2s_init(seq2seq.S2SConfig(hidden=8,
                                                           max_steps=8)),
    "s2s_infer_fused": lambda: infer.s2s_infer_fused(
        seq2seq.s2s_init(seq2seq.S2SConfig(hidden=8, max_steps=8),
                         device=CPU),
        env.FusionEnv(tiny_cnn(), accel.PAPER_ACCEL, 32, 8 * MB, nmax=8)),
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


class _ThirdConfig:
    """A config class of a third mapper model."""


class _ThirdBackend:
    kind = "third"

    @staticmethod
    def forward(model, rtg, states, actions, hw=None):
        return actions

    @staticmethod
    def state_init(model, batch: int = 1):
        return {"t": 0}

    @staticmethod
    def prefill(model, state, r0, s0, hw=None):
        return r0, state

    @staticmethod
    def step(model, state, r_t, s_t, a_prev, hw=None):
        return a_prev, state


def test_register_backend_lets_a_third_model_ride():
    from repro_torch.core import backend
    cfg = _ThirdConfig()
    with pytest.raises(TypeError, match="no mapper backend"):
        backend.backend_for(cfg)
    saved = dict(backend._BACKENDS)
    try:
        backend.register_backend(_ThirdConfig, _ThirdBackend)
        assert backend.backend_for(cfg) is _ThirdBackend
        assert backend.backend_for(dtm.DTConfig()) is dtm.DTBackend
        assert backend.backend_for(seq2seq.S2SConfig()) is seq2seq.S2SBackend
        assert isinstance(_ThirdBackend, type)
        for fn in ("forward", "state_init", "prefill", "step"):
            assert hasattr(backend.MapperBackend, fn)
            assert callable(getattr(_ThirdBackend, fn))
    finally:
        backend._BACKENDS.clear()
        backend._BACKENDS.update(saved)


# names of ``repro.core.__all__`` the port leaves out (ROADMAP, "Not
# carried over": the XLA/Pallas evaluator switch, the JAX pytree forms of
# the hw row and the action codecs), and names only the port exports (its
# torch modules and tree helpers)
NOT_CARRIED = {"HwVec", "as_hw", "hw_from_array", "encode_action_jnp",
               "decode_action_jnp", "default_evaluator",
               "set_default_evaluator"}
PORT_ONLY = {"DT", "S2S", "param_tree", "load_param_tree",
             "naive_uniform_mb"}


def test_core_exports_the_reference_surface():
    import repro_torch.core as tcore
    ref_all = _reference_core_all()
    assert set(tcore.__all__) - PORT_ONLY == set(ref_all) - NOT_CARRIED
    assert len(tcore.__all__) == len(set(tcore.__all__))
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
    assert tcore.MapperEngine is serving.MapperEngine
    assert {"register_backend", "MapperBackend", "prefix_step",
            "env_step", "StrategyCache"} <= set(tcore.__all__)


def _reference_core_all():
    """``repro.core.__all__``, read from its source without importing the
    reference."""
    src = (ROOT / "src" / "repro" / "core" / "__init__.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("repro.core has no __all__")
