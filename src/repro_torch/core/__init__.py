"""The mapper core: conditions, cost model, environment, DT, G-Sampler,
the teacher corpus, training, inference, the refiners (gradient polish,
the DE/CMA-ES portfolio), and the paper's yardsticks: the Table-1
baselines (black-box optimizers, A2C, the Seq2Seq mapper) and the exact
optimum with its f64 loop model."""
from .accel import (ACCEL_ZOO, HW_FEATURE_DIM, HW_FIELDS, PAPER_ACCEL,
                    AccelConfig, accel_features, accel_from_features,
                    hw_array, stack_hw)
from .cost_model import (SYNC, CostOut, PrefixCarry, PrefixConsts,
                         baseline_grid, baseline_no_fusion, evaluate,
                         evaluate_grid, evaluate_grid_stats,
                         evaluate_population, evaluate_population_stats,
                         finalize_groups, pack_workload, prefix_consts,
                         prefix_init, prefix_out, prefix_probe_peak,
                         prefix_scan, prefix_step, prefix_trace,
                         stack_workloads)
from .env import (STATE_DIM, EnvConsts, FusionEnv, decode_action,
                  encode_action, env_final, env_make, env_observe, env_reset,
                  env_step, returns_to_go)
from .model import (DT, DTBackend, DTConfig, dt_apply, dt_cache_init,
                    dt_decode_step, dt_init, dt_loss, dt_prefill,
                    load_param_tree, param_tree)
from .seq2seq import (S2S, S2SBackend, S2SConfig, s2s_apply,
                      s2s_decode_start, s2s_decode_step, s2s_encode,
                      s2s_init, s2s_loss, s2s_stream_init, s2s_stream_step)
from .backend import MapperBackend, backend_for, register_backend
from .infer import (InferResult, dnnfuser_infer, dnnfuser_infer_batch,
                    dnnfuser_infer_fused, s2s_infer, s2s_infer_fused)
from .baselines import BASELINE_METHODS, SearchResult, run_baseline
from .a2c import a2c_search
from .gsampler import (GSamplerConfig, GSamplerResult, GridTeacherResult,
                       gsampler_search, gsampler_search_grid,
                       naive_uniform_mb)
from .dataset import (TrajectoryDataset, collect_teacher_data,
                      generate_teacher_corpus, merge_datasets,
                      window_dataset)
from .train import (TrainConfig, fine_tune, make_train_step, restore_params,
                    train_model)
from .polish import PolishConfig, PolishResult, polish_grid, polish_strategy
from .portfolio import (PortfolioConfig, PortfolioResult, cmaes_search_grid,
                        de_search_grid)
from .optimal import (OptimalResult, brute_force_optimal,
                      enumerate_strategies, optimal_grid, optimal_mapping,
                      optimal_search, scaled_wl_np)

# The serving stack layers on top of core; its API is re-exported here,
# lazily (PEP 562), as the reference does: an eager import would cycle when
# ``repro_torch.serving`` is imported first.
_SERVING_API = ("MapperEngine", "MapRequest", "MapResponse", "StrategyCache",
                "AsyncMapperScheduler", "MapFuture", "AdmissionError",
                "ReplicaGroup", "ServingConfig", "DriftConfig",
                "DriftMonitor", "DriftReport", "RefreshWorker")


def __getattr__(name):
    if name in _SERVING_API:
        from .. import serving
        return getattr(serving, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ACCEL_ZOO", "HW_FEATURE_DIM", "HW_FIELDS", "PAPER_ACCEL",
           "AccelConfig", "accel_features", "accel_from_features",
           "hw_array", "stack_hw", "SYNC", "CostOut", "baseline_grid",
           "baseline_no_fusion", "evaluate", "evaluate_grid",
           "evaluate_grid_stats", "evaluate_population",
           "evaluate_population_stats", "finalize_groups", "pack_workload",
           "PrefixConsts", "PrefixCarry", "prefix_consts", "prefix_init",
           "prefix_step", "prefix_out", "prefix_probe_peak", "prefix_scan",
           "prefix_trace", "stack_workloads", "FusionEnv", "STATE_DIM",
           "decode_action", "encode_action", "EnvConsts", "env_make",
           "env_reset", "env_observe", "env_step", "env_final",
           "returns_to_go", "DT", "DTBackend", "DTConfig",
           "dt_apply", "dt_cache_init", "dt_decode_step", "dt_init",
           "dt_loss", "dt_prefill", "load_param_tree", "param_tree",
           "S2S", "S2SBackend", "S2SConfig", "s2s_apply", "s2s_decode_start",
           "s2s_decode_step", "s2s_encode", "s2s_init", "s2s_loss",
           "s2s_stream_init", "s2s_stream_step", "MapperBackend",
           "backend_for", "register_backend",
           "InferResult", "dnnfuser_infer",
           "dnnfuser_infer_batch", "dnnfuser_infer_fused", "s2s_infer",
           "s2s_infer_fused", "BASELINE_METHODS", "SearchResult",
           "run_baseline", "a2c_search", "GSamplerConfig",
           "GSamplerResult", "GridTeacherResult", "gsampler_search",
           "gsampler_search_grid", "naive_uniform_mb", "TrajectoryDataset",
           "collect_teacher_data", "generate_teacher_corpus",
           "merge_datasets", "window_dataset", "TrainConfig", "fine_tune",
           "make_train_step", "restore_params", "train_model",
           "PolishConfig", "PolishResult", "polish_grid", "polish_strategy",
           "PortfolioConfig", "PortfolioResult", "cmaes_search_grid",
           "de_search_grid", "OptimalResult", "brute_force_optimal",
           "enumerate_strategies", "optimal_grid", "optimal_mapping",
           "optimal_search", "scaled_wl_np", *_SERVING_API]
