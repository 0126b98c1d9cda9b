"""The mapper core: conditions, cost model, environment, DT, G-Sampler,
the teacher corpus, training, inference, and the refiners (gradient
polish, the DE/CMA-ES portfolio)."""
from .accel import (ACCEL_ZOO, HW_FEATURE_DIM, HW_FIELDS, PAPER_ACCEL,
                    AccelConfig, accel_features, accel_from_features,
                    hw_array, stack_hw)
from .cost_model import (SYNC, CostOut, baseline_grid, baseline_no_fusion,
                         evaluate, evaluate_grid, evaluate_grid_stats,
                         evaluate_population, evaluate_population_stats,
                         pack_workload, prefix_scan, prefix_trace,
                         stack_workloads)
from .env import FusionEnv, decode_action, encode_action, returns_to_go
from .model import (DT, DTBackend, DTConfig, dt_apply, dt_cache_init,
                    dt_decode_step, dt_init, dt_loss, dt_prefill,
                    load_param_tree, param_tree)
from .backend import backend_for
from .infer import (InferResult, dnnfuser_infer, dnnfuser_infer_batch,
                    dnnfuser_infer_fused)
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

__all__ = ["ACCEL_ZOO", "HW_FEATURE_DIM", "HW_FIELDS", "PAPER_ACCEL",
           "AccelConfig", "accel_features", "accel_from_features",
           "hw_array", "stack_hw", "SYNC", "CostOut", "baseline_grid",
           "baseline_no_fusion", "evaluate", "evaluate_grid",
           "evaluate_grid_stats", "evaluate_population",
           "evaluate_population_stats", "pack_workload", "prefix_scan",
           "prefix_trace", "stack_workloads", "FusionEnv", "decode_action",
           "encode_action", "returns_to_go", "DT", "DTBackend", "DTConfig",
           "dt_apply", "dt_cache_init", "dt_decode_step", "dt_init",
           "dt_loss", "dt_prefill", "load_param_tree", "param_tree",
           "backend_for", "InferResult", "dnnfuser_infer",
           "dnnfuser_infer_batch", "dnnfuser_infer_fused", "GSamplerConfig",
           "GSamplerResult", "GridTeacherResult", "gsampler_search",
           "gsampler_search_grid", "naive_uniform_mb", "TrajectoryDataset",
           "collect_teacher_data", "generate_teacher_corpus",
           "merge_datasets", "window_dataset", "TrainConfig", "fine_tune",
           "make_train_step", "restore_params", "train_model",
           "PolishConfig", "PolishResult", "polish_grid", "polish_strategy",
           "PortfolioConfig", "PortfolioResult", "cmaes_search_grid",
           "de_search_grid"]
