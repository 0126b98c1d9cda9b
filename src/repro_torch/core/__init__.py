"""The mapper core: conditions, cost model, environment, DT, G-Sampler."""
from .accel import (ACCEL_ZOO, HW_FEATURE_DIM, HW_FIELDS, PAPER_ACCEL,
                    AccelConfig, accel_features, accel_from_features,
                    hw_array, stack_hw)
from .cost_model import (SYNC, CostOut, baseline_grid, baseline_no_fusion,
                         evaluate, evaluate_grid, evaluate_grid_stats,
                         evaluate_population, evaluate_population_stats,
                         pack_workload, stack_workloads)
from .env import FusionEnv, decode_action, encode_action
from .model import (DT, DTBackend, DTConfig, dt_apply, dt_cache_init,
                    dt_decode_step, dt_init, dt_prefill)
from .backend import backend_for
from .infer import InferResult, dnnfuser_infer_batch, dnnfuser_infer_fused
from .gsampler import GSamplerConfig, GridTeacherResult, gsampler_search_grid

__all__ = ["ACCEL_ZOO", "HW_FEATURE_DIM", "HW_FIELDS", "PAPER_ACCEL",
           "AccelConfig", "accel_features", "accel_from_features",
           "hw_array", "stack_hw", "SYNC", "CostOut", "baseline_grid",
           "baseline_no_fusion", "evaluate", "evaluate_grid",
           "evaluate_grid_stats", "evaluate_population",
           "evaluate_population_stats", "pack_workload", "stack_workloads",
           "FusionEnv", "decode_action", "encode_action", "DT", "DTBackend",
           "DTConfig", "dt_apply", "dt_cache_init", "dt_decode_step",
           "dt_init", "dt_prefill", "backend_for", "InferResult",
           "dnnfuser_infer_batch", "dnnfuser_infer_fused", "GSamplerConfig",
           "GridTeacherResult", "gsampler_search_grid"]
