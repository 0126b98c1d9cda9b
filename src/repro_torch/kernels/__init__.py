"""Hand-written CUDA kernels of the port, each with its plain PyTorch twin.

``fusion_eval`` (``csrc/fusion_eval.cu``) replaces the reference's Pallas
``_fe_kernel``.  Sources are built with ``nvcc`` at first use
(``_build``); importing this package builds nothing."""
from .fusion_eval import (backend_stats, compiled_backend_supported,
                          fusion_eval_grid, fusion_eval_grid_stats,
                          fusion_eval_grid_stats_plain, reset_launches)

__all__ = ["fusion_eval_grid", "fusion_eval_grid_stats",
           "fusion_eval_grid_stats_plain", "compiled_backend_supported",
           "backend_stats", "reset_launches"]
