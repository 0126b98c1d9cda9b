"""Hand-written optimizers and learning-rate schedules."""
from .adamw import (AdamWState, GradientTransformation, SGDState,
                    accumulated_value_and_grad, adamw, apply_updates,
                    clip_by_global_norm, global_norm, sgd, value_and_grad)
from .schedule import constant, cosine_with_warmup, linear_warmup

__all__ = ["AdamWState", "GradientTransformation", "SGDState", "adamw",
           "sgd", "apply_updates", "global_norm", "clip_by_global_norm",
           "value_and_grad", "accumulated_value_and_grad",
           "cosine_with_warmup", "constant", "linear_warmup"]
