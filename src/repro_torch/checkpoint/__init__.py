"""Reference-checkpoint reader and weight conversion (numpy + torch only)."""
from .reference import (dt_params_from_reference, load_reference,
                        lm_params_from_reference)

__all__ = ["load_reference", "dt_params_from_reference",
           "lm_params_from_reference"]
