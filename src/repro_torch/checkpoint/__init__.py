"""Checkpoints in the reference's format (numpy + torch only): a writer,
a reader and the ``Checkpointer``, and the functions that carry the
reference's DT and LM weights into the port."""
from .checkpointer import (Checkpointer, restore_pytree, restore_subtree,
                           save_pytree, upgrade_pytree)
from .reference import (dt_params_from_reference, load_reference,
                        lm_params_from_reference)

__all__ = ["Checkpointer", "save_pytree", "restore_pytree",
           "restore_subtree", "upgrade_pytree", "load_reference",
           "dt_params_from_reference", "lm_params_from_reference"]
