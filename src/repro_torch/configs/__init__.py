"""Assigned architecture configs (+ shape grid); a copy of ``repro.configs``.

Each ``<arch>.py`` defines ``CONFIG`` with the exact published parameters;
``get_config(name)`` returns it, ``get_config(name, reduced=True)`` returns
the same-family smoke-test reduction.  ``SHAPES`` is the assigned input-
shape grid; ``cells()`` enumerates the (arch x shape) dry-run cells with the
DESIGN §5 long_500k skip policy applied.  ``PORT_NAMES`` are the port's own
configs (``moonlight_16b_a3b``), which ``get_config`` resolves outside that
grid.
"""
from .base import (ArchConfig, Shape, SHAPES, ARCH_NAMES, PORT_NAMES,
                   get_config, cells)

__all__ = ["ArchConfig", "Shape", "SHAPES", "ARCH_NAMES", "PORT_NAMES",
           "get_config", "cells"]
