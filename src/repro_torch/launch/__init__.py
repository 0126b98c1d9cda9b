"""Launchers of the port (port of ``repro.launch``): greedy serving."""
from .serve import serve_greedy

__all__ = ["serve_greedy"]
