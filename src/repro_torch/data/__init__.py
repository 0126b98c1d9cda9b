"""The synthetic-LM data pipeline (port of ``repro.data``, numpy only)."""
from .pipeline import Prefetcher, SyntheticLM, make_batch_iterator

__all__ = ["SyntheticLM", "Prefetcher", "make_batch_iterator"]
