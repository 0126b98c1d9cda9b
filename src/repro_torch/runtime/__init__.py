"""The fault-tolerant training runtime (port of ``repro.runtime``) and the
port's spans and counters (``obs``).  The training names resolve lazily,
so the layers that import ``obs`` do not import the training loop."""

_HOME = {"TrainLoop": "fault_tolerance", "StragglerMonitor":
         "fault_tolerance"}

__all__ = list(_HOME) + ["obs"]


def __getattr__(name):
    if name in _HOME:
        import importlib
        return getattr(importlib.import_module(f".{_HOME[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
