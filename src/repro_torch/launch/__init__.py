"""Launchers of the port (port of ``repro.launch``): greedy serving and its
command line, ``python -m repro_torch.launch.serve``.  The names resolve
lazily, so running the module does not import it twice."""

__all__ = ["serve_greedy", "replay_batch", "main"]


def __getattr__(name):
    if name in __all__:
        from . import serve
        return getattr(serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
