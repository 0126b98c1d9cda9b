"""Launchers of the port (port of ``repro.launch``): greedy serving and its
command line, ``python -m repro_torch.launch.serve``, and LM training and
its command line, ``python -m repro_torch.launch.train``.  The names
resolve lazily, so running a module does not import it twice."""

_HOME = {"serve_greedy": "serve", "replay_batch": "serve", "main": "serve",
         "mapper_microbatch": "train", "make_local_train_step": "train",
         "train": "train"}

__all__ = list(_HOME)


def __getattr__(name):
    if name in _HOME:
        import importlib
        return getattr(importlib.import_module(f".{_HOME[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
