"""Launchers of the port (port of ``repro.launch``): greedy serving and its
command line, ``python -m repro_torch.launch.serve``; LM training and its
command line, ``python -m repro_torch.launch.train``; the device meshes
(``mesh``), the step builders that run a cell on a mesh (``steps``), and
the dry-run of every cell's per-device budget on the production meshes,
``python -m repro_torch.launch.dryrun`` (``cost_analysis`` prices it).
The names resolve lazily, so running a module does not import it
twice."""

_HOME = {"serve_greedy": "serve", "replay_batch": "serve", "main": "serve",
         "mapper_microbatch": "train", "make_local_train_step": "train",
         "train": "train", "build_train_step": "steps",
         "build_prefill": "steps", "build_decode_step": "steps",
         "make_production_mesh": "mesh", "init_mesh": "mesh",
         "process_group": "mesh", "lower_cell": "dryrun"}

__all__ = list(_HOME)


def __getattr__(name):
    if name in _HOME:
        import importlib
        return getattr(importlib.import_module(f".{_HOME[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
