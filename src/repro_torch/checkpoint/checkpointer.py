"""Checkpoints in the reference's format (port of
``repro.checkpoint.checkpointer``, numpy + torch only).

A checkpoint is a directory of ``leaf_<i>.npy`` files plus ``meta.json``:
``{"leaves": {path: {"file", "shape", "dtype"}}, "digest": sha256}``.
Paths join the tree's keys with ``/``: a dict key as it is, a list index
as its number, a NamedTuple field as ``.<field>`` (``opt_state/.mu/
blocks/0/attn/q/w``), as JAX's key paths print.  Leaves are numbered in
sorted path order, and the digest hashes each path and the first MiB of
its array's bytes in that order, so a tree written here and the same tree
written by the reference are the same files.  A bf16 leaf is stored as
f32 under its logical dtype.

Properties kept from the reference: writes are atomic (``.tmp_<name>``
renamed into place), ``Checkpointer.save_async`` snapshots to host memory
at once and writes in a background thread, and the checkpointer keeps the
last ``keep`` steps.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import threading

import numpy as np
import torch

__all__ = ["Checkpointer", "save_pytree", "restore_pytree",
           "restore_subtree", "upgrade_pytree"]


def _children(node):
    """``[(key, child)]`` of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree) -> dict:
    """``{path: leaf}`` of ``tree``."""
    keyed = {}

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            keyed["/".join(path)] = node
            return
        for k, child in kids:
            walk(child, path + (str(k),))

    walk(tree, ())
    return keyed


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as stored, and its logical dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        logical = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy(), logical
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _digest(items) -> str:
    digest = hashlib.sha256()
    for key, arr in items:
        digest.update(key.encode())
        digest.update(arr.tobytes()[: 1 << 20])   # first MiB per leaf
    return digest.hexdigest()


def _snapshot(tree) -> dict:
    """``{path: (host array, logical dtype)}``: what a save writes."""
    return {k: _host(v) for k, v in _flatten(tree).items()}


def _write(snap: dict, path: pathlib.Path) -> None:
    path = pathlib.Path(path)
    tmp = path.parent / f".tmp_{path.name}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {}
    items = sorted(snap.items())
    for i, (key, (arr, logical)) in enumerate(items):
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest[key] = {"file": fname, "shape": list(arr.shape),
                         "dtype": logical}
    (tmp / "meta.json").write_text(json.dumps(
        {"leaves": manifest,
         "digest": _digest((k, a) for k, (a, _) in items)}, indent=1))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)


def save_pytree(tree, path) -> None:
    """Atomic synchronous save of one tree (dicts, lists, NamedTuples;
    leaves are tensors, arrays or numbers)."""
    _write(_snapshot(tree), pathlib.Path(path))


def _rebuild(arrays: dict, template, prefix: str = ""):
    """``template``'s structure filled from ``arrays`` (keyed by path
    under ``prefix``): tensors take the template leaf's dtype and device,
    arrays and numbers its numpy type."""
    def build(node, path):
        kids = _children(node)
        if kids is None:
            key = "/".join(path)
            if key not in arrays:
                raise KeyError(f"checkpoint has no leaf {key}")
            arr = arrays[key]
            if isinstance(node, torch.Tensor):
                return torch.as_tensor(arr).to(dtype=node.dtype,
                                               device=node.device)
            return np.asarray(arr, dtype=np.asarray(node).dtype)
        built = [(k, build(child, path + (str(k),))) for k, child in kids]
        if isinstance(node, dict):
            return dict(built)
        if hasattr(node, "_fields"):
            return type(node)(*(v for _, v in built))
        return type(node)(v for _, v in built)

    return build(template, tuple(p for p in prefix.split("/") if p))


def restore_pytree(path, template=None, *, verify: bool = True):
    """Restore a checkpoint; with ``template`` its structure and leaf types
    are rebuilt (the checkpoint must hold exactly its leaves), otherwise a
    flat ``{path: ndarray}`` dict is returned.  Raises ``IOError`` when
    ``verify`` and the digest does not match."""
    path = pathlib.Path(path)
    meta = json.loads((path / "meta.json").read_text())
    arrays = {key: np.load(path / meta["leaves"][key]["file"])
              for key in sorted(meta["leaves"])}
    if verify and _digest(arrays.items()) != meta["digest"]:
        raise IOError(f"checkpoint {path} failed digest verification")
    if template is None:
        return arrays
    want = set(_flatten(template))
    if want != set(arrays):
        raise KeyError(f"checkpoint/template mismatch: "
                       f"{sorted(want ^ set(arrays))}")
    return _rebuild(arrays, template)


def restore_subtree(path, prefix: str, template, *, verify: bool = True):
    """Restore only the leaves under ``<prefix>/`` into ``template``'s
    structure (e.g. the params of a {params, opt_state} checkpoint)."""
    return _rebuild(restore_pytree(path, None, verify=verify), template,
                    prefix)


def upgrade_pytree(path, template, *, prefix: str | None = None,
                   verify: bool = True):
    """Restore a checkpoint into a possibly NEWER architecture ``template``
    (e.g. ``model.param_tree`` of a DT): leaves present in the checkpoint
    restore as usual; leaves it lacks (e.g. the hw-condition embedding
    ``emb_h`` of a ``DTConfig(hw_dim>0)`` model) are ZERO-filled in the
    template leaf's shape, dtype and device.  The hw embedding enters
    additively, so a zero-filled upgrade answers as the old mapper did
    until fine-tuned.  ``prefix`` selects a subtree (``"params"`` of a
    {params, opt_state} training checkpoint).  Returns ``(tree,
    missing_keys)``; checkpoint leaves the template does not reference are
    ignored, and a leaf whose shape differs from the template's raises
    (an upgrade only ADDS leaves)."""
    arrays = restore_pytree(path, None, verify=verify)
    if prefix is not None:
        pre = f"{prefix}/"
        arrays = {k[len(pre):]: v for k, v in arrays.items()
                  if k.startswith(pre)}
    missing, sub = [], {}
    for k, leaf in _flatten(template).items():
        want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else np.shape(leaf)
        if k in arrays:
            if tuple(arrays[k].shape) != tuple(want):
                raise ValueError(
                    f"checkpoint leaf {k} has shape {arrays[k].shape} but "
                    f"the template expects {tuple(want)}; upgrade_pytree "
                    f"only fills leaves the checkpoint lacks")
            sub[k] = arrays[k]
        else:
            missing.append(k)
            sub[k] = np.zeros(want, np.float32)
    return _rebuild(sub, template), missing


class Checkpointer:
    """Step-indexed checkpoint manager with async save and keep-last-k."""

    def __init__(self, root, keep: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None

    def _dir(self, step: int) -> pathlib.Path:
        return self.root / f"ckpt_{step:08d}"

    def path(self, step: int | None = None) -> pathlib.Path:
        """Directory of checkpoint ``step`` (default: the latest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        return self._dir(step)

    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.root.iterdir()
                      if p.name.startswith("ckpt_"))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def _gc(self):
        for step in self.steps()[: -self.keep]:
            shutil.rmtree(self._dir(step), ignore_errors=True)

    def save(self, step: int, tree):
        self.wait()
        save_pytree(tree, self._dir(step))
        self._gc()

    def save_async(self, step: int, tree):
        """Snapshot to host now; write in the background."""
        self.wait()
        snap = _snapshot(tree)

        def _run():
            try:
                _write(snap, self._dir(step))
                self._gc()
            except Exception as e:          # re-raised by wait()
                self._error = e
        self._pending = threading.Thread(target=_run, daemon=True)
        self._pending.start()

    def wait(self):
        """Join the background write; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template=None, step: int | None = None):
        """``(step, tree)`` of checkpoint ``step`` (default: the latest), or
        ``(None, None)`` when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return step, restore_pytree(self._dir(step), template)
