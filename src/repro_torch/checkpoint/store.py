"""Fault-tolerant checkpointing: atomic, async, integrity-checked, keep-k.

Port of ``repro/checkpoint/store.py``, with the same on-disk format: one
``leaf_<i>.npy`` a leaf and a ``manifest.json`` of SHA-256 digests, so a
checkpoint written by the reference's store restores here, and back.

* **Atomic**: write to ``step_<n>.tmp/`` then ``os.replace`` to
  ``step_<n>/``: a crash mid-write never corrupts the latest checkpoint.
* **Async**: ``save_async`` copies every leaf to host memory now (the step
  loop stalls only for the copy) and serialises on a background thread.
* **Integrity**: ``restore`` verifies each leaf's SHA-256 before reading
  it and falls back to the previous checkpoint on a mismatch (torn
  writes, bit rot).
* **Keep-k**: old checkpoints are removed after a successful write.

A tree is any nesting of dicts, lists, tuples and NamedTuples whose leaves
are tensors, numpy arrays or scalars; ``None`` holds no leaf.  Leaves are
numbered in the reference's order: dict keys sorted, sequences in order.
``restore(..., device=...)`` puts the leaves that are tensors in the
template on that device (the reference's ``sharding_tree`` re-lays them
out for a mesh; re-sharding over several cards waits for the port of
``parallel/``).
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch


def _flatten(tree):
    """(leaves, structure) of ``tree``; ``_unflatten`` inverts it."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, subs = [], []
        for k in keys:
            lv, st = _flatten(tree[k])
            leaves += lv
            subs.append(st)
        return leaves, ("dict", keys, subs)
    if isinstance(tree, (list, tuple)):
        leaves, subs = [], []
        for item in tree:
            lv, st = _flatten(item)
            leaves += lv
            subs.append(st)
        kind = type(tree) if hasattr(tree, "_fields") else type(tree).__name__
        return leaves, ("seq", kind, subs)
    return [tree], "leaf"


def _unflatten(structure, leaves):
    it = iter(leaves)

    def build(st):
        if st is None:
            return None
        if st == "leaf":
            return next(it)
        if st[0] == "dict":
            return {k: build(sub) for k, sub in zip(st[1], st[2])}
        kind, items = st[1], [build(sub) for sub in st[2]]
        if kind == "list":
            return items
        if kind == "tuple":
            return tuple(items)
        return kind(*items)                       # a NamedTuple class

    return build(structure)


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf``: never a view, so a slab updated in place
    after ``save_async`` returns (a CPU tensor, a numpy array) cannot
    change what is written."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


class CheckpointStore:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree) -> None:
        self._write(step, [_to_host(x) for x in _flatten(tree)[0]])

    def save_async(self, step: int, tree) -> None:
        """Copy to host now; serialise in the background."""
        self.wait()
        if self._error:
            raise self._error
        host_leaves = [_to_host(x) for x in _flatten(tree)[0]]
        self._thread = threading.Thread(target=self._write_guarded, args=(step, host_leaves))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write_guarded(self, step: int, leaves) -> None:
        try:
            self._write(step, leaves)
        except Exception as e:  # noqa: BLE001 — surfaced on the next save
            self._error = e

    def _write(self, step: int, leaves) -> None:
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, leaf in enumerate(leaves):
            name = _leaf_name(i)
            path = tmp / name
            with open(path, "wb") as f:
                np.save(f, leaf, allow_pickle=False)
            digest = hashlib.sha256(path.read_bytes()).hexdigest()
            manifest["leaves"].append(
                {"name": name, "sha256": digest, "shape": list(leaf.shape),
                 "dtype": str(leaf.dtype)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not p.is_dir():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _verify(self, step: int) -> list[np.ndarray] | None:
        d = self.dir / f"step_{step:010d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
        except (OSError, json.JSONDecodeError):
            return None
        leaves = []
        for entry in manifest["leaves"]:
            path = d / entry["name"]
            if not path.exists():
                return None
            if hashlib.sha256(path.read_bytes()).hexdigest() != entry["sha256"]:
                return None
            leaves.append(np.load(path, allow_pickle=False))
        return leaves

    def restore(self, tree_like, *, step: int | None = None, device=None):
        """Restore into the structure of ``tree_like``.

        Walks back through older checkpoints if the newest fails integrity.
        Leaves come back as numpy arrays; with ``device``, those whose
        counterpart in ``tree_like`` is a tensor come back as tensors on
        ``device``.  Returns (step, tree) or (None, None) when nothing
        restorable exists.
        """
        candidates = [step] if step is not None else list(reversed(self.all_steps()))
        like, structure = _flatten(tree_like)
        for s in candidates:
            leaves = self._verify(s)
            if leaves is None:
                continue
            if len(leaves) != len(like):
                raise ValueError(f"checkpoint step {s} holds {len(leaves)} leaves, the "
                                 f"template {len(like)}")
            if device is not None:
                leaves = [torch.from_numpy(lf).to(device) if isinstance(t, torch.Tensor)
                          else lf for lf, t in zip(leaves, like)]
            return s, _unflatten(structure, leaves)
        return None, None
