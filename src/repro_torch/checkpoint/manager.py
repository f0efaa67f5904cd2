"""Fault-tolerant checkpointing (counterpart of ``repro/checkpoint/manager.py``):
atomic, asynchronous, with a retention policy.

* Format: one ``.npz`` per tree, keys the tree paths joined by ``|``
  (``/`` in a key becomes ``_``), and a ``.json`` sidecar with each
  leaf's dtype and shape — the reference's files, so an npz written by
  either package loads in the other.  numpy has no bfloat16: a bf16 leaf
  is stored as the reference stores one (2-byte void, ``|V2``, the raw
  bits; dtype ``bfloat16`` in the sidecar) and loads here as a
  ``torch.bfloat16`` tensor (the reference loads such a leaf as the raw
  ``|V2`` array).
* Atomicity: each file is written under a ``.tmp`` name, then
  ``os.replace``d, so a crash mid-write never corrupts the latest
  checkpoint.
* Async: one writer thread drains a depth-1 queue (a newer snapshot
  replaces a queued stale one), so a caller never waits on the disk.
* Retention: the newest ``keep`` checkpoints, and every ``keep_every``.
* Preemption: ``install_sigterm_hook`` runs a callback on SIGTERM.

Leaves load as CPU tensors; a restore moves them where the caller wants.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import signal
import threading
from typing import Any

import numpy as np
import torch

_SEP = "|"


def _flatten(tree: Any, prefix=""):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _flatten(v, f"{prefix}{_SEP}{k}" if prefix else k)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{_SEP}#{i}" if prefix else f"#{i}")
    else:
        yield prefix, tree


def _unflatten(pairs: dict):
    root: Any = {}
    for path, val in pairs.items():
        keys = path.split(_SEP)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val

    def fix(node):
        if isinstance(node, dict) and node and all(k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array the npz stores and its sidecar dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2"), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return a, "bfloat16"
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save_pytree(path: str, tree: Any) -> None:
    arrs, meta = {}, {}
    for name, leaf in _flatten(tree):
        a, dtype = _to_numpy(leaf)
        arrs[name] = a
        meta[name] = {"dtype": dtype, "shape": list(a.shape)}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(tmp, **{k.replace("/", "_"): v for k, v in arrs.items()})
    os.replace(tmp + ".npz", path)  # np.savez appends .npz to the tmp name
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")


def load_pytree(path: str) -> Any:
    """The tree saved at ``path``, leaves as CPU tensors."""
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path, allow_pickle=False) as z:
        pairs = {name: _from_numpy(z[name.replace("/", "_")], m["dtype"])
                 for name, m in meta.items()}
    return _unflatten(pairs)


def _snapshot(tree: Any) -> Any:
    """A host copy of a tree of tensors (what a queued save writes later)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, keep_every: int = 0):
        self.dir = directory
        self.keep = keep
        self.keep_every = keep_every
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- paths
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.npz")

    def all_steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            # the committed-checkpoint pattern only (never .tmp leftovers)
            if len(f) == 17 and f.startswith("step_") and f.endswith(".npz") and f[5:13].isdigit():
                out.append(int(f[5:13]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.all_steps()
        return s[-1] if s else None

    # -------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        if self._err:
            raise self._err
        snapshot = _snapshot(tree)
        if blocking:
            self._write(step, snapshot)
            return
        try:  # drop a stale queued snapshot in favour of the new one
            self._q.get_nowait()
            self._q.task_done()
        except queue.Empty:
            pass
        self._q.put((step, snapshot))

    def _writer(self):
        while True:
            step, snap = self._q.get()
            try:
                self._write(step, snap)
            except Exception as e:  # surfaced on the next save() or wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, snap: Any):
        save_pytree(self._path(step), snap)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        victims = steps[: -self.keep] if self.keep else []
        for s in victims:
            if self.keep_every and s % self.keep_every == 0:
                continue
            for suffix in ("", ".json"):
                try:
                    os.remove(self._path(s) + suffix)
                except OSError:
                    pass

    # ------------------------------------------------------------ restore
    def restore(self, step: int | None = None) -> tuple[int, Any] | None:
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return step, load_pytree(self._path(step))

    def wait(self):
        """Block until every queued write has landed (tests, shutdown)."""
        self._q.join()
        if self._err:
            raise self._err


def install_sigterm_hook(fn):
    """Run ``fn()`` on SIGTERM, then the previous handler if that is
    callable: preemption safety.  ``fn`` runs inside the signal handler,
    between two bytecodes of whatever the main thread was doing, so it
    must not communicate: over several ranks a save that gathers would
    pair its collectives with another rank's step.  The train CLI passes
    a flag setter and saves at the next step boundary."""
    prev = signal.getsignal(signal.SIGTERM)

    def handler(signum, frame):
        fn()
        if callable(prev):
            prev(signum, frame)

    signal.signal(signal.SIGTERM, handler)


def wipe(directory: str):
    shutil.rmtree(directory, ignore_errors=True)
