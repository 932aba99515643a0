"""Checkpointing: state save/restore with async write + elastic restore
(the port of ``repro.train.checkpoint``).

Layout (the reference's, file for file):

    <dir>/step_<n>/
        meta.json          — step, leaf keys, files, shapes, dtypes
        <leafpath>.npy     — one file per leaf of the reference's state tree

The leaves are the reference's logical arrays: parameters stacked
``(n_reps, ...)``, the optimizer state as the optimizers keep it, the
step.  Keys follow the reference's path rule (``params/layers/layer0/
attn/attn/wq``, ``opt/v/embed/table/[0]``, ``opt/count``, ``step``), so
either package restores a checkpoint the other wrote.  bfloat16 leaves
(Adafactor's ``m``) are written as numpy writes the reference's: their
raw two-byte words, which ``np.load`` returns as a ``V2`` array.
Restore puts the arrays on any device (the port's elastic restore).

Writes happen on a background thread (async checkpointing) so the train
loop never blocks on disk; ``wait()`` joins before the next save or exit.
A step is written into ``step_<n>.tmp`` and renamed into place, so a
crash mid-write leaves no partial checkpoint behind.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core.backend import resolve_device
from repro_torch.models.params import state_to_reference


def _seg(k) -> str:
    return f"[{k}]" if isinstance(k, int) else str(k)


def _flatten_with_paths(tree, prefix=()):
    """(key, leaf) in the reference's order: dict keys sorted, tuple
    entries by index."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return [("/".join(_seg(p) for p in prefix), tree)]
    out = []
    for k, v in items:
        out.extend(_flatten_with_paths(v, prefix + (k,)))
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, state, step: int, blocking: bool = False):
        """Write the train state ``{"params": Model, "opt", "step"}`` as
        checkpoint ``step``.  The state is copied to the host before this
        returns; the files are written on a thread unless ``blocking``."""
        self.wait()
        host = [(k, _dtype_name(v), _to_numpy(v)) for k, v in
                _flatten_with_paths(state_to_reference(state))]

        def write():
            path = os.path.join(self.dir, f"step_{step:08d}")
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            meta = {"step": step, "leaves": []}
            for k, dtype, arr in host:
                fn = k.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fn), arr)
                meta["leaves"].append(
                    {"key": k, "file": fn, "shape": list(arr.shape),
                     "dtype": dtype})
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, abstract_state, step: Optional[int] = None,
                device=None):
        """Restore into the structure of ``abstract_state`` (the reference's
        stacked tree, e.g. ``train.step.abstract_state``) on ``device``
        (resolved as the entry points resolve it).  Returns (the tree of
        tensors, the step); ``params.state_from_reference`` loads it into
        a model."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        dev = resolve_device(device)
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        by_key = {leaf["key"]: leaf for leaf in meta["leaves"]}

        def load(key, want):
            leaf = by_key[key]
            arr = np.load(os.path.join(path, leaf["file"]))
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"expected {tuple(want.shape)}")
            return _from_numpy(arr, leaf["dtype"]).to(dev)

        return _map_with_keys(load, abstract_state), step


def _map_with_keys(fn, tree, prefix=()):
    """``fn(key, leaf)`` over the leaves of ``tree``, keeping its
    structure; keys as ``_flatten_with_paths`` makes them."""
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_keys(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn("/".join(_seg(p) for p in prefix), tree)
