"""Checkpointing: step-atomic, async, retention, restore onto a device.

The reference's ``checkpoint/manager.py`` in PyTorch, with its layout:

    <dir>/step_<n:08d>/arrays.npz + meta.json

``arrays.npz`` holds one array per leaf, keyed by the leaf's path in the
tree as the reference spells it (``k:<dict key>``, ``i:<tuple index>``,
``n:<NamedTuple field>``, joined by ``||``; dict keys in sorted order),
bf16 as its raw 2-byte values (numpy has no bf16; the reference's
``ml_dtypes`` arrays land in the file the same way).  So a checkpoint
written by either package restores into the other.  Writes go to a
``.tmp`` directory renamed into place: a crash mid-save never corrupts the
latest checkpoint.

The port's optimizer updates its tensors in place, where the reference's
arrays are immutable: :class:`AsyncSaver` therefore copies every tensor to
the host before ``save`` returns, and only the copy goes to its thread.
The reference's ``restore(shardings=)`` becomes ``restore(device=)``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "||"


def _walk(fn: Callable[[str, Any], Any], tree, path: Tuple[str, ...] = ()):
    """``fn(key, leaf)`` over the leaves of a tree of dicts, NamedTuples,
    tuples and lists, rebuilt with the results; ``key`` is the leaf's
    path string.  None is an empty subtree, as in ``jax.tree_util``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(fn, tree[k], path + (f"k:{k}",))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(fn, getattr(tree, f), path + (f"n:{f}",))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(fn, t, path + (f"i:{i}",))
                          for i, t in enumerate(tree))
    return fn(_SEP.join(path), tree)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array that owns its memory: a tensor is copied to
    the host, bf16 as raw 2-byte values."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.array(leaf, copy=True)


def _flatten(tree) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def put(key, leaf):
        out[key] = _to_host(leaf)
    _walk(put, tree)
    return out


def save(tree: Any, directory: str, step: int, *,
         extra: Optional[dict] = None) -> str:
    """Synchronous atomic save; returns the checkpoint path."""
    return _write(_flatten(tree), directory, step, extra)


def _write(arrays: Dict[str, np.ndarray], directory: str, step: int,
           extra: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta_ = {"step": step, "n_arrays": len(arrays), "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta_, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


class AsyncSaver:
    """Backgrounds the file write; at most one save in flight.  ``save``
    returns once every tensor is copied to the host, so the caller may
    update its tensors in place at once."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, tree, directory: str, step: int,
             extra: Optional[dict] = None) -> None:
        self.wait()
        arrays = _flatten(tree)

        def work():
            self.last_path = _write(arrays, directory, step, extra)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1))
             for name in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", name))]
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    if arr.dtype.kind == "V":
        # raw bytes of a type numpy lacks (bf16): reinterpret as the
        # target's dtype
        t = torch.from_numpy(arr.view(np.uint8).copy()).view(like.dtype)
        t = t.reshape(arr.shape)
    else:
        t = torch.from_numpy(np.array(arr, copy=True)).to(like.dtype)
    return t.to(like.device if device is None else device)


def restore(target_like: Any, directory: str,
            step: Optional[int] = None, *, device=None) -> Any:
    """Restore into the structure of ``target_like`` (a tree of tensors):
    each leaf in its target's dtype, on ``device`` when given, else on the
    target leaf's device.  Raises ``KeyError`` for a leaf the checkpoint
    lacks."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def get(key, leaf):
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            return _from_host(data[key], leaf, device)
        return _walk(get, target_like)


def retain(directory: str, keep: int) -> List[str]:
    """Delete all but the newest ``keep`` checkpoints; returns removed."""
    if not os.path.isdir(directory):
        return []
    steps = sorted(int(m.group(1))
                   for name in os.listdir(directory)
                   if (m := re.fullmatch(r"step_(\d+)", name)))
    removed = []
    for s in steps[:-keep] if keep > 0 else []:
        p = os.path.join(directory, f"step_{s:08d}")
        shutil.rmtree(p)
        removed.append(p)
    return removed


def meta(directory: str, step: int) -> dict:
    with open(os.path.join(directory, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)
