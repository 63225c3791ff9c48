"""Checkpointing (``repro/ckpt/checkpoint.py``), in the reference's
on-disk format, so that a checkpoint written by one package restores in
the other.

Layout: ``<dir>/step_<n>/`` holding one ``.npy`` per tree leaf plus
``manifest.json`` (step, and each leaf's name, shape and original
dtype; bf16 is widened to fp32 for ``.npy``). Writes go to a ``.tmp``
directory and an atomic rename, so a job killed mid-write never corrupts
the latest checkpoint — a restart picks the newest *complete* step.

Leaf names and order are those of ``jax.tree_util.tree_flatten_with_path``:
dict keys sorted and written ``['k']``, NamedTuple fields ``.name``,
sequence items ``[i]``, joined by ``__`` (``/`` becomes ``_``). So
``{"params": ..., "opt": AdamWState}`` writes ``['opt']__.step``,
``['opt']__.m__['embed']``, ..., ``['params']__['embed']``, ...

* ``AsyncCheckpointer`` snapshots the tensors to host memory before
  ``save`` returns, then writes on a background thread.
* ``restore_checkpoint(..., device=...)`` puts each leaf on a device (one,
  or a tree of them): restoring onto another device than the one saved
  from is the same call (the reference's ``shardings=``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, tree_leaves, tree_unflatten

#: dtypes ``.npy`` holds as they are (the reference's list); others are
#: widened to fp32
_NPY_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.uint32,
               np.bool_, np.int8, np.uint8, np.float16, np.uint16,
               np.int16, np.uint64)


def _flatten(tree) -> tuple[list, list]:
    flat = flatten_with_path(tree)
    names = ["__".join(path).replace("/", "_") for path, _ in flat]
    return names, [leaf for _, leaf in flat]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array ``.npy`` stores, the leaf's dtype name)."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy(), name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if arr.dtype not in _NPY_DTYPES:
        arr = arr.astype(np.float32)     # bf16 etc: widen for .npy
    return arr, name


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    names, leaves = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for name, leaf in zip(names, leaves):
        arr, orig_dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": orig_dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> "int | None":
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, tree_like, *,
                       device=None):
    """Restore into the structure of ``tree_like`` (tensors: their dtypes
    are kept). Each leaf goes to ``device`` — one device, or a tree of
    devices matching ``tree_like`` — or, with None, to its ``tree_like``
    leaf's device (the elastic-restart path: another device than at save
    time)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    names, leaves = _flatten(tree_like)
    if device is None or isinstance(device, (str, torch.device)):
        devices = [device] * len(leaves)
    else:
        devices = tree_leaves(device)
    out = []
    for name, like, dev in zip(names, leaves, devices):
        arr = np.load(os.path.join(d, name + ".npy"))
        t = torch.from_numpy(arr)
        dev = dev if dev is not None else like.device
        out.append(t.to(device=dev, dtype=like.dtype))
    return tree_unflatten(tree_like, out)


class AsyncCheckpointer:
    """Snapshot-to-host then write on a background thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: "threading.Thread | None" = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree):
        """Copy every leaf to host memory (the blocking snapshot: training
        may write its tensors in place as soon as this returns), then
        write the checkpoint and drop old ones on a thread."""
        self.wait()
        leaves = [leaf.detach().to("cpu", copy=True)
                  if torch.is_tensor(leaf) else np.array(leaf)
                  for leaf in tree_leaves(tree)]
        host_tree = tree_unflatten(tree, leaves)

        def _write():
            save_checkpoint(self.ckpt_dir, step, host_tree)
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
