"""Sharded checkpointing: atomic, manifest-driven, resumable, async-capable
(the port of ``repro.train.checkpoint``, in the reference's on-disk
format, so that either package restores the other's checkpoints).

Layout (one directory per step):

    ckpt_dir/step_000123/
        manifest.json       # leaf paths, shapes, dtypes, step metadata
        shard_XXXX.npz      # flattened leaves, split at ~512 MiB a file
    ckpt_dir/LATEST         # atomic pointer (write tmp + rename)

A leaf's path joins its keys with ``/``; a tuple's index is a key, so
``save(d, s, (params, opt_state))`` writes ``0/blocks/...``, ``1/m/...``,
``1/step``.  Dict keys are walked in sorted order, as JAX flattens them.

A bfloat16 leaf is written as its raw 2-byte values (numpy dtype ``|V2``),
which is what ``np.savez`` writes for the reference's bfloat16 arrays, and
its manifest dtype is ``"bfloat16"``.  numpy has no bfloat16 of its own,
so ``restore`` returns CPU tensors (a bfloat16 leaf read back as
``uint16`` and viewed as ``torch.bfloat16``), not numpy arrays; the caller
moves them to its device.

Fault-tolerance properties:
  * atomic publish: a crash mid-save never corrupts LATEST;
  * self-describing: restore works from the manifest alone;
  * async: ``save_async`` copies the tree to host memory before it
    returns, then writes on a thread;
  * deterministic data resume: the manifest stores the data cursor.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "latest_step"]

_SHARD_BYTES = 512 * 2**20


def _flatten_with_paths(tree, path=()):
    """(path string, leaf) pairs in JAX's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], (*path, k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, (*path, i))
    else:
        yield "/".join(str(k) for k in path), tree


def _unflatten_like(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten_like(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf, copy: bool) -> tuple[np.ndarray, str]:
    """A leaf as a host array to write, and its manifest dtype.  With
    ``copy``, the array owns its memory (never a view of a CPU tensor)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        copy = copy and leaf.device.type == "cpu"   # .cpu() aliases it
        if t.dtype == torch.bfloat16:
            a = t.view(torch.uint16).numpy().view(np.dtype("V2"))
            return (a.copy() if copy else a), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return (np.array(a) if copy else a), str(a.dtype)


def _write(ckpt_dir: str, step: int, paths, host, dtypes,
           extra: Optional[dict]) -> str:
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)

    shards: list[list[int]] = [[]]
    shard_of: list[int] = []
    size = 0
    for i, arr in enumerate(host):
        if size > _SHARD_BYTES and shards[-1]:
            shards.append([])
            size = 0
        shards[-1].append(i)
        shard_of.append(len(shards) - 1)
        size += arr.nbytes

    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": [
            {"path": p, "shape": list(a.shape), "dtype": d,
             "shard": shard_of[i]}
            for i, (p, a, d) in enumerate(zip(paths, host, dtypes))
        ],
        "n_shards": len(shards),
    }
    for si, idxs in enumerate(shards):
        np.savez(os.path.join(tmp_dir, f"shard_{si:04d}.npz"),
                 **{f"leaf_{i}": host[i] for i in idxs})
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)

    # atomic LATEST pointer
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir)
    with os.fdopen(fd, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))
    return step_dir


def _snapshot(tree: Any, copy: bool):
    paths, host, dtypes = [], [], []
    for p, leaf in _flatten_with_paths(tree):
        a, d = _to_host(leaf, copy)
        paths.append(p)
        host.append(a)
        dtypes.append(d)
    return paths, host, dtypes


def save(ckpt_dir: str, step: int, tree: Any, *,
         extra: Optional[dict] = None) -> str:
    """Synchronous sharded save with atomic LATEST publish."""
    return _write(ckpt_dir, step, *_snapshot(tree, copy=False), extra)


def save_async(ckpt_dir: str, step: int, tree: Any, *,
               extra: Optional[dict] = None) -> threading.Thread:
    """Copy the tree to host memory now; write on a background thread.
    The copy is taken before this returns, so the caller may go on
    updating its tensors."""
    snapshot = _snapshot(tree, copy=True)
    t = threading.Thread(target=_write,
                         args=(ckpt_dir, step, *snapshot, extra),
                         daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _from_host(arr: np.ndarray, want: str) -> torch.Tensor:
    if not arr.flags.writeable:
        arr = arr.copy()
    if want == "bfloat16":
        # npz keeps a bfloat16 leaf as raw 2-byte values
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    if str(arr.dtype) != want:
        raise TypeError(f"checkpoint leaf of dtype {want!r} stored as "
                        f"{arr.dtype}: only bfloat16 is read from raw bytes")
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, tree_like: Any, *, step: Optional[int] = None):
    """Restore into the structure of ``tree_like`` (values ignored).

    Returns (tree, extra), the leaves as CPU tensors; the caller moves them
    to its device."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no LATEST in {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)

    by_shard: dict[int, list[int]] = {}
    for i, leaf in enumerate(manifest["leaves"]):
        by_shard.setdefault(leaf["shard"], []).append(i)

    values: dict[int, torch.Tensor] = {}
    for si, idxs in by_shard.items():
        with np.load(os.path.join(step_dir, f"shard_{si:04d}.npz")) as z:
            for i in idxs:
                values[i] = _from_host(z[f"leaf_{i}"],
                                       manifest["leaves"][i]["dtype"])

    paths = [p for p, _ in _flatten_with_paths(tree_like)]
    want = {p: i for i, p in enumerate(paths)}
    out: list = [None] * len(paths)
    for i, leaf in enumerate(manifest["leaves"]):
        j = want.get(leaf["path"])
        if j is None:
            raise KeyError(f"checkpoint leaf {leaf['path']} not in target tree")
        out[j] = values[i]
    if any(o is None for o in out):
        missing = [paths[j] for j, o in enumerate(out) if o is None]
        raise KeyError(f"target leaves missing from checkpoint: {missing[:5]}")
    return _unflatten_like(tree_like, iter(out)), manifest["extra"]
