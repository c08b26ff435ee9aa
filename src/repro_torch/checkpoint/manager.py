"""Fault-tolerant checkpointing: atomic pytree save/restore with retention
(twin of ``repro.checkpoint.manager``).

Design, as in the reference:
  - every leaf is written to one ``.npz`` under a temp dir, then the dir is
    atomically renamed into place (rename-aside swap) — a crash mid-save
    never corrupts the latest checkpoint;
  - tree structure is stored as JSON (path-joined keys), dtypes preserved;
  - retention keeps the newest ``keep`` checkpoints.

The file layout (``leaves.npz`` + ``meta.json``) is the reference's, so a
checkpoint written by either package reads in the other. A leaf may be a
numpy array, a scalar or a torch tensor on any device (it is copied to the
host). A bfloat16 leaf is written as its 16-bit pattern (``uint16``) with
dtype ``"bfloat16"`` in ``meta.json``, as the reference writes it. numpy
has no bfloat16, so ``restore_pytree`` returns numpy arrays, except that a
bfloat16 leaf comes back as a CPU ``torch.bfloat16`` tensor.

The reference's multi-host shard layout (``host_<i>``) belongs to meshes,
which the port does not run yet.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zipfile
from typing import Any, Optional

import numpy as np
import torch

Pytree = Any


def _flatten_with_paths(tree) -> list[tuple[str, Any]]:
    out = []

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + (str(i),))
        else:
            out.append(("/".join(path), node))

    rec(tree, ())
    return out


def _treedef_json(tree):
    if isinstance(tree, dict):
        return {"__kind": "dict", "items": {k: _treedef_json(v) for k, v in tree.items()}}
    if isinstance(tree, list):
        return {"__kind": "list", "items": [_treedef_json(v) for v in tree]}
    if isinstance(tree, tuple):
        return {"__kind": "tuple", "items": [_treedef_json(v) for v in tree]}
    return {"__kind": "leaf"}


def _rebuild(tdef, leaves_by_path, path=()):
    kind = tdef["__kind"]
    if kind == "dict":
        return {k: _rebuild(v, leaves_by_path, path + (str(k),))
                for k, v in tdef["items"].items()}
    if kind in ("list", "tuple"):
        seq = [_rebuild(v, leaves_by_path, path + (str(i),))
               for i, v in enumerate(tdef["items"])]
        return seq if kind == "list" else tuple(seq)
    return leaves_by_path["/".join(path)]


def _leaf_array(leaf) -> tuple[np.ndarray, str]:
    """(the array written to ``leaves.npz``, its dtype name in meta.json)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(tree: Pytree, directory: str) -> None:
    os.makedirs(os.path.dirname(directory) or ".", exist_ok=True)
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten_with_paths(tree)
    arrays, dtypes = {}, {}
    for i, (path, leaf) in enumerate(flat):
        arrays[str(i)], dtypes[str(i)] = _leaf_array(leaf)
    np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
    meta = {
        "treedef": _treedef_json(tree),
        "paths": [p for p, _ in flat],
        "dtypes": dtypes,
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    # rename-aside swap: the old checkpoint moves aside *before* the new
    # one replaces it, so one valid checkpoint exists at every instant —
    # a kill between rmtree and replace can no longer lose both
    old = directory + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(directory):
        os.replace(directory, old)
    os.replace(tmp, directory)
    if os.path.exists(old):
        shutil.rmtree(old)


def restore_pytree(directory: str) -> Pytree:
    """The tree ``save_pytree`` wrote: numpy leaves, and a CPU
    ``torch.bfloat16`` tensor for each bfloat16 leaf."""
    if not os.path.exists(os.path.join(directory, "meta.json")):
        # a crash between the two renames above leaves only the aside
        # copy; fall back to it rather than failing the restore
        old = directory + ".old"
        if os.path.exists(os.path.join(old, "meta.json")):
            directory = old
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(directory, "leaves.npz"))
    leaves_by_path = {}
    for i, path in enumerate(meta["paths"]):
        arr = data[str(i)]
        dt = meta["dtypes"][str(i)]
        if dt == "bfloat16":
            arr = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        leaves_by_path[path] = arr
    return _rebuild(meta["treedef"], leaves_by_path)


# ------------------------------------------------- update-plane checkpoints
def save_update_store(store, row_ids, directory: str) -> None:
    """Serialize the live (un-aggregated) rows of a card-resident
    ``UpdateStore`` so an async run can resume with its in-flight updates
    intact. Only the referenced rows are written — one device-to-host copy
    per checkpoint, not per round — together with their ids so record
    handles (``ResultRecord.update_row``) stay valid after rehydration."""
    ids = np.asarray(row_ids, np.int64)
    rows = (store.gather(ids).cpu().numpy() if ids.size
            else np.zeros((0, store.row_width), np.float32))
    save_pytree({"ids": ids, "rows": rows,
                 "n_params": np.int64(store.n_params)}, directory)


def restore_update_store(directory: str) -> tuple[np.ndarray, np.ndarray, int]:
    """Returns (row_ids, rows [L, N], n_params) saved by
    ``save_update_store``; the caller writes them back into a fresh store at
    the original ids (``UpdateStore.write_at``) for a bit-exact resume."""
    tree = restore_pytree(directory)
    return (np.asarray(tree["ids"], np.int64),
            np.asarray(tree["rows"], np.float32),
            int(tree["n_params"]))


class CheckpointManager:
    """step-indexed checkpoints with retention + atomic latest resolution."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def save(self, step: int, tree: Pytree, extra: Optional[dict] = None) -> str:
        d = self._step_dir(step)
        save_pytree(tree, d)
        if extra is not None:
            with open(os.path.join(d, "extra.json"), "w") as f:
                json.dump(extra, f)
        self._gc()
        return d

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: Optional[int] = None) -> tuple[Pytree, dict, int]:
        """Restore ``step`` (explicit steps still raise on corruption) or,
        with ``step=None``, the newest *loadable* retained step: corrupt
        or partial checkpoints — missing meta.json, truncated leaves.npz —
        are skipped in favor of the next older one."""
        if step is not None:
            return self._restore_step(step)
        candidates = self.steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        last_err: Optional[Exception] = None
        for s in reversed(candidates):
            try:
                return self._restore_step(s)
            except (OSError, ValueError, KeyError, json.JSONDecodeError,
                    zipfile.BadZipFile) as e:
                last_err = e
        raise FileNotFoundError(
            f"no loadable checkpoint under {self.root} "
            f"({len(candidates)} corrupt): {last_err}")

    def _restore_step(self, step: int) -> tuple[Pytree, dict, int]:
        d = self._step_dir(step)
        tree = restore_pytree(d)
        extra = {}
        ep = os.path.join(d, "extra.json")
        if os.path.exists(ep):
            with open(ep) as f:
                extra = json.load(f)
        return tree, extra, step

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
