"""Fault-tolerant checkpointing: sharded npz + manifest, atomic publish,
elastic reshard on restore.

Counterpart of ``repro/checkpoint/store.py``, with the same on-disk layout,
so a checkpoint written by either package restores in the other::

    ckpt_dir/
      step_000123/
        manifest.json          # leaf names, shapes, dtypes, shard map
        shard_000.npz          # leaf -> array chunk (leading-dim split)
        shard_001.npz
      step_000123.COMMITTED    # written LAST (atomic rename): a crash
                               # mid-write never yields a loadable step

Leaves are split along the leading axis over ``num_shards`` files; the
restore path reassembles from any shard count. A tensor on the card is
copied to the host once per leaf; ``torch.bfloat16`` is stored as a
``uint16`` view with dtype ``"bfloat16"`` (npz has no bf16).
``load_checkpoint`` returns tensors on the device of each ``like`` leaf
(the CPU for an ndarray or a number).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common import tree as tr

_BF16 = "bfloat16"


def _to_numpy(x) -> tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.uint16), _BF16
        arr = x.cpu().numpy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir, step: int, state: Any,
                    num_shards: int = 1,
                    pre_commit_hook=None) -> pathlib.Path:
    """Write one step. ``state`` is a tree of tensors, ndarrays and
    numbers (``common/tree.py``).

    ``pre_commit_hook(tmp_dir)``, if given, runs after every shard file and
    the manifest are written but BEFORE the atomic rename + commit marker:
    the window a preempted writer dies in. A hook that raises (or exits)
    leaves only a ``.tmp_step_*`` directory behind, which readers never
    trust (no ``.COMMITTED`` marker) and ``sweep_stale_tmp`` removes on
    the next manager init.
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_",
                                        dir=ckpt_dir))
    manifest = {"step": step, "num_shards": num_shards, "leaves": []}
    shards: list[dict] = [{} for _ in range(num_shards)]

    for name, leaf in tr.tree_flatten_with_paths(state):
        arr, dtype = _to_numpy(leaf)
        entry = {"name": name, "shape": list(arr.shape), "dtype": dtype,
                 "splits": []}
        if arr.ndim == 0 or arr.shape[0] < num_shards or num_shards == 1:
            shards[0][name] = arr
            entry["splits"] = [{"shard": 0, "rows": list(arr.shape[:1])}]
        else:
            chunks = np.array_split(arr, num_shards, axis=0)
            for i, c in enumerate(chunks):
                shards[i][name] = c
                entry["splits"].append({"shard": i, "rows": [c.shape[0]]})
        manifest["leaves"].append(entry)

    for i, payload in enumerate(shards):
        np.savez(tmp / f"shard_{i:03d}.npz", **payload)
    (tmp / "manifest.json").write_text(json.dumps(manifest))

    if pre_commit_hook is not None:
        pre_commit_hook(tmp)

    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    # commit marker LAST: readers only trust committed steps
    (ckpt_dir / f"step_{step:08d}.COMMITTED").touch()
    return final


def sweep_stale_tmp(ckpt_dir) -> list[pathlib.Path]:
    """Remove the ``.tmp_step_*`` directories a writer killed
    mid-checkpoint left behind; return the paths removed. Safe because the
    store has one writer per directory: a tmp directory present when a
    manager starts belongs to a dead writer."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    swept = []
    for tmp in ckpt_dir.glob(".tmp_step_*"):
        if tmp.is_dir():
            shutil.rmtree(tmp, ignore_errors=True)
            swept.append(tmp)
    return swept


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for marker in ckpt_dir.glob("step_*.COMMITTED"):
        s = int(marker.stem.split("_")[1])
        if (ckpt_dir / f"step_{s:08d}" / "manifest.json").exists():
            steps.append(s)
    return max(steps) if steps else None


def _device_of(ref) -> torch.device:
    return ref.device if isinstance(ref, torch.Tensor) else torch.device(
        "cpu")


def load_checkpoint(ckpt_dir, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``, whatever the writer's shard
    count; every leaf comes back as a tensor on its ``like`` leaf's
    device. A leaf whose shape differs from ``like``'s raises
    ``AssertionError``; a leaf missing from every shard raises
    ``FileNotFoundError``."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    data = {}
    for i in range(manifest["num_shards"]):
        f = d / f"shard_{i:03d}.npz"
        if f.exists():
            with np.load(f) as z:
                for k in z.files:
                    data.setdefault(k, []).append((i, z[k]))

    by_name = {}
    for entry in manifest["leaves"]:
        parts = sorted(data.get(entry["name"], []), key=lambda t: t[0])
        if not parts:
            raise FileNotFoundError(f"leaf {entry['name']} missing")
        if len(parts) == 1:
            arr = parts[0][1]
        else:
            arr = np.concatenate([p[1] for p in parts], axis=0)
        by_name[entry["name"]] = _from_numpy(arr, entry["dtype"])

    out = []
    for name, ref in tr.tree_flatten_with_paths(like):
        arr = by_name[name]
        want = tuple(np.shape(ref) if not isinstance(ref, torch.Tensor)
                     else ref.shape)
        if tuple(arr.shape) != want:
            raise AssertionError(
                f"{name}: ckpt {tuple(arr.shape)} vs expected {want}")
        out.append(arr.to(_device_of(ref)))
    return tr.tree_unflatten(like, out)


class CheckpointManager:
    """Keep-last-N manager with restore-latest."""

    def __init__(self, ckpt_dir, keep: int = 3, num_shards: int = 1):
        self.dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self.num_shards = num_shards
        # a writer killed mid-save leaves a .tmp_step_* directory, which
        # _gc never matches (it globs committed markers): sweep it here
        sweep_stale_tmp(self.dir)

    def save(self, step: int, state: Any, pre_commit_hook=None):
        save_checkpoint(self.dir, step, state, self.num_shards,
                        pre_commit_hook=pre_commit_hook)
        self._gc()

    def restore_latest(self, like: Any):
        s = latest_step(self.dir)
        if s is None:
            return None, None
        return s, load_checkpoint(self.dir, s, like)

    def _gc(self):
        steps = sorted(
            int(m.stem.split("_")[1])
            for m in self.dir.glob("step_*.COMMITTED"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
            (self.dir / f"step_{s:08d}.COMMITTED").unlink(missing_ok=True)
