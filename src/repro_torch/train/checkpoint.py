"""Fault-tolerant checkpointing: atomic, async, resumable.

Port of the reference package's ``train/checkpoint.py``.  Layout:
``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, written to a ``.tmp``
directory first and atomically renamed, so a process dying mid-save never
leaves a half-written "latest" checkpoint.  Restore checks the manifest
(keys and shapes) against the live state and refuses a mismatched tree.
Arrays are stored on the host, unsharded; a bf16 leaf is stored as float32
(exactly) and cast back on restore.  The reference's re-sharding onto a
different mesh waits for the port's sharding slice (``ROADMAP.md``).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.tree import tree_items, tree_unflatten


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy().copy()


def _flatten(tree):
    return {key: _to_host(leaf) for key, leaf in tree_items(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_save else None)
        self._pending: Optional[concurrent.futures.Future] = None

    # ------------------------------------------------------------- save

    def save(self, state, step: int, wait: bool = False):
        """Write ``state`` as step ``step``; the copy to the host happens
        now, the file writes in the background unless ``wait``."""
        arrays = _flatten(state)
        self._wait()
        if self._pool is None or wait:
            self._write(arrays, step)
        else:
            self._pending = self._pool.submit(self._write, arrays, step)

    def _wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, arrays, step: int):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays.keys()),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ------------------------------------------------------------- restore

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, like) -> Any:
        """The state saved at ``step``, shaped, typed and placed like
        ``like``; raises ValueError when the trees' keys or shapes differ."""
        self._wait()
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        items = list(tree_items(like))
        keys = [k for k, _ in items]
        if sorted(keys) != manifest["keys"]:
            raise ValueError(
                f"checkpoint tree mismatch: {set(keys) ^ set(manifest['keys'])}")
        leaves = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, leaf in items:
                arr = data[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                                     f"{tuple(leaf.shape)}")
                leaves.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
        return tree_unflatten(like, leaves)

    def restore_latest(self, like) -> Optional[Tuple[Any, int]]:
        steps = self.all_steps()
        if not steps:
            return None
        s = steps[-1]
        return self.restore(s, like), s

    def close(self):
        self._wait()
        if self._pool:
            self._pool.shutdown()
