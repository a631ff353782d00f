"""Fault-tolerant checkpointing — atomic, async, restart-exact; the
contract of ``repro/checkpoint/store.py`` over the port's trees (dicts and
lists of tensors).

* **Atomic**: write to ``step_K.tmp-<nonce>/`` then ``os.replace`` to
  ``step_K/`` — a preempted writer never corrupts the latest checkpoint.
* **Async**: ``save_async`` copies every tensor to host memory now
  (blocking on the copy, so a step that then updates the params in place
  cannot reach the snapshot), then serializes on a background thread.
  ``wait()`` joins before the next save (one outstanding write) and
  re-raises a writer's error.
* **Self-describing**: ``manifest.json`` holds the keys, shapes, dtypes,
  the tree's structure and the step, with a sha256 checksum of itself;
  arrays land in one ``arrays.npz``.  Keys are the leaves' paths joined
  with ``/`` (``layers/0/attn/wq``; dict keys sorted, list entries by
  index).  bfloat16 tensors are stored as their uint16 bits and restored
  bit for bit.
* **Retention**: the ``keep`` most recent checkpoints survive a commit;
  stale ``.tmp-*`` directories are removed and never listed.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.stepgraph import tree_flatten, tree_unflatten

_FLAT_SEP = "/"


def _flatten_with_paths(tree, path: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, path + (str(i),))]
    return [(_FLAT_SEP.join(path), tree)]


def _to_host(leaf) -> torch.Tensor:
    """A CPU copy of a leaf, taken now (a tensor on the card is copied
    synchronously)."""
    t = torch.as_tensor(leaf).detach()
    return t.to("cpu", copy=True)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:012d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp-" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except (ValueError, IndexError):
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree) -> str:
        """Synchronous atomic save."""
        return self._write(step, self._snapshot(tree))

    def save_async(self, step: int, tree) -> None:
        """Device->host copy now; disk write on a background thread."""
        self.wait()
        host = self._snapshot(tree)

        def work():
            try:
                self._write(step, host)
            except BaseException as e:  # noqa: BLE001 — surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------ #
    @staticmethod
    def _snapshot(tree):
        """(struct, [(key, host tensor)]): every leaf copied to host."""
        struct, _ = tree_flatten(tree)
        return struct, [(k, _to_host(v)) for k, v in
                        _flatten_with_paths(tree)]

    def _write(self, step: int, host) -> str:
        struct, flat = host
        final = self._step_dir(step)
        nonce = f"{os.getpid()}-{int(time.time() * 1e6)}"
        tmp = f"{final}.tmp-{nonce}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: _as_numpy(t) for k, t in flat})
        manifest = {
            "step": step,
            "keys": [k for k, _ in flat],
            "shapes": {k: list(t.shape) for k, t in flat},
            "dtypes": {k: _dtype_name(t) for k, t in flat},
            "treedef": repr(struct),
        }
        blob = json.dumps(manifest, sort_keys=True).encode()
        manifest["checksum"] = hashlib.sha256(blob).hexdigest()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                     # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        # drop stale tmp dirs + old checkpoints beyond `keep`
        for name in os.listdir(self.dir):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------ #
    def restore(self, template, step: Optional[int] = None):
        """Restore into the structure of ``template``: every key present
        with the template leaf's shape, each tensor on the template leaf's
        device.  Returns ``(tree, step)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for key, tmpl in _flatten_with_paths(template):
                if key not in data:
                    raise KeyError(
                        f"checkpoint {d} missing leaf {key!r} "
                        "(template mismatch)")
                arr = data[key]
                want = tuple(torch.as_tensor(tmpl).shape)
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"leaf {key!r}: checkpoint shape {arr.shape} != "
                        f"template {want}")
                device = tmpl.device if isinstance(tmpl, torch.Tensor) \
                    else "cpu"
                leaves.append(_from_numpy(arr, manifest["dtypes"][key])
                              .to(device))
        return tree_unflatten(tree_flatten(template)[0], leaves), step
