"""Checkpointing: checkable, durable write actions on a checkpoint store.

Counterpart of ``repro.checkpoint.store``. A checkpoint is a *write action*
in the LOG.io sense: durable (fsync'd file with a step id) and checkable
(``status`` reads the step id back), so the recovery protocol guarantees
exactly-once commits even if the trainer dies mid-save. Restart = load the
latest complete checkpoint + let the LOG.io data pipeline replay the batches
after it (deterministic feed and deterministic step => bit-identical
resume).

``save`` turns the state into numpy first (``to_host``: each parameter
module as {name: array}); ``latest`` hands back that numpy tree, and the
driver puts it on its device (``training.step.train_state_from_host``).
"""
from __future__ import annotations

import os
import pickle
import tempfile
import threading
from typing import Any, Optional, Tuple

import torch

from repro_torch.bridge import to_numpy


def to_host(tree: Any) -> Any:
    """numpy copy of a tree of dicts, tensors and modules (a module becomes
    {parameter name: array})."""
    if isinstance(tree, torch.nn.Module):
        return {name: to_numpy(t) for name, t in tree.named_parameters()}
    if isinstance(tree, torch.Tensor):
        return to_numpy(tree)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree


class CheckpointStore:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.lock = threading.Lock()

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.pkl")

    def save(self, state: Any, step: int) -> str:
        """Durable write: temp file + fsync + atomic rename (the 'success
        response' of Sec. 2.2 — once renamed, the write is durable)."""
        host_state = to_host(state)
        path = self._path(step)
        with self.lock:
            fd, tmp = tempfile.mkstemp(dir=self.dir)
            with os.fdopen(fd, "wb") as f:
                pickle.dump({"step": step, "state": host_state}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        return path

    def status(self, step: int) -> str:
        """Checkable write action (Alg 8 step 2.a)."""
        return "success" if os.path.exists(self._path(step)) else "unknown"

    def _steps(self):
        return sorted(int(f[5:13]) for f in os.listdir(self.dir)
                      if f.startswith("ckpt_") and f.endswith(".pkl"))

    def latest(self) -> Tuple[Optional[int], Optional[Any]]:
        with self.lock:
            steps = self._steps()
        if not steps:
            return None, None
        with open(self._path(steps[-1]), "rb") as f:
            d = pickle.load(f)
        return d["step"], d["state"]

    def gc(self, keep: int = 2):
        with self.lock:
            for s in self._steps()[:-keep]:
                os.remove(self._path(s))
