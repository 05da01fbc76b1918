"""Checkpoint save and restore (counterpart of
``makani_tpu/utils/checkpoint_helpers.py``).

The JAX package's layout, with ``torch.save`` state dicts in place of orbax
trees: version n of a run is the directory ``ckpt_v{n}/`` under the
checkpoint directory, holding ``model`` (the module's ``state_dict``),
``opt`` (the optimizer's, with each parameter's step count, which is also
the schedule's position) and ``meta.json`` (epoch, iterations, best
validation loss). ``best_checkpoint.txt`` names the best version, and a save
keeps the newest ``checkpoint_num_versions`` versions and the best one.
``bytes_written``/``seconds_written`` and ``bytes_read``/``seconds_read``
sum the traffic of the ``model`` and ``opt`` files.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import torch

__all__ = ["CheckpointManager", "get_latest_checkpoint_version"]


def get_latest_checkpoint_version(checkpoint_dir: str) -> Optional[int]:
    if not os.path.isdir(checkpoint_dir):
        return None
    versions = [int(name[6:]) for name in os.listdir(checkpoint_dir) if name.startswith("ckpt_v") and name[6:].isdigit()]
    return max(versions) if versions else None


def _module_device(module) -> torch.device:
    return next(module.parameters()).device


class CheckpointManager:
    def __init__(self, params):
        exp_dir = params.get("experiment_dir", params.get("exp_dir"))
        self.checkpoint_dir = params.get("checkpoint_dir", None) or os.path.join(exp_dir, "checkpoints")
        self.num_versions = params.get("checkpoint_num_versions", 3)
        self.bytes_written = self.bytes_read = 0
        self.seconds_written = self.seconds_read = 0.0

    def _path(self, version: int) -> str:
        return os.path.join(self.checkpoint_dir, f"ckpt_v{version}")

    def _save(self, obj, path: str):
        t0 = time.perf_counter()
        torch.save(obj, path)
        self.seconds_written += time.perf_counter() - t0
        self.bytes_written += os.path.getsize(path)

    def _load(self, path: str, device):
        t0 = time.perf_counter()
        obj = torch.load(path, map_location=device, weights_only=True)
        self.seconds_read += time.perf_counter() - t0
        self.bytes_read += os.path.getsize(path)
        return obj

    def save(self, model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer], meta: dict, is_best: bool = False):
        version = (get_latest_checkpoint_version(self.checkpoint_dir) or 0) + 1
        path = self._path(version)
        # model and optimizer apart, so inference restores the weights alone;
        # the checkpoint directory is made here, by the first save, and never
        # by a manager that only restores
        os.makedirs(path, exist_ok=True)
        self._save(model.state_dict(), os.path.join(path, "model"))
        if optimizer is not None:
            self._save(optimizer.state_dict(), os.path.join(path, "opt"))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

        if is_best:
            with open(os.path.join(self.checkpoint_dir, "best_checkpoint.txt"), "w") as f:
                f.write(str(version))

        # rotate old versions, keeping the best
        best_version = self.best_version()
        versions = sorted(int(n[6:]) for n in os.listdir(self.checkpoint_dir) if n.startswith("ckpt_v") and n[6:].isdigit())
        for v in versions[: -self.num_versions]:
            if v != best_version:
                shutil.rmtree(self._path(v), ignore_errors=True)

    def best_version(self) -> Optional[int]:
        best = os.path.join(self.checkpoint_dir, "best_checkpoint.txt")
        if os.path.isfile(best):
            with open(best) as f:
                return int(f.read().strip())
        return None

    def restore(self, version: int, model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None) -> dict:
        """Load version ``version`` into ``model`` (strictly: every parameter
        and nothing more) and, where given and saved, ``optimizer``; returns
        its meta."""
        path = self._path(version)
        device = _module_device(model)
        model.load_state_dict(self._load(os.path.join(path, "model"), device))
        if optimizer is not None and os.path.isfile(os.path.join(path, "opt")):
            optimizer.load_state_dict(self._load(os.path.join(path, "opt"), device))
        meta = {}
        meta_path = os.path.join(path, "meta.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return meta

    def restore_latest(self, model, optimizer=None) -> Optional[dict]:
        version = get_latest_checkpoint_version(self.checkpoint_dir)
        return None if version is None else self.restore(version, model, optimizer)

    def restore_best(self, model, optimizer=None) -> Optional[dict]:
        version = self.best_version() or get_latest_checkpoint_version(self.checkpoint_dir)
        return None if version is None else self.restore(version, model, optimizer)
