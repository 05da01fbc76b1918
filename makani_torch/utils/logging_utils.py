"""Logging setup (counterpart of ``makani_tpu/utils/logging_utils.py``)."""

from __future__ import annotations

import json
import logging
import os
import time

__all__ = ["config_logger", "log_to_file", "log_versions", "ExperimentLogger"]

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def config_logger(level=logging.INFO):
    logging.basicConfig(format=_FORMAT, level=level)


def log_to_file(logger_name=None, log_level=logging.INFO, log_filename="out.log"):
    os.makedirs(os.path.dirname(os.path.abspath(log_filename)), exist_ok=True)
    logger = logging.getLogger(logger_name)
    fh = logging.FileHandler(log_filename)
    fh.setLevel(log_level)
    fh.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(fh)


class ExperimentLogger:
    """Experiment metric tracker: one JSON line per call appended to
    ``metrics.jsonl`` under the experiment directory, and the config's JSON
    values in ``config.json``. wandb (``log_to_wandb``) is not ported and
    raises."""

    def __init__(self, exp_dir: str, config: dict | None = None, log_to_wandb: bool = False, project: str = "makani-tpu", name: str | None = None):
        if log_to_wandb:
            raise NotImplementedError("log_to_wandb is not ported (the port logs to metrics.jsonl)")
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, "metrics.jsonl")
        if config is not None:
            with open(os.path.join(exp_dir, "config.json"), "w") as f:
                json.dump({k: v for k, v in config.items() if _is_jsonable(v)}, f, indent=2, default=str)

    def log(self, metrics: dict, step: int | None = None):
        row = {k: v for k, v in metrics.items() if _is_jsonable(v)}
        if step is not None:
            row["step"] = step
        row["_time"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def finish(self):
        pass


def _is_jsonable(v):
    return isinstance(v, (int, float, str, bool, type(None), list, tuple, dict))


def log_versions():
    import subprocess

    import torch

    logger = logging.getLogger()
    try:
        git_hash = subprocess.check_output(["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL).strip().decode()
        logger.info(f"git hash: {git_hash}")
    except (OSError, subprocess.CalledProcessError):
        logger.info("git hash: not in a git checkout")
    logger.info(f"torch version: {torch.__version__} (cuda {torch.version.cuda})")
    if torch.cuda.is_available():
        logger.info(f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}")
