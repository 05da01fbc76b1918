"""YAML configuration with anchor inheritance (ref makani/utils/YParams.py:21-146).

The reference's recipe files use a single YAML document whose top-level keys
are named experiment configs, sharing a ``&BASE_CONFIG`` anchor. PyYAML
resolves anchors/merges natively, so ``YParams(file, config)`` just selects
the top-level key. ``ParamsBase`` is the dict/attribute hybrid the whole
framework passes around.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import yaml

__all__ = ["ParamsBase", "YParams"]

# PyYAML implements YAML 1.1, whose float resolver rejects exponent forms
# without a dot ("1E-3", "5E-4" — the style the reference's recipes use
# throughout). The reference loads with ruamel (YAML 1.2 core schema), which
# resolves them as floats; coerce ONLY those stragglers — dotted floats are
# already resolved by YAML 1.1, so any other float-looking string (version
# tags, experiment names) was deliberately quoted and must stay a string.
_FLOAT_RE = re.compile(r"^[+-]?\d+[eE][+-]?\d+$")


def _coerce_numeric_strings(node):
    if isinstance(node, dict):
        return {k: _coerce_numeric_strings(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_coerce_numeric_strings(v) for v in node]
    if isinstance(node, str) and _FLOAT_RE.match(node):
        return float(node)
    return node


class ParamsBase:
    """Dict/attribute hybrid parameter store."""

    def __init__(self, params: dict | None = None):
        self.params = dict(params or {})

    def __getitem__(self, key):
        return self.params[key]

    def __setitem__(self, key, value):
        self.params[key] = value

    def __getattr__(self, key):
        params = self.__dict__.get("params", {})
        if key in params:
            return params[key]
        raise AttributeError(f"no parameter {key}")

    def __setattr__(self, key, value):
        if key == "params":
            super().__setattr__(key, value)
        else:
            self.params[key] = value

    def __contains__(self, key):
        return key in self.params

    def get(self, key, default=None):
        return self.params.get(key, default)

    def update(self, new_params: dict, allow_new: bool = True):
        for key, value in new_params.items():
            if allow_new or key in self.params:
                self.params[key] = value

    def to_dict(self) -> dict:
        return dict(self.params)

    def to_yaml(self, path: str):
        with open(path, "w") as f:
            yaml.safe_dump(self.params, f, sort_keys=False)

    @classmethod
    def from_json(cls, path: str) -> "ParamsBase":
        with open(path) as f:
            return cls(json.load(f))

    def log(self, logger=None):
        lines = ["------------------ Configuration ------------------"]
        for key in sorted(self.params):
            lines.append(f"{key} {self.params[key]}")
        lines.append("----------------------------------------------------")
        msg = "\n".join(lines)
        if logger is not None:
            logger.info(msg)
        return msg


class YParams(ParamsBase):
    """Select one named config from a multi-config YAML file."""

    def __init__(self, yaml_filename: str, config_name: str, print_params: bool = False):
        if not os.path.exists(yaml_filename):
            raise FileNotFoundError(yaml_filename)
        with open(yaml_filename) as f:
            doc = yaml.safe_load(f)
        if config_name not in doc:
            raise KeyError(f"config {config_name} not found in {yaml_filename}; available: {list(doc)}")
        super().__init__(_coerce_numeric_strings(doc[config_name] or {}))
        self.params["config"] = config_name
        self.params["yaml_filename"] = yaml_filename
        if print_params:
            print(self.log())
