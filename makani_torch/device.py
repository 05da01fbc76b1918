"""Where the port builds its modules and tables: on the card unless the
caller names another device (the tests pass ``device="cpu"``)."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``torch.device("cuda")`` for None, else ``torch.device(device)``."""
    return torch.device("cuda") if device is None else torch.device(device)
