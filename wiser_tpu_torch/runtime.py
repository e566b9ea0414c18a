"""Device selection. The device is always named by the caller; asking for
CUDA where there is none raises instead of running on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev
