"""Small helpers shared by the stage drivers."""

from __future__ import annotations

import torch


def round_up(n: int, m: int) -> int:
    """Round n up to a multiple of the bucket size m."""
    return ((n + m - 1) // m) * m


def resolve_device(device=None) -> torch.device:
    """The device a run asked for; None picks the first CUDA card when
    there is one, else the CPU. A CUDA request without a card raises —
    nothing falls back to the CPU quietly."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA card is "
                           "available")
    return device


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU): stage walls
    are taken at these points."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
