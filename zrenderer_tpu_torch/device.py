"""Explicit device resolution.

Every entry point of the port takes a ``device`` argument and resolves it
here.  Asking for CUDA on a host without a usable card raises: the port
never falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"``, ``"cuda:N"``, ``"cpu"`` or a ``torch.device`` -> a
    concrete ``torch.device`` (a bare ``cuda`` gets the current index)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False (no CUDA card or a CPU-only torch build)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
