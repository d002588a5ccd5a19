"""Device selection: ``cuda`` by default, the CPU only when asked for."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means ``cuda``. A CUDA device raises when there is no GPU: the
    port never falls back to the CPU on its own. ``"meta"`` builds shapes
    only (used by the weight bridge to list the expected keys).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
