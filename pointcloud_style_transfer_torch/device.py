"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU; a request for
``cuda`` on a machine without a card raises instead of quietly running on the
CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises if a CUDA device is asked for and no
    card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run the port on the CPU")
    return dev
