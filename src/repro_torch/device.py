"""Device policy: entry points run on the card unless told otherwise."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  Asking for ``cuda`` without a card raises;
    the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev
