"""Reference weights into the port's parameter layout.

The reference keeps per-pattern-position parameters stacked over groups
(``params["blocks"][pos]`` leaves have a leading ``num_groups`` axis); the
port keeps one dictionary per layer in execution order, layer
``g * len(pattern) + pos``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .model import layer_specs, torch_dtype


def _to_tensor(arr: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    arr = np.array(arr)                  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16, by name
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif arr.dtype == np.float32:
        t = torch.from_numpy(arr)
    else:
        raise TypeError(f"weights must be float32 or bfloat16, got "
                        f"{arr.dtype}")
    return t.to(device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                    device=None) -> Dict[str, Any]:
    """``tree``: the reference's ``init_lm`` parameters with numpy leaves
    (float32 or ``ml_dtypes.bfloat16``).  Returns the port's parameters
    on ``device`` in the config's dtype."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    convert = lambda a: _to_tensor(a, dt, dev)  # noqa: E731
    pattern_len = len(cfg.pattern())
    stacked = tree["blocks"]
    if len(stacked) != pattern_len:
        raise ValueError(f"{len(stacked)} stacked positions, pattern has "
                         f"{pattern_len}")
    blocks = []
    for layer, _ in enumerate(layer_specs(cfg)):
        g, pos = divmod(layer, pattern_len)
        blocks.append(_map(stacked[pos], lambda a, g=g: convert(a[g])))
    return {"embed": _map(tree["embed"], convert),
            "final_norm": convert(tree["final_norm"]),
            "blocks": blocks}
