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
from ..kernels import ops
from .model import layer_specs, torch_dtype
from .ssm import FLOAT32_LEAVES


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


def _map(tree, fn, name=""):
    """``fn(name, leaf)`` over a nested dictionary; ``name`` is the leaf's
    own key."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    return fn(name, tree)


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                    device=None) -> Dict[str, Any]:
    """``tree``: the reference's ``init_lm`` parameters with numpy leaves
    (float32 or ``ml_dtypes.bfloat16``).  Returns the port's parameters
    on ``device`` in the dtypes the reference gives them: the config's
    dtype, except the SSM leaves it keeps in float32."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)

    def convert(name, a):
        return _to_tensor(a, torch.float32 if name in FLOAT32_LEAVES else dt,
                          dev)
    pattern_len = len(cfg.pattern())
    stacked = tree["blocks"]
    if len(stacked) != pattern_len:
        raise ValueError(f"{len(stacked)} stacked positions, pattern has "
                         f"{pattern_len}")
    blocks = []
    for layer, _ in enumerate(layer_specs(cfg)):
        g, pos = divmod(layer, pattern_len)
        blocks.append(_map(stacked[pos],
                           lambda name, a, g=g: convert(name, a[g])))
    return {"embed": _map(tree["embed"], convert),
            "final_norm": convert("final_norm", tree["final_norm"]),
            "blocks": blocks}


def param_checksums(params: Dict[str, Any], block: int = 1024
                    ) -> Dict[str, torch.Tensor]:
    """The uint32 chunk checksum of every parameter leaf, read as its
    bytes, keyed by its path (``blocks.3.mixer.in_x``): what a worker
    checks weights against on ingest.  On the card each leaf is one
    launch of the checksum kernel; nothing is synchronised."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            items = tree.items()
        elif isinstance(tree, list):
            items = enumerate(tree)
        else:
            out[path] = ops.chunk_checksum(
                tree.reshape(-1).view(torch.uint8), block)
            return
        for k, v in items:
            walk(v, f"{path}.{k}" if path else str(k))
    walk(params, "")
    return out
