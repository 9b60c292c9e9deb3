"""The reference's parameter layout into the port's, and back.

The reference keeps per-pattern-position parameters stacked over groups
(``params["blocks"][pos]`` leaves have a leading ``num_groups`` axis); the
port keeps one dictionary per layer in execution order, layer
``g * len(pattern) + pos``.  Every block kind carries across: a hybrid
block's SSM mixer beside its ``norm2`` and ``ffn``, a cross-attention
block's scalar ``gate``.  ``params_from_jax`` reads the reference's
layout (numpy or tensor leaves), ``jax_layout`` writes it (tensor
leaves): what a checkpoint of the reference's holds.  ``state_from_jax``
turns the reference trainer's whole state into the port's: the
parameters through ``params_from_jax``, the optimizer's moments and the
error-feedback residual kept in the reference's layout (as the port's
optimizer keeps them).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels import ops
from . import moe, ssm
from .model import layer_specs, torch_dtype

# leaves the reference keeps in float32 whatever the model's dtype
FLOAT32_LEAVES = ssm.FLOAT32_LEAVES | moe.FLOAT32_LEAVES


def _to_tensor(arr, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=dtype)
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
    (float32 or ``ml_dtypes.bfloat16``) or tensor leaves (a restored
    checkpoint's, ``jax_layout``'s).  Returns the port's parameters
    on ``device`` in the dtypes the reference gives them: the config's
    dtype, except the SSM leaves and the MoE router it keeps in
    float32."""
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


def jax_layout(params: Dict[str, Any], cfg: ArchConfig) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: the port's parameters as the
    reference's tree, ``blocks`` a tuple over pattern positions whose
    leaves stack that position's layers over groups (a leading
    ``num_groups`` axis), each leaf in its dtype on its device."""
    pattern_len = len(cfg.pattern())
    blocks = params["blocks"]
    if len(blocks) % pattern_len:
        raise ValueError(f"{len(blocks)} layers, not whole groups of "
                         f"{pattern_len}")
    if len(blocks) != len(layer_specs(cfg)):
        raise ValueError(f"{len(blocks)} layers; {cfg.name} has "
                         f"{cfg.num_layers}")

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "blocks": tuple(stack(blocks[pos::pattern_len])
                            for pos in range(pattern_len))}


def param_checksums(params: Dict[str, Any], block: int = 1024
                    ) -> Dict[str, torch.Tensor]:
    """The uint32 chunk checksum of every parameter leaf, read as its
    bytes, keyed by its path (``blocks.3.mixer.in_x``): what a worker
    checks weights against on ingest.  On the card all leaves go to one
    launch of the checksum kernel; nothing is synchronised."""
    paths, leaves = [], []

    def walk(tree, path):
        if isinstance(tree, dict):
            items = tree.items()
        elif isinstance(tree, list):
            items = enumerate(tree)
        else:
            paths.append(path)
            leaves.append(tree)
            return
        for k, v in items:
            walk(v, f"{path}.{k}" if path else str(k))
    walk(params, "")
    sums = ops.chunk_checksums(leaves, block, as_bytes=True)
    return dict(zip(paths, sums.unbind(0)))


def _moments_from_jax(tree, device: torch.device):
    """A tree of the reference's moments (float32, bfloat16 or int8
    ``{"q", "scale"}`` leaves; ``blocks`` a tuple) as tensors of the same
    dtypes and layout, bit for bit."""
    if isinstance(tree, dict):
        return {k: _moments_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_moments_from_jax(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16, by name
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    if arr.dtype not in (np.float32, np.int8, np.int32):
        raise TypeError(f"optimizer state leaf of {arr.dtype}")
    return torch.from_numpy(arr).to(device)


def state_from_jax(state: Dict[str, Any], cfg: ArchConfig,
                   device=None) -> Dict[str, Any]:
    """The reference ``Trainer.state`` (numpy or tensor leaves) as the
    port's: ``params`` per layer (``params_from_jax``); ``opt`` with
    ``mu`` and ``nu`` in their moment dtype (float32, bfloat16 or int8
    ``{"q", "scale"}``, the reference's blocks) and ``step`` (int32);
    ``ef_residual`` (float32) where the state has one.  Moments and the
    residual keep the reference's stacked layout."""
    dev = resolve_device(device)
    opt = state["opt"]
    out = {"params": params_from_jax(state["params"], cfg, dev),
           "opt": {"mu": _moments_from_jax(opt["mu"], dev),
                   "nu": _moments_from_jax(opt["nu"], dev),
                   "step": torch.as_tensor(np.array(opt["step"]),
                                           dtype=torch.int32, device=dev)}}
    if "ef_residual" in state:
        out["ef_residual"] = _moments_from_jax(state["ef_residual"], dev)
    return out
