"""Federation-backed checkpointing — restart storms through pod caches.

Saves go through the data plane's **write path** (``DataPlane.store``,
the paper's §6 write-back future work): the training job acks as soon as
bytes land in the pod cache; ``DataPlane.drain`` pushes dirty objects to
the origin under a rate limit so a 512-host synchronous save cannot melt
the storage fabric.

Restores are the paper's headline scenario inverted onto the fleet: after
a preemption, every host of a pod re-reads the same checkpoint objects —
the first reader warms the pod cache and the other N−1 hit it, so the
origin sees each byte once per pod instead of once per host.

Layout: one federation object per parameter leaf (so a host restoring a
*shard* fetches only the leaves it owns) plus a JSON manifest:

    /ckpt/<run>/step_<k>/manifest.json
    /ckpt/<run>/step_<k>/<leaf.path>.npy

The port of ``repro.train.checkpoint``.  A state is a nested dict, list or
tuple of tensors (or numpy arrays); its leaves are named and ordered as
the reference's ``jax.tree_util.tree_flatten_with_path`` names and
orders them (dict keys sorted, sequence indices), so a state in the
reference's layout (``models.jax_layout``) gives the reference's object
names, ``.npy`` bytes and manifest.  bf16 leaves are stored widened to
float32 and restored bit-exact as bf16 tensors on the caller's device.
The chunks' digests are taken where the plane's federation digests real
bytes (its ``device``).

The legacy ``(run, writeback, client)`` form still works — the pair is
wrapped in a :class:`~repro_torch.core.api.ClientPlane` with a
``DeprecationWarning``.
"""
from __future__ import annotations

import io
import json
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.api import ClientPlane, DataPlane, FetchRequest, FetchResult
from ..core.monitoring import FetchRollup
from ..device import resolve_device


def _items(node):
    """A node's children in the reference's tree order, or None for a
    leaf: dict keys sorted, sequence indices."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    items = _items(tree)
    if items is None:
        return [] if tree is None else [(prefix, tree)]
    out = []
    for k, v in items:
        out += _leaf_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    items = _items(like)
    if items is None:
        return None if like is None else next(leaves)
    if isinstance(like, dict):
        filled = {k: _unflatten(v, leaves) for k, v in items}
        return {k: filled[k] for k in like}
    return type(like)(_unflatten(v, leaves) for _, v in items)


def _encode_array(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _decode_array(raw: bytes) -> np.ndarray:
    return np.load(io.BytesIO(raw), allow_pickle=False)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array to store and its dtype's name: bf16 is widened
    to float32 (npy-portable) and named ``bfloat16``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return _contiguous(t.float().cpu().numpy()), "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":        # ml_dtypes', by name
            return _contiguous(arr.astype(np.float32)), "bfloat16"
    return _contiguous(arr), str(arr.dtype)


def _contiguous(arr: np.ndarray) -> np.ndarray:
    """A C-contiguous array of ``arr``'s shape: a 0-d leaf (the
    optimizer's step) stays 0-d, as the reference stores it."""
    return np.ascontiguousarray(arr).reshape(arr.shape)


def _fold(agg: FetchResult, res: FetchResult) -> None:
    agg.seconds += res.seconds
    agg.bytes += res.bytes
    agg.chunks += res.chunks
    agg.cache_hits += res.cache_hits
    agg.cache_misses += res.cache_misses
    agg.local_hits += res.local_hits
    agg.size = agg.bytes


class FederatedCheckpointer:
    """Checkpoint save/restore through a :class:`DataPlane`."""

    def __init__(self, run: str, plane: DataPlane, client=None, *,
                 site: str = "", worker: int = 0) -> None:
        if not hasattr(plane, "fetch"):
            # Legacy call site: (run, writeback, client).
            warnings.warn(
                "FederatedCheckpointer(run, writeback, client) is "
                "deprecated; pass a DataPlane (e.g. AnalyticPlane(fed)) "
                "and site/worker", DeprecationWarning, stacklevel=2)
            plane = ClientPlane(client=client, writeback=plane)
        self.run = run
        self.plane = plane
        self.site = site
        self.worker = worker
        self.stats = FetchRollup("checkpointer")
        self.leaves = 0

    def prefix(self, step: int) -> str:
        return f"/ckpt/{self.run}/step_{step:08d}"

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, drain: bool = True) -> FetchResult:
        """Write state through the plane's write-back path; optionally
        drain to the origin now.  Returns the aggregate store result
        (drain time is accounted in ``stats``, not the return — acks
        happen at cache residency)."""
        agg = FetchResult(path=self.prefix(step), method="checkpoint-save",
                          plane=getattr(self.plane, "name", ""))
        manifest = {"step": step, "leaves": []}
        for name, leaf in _leaf_paths(state):
            arr, stored_dtype = _to_numpy(leaf)
            path = f"{self.prefix(step)}/{name}.npy"
            res = self.plane.store(path, _encode_array(arr),
                                   site=self.site, worker=self.worker)
            self.stats.add(res)
            _fold(agg, res)
            manifest["leaves"].append(
                {"name": name, "path": path, "dtype": stored_dtype,
                 "shape": list(arr.shape)})
        res = self.plane.store(f"{self.prefix(step)}/manifest.json",
                               json.dumps(manifest).encode(),
                               site=self.site, worker=self.worker)
        self.stats.add(res)
        _fold(agg, res)
        if drain:
            self.stats.add(self.plane.drain())
        self.leaves = len(manifest["leaves"])
        return agg

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        """Newest checkpoint the plane can see (origin catalogs plus
        not-yet-drained write-back objects — read-your-writes)."""
        best = None
        for p in self.plane.paths(f"/ckpt/{self.run}/"):
            if p.endswith("manifest.json"):
                step = int(p.split("step_")[1].split("/")[0])
                best = step if best is None else max(best, step)
        return best

    def _fetch(self, path: str) -> FetchResult:
        res = self.plane.fetch(FetchRequest(
            path=path, site=self.site, worker=self.worker,
            method="cvmfs", want_data=True, tenant="checkpoint"))
        self.stats.add(res)
        if not res.ok or res.data is None:
            raise FileNotFoundError(res.error or path)
        return res

    def restore(self, step: int, like=None,
                device=None) -> Tuple[Any, FetchResult]:
        """Fetch a checkpoint through the nearest cache.  Leaves come back
        as tensors on ``device`` (``None`` means ``cuda``), in their stored
        dtypes (bf16 narrowed back exactly); a ``name → tensor`` dict, or
        ``like``'s structure when it is given."""
        dev = resolve_device(device)
        agg = FetchResult(path=self.prefix(step),
                          method="checkpoint-restore",
                          plane=getattr(self.plane, "name", ""))
        res = self._fetch(f"{self.prefix(step)}/manifest.json")
        _fold(agg, res)
        manifest = json.loads(res.data.decode())
        leaves: Dict[str, torch.Tensor] = {}
        for entry in manifest["leaves"]:
            res = self._fetch(entry["path"])
            _fold(agg, res)
            t = torch.from_numpy(_decode_array(res.data)).to(dev)
            if entry["dtype"] == "bfloat16":
                t = t.to(torch.bfloat16)
            leaves[entry["name"]] = t
        if like is None:
            return leaves, agg
        flat = iter([leaves[name] for name, _ in _leaf_paths(like)])
        return _unflatten(like, flat), agg
