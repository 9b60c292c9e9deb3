"""AdamW with configurable moment precision (fp32 / bf16 / int8-blockwise).

The port of ``repro.train.optimizer``.  The int8 mode is blockwise
quantized (per-256-element absmax scales) with the same update math in
fp32 — a standard 8-bit-Adam construction.  ``schedule`` and the bias
corrections are float32 tensors, as the reference computes them.

The port keeps one parameter dictionary per layer; the reference stacks
each pattern position's layers over groups.  Two things of the
reference's follow that stacking, and the port keeps them:

* **Weight decay by the stacked rank.**  A leaf is decayed where its
  reference leaf has rank >= 2, so a layer's ``norm1`` (d,), which the
  reference holds as (G, d), is decayed; ``final_norm`` is not.
* **The int8 blocks of the stack.**  The moments live in the reference's
  layout (``blocks`` a tuple over pattern positions, each leaf stacked
  over groups, ``opt_layout``), so an int8 moment's blocks of 256 cut the
  stack's flattening, as the reference's do, and ``state_from_jax``
  carries them bit for bit.

``adamw_update`` updates the parameters and the moments in place (one
copy of the state on the card, not two) and returns them.
``opt_state_specs`` waits for ``sharding/rules.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

BLOCK = 256
Path = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"       # float32 | bfloat16 | int8
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay, a float32 tensor."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                         1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


# ---------------------------------------------------------------------------
# Blockwise int8 moment codec
# ---------------------------------------------------------------------------
def _q8_encode(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / scale.clamp_min(1e-12)).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _q8_decode(enc: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    flat = (enc["q"].float() * enc["scale"]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def _encode_moment(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _q8_encode(x)
    return x.to(getattr(torch, dtype))


def _decode_moment(m, shape, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _q8_decode(m, shape)
    return m.float()


# ---------------------------------------------------------------------------
# The reference's leaves over the port's per-layer parameters
# ---------------------------------------------------------------------------
def walk(tree, path: Path = ()):
    """(path, leaf) of every tensor of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (i,))
    else:
        yield path, tree


def get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def put(tree, path: Path, value) -> None:
    get(tree, path[:-1])[path[-1]] = value


def ref_units(params, period: int) -> List[Tuple[Path, List[Path]]]:
    """Each leaf of the reference's layout as (its path there, the paths of
    the port's leaves it stacks): ``embed``'s and ``final_norm`` alone;
    ``("blocks", pos, ...)`` stacking layers pos, pos + period, ... in
    group order."""
    units = [(p, [p]) for p, _ in walk({k: v for k, v in params.items()
                                        if k != "blocks"})]
    layers = len(params["blocks"])
    if layers % period:
        raise ValueError(f"{layers} layers, not whole groups of {period}")
    for pos in range(period):
        for sub, _ in walk(params["blocks"][pos]):
            units.append((("blocks", pos) + sub,
                          [("blocks", layer) + sub
                           for layer in range(pos, layers, period)]))
    return units


def stacked(tree, unit: Tuple[Path, List[Path]]) -> torch.Tensor:
    """A unit's leaf in the reference's shape: its layers' leaves stacked
    over groups (a block leaf), or the leaf itself."""
    path, leaves = unit
    if path[0] != "blocks":
        return get(tree, leaves[0])
    return torch.stack([get(tree, p) for p in leaves])


def opt_layout(params, period: int, fn) -> Dict[str, Any]:
    """The reference's tree of ``fn(shape)`` over its leaves' shapes:
    ``blocks`` a tuple over pattern positions."""
    out: Dict[str, Any] = {"blocks": [{} for _ in range(period)]}
    for path, leaves in ref_units(params, period):
        leaf = get(params, leaves[0])
        shape = tuple(leaf.shape) if path[0] != "blocks" else \
            (len(leaves),) + tuple(leaf.shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {}) if isinstance(node, dict) else \
                node[k]
        node[path[-1]] = fn(shape, leaf.device)
    out["blocks"] = tuple(out["blocks"])
    return out


# ---------------------------------------------------------------------------
def init_opt_state(params, cfg: AdamWConfig, period: int):
    """Zero moments in the reference's layout (``period``: the config's
    pattern length), and a step count of 0."""
    def zeros(shape, device):
        return _encode_moment(torch.zeros(shape, device=device),
                              cfg.moment_dtype)
    device = params["final_norm"].device
    return {"mu": opt_layout(params, period, zeros),
            "nu": opt_layout(params, period, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in leaves]).sum())


def _adam(p, g, m, v, lr, clip, b1c, b2c, cfg: AdamWConfig, decay: bool):
    """One leaf's update in float32: (new p in p's dtype, m, v)."""
    g = g.float() * clip
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    mhat = m / b1c
    vhat = v / b2c
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    if decay:
        delta = delta + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m, v


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig):
    """One AdamW step, in place.  ``grads`` and ``params`` are the port's
    per-layer trees; ``opt_state`` is ``init_opt_state``'s.  Returns
    (params, opt_state, metrics)."""
    period = len(opt_state["mu"]["blocks"])
    units = ref_units(params, period)
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm([g for _, g in walk(grads)])
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0) if cfg.grad_clip else 1.0
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    int8 = cfg.moment_dtype == "int8"
    for unit in units:
        path, leaves = unit
        block = path[0] == "blocks"
        decay = bool(cfg.weight_decay) and \
            get(params, leaves[0]).dim() + block >= 2
        mu, nu = get(opt_state["mu"], path), get(opt_state["nu"], path)
        if int8:      # the stack's blocks: decode, step and encode it whole
            p = stacked(params, unit)
            new_p, m, v = _adam(p, stacked(grads, unit),
                                _q8_decode(mu, p.shape),
                                _q8_decode(nu, p.shape), lr, clip, b1c, b2c,
                                cfg, decay)
            put(opt_state["mu"], path, _q8_encode(m))
            put(opt_state["nu"], path, _q8_encode(v))
            for i, lp in enumerate(leaves):
                get(params, lp).copy_(new_p[i] if block else new_p)
            continue
        for i, lp in enumerate(leaves):        # elementwise: layer by layer
            p = get(params, lp)
            m_i, v_i = (mu[i], nu[i]) if block else (mu, nu)
            new_p, m, v = _adam(p, get(grads, lp), m_i.float(), v_i.float(),
                                lr, clip, b1c, b2c, cfg, decay)
            p.copy_(new_p)
            m_i.copy_(m)
            v_i.copy_(v)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
