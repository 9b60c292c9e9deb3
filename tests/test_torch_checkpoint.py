"""The port's federation-backed checkpointer against ``repro.train`` on the
CPU.

Same inputs as the reference's own test of the weight leg
(``tests/test_train_traffic.py``): the qwen2-7b smoke config, weights
from the reference's ``init_lm(PRNGKey(0))`` carried across by
``params_from_jax``, a fleet of one pod of 4 hosts behind
``AnalyticPlane``.  The reference saves its tree; the port saves its
parameters in the reference's layout (``jax_layout``) through a
federation that digests real bytes on the CPU.  Everything the
federation holds after save and drain (object bytes, the manifest,
every catalog's chunk digests) and every ``FetchResult`` counter must be
equal; restored leaves bit-exact, in float32 and in bf16.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as TC
from repro.configs import get_config as jax_config
from repro.models import init_lm as jax_init_lm
from repro.train import FederatedCheckpointer as JaxCheckpointer
from repro_torch.configs import get_config
from repro_torch.models import jax_layout, params_from_jax
from repro_torch.train import FederatedCheckpointer

RESULT_KEYS = ("bytes", "chunks", "cache_hits", "cache_misses", "local_hits",
               "seconds", "size", "method", "path", "ok")


def _weights(dtype):
    jcfg = dataclasses.replace(jax_config("qwen2-7b", smoke=True),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              dtype=dtype)
    jp, _ = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    return cfg, jp, params_from_jax(jp, cfg, device="cpu")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def weights(request):
    return _weights(request.param)


def _planes():
    return (RC.AnalyticPlane(RC.build_fleet_federation(num_pods=1,
                                                       hosts_per_pod=4)),
            TC.AnalyticPlane(TC.build_fleet_federation(
                num_pods=1, hosts_per_pod=4, device="cpu")))


def _result(res):
    return {k: getattr(res, k) for k in RESULT_KEYS}


def _held(plane):
    """Every object the origin holds: its catalog entry and its bytes."""
    origin = plane.fed.origins[0]
    out = {}
    for meta in origin.list_objects():
        data = b"".join(origin.store.get_chunk(meta.path, i).data
                        for i in range(meta.num_chunks))
        out[meta.path] = (meta.size, meta.chunk_size,
                          list(meta.chunk_digests), data)
    return out


def _saved(weights):
    cfg, jp, p = weights
    ref_plane, plane = _planes()
    ref_ck = JaxCheckpointer("srv", ref_plane, site="pod0", worker=0)
    ck = FederatedCheckpointer("srv", plane, site="pod0", worker=0)
    return (ref_plane, plane, ref_ck, ck, ref_ck.save(0, jp),
            ck.save(0, jax_layout(p, cfg)))


def test_save_and_drain_hold_the_references_objects(weights):
    ref_plane, plane, ref_ck, ck, ref_res, res = _saved(weights)
    held, want = _held(plane), _held(ref_plane)
    assert sorted(held) == sorted(want)
    assert held == want
    manifest = json.loads(held["/ckpt/srv/step_00000000/manifest.json"][3])
    assert len(manifest["leaves"]) == ck.leaves == ref_ck.leaves == 15
    assert {e["dtype"] for e in manifest["leaves"]} == \
        {"float32" if weights[0].dtype == "float32" else "bfloat16"}
    assert _result(res) == _result(ref_res)
    assert dataclasses.asdict(ck.stats) == dataclasses.asdict(ref_ck.stats)
    assert plane._writebacks and not any(
        wb.dirty_paths() for wb in plane._writebacks.values())


def test_restore_counters_and_leaves(weights):
    cfg, _, p = weights
    ref_plane, plane, *_ = _saved(weights)
    ref_ck = JaxCheckpointer("srv", ref_plane, site="pod0", worker=1)
    ck = FederatedCheckpointer("srv", plane, site="pod0", worker=1)
    want_tree, want = ref_ck.restore(0)
    got_tree, got = ck.restore(0, device="cpu")
    assert _result(got) == _result(want)
    assert got.cache_hits > 0 and got.chunks == want.chunks
    assert dataclasses.asdict(ck.stats) == dataclasses.asdict(ref_ck.stats)
    assert sorted(got_tree) == sorted(want_tree)
    saved = jax_layout(p, cfg)
    for name, t in got_tree.items():
        keys = name.split("/")
        leaf = saved
        for k in keys:
            leaf = leaf[int(k)] if isinstance(leaf, tuple) else leaf[k]
        assert t.dtype == leaf.dtype and t.device.type == "cpu"
        assert torch.equal(t, leaf), name
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(want_tree[name], np.float32))


def test_restore_like_gives_the_port_parameters(weights):
    cfg, _, p = weights
    _, plane, *_ = _saved(weights)
    ck = FederatedCheckpointer("srv", plane, site="pod0", worker=2)
    tree, _ = ck.restore(0, like=jax_layout(p, cfg), device="cpu")
    assert isinstance(tree["blocks"], tuple)
    got = params_from_jax(tree, cfg, device="cpu")
    flat = [(a, b) for a, b in zip(_leaves(got), _leaves(p), strict=True)]
    assert flat and all(a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in flat)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_latest_step_matches():
    cfg, jp, p = _weights("float32")
    ref_plane, plane = _planes()
    steps = []
    for core_plane, ck_cls, state in ((ref_plane, JaxCheckpointer, jp),
                                      (plane, FederatedCheckpointer,
                                       jax_layout(p, cfg))):
        ck = ck_cls("run", core_plane, site="pod0", worker=0)
        got = [ck.latest_step()]
        ck.save(0, {"w": state["final_norm"]})
        ck.save(7, {"w": state["final_norm"]}, drain=False)   # dirty
        got.append(ck.latest_step())
        ck.save(3, {"w": state["final_norm"]})
        got.append(ck.latest_step())
        steps.append(got)
    assert steps[0] == steps[1] == [None, 7, 7]


def test_leaf_names_follow_the_references_tree_order():
    """Dict keys sorted, sequence indices, None an empty subtree — the
    order ``jax.tree_util.tree_flatten_with_path`` gives."""
    from repro_torch.train import checkpoint
    tree = {"b": [np.zeros(1), {"z": np.ones(2), "a": None}],
            "a": (np.zeros(3),), "c": np.zeros(())}
    got = [name for name, _ in checkpoint._leaf_paths(tree)]
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert got == want == ["a/0", "b/0", "b/1/z", "c"]


def test_legacy_form_warns_and_saves():
    def run(core, cls):
        fed = core.build_fleet_federation(
            num_pods=1, hosts_per_pod=4,
            **({"device": "cpu"} if core is TC else {}))
        wb = fed.writeback("pod0/cache")
        with pytest.warns(DeprecationWarning):
            ck = cls("old", wb, fed.client("pod0", 0))
        res = ck.save(0, {"w": np.arange(6, dtype=np.float32)})
        return _result(res), dataclasses.asdict(ck.stats)
    assert run(TC, FederatedCheckpointer) == run(RC, JaxCheckpointer)


def test_restore_defaults_to_cuda(monkeypatch):
    cfg, _, p = _weights("float32")
    _, plane = _planes()
    FederatedCheckpointer("srv", plane, site="pod0").save(
        0, jax_layout(p, cfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FederatedCheckpointer("srv", plane, site="pod0",
                              worker=1).restore(0)
    # a federation built without a device digests real bytes on the card
    fed = TC.build_fleet_federation(num_pods=1, hosts_per_pod=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        FederatedCheckpointer("x", TC.AnalyticPlane(fed),
                              site="pod0").save(0, {"w": p["final_norm"]})
