"""The port's serving tier: signature memoization, the session pack cache,
the WorkerPool (thread shards asked for explicitly, and shards spawned as
processes on the caller's device, sharing one store), a pool that cannot
start raising instead of falling back to threads, and the async front
door's coalescing and deadlines, as the JAX package's serving tests ask of
its tier. One spawned pool of two shards serves the whole file."""
import asyncio
import copy
import os

import pytest

import repro_torch
from repro_torch import device as device_mod
from repro_torch.core import suite
from repro_torch.core.cgra import CGRA
from repro_torch.core.encode import EncoderSession
from repro_torch.core.mapper import MapperConfig, map_loop
from repro_torch.core.sat.portfolio import SolverSession
from repro_torch.core.service import (MappingService, dfg_signature,
                                      shape_signature)
from repro_torch.core.workers import (WorkerPool, WorkerStartError,
                                      _probe_shards)
from repro_torch.launch.serve import CompileFrontDoor, DeadlineExceeded

repro_torch.set_default_device("cpu")

CFG = MapperConfig(solver="auto", timeout_s=90)


def _near_variant(g, v=0):
    """Input ``v % sites`` of a two-input node rewired onto the node's other
    producer: one lattice bucket, another exact shape."""
    g2 = copy.deepcopy(g)
    sites = [nid for nid in sorted(g2.nodes)
             if len(g2.nodes[nid].ins) == 2
             and g2.nodes[nid].ins[0][1] == 0
             and g2.nodes[nid].ins[1][1] == 0
             and g2.nodes[nid].ins[0][0] != g2.nodes[nid].ins[1][0]]
    node = g2.nodes[sites[v % len(sites)]]
    keep = node.ins[v // len(sites) % 2][0]
    node.ins = ((keep, 0), (keep, 0))
    g2.touch()
    g2.name = f"{g.name}~v{v}"
    g2.validate()
    return g2


def _same(a, b):
    return (a.success, a.ii, a.mii, a.placement) == \
        (b.success, b.ii, b.mii, b.placement)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("serving") / "store")


@pytest.fixture(scope="module")
def spawned(store_dir):
    """The file's one spawned pool: two process shards on the CPU."""
    with WorkerPool(workers=2, store_path=store_dir) as pool:
        yield pool


# ------------------------------------------------- signature memoization
def test_signature_memoized_on_instance_and_invalidated_on_mutation():
    g = suite.get("sha")
    assert g._sig_cache == {}
    s1 = dfg_signature(g)
    assert g._sig_cache and dfg_signature(g) is s1
    sh1 = shape_signature(g)
    cgra = CGRA(3, 3)
    sh_arch = shape_signature(g, cgra)
    assert shape_signature(g) is sh1
    assert shape_signature(g, cgra) is sh_arch
    g.add("add", [(0, 0), (0, 0)])
    assert g._sig_cache == {} and dfg_signature(g) != s1
    g2 = suite.get("sha")
    dfg_signature(g2)
    g2.touch()
    assert g2._sig_cache == {}
    g3 = suite.get("gsm")
    dfg_signature(g3)
    g4 = copy.deepcopy(g3)
    assert g4._sig_cache == {} and dfg_signature(g4) == dfg_signature(g3)


def test_session_pack_cache_lru_bounded_and_counted():
    sess = SolverSession(EncoderSession(suite.get("sha"), CGRA(3, 3),
                                        CFG.amo), method="cdcl", seed=7)
    sess.max_cached_packs = 2
    for ii in range(3, 8):
        sess.ensure_ii(ii)
        sess.host_pack(ii)
    assert len(sess._pack_np) == 2 and sess.pack_evictions == 3
    _, reused = sess.host_pack(7)
    assert reused and sess.pack_reuses >= 1
    _, reused = sess.host_pack(3)
    assert not reused
    snap = MappingService().stats.snapshot()
    assert "pack_evictions" in snap and "pack_reuses" in snap


# ------------------------------------------------------- thread shards
def test_worker_pool_inline_routes_and_aggregates(tmp_path):
    cgra = CGRA(3, 3)
    kernels = [suite.get(n) for n in ("sha", "gsm", "srand")]
    with WorkerPool(workers=2, store_path=str(tmp_path / "store"),
                    inline=True) as pool:
        assert {pool.shard_of(g, cgra, CFG) for g in kernels} <= {0, 1}
        res = [f.result(timeout=120)
               for f in [pool.submit(g, cgra, CFG) for g in kernels]]
        assert all(r.success for r in res)
        assert pool.shard_of(kernels[0], cgra, CFG) == \
            pool.shard_of(kernels[0], cgra, CFG)
        assert pool.map(kernels[0], cgra, CFG).service.via == "cache"
        st = pool.stats()
        assert st["requests"] == 4 and st["inline"]
        assert st["n_workers"] == 2 and len(st["shards"]) == 1
        assert {p["pid"] for p in _probe_shards(pool)} == {os.getpid()}


def test_workers_0_asks_for_thread_shards():
    with WorkerPool(workers=0) as pool:
        assert pool.inline and pool.n_workers == 1
        assert pool.map(suite.get("srand"), CGRA(2, 2), CFG).success


# ------------------------------------------------------ spawned shards
def test_spawned_shards_run_on_the_callers_device(spawned):
    """Spawn does not inherit the default device: each shard takes the
    parent's (here the CPU) in its initialiser."""
    assert not spawned.inline and spawned.n_workers == 2
    probes = _probe_shards(spawned)
    assert [p["device"] for p in probes] == ["cpu", "cpu"]
    pids = {p["pid"] for p in probes}
    assert len(pids) == 2 and os.getpid() not in pids
    # the CPU route launches no kernel
    assert all(not any(p["launches"].values()) for p in probes)


def test_spawned_pool_serves_what_direct_mapping_serves(spawned):
    cgra = CGRA(3, 3)
    names = ("sha", "gsm", "srand")
    futs = {n: spawned.submit(suite.get(n), cgra, CFG) for n in names}
    for n in names:
        r = futs[n].result(timeout=300)
        assert r.service.via == "cold"
        assert _same(r, map_loop(suite.get(n), cgra, CFG)), n
    again = spawned.map(suite.get("sha"), cgra, CFG, timeout=300)
    assert again.service.via == "cache"
    st = spawned.stats()
    assert not st["inline"] and len(st["shards"]) == 2
    assert st["requests"] >= 4 and st["disk_writes"] >= 3


def test_spawned_shards_share_their_store(spawned, store_dir):
    """What a shard process persisted, another process reads from disk."""
    cgra = CGRA(2, 2)
    r = spawned.map(suite.get("bitcount"), cgra, CFG, timeout=300)
    with WorkerPool(workers=1, store_path=store_dir, inline=True) as pool:
        got = pool.map(suite.get("bitcount"), cgra, CFG)
    assert got.service.via == "disk" and _same(got, r)


def test_front_door_over_spawned_shards_admits_near_shapes(spawned):
    cgra = CGRA(3, 3)
    base = [suite.get(n) for n in ("nw", "bitcount")]
    corpus = base + [_near_variant(g, v) for g in base for v in (0, 1)]
    near0 = spawned.stats().get("near_hits", 0)

    async def drive():
        async with CompileFrontDoor(spawned, window_ms=4.0) as door:
            first = await asyncio.gather(*(door.compile(g, cgra, CFG)
                                           for g in base))
            rest = await asyncio.gather(*(door.compile(g, cgra, CFG)
                                          for g in corpus[len(base):]))
            return first + rest, door.stats.snapshot()

    res, stats = asyncio.run(drive())
    for g, r in zip(corpus, res):
        assert _same(r, map_loop(g, cgra, CFG)), g.name
    assert stats["served"] == len(corpus) and stats["failed"] == 0
    assert spawned.stats()["near_hits"] - near0 >= 1


# ------------------------------------------------- no fall-back to threads
def test_a_pool_that_cannot_start_raises(tmp_path):
    not_a_dir = tmp_path / "file"
    not_a_dir.write_text("a store path that is a file")
    with pytest.raises(WorkerStartError, match="did not start"):
        WorkerPool(workers=1, store_path=str(not_a_dir))


def test_a_pool_on_a_missing_device_raises(monkeypatch):
    monkeypatch.setattr(device_mod, "_DEFAULT", "cuda")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(device_mod.DeviceUnavailable):
        WorkerPool(workers=1)


# ------------------------------------------------------------- front door
def test_front_door_coalesces_and_matches_direct(tmp_path):
    cgra = CGRA(3, 3)
    g = suite.get("srand")
    gother = suite.get("bitcount")

    async def drive():
        with WorkerPool(workers=2, store_path=str(tmp_path / "store"),
                        inline=True) as pool:
            async with CompileFrontDoor(pool, window_ms=20,
                                        max_batch=64) as door:
                res = await asyncio.gather(*(
                    [door.compile(g, cgra, CFG) for _ in range(12)]
                    + [door.compile(gother, cgra, CFG)]))
                stats = door.stats.snapshot()
        return res, stats

    res, stats = asyncio.run(drive())
    assert all(r.success for r in res)
    assert len({(r.ii, tuple(sorted(r.placement.items())))
                for r in res[:12]}) == 1
    assert stats["submitted"] == stats["served"] == 13
    assert stats["coalesced"] >= 1 and stats["failed"] == 0
    assert _same(res[0], map_loop(g, cgra, CFG))


def test_front_door_enforces_deadlines():
    cgra = CGRA(3, 3)
    g = suite.get("nw")

    async def drive():
        with WorkerPool(workers=1, inline=True) as pool:
            async with CompileFrontDoor(pool) as door:
                with pytest.raises(DeadlineExceeded):
                    await door.compile(g, cgra, CFG, deadline_s=1e-4)
                r = await door.compile(g, cgra, CFG, deadline_s=120)
                return r, door.stats.snapshot()

    r, stats = asyncio.run(drive())
    assert r.success
    assert stats["deadline_violations"] == 1 and stats["served"] == 1


def test_front_door_needs_start():
    door = CompileFrontDoor(pool=None)
    with pytest.raises(RuntimeError, match="not started"):
        asyncio.run(door.compile(suite.get("nw"), CGRA(2, 2)))
