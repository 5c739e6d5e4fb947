"""The port's mapping service (``repro_torch.core.service``) against the
JAX package's: the request signatures and near-shape keys equal the
reference's on every suite DFG; the service serves the same II, placement
and attempts as the reference service with CDCL on the 2x2 and 3x3 cells,
and prunes the same IIs on a warm pass; and the cache, disk restart with
core preload, near-shape admission, session pool and a concurrent hammer
behave as the JAX package's service tests ask of it."""
import copy
import threading

import pytest

from repro.core import suite as ref_suite
from repro.core.cgra import CGRA as RefCGRA
from repro.core.mapper import MapperConfig as RefConfig
from repro.core.service import MappingService as RefService
from repro.core.service import (dfg_signature as ref_dfg_sig,
                                near_shape_key as ref_near_key,
                                shape_signature as ref_shape_sig)
import repro_torch
from repro_torch import MapRequest, compile
from repro_torch.core import suite
from repro_torch.core.cgra import CGRA
from repro_torch.core.dfg import DFG
from repro_torch.core.mapper import MapperConfig, map_loop
from repro_torch.core.service import (MappingService, dfg_signature,
                                      get_service, near_shape_key,
                                      reset_service, shape_signature,
                                      topology_signature)
from repro_torch.core.simulator import verify_mapping
from repro_torch.core.store import MappingStore

repro_torch.set_default_device("cpu")

CFG = MapperConfig(solver="auto", timeout_s=90)
CDCL = dict(solver="cdcl", timeout_s=90)


def _near_variant(g):
    """One rewired edge: same node/edge counts, kinds, and distance set
    (same lattice bucket), different exact wiring (different shape)."""
    g2 = copy.deepcopy(g)
    for nid in sorted(g2.nodes):
        ins = g2.nodes[nid].ins
        if (len(ins) == 2 and ins[0][1] == 0 and ins[1][1] == 0
                and ins[0][0] != ins[1][0]):
            g2.nodes[nid].ins = ((ins[0][0], 0), (ins[0][0], 0))
            g2.touch()
            g2.validate()
            return g2
    raise AssertionError("kernel has no rewireable two-input node")


def _served(r):
    return (r.success, r.ii, r.mii, r.placement,
            [(a.ii, a.status, a.via) for a in r.attempts])


# ------------------------------------------------- signatures vs reference
@pytest.mark.parametrize("name", suite.names())
def test_signatures_equal_reference(name):
    g, rg = suite.get(name), ref_suite.get(name)
    assert dfg_signature(g) == ref_dfg_sig(rg)
    assert shape_signature(g) == ref_shape_sig(rg)
    for r, c in ((2, 2), (3, 3), (4, 4)):
        sh, rsh = shape_signature(g, CGRA(r, c)), \
            ref_shape_sig(rg, RefCGRA(r, c))
        assert sh == rsh
        for delta in (0, 1, 2):
            assert near_shape_key(sh, delta) == ref_near_key(rsh, delta)


# -------------------------------------- served results vs the reference's
@pytest.mark.parametrize("size,name", [(size, name)
                                       for size in ("2x2", "3x3")
                                       for name in suite.names()])
def test_service_serves_what_the_reference_service_serves(size, name):
    """Cold pass and forced warm pass (use_cache=False) of a suite kernel
    through each package's service, with CDCL: the same verdict, II, MII,
    placement (the schedule's PE, cycle and iteration per node) and
    attempts, the same IIs pruned from the recorded cores, and the same
    service counters."""
    r, c = int(size[0]), int(size[2])
    svc, ref = MappingService(), RefService()
    cgra, rcgra = CGRA(r, c), RefCGRA(r, c)
    g, rg = suite.get(name), ref_suite.get(name)
    cold = svc.map(g, cgra, MapperConfig(**CDCL))
    rcold = ref.map(rg, rcgra, RefConfig(**CDCL))
    assert _served(cold) == _served(rcold)
    assert cold.service.via == rcold.service.via == "cold"
    warm = svc.map(g, cgra, MapperConfig(**CDCL), use_cache=False)
    rwarm = ref.map(rg, rcgra, RefConfig(**CDCL), use_cache=False)
    assert _served(warm) == _served(rwarm)
    assert warm.service.via == "warm"
    assert warm.service.iis_pruned == rwarm.service.iis_pruned
    if warm.success and warm.ii > warm.mii:
        assert warm.service.iis_pruned == warm.ii - warm.mii
    assert svc.stats.snapshot() == ref.stats.snapshot()


# ------------------------------------------------------------ the front door
def test_compile_routes_service_default_and_instances():
    reset_service()
    try:
        g = suite.get("srand")
        r1 = compile(MapRequest(dfg=g, arch="3x3", service="default"))
        r2 = compile(MapRequest(dfg=suite.get("srand"), arch="3x3",
                                service="default"))
        assert r1.service.via == "cold" and r2.service.via == "cache"
        assert get_service().stats.requests == 2
        svc = MappingService()
        r3 = compile(MapRequest(dfg=g, arch="3x3", service=svc))
        assert r3.service.via == "cold" and svc.stats.requests == 1
        assert r3.ii == r1.ii == compile(MapRequest(dfg=g, arch="3x3")).ii
        with pytest.raises(ValueError, match="unknown service"):
            compile(MapRequest(dfg=g, arch="3x3", service="elsewhere"))
    finally:
        reset_service()


def test_run_suite_through_service():
    svc = MappingService()
    cgra = CGRA(3, 3)
    first = suite.run_suite(cgra, CFG, names_subset=["gsm", "srand"],
                            service=svc)
    second = suite.run_suite(cgra, CFG, names_subset=["gsm", "srand"],
                             service=svc)
    for name in ("gsm", "srand"):
        assert second[name].service.cache_hit
        assert first[name].ii == second[name].ii


def test_map_loop_service_param_routes_through_service():
    svc = MappingService()
    cgra = CGRA(3, 3)
    r1 = map_loop(suite.get("nw"), cgra, CFG, service=svc)
    r2 = map_loop(suite.get("nw"), cgra, CFG, service=svc)
    assert r1.service is not None and r2.service.cache_hit
    assert r1.ii == r2.ii and svc.stats.requests == 2


def test_unresolvable_guide_runs_unguided_through_the_service():
    svc = MappingService()
    r = svc.map(suite.get("srand"), CGRA(3, 3), MapperConfig(guide="any"),
                sweep_width=2)
    base = svc.map(suite.get("srand"), CGRA(3, 3), MapperConfig(),
                   sweep_width=2)
    assert r.success and r.ii == base.ii
    assert r.guidance == {"guide": "any", "used": False}


# ------------------------------------------------------------ mapping cache
def test_cache_hit_determinism_and_isolated_copies():
    svc = MappingService()
    cgra = CGRA(3, 3)
    r1 = svc.map(suite.get("sha"), cgra, CFG)
    r2 = svc.map(suite.get("sha"), cgra, CFG)
    assert r1.service.via == "cold" and not r1.service.cache_hit
    assert r2.service.via == "cache" and r2.service.cache_hit
    assert (r1.ii, r1.mii, r1.placement) == (r2.ii, r2.mii, r2.placement)
    r2.ii = None           # the returned wrapper is a copy
    assert svc.map(suite.get("sha"), cgra, CFG).ii == r1.ii
    assert svc.stats.cache_hits == 2 and svc.stats.requests == 3
    rc = copy.deepcopy(r1)
    assert rc.ii == r1.ii and rc.service.via == r1.service.via


def test_cache_keyed_on_config_and_topology():
    svc = MappingService()
    svc.map(suite.get("gsm"), CGRA(3, 3), CFG)
    assert not svc.map(suite.get("gsm"), CGRA(4, 4), CFG).service.cache_hit
    assert not svc.map(suite.get("gsm"), CGRA(3, 3), MapperConfig(
        solver="auto", timeout_s=90, amo="sequential")).service.cache_hit
    assert svc.map(suite.get("gsm"), CGRA(3, 3), CFG).service.cache_hit
    assert topology_signature(CGRA(3, 3)) != topology_signature(
        CGRA(3, 3, topology="torus"))


# ----------------------------------------------------------- session pool
def test_same_shape_requests_share_one_session():
    svc = MappingService()
    cgra = CGRA(2, 2)

    def build(op):
        g = DFG("shape")
        a = g.add("const", imm=5)
        b = g.add("iv")
        c = g.add(op, [(a, 0), (b, 0)])
        g.add("xor", [(c, 0), (b, 0)])
        return g
    r_add = svc.map(build("add"), cgra, CFG)
    r_sub = svc.map(build("sub"), cgra, CFG)
    assert not r_sub.service.cache_hit and r_sub.service.session_reused
    assert svc.n_sessions == 1 and r_add.ii == r_sub.ii
    for r, g in ((r_add, build("add")), (r_sub, build("sub"))):
        assert verify_mapping(g, cgra, r.placement, r.ii, n_iters=6).ok


def test_session_pool_is_lru_bounded():
    svc = MappingService(max_sessions=2)
    for r, c in ((2, 2), (3, 3), (4, 4)):
        svc.map(suite.get("srand"), CGRA(r, c), CFG)
    assert svc.n_sessions == 2 and svc.stats.session_evictions == 1


def test_sweep_through_service_prunes_and_agrees():
    svc = MappingService()
    cgra = CGRA(3, 3)
    r1 = svc.map(suite.get("sha"), cgra, CFG)
    r2 = svc.map(suite.get("sha"), cgra, CFG, sweep_width=3,
                 use_cache=False)
    assert r2.ii == r1.ii and any(a.via == "core" for a in r2.attempts)


# ------------------------------------------- disk restart and core preload
def test_disk_restart_serves_from_disk_and_preloads_cores(tmp_path):
    path = str(tmp_path / "store")
    cgra = CGRA(3, 3)
    g = suite.get("sha")
    svc1 = MappingService(store=MappingStore(path))
    r_cold = svc1.map(g, cgra, CFG)
    assert r_cold.success and r_cold.service.via == "cold"
    assert svc1.stats.disk_writes == 1
    n_unsat = sum(a.status == "UNSAT" for a in r_cold.attempts)
    assert n_unsat >= 1 and svc1.stats.cores_persisted == n_unsat

    svc2 = MappingService(store=MappingStore(path))   # a restarted process
    r_disk = svc2.map(g, cgra, CFG)
    assert r_disk.service.via == "disk" and svc2.stats.disk_hits == 1
    assert (r_disk.ii, r_disk.placement) == (r_cold.ii, r_cold.placement)
    assert svc2.map(g, cgra, CFG).service.via == "cache"

    r_resolve = svc2.map(g, cgra, CFG, use_cache=False)
    assert r_resolve.ii == r_cold.ii
    assert svc2.stats.cores_preloaded == n_unsat
    assert r_resolve.service.iis_pruned == n_unsat
    assert all(a.via == "core" for a in r_resolve.attempts
               if a.status == "UNSAT")
    # each persisted core carries its refuted projection as a witness
    store = MappingStore(path)
    skey = next(iter(svc2._pool))
    assert all(store.verify_core(skey, ii)
               for ii in store.cores_for(skey))


# --------------------------------------------------- near-shape admission
def test_near_shape_admission_seeds_a_fresh_session():
    cgra = CGRA(3, 3)
    g = suite.get("sha")
    gv = _near_variant(g)
    assert shape_signature(g) != shape_signature(gv)
    assert near_shape_key(shape_signature(g), 1) == \
        near_shape_key(shape_signature(gv), 1)
    svc = MappingService(near_delta=1)
    assert not svc.map(g, cgra, CFG).service.near_seeded
    r2 = svc.map(gv, cgra, CFG)
    assert r2.success and r2.service.near_seeded
    assert svc.stats.near_hits == 1
    assert verify_mapping(r2.dfg, cgra, r2.placement, r2.ii, n_iters=5).ok
    svc0 = MappingService(near_delta=0)
    svc0.map(g, cgra, CFG)
    svc0.map(gv, cgra, CFG)
    assert svc0.stats.near_hits == 0


# ------------------------------------------------ concurrent service hammer
def test_service_concurrent_hammer_is_consistent():
    svc = MappingService()
    cgra = CGRA(3, 3)
    kernels = [suite.get("sha"), suite.get("gsm")]
    n_threads, per_thread = 8, 4
    results, errors = [], []

    def worker(t):
        try:
            for i in range(per_thread):
                g = kernels[(t + i) % len(kernels)]
                results.append((g.name, svc.map(g, cgra, CFG)))
        except Exception as e:          # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    assert svc.stats.requests == len(results) == n_threads * per_thread
    by_kernel = {}
    for name, r in results:
        assert r.success
        by_kernel.setdefault(name, set()).add(
            (r.ii, tuple(sorted(r.placement.items()))))
    assert all(len(v) == 1 for v in by_kernel.values())
    assert svc.stats.cache_hits >= n_threads * per_thread \
        - n_threads * len(kernels)
    assert svc.stats.sessions_created == len(kernels)


def test_get_service_is_process_wide_singleton():
    reset_service()
    try:
        assert get_service() is get_service()
    finally:
        reset_service()
