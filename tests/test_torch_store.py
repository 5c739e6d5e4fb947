"""The port's disk store (``repro_torch.core.store``) + arena serialisation:
the JAX package's property tests of its store, run on the port, then the
port's own: store keys byte-equal to the reference's on every suite cell,
core and arena records that either package wrote readable by the other,
and mapping records read through a restricted unpickler, so that a record
the JAX package wrote is a miss that imports nothing of it.

Two invariants carry the whole persistence tier:

  1. ``ClauseArena -> bytes -> ClauseArena`` is **stream-exact** — the
     round-tripped arena holds the identical CSR ``(lits, offs)`` pair,
     including zero-length (empty) clauses and the selector-guard
     literals of incremental layers. Session signatures, the UNSAT
     registry, and WalkSAT packs all key on the exact clause stream, so
     "semantically equal" is not good enough.
  2. A damaged ``store.log`` must never crash or silently serve garbage:
     torn tails (writer died mid-append) are truncated away and the
     complete prefix survives; complete-but-corrupt bytes quarantine the
     log (renamed aside, store restarts empty).
"""
import os
import pickle
import struct
import subprocess
import sys
from dataclasses import astuple

import numpy as np
import pytest

try:
    from hypothesis import HealthCheck, given, settings, strategies as st
except ImportError:   # optional dep: fall back to the local shim
    from _propshim import HealthCheck, given, settings, strategies as st

from repro.core import store as ref_store
from repro.core import suite as ref_suite
from repro.core.cgra import CGRA as RefCGRA
from repro.core.cnf import CNF as RefCNF
from repro.core.cnf import ClauseArena as RefArena
from repro.core.mapper import MapperConfig as RefConfig
from repro.core.mapper import MappingResult as RefResult
from repro.core.service import (dfg_signature as ref_dfg_sig,
                                shape_signature as ref_shape_sig,
                                topology_signature as ref_topo_sig)
import repro_torch
from repro_torch.core import suite
from repro_torch.core.cgra import CGRA
from repro_torch.core.cnf import (ArenaFormatError, ClauseArena, CNF,
                                  IncrementalCNF)
from repro_torch.core.mapper import MapperConfig, MappingResult, map_loop
from repro_torch.core.service import (dfg_signature, shape_signature,
                                      topology_signature)
from repro_torch.core.store import (MappingStore, _HEAD, _MAGIC,
                                    canonical_bytes, key_hash)

repro_torch.set_default_device("cpu")


# --------------------------------------------------------------- strategies

@st.composite
def random_arena(draw):
    """Random CSR arenas: mixed-width clauses, empty clauses included,
    positive and negative literals."""
    arena = ClauseArena()
    n = draw(st.integers(0, 30))
    for _ in range(n):
        width = draw(st.integers(0, 6))   # 0 = empty clause (UNSAT core)
        lits = []
        for _ in range(width):
            v = draw(st.integers(1, 400))
            lits.append(-v if draw(st.booleans()) else v)
        arena.add(lits)
    return arena


def assert_stream_exact(a: ClauseArena, b: ClauseArena) -> None:
    assert len(a) == len(b)
    assert a.n_lits == b.n_lits
    assert np.array_equal(a.lits_view(), b.lits_view())
    assert np.array_equal(a.offs_view(), b.offs_view())
    assert a.lits_view().dtype == b.lits_view().dtype == np.int32


# ------------------------------------------------------ arena serialisation

@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(random_arena())
def test_arena_bytes_roundtrip_stream_exact(arena):
    assert_stream_exact(arena, ClauseArena.from_bytes(arena.to_bytes()))


def test_arena_roundtrip_empty_and_empty_clause():
    empty = ClauseArena()
    assert_stream_exact(empty, ClauseArena.from_bytes(empty.to_bytes()))
    a = ClauseArena()
    a.add([])                 # the empty clause, alone
    a.add([3, -1])
    a.add([])
    rt = ClauseArena.from_bytes(a.to_bytes())
    assert_stream_exact(a, rt)
    assert rt.clause(0) == () and rt.clause(2) == ()


def test_arena_roundtrip_guarded_layers():
    """Selector-guarded incremental layers survive byte round-trips: the
    guard literals are ordinary arena literals and must come back in the
    exact positions the encoder appended them."""
    inc = IncrementalCNF()
    a, b = inc.new_var(), inc.new_var()
    inc.add(a, b)
    for ii in (2, 3):
        inc.begin_layer(ii)
        x = inc.new_var()
        inc.add(x, -a)
        inc.add(-x, b)
        inc.end_layer()
    arena = inc.clauses._arena
    rt = ClauseArena.from_bytes(arena.to_bytes())
    assert_stream_exact(arena, rt)
    # the guard literal of each layer appears in the round-tripped stream
    for ii in (2, 3):
        sel = inc.selector(ii)
        assert any(-sel in rt.clause(i) for i in range(len(rt)))


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(random_arena(), st.integers(0, 3))
def test_arena_rejects_damage(arena, mode):
    """Any single corruption — magic, version, truncation, bit flip —
    raises ArenaFormatError; never a silent wrong arena."""
    blob = bytearray(arena.to_bytes())
    if mode == 0:
        blob[0] ^= 0xFF                      # magic
    elif mode == 1:
        blob[4] ^= 0x01                      # version
    elif mode == 2:
        blob = blob[:max(1, len(blob) // 2)]  # truncation
    else:
        blob[len(blob) // 2] ^= 0x40         # payload/CRC bit flip
    with pytest.raises(ArenaFormatError):
        ClauseArena.from_bytes(bytes(blob))


def test_arena_rejects_inconsistent_csr():
    arena = ClauseArena()
    arena.add([1, -2])
    blob = bytearray(arena.to_bytes())
    # offs live right after the 24-byte header; make them non-monotone
    struct.pack_into("<q", blob, 24 + 8, -1)
    import zlib
    body = bytes(blob[:-4])
    blob[-4:] = struct.pack("<I", zlib.crc32(body[24:]) & 0xFFFFFFFF)
    with pytest.raises(ArenaFormatError):
        ClauseArena.from_bytes(bytes(blob))


# ----------------------------------------------------------- canonical keys

def test_canonical_bytes_deterministic_and_injective_enough():
    k1 = ("topo", (3, 3), 1.5, True, None, b"x", frozenset({2, 1}))
    assert canonical_bytes(k1) == canonical_bytes(
        ("topo", (3, 3), 1.5, True, None, b"x", frozenset({1, 2})))
    assert key_hash(k1) != key_hash(("topo", (3, 3), 1.5, True, None,
                                     b"x", frozenset({1, 3})))
    # type confusion must not collide: 1 vs True vs "1"
    assert len({key_hash((1,)), key_hash((True,)), key_hash(("1",))}) == 3
    with pytest.raises(TypeError):
        canonical_bytes({"dict": "not canonical"})


# ------------------------------------------------------------ store basics

def _mk_result(ii: int) -> MappingResult:
    return MappingResult(success=True, ii=ii, mii=2,
                         placement={0: (0, 0, 0), 1: (1, 0, 0)})


def test_store_mapping_roundtrip_across_reopen(tmp_path):
    path = str(tmp_path / "store")
    s1 = MappingStore(path)
    key = ("topo", "shape", ("cfg", 1))
    assert s1.get_mapping(key) is None
    assert s1.put_mapping(key, _mk_result(4))
    got = s1.get_mapping(key)
    assert got.ii == 4 and got.placement == _mk_result(4).placement
    # a later write under the same key wins
    assert s1.put_mapping(key, _mk_result(5))
    s2 = MappingStore(path)                      # fresh process, cold index
    assert s2.get_mapping(key).ii == 5
    assert s2.n_mappings == 1
    assert s2.stats.quarantined == 0


def test_store_arena_roundtrip(tmp_path):
    s = MappingStore(str(tmp_path / "store"))
    arena = ClauseArena()
    arena.add([1, -2, 3])
    arena.add([])
    assert s.put_arena(("arena", 7), 9, arena)
    n_vars, rt = s.get_arena(("arena", 7))
    assert n_vars == 9
    assert_stream_exact(arena, rt)
    assert s.get_arena(("absent",)) is None


def test_store_core_registry_and_witness_verification(tmp_path):
    s = MappingStore(str(tmp_path / "store"))
    skey = ("session", "key")
    unsat = CNF()
    x = unsat.new_var()
    unsat.add(x)
    unsat.add(-x)
    sat = CNF()
    y = sat.new_var()
    sat.add(y)
    assert s.put_core(skey, 3, (7, -9), witness=unsat)
    assert s.put_core(skey, 4, (), witness=None)
    assert s.put_core(skey, 5, (2,), witness=sat)   # wrong verdict on disk
    s2 = MappingStore(str(tmp_path / "store"))
    assert s2.cores_for(skey) == {3: (7, -9), 4: (), 5: (2,)}
    assert s2.cores_for(("other",)) == {}
    # self-certification: the stored projection re-solves to the verdict
    assert s2.verify_core(skey, 3) is True
    assert s2.verify_core(skey, 4) is None          # no witness attached
    assert s2.verify_core(skey, 5) is False         # caught lying
    nv, arena = s2.core_witness(skey, 3)
    assert nv == 1 and len(arena) == 2


# --------------------------------------------------- damage: torn vs corrupt

def test_store_torn_tail_truncated_not_fatal(tmp_path):
    path = str(tmp_path / "store")
    s = MappingStore(path)
    key = ("ok",)
    s.put_mapping(key, _mk_result(3))
    good_size = os.path.getsize(s.log_path)
    # a writer died mid-append: half a record of trailing garbage
    with open(s.log_path, "ab") as f:
        f.write(_HEAD.pack(_MAGIC, 1, b"\x00" * 32, 10_000, 0))
        f.write(b"\x7f" * 12)
    s2 = MappingStore(path)
    assert s2.stats.torn_tail_truncated == 1
    assert s2.stats.quarantined == 0
    assert s2.get_mapping(key).ii == 3               # prefix survives
    # the next append truncates the torn tail before writing
    assert s2.put_mapping(("new",), _mk_result(6))
    assert os.path.getsize(s2.log_path) > good_size
    s3 = MappingStore(path)
    assert s3.get_mapping(("new",)).ii == 6
    assert s3.stats.torn_tail_truncated == 0


@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, 1), st.integers(1, 1_000_000))
def test_store_corruption_quarantined_not_fatal(mode, where):
    """Complete-but-invalid bytes (flipped payload bit, garbled magic)
    must quarantine the log — renamed aside, store restarts empty and
    writable — never crash, never serve the garbled record."""
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "store")
        s = MappingStore(path)
        s.put_mapping(("a",), _mk_result(2))
        s.put_mapping(("b",), _mk_result(3))
        size = os.path.getsize(s.log_path)
        with open(s.log_path, "r+b") as f:
            if mode == 0:
                f.seek(where % 4)                    # record 0's magic
            else:
                f.seek(_HEAD.size + (where % 8))     # record 0's payload
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x20]))
        s2 = MappingStore(path)
        assert s2.stats.quarantined == 1
        assert s2.get_mapping(("a",)) is None
        assert s2.get_mapping(("b",)) is None
        quarantined = [p for p in os.listdir(path)
                       if p.startswith("store.log.corrupt-")]
        assert quarantined, "corrupt log not kept for post-mortem"
        assert os.path.getsize(os.path.join(path, quarantined[0])) == size
        # the store stays writable after quarantine
        assert s2.put_mapping(("c",), _mk_result(4))
        assert s2.get_mapping(("c",)).ii == 4


def test_store_readonly_never_appends(tmp_path):
    path = str(tmp_path / "store")
    MappingStore(path).put_mapping(("k",), _mk_result(2))
    ro = MappingStore(path, readonly=True)
    assert ro.get_mapping(("k",)).ii == 2
    assert not ro.put_mapping(("k2",), _mk_result(3))
    assert ro.get_mapping(("k2",)) is None


def test_store_sees_concurrent_writer_appends(tmp_path):
    """A reader indexes records another store instance (process) appended
    after the reader opened — the get-miss refresh path."""
    path = str(tmp_path / "store")
    reader = MappingStore(path)
    writer = MappingStore(path)
    writer.put_mapping(("late",), _mk_result(7))
    assert reader.get_mapping(("late",)).ii == 7
    d = reader.describe()
    assert d["mappings"] == 1 and d["refreshes"] >= 2


# --------------------------------------------------------------- compaction

@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.integers(0, 5), min_size=1, max_size=24),
       st.integers(2, 9))
def test_store_compaction_preserves_every_lookup(key_picks, n_cores):
    """Random overwrite-heavy write sequence -> compact -> every current
    key->value lookup (mappings, arenas, cores, witnesses) answers
    identically, and the dead versions' bytes are reclaimed."""
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        s = MappingStore(os.path.join(td, "store"))
        latest: dict = {}
        for i, k in enumerate(key_picks):
            key = ("map", k)
            assert s.put_mapping(key, _mk_result(i + 2))
            latest[key] = i + 2
        arena = ClauseArena()
        arena.add([1, -2])
        arena.add([])
        assert s.put_arena(("ar", 0), 5, arena)
        assert s.put_arena(("ar", 0), 7, arena)      # overwrite: 7 wins
        unsat = CNF()
        x = unsat.new_var()
        unsat.add(x)
        unsat.add(-x)
        skey = ("sess",)
        for ii in range(3, 3 + n_cores):
            assert s.put_core(skey, ii, (ii,), witness=unsat)
        assert s.put_core(skey, 3, (-1,), witness=unsat)  # latest per II wins
        before = os.path.getsize(s.log_path)

        cst = s.compact()
        assert cst["bytes_before"] == before
        assert cst["bytes_after"] == os.path.getsize(s.log_path)
        overwrites = (len(key_picks) - len(latest)) + 1 + 1
        assert cst["records_dropped"] == overwrites
        if overwrites:
            assert cst["bytes_after"] < cst["bytes_before"]

        for reader in (s, MappingStore(os.path.join(td, "store"))):
            for key, ii in latest.items():
                assert reader.get_mapping(key).ii == ii
            nv, rt = reader.get_arena(("ar", 0))
            assert nv == 7
            assert_stream_exact(arena, rt)
            cores = reader.cores_for(skey)
            assert set(cores) == set(range(3, 3 + n_cores))
            assert cores[3] == (-1,)
            # witness blobs survive at their re-derived offsets and still
            # self-certify the recorded UNSAT verdict
            for ii in range(3, 3 + n_cores):
                assert reader.verify_core(skey, ii) is True
            assert reader.stats.quarantined == 0


def test_store_compaction_idempotent_and_readonly_noop(tmp_path):
    path = str(tmp_path / "store")
    s = MappingStore(path)
    s.put_mapping(("a",), _mk_result(2))
    s.put_mapping(("a",), _mk_result(3))
    first = s.compact()
    assert first["records_dropped"] == 1
    second = s.compact()                 # nothing left to reclaim
    assert second["records_dropped"] == 0
    assert second["bytes_after"] == first["bytes_after"]
    assert s.get_mapping(("a",)).ii == 3
    assert s.stats.compactions == 2
    ro = MappingStore(path, readonly=True)
    assert ro.compact() == {"bytes_before": 0, "bytes_after": 0,
                            "records_kept": 0, "records_dropped": 0}
    assert ro.get_mapping(("a",)).ii == 3


def test_store_compaction_quarantines_corrupt_log(tmp_path):
    """Compaction of a log with complete-but-invalid bytes behaves exactly
    like refresh: quarantine (renamed aside, store restarts empty), never
    a crash, never a compacted log built from garbled records."""
    path = str(tmp_path / "store")
    s = MappingStore(path)
    s.put_mapping(("a",), _mk_result(2))
    s.put_mapping(("b",), _mk_result(3))
    with open(s.log_path, "r+b") as f:
        f.seek(_HEAD.size + 4)                        # record 0's payload
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x20]))
    s2 = MappingStore.__new__(MappingStore)
    s2.__init__(path)                                 # scans -> quarantines
    s3 = MappingStore(path)
    out = s3.compact()
    assert out["records_kept"] == 0
    # quarantined log kept aside; compacted store stays empty but writable
    assert any(p.startswith("store.log.corrupt-") for p in os.listdir(path))
    assert s3.put_mapping(("c",), _mk_result(4))
    assert s3.get_mapping(("c",)).ii == 4


def test_store_compaction_truncates_torn_tail(tmp_path):
    path = str(tmp_path / "store")
    s = MappingStore(path)
    s.put_mapping(("keep",), _mk_result(4))
    with open(s.log_path, "ab") as f:                 # writer died mid-append
        f.write(_HEAD.pack(_MAGIC, 1, b"\x00" * 32, 10_000, 0))
        f.write(b"\x7f" * 8)
    out = s.compact()
    assert out["records_kept"] == 1
    s2 = MappingStore(path)
    assert s2.get_mapping(("keep",)).ii == 4
    assert s2.stats.torn_tail_truncated == 0          # tail gone for good


# ------------------------------------------------ the port beside the JAX one

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(size, name) for size in ("2x2", "3x3", "4x4")
         for name in suite.names()]


def _keys(sig, cfg_tuple):
    """The service's store keys from (topology, shape, dfg) signatures:
    a mapping record's cache key and a core record's session key."""
    topo, shape, dfg = sig
    return [topo, shape, dfg, (dfg, topo, cfg_tuple, 1),
            (topo, shape, "pairwise", "auto", 0, 100_000)]


@pytest.mark.parametrize("size,name", CELLS)
def test_store_keys_byte_equal_to_reference(size, name):
    r, c = int(size[0]), int(size[2])
    g, cgra = suite.get(name), CGRA(r, c)
    rg, rcgra = ref_suite.get(name), RefCGRA(r, c)
    mine = _keys((topology_signature(cgra), shape_signature(g, cgra),
                  dfg_signature(g)), astuple(MapperConfig()))
    ref = _keys((ref_topo_sig(rcgra), ref_shape_sig(rg, rcgra),
                 ref_dfg_sig(rg)), astuple(RefConfig()))
    for a, b in zip(mine, ref):
        assert canonical_bytes(a) == ref_store.canonical_bytes(b)
        assert key_hash(a) == ref_store.key_hash(b)


def test_reference_core_and_arena_records_read_by_the_port(tmp_path):
    path = str(tmp_path / "store")
    ref = ref_store.MappingStore(path)
    unsat = RefCNF()
    x = unsat.new_var()
    unsat.add(x)
    unsat.add(-x)
    skey = ("session", ("topo", 3), 7)
    assert ref.put_core(skey, 4, (5, -6), witness=unsat)
    assert ref.put_core(skey, 5, ())
    arena = RefArena()
    arena.add([1, -2, 3])
    arena.add([])
    assert ref.put_arena(("arena", 1), 9, arena)
    mine = MappingStore(path)
    assert mine.cores_for(skey) == {4: (5, -6), 5: ()}
    assert mine.verify_core(skey, 4) is True
    assert mine.verify_core(skey, 5) is None
    n_vars, got = mine.get_arena(("arena", 1))
    assert n_vars == 9
    assert np.array_equal(got.lits_view(), arena.lits_view())
    assert np.array_equal(got.offs_view(), arena.offs_view())
    # and the other way: the port's core record read by the reference
    assert mine.put_core(skey, 6, (8,), witness=CNF())
    assert ref_store.MappingStore(path).cores_for(skey)[6] == (8,)


def test_port_mapping_record_roundtrip(tmp_path):
    """A served result with its DFG, fabric, register allocation and
    attempts comes back through the restricted unpickler whole."""
    res = map_loop(suite.get("srand"), CGRA(2, 2),
                   MapperConfig(solver="cdcl", timeout_s=60))
    s = MappingStore(str(tmp_path / "store"))
    assert s.put_mapping(("k",), res)
    got = MappingStore(str(tmp_path / "store")).get_mapping(("k",))
    assert isinstance(got, MappingResult) and got.service is None
    assert (got.success, got.ii, got.mii, got.placement) == \
        (res.success, res.ii, res.mii, res.placement)
    assert [(a.ii, a.status) for a in got.attempts] == \
        [(a.ii, a.status) for a in res.attempts]
    assert got.dfg.nodes.keys() == res.dfg.nodes.keys()


def test_record_naming_another_module_is_a_miss_never_loaded(tmp_path):
    class Boom:
        def __reduce__(self):
            return (os.system, ("exit 3",))
    s = MappingStore(str(tmp_path / "store"))
    s._append(1, key_hash(("evil",)), pickle.dumps(Boom()))
    assert s.get_mapping(("evil",)) is None
    assert s.stats.mappings_foreign == 1
    assert s.stats.mappings_read == 0


def test_reference_mapping_record_is_a_foreign_miss(tmp_path):
    """A record the JAX package wrote names repro.core.mapper: the port
    counts it as a miss and never imports repro (checked in a fresh
    process that has not imported it either)."""
    path = str(tmp_path / "store")
    ref_store.MappingStore(path).put_mapping(
        ("shared", "key"), RefResult(success=True, ii=3, mii=2,
                                     placement={0: (0, 0, 0)}))
    code = f"""
import sys
from repro_torch.core.mapper import MappingResult
from repro_torch.core.store import MappingStore
s = MappingStore({path!r})
assert s.n_mappings == 1
assert s.get_mapping(("shared", "key")) is None
assert s.stats.mappings_foreign == 1 and s.stats.mappings_read == 0
s.put_mapping(("port", "key"), MappingResult(success=True, ii=4))
assert MappingStore({path!r}).get_mapping(("port", "key")).ii == 4
print("LOADED:" + ",".join(sorted(m for m in sys.modules if m == "repro"
                                  or m.startswith("repro.")
                                  or m.split(".")[0] == "jax")))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "LOADED:"
