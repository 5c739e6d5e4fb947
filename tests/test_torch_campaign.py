"""The port's mapping campaign (``repro_torch.core.campaign`` and
``repro_torch.launch.campaign``) against the JAX package's: corpus digests,
canonical keys, cell features and cell keys byte-identical (also across
``PYTHONHASHSEED``s), campaign records with the reference's MII / II /
verdicts, the sharded dataset's durability, the foreign-record rule (a
record written by the JAX package is counted, never imported), and the
launcher's gates."""
import os
import random
import subprocess
import sys

import numpy as np
import pytest

try:
    from hypothesis import HealthCheck, given, settings, strategies as st
except ImportError:
    from _propshim import HealthCheck, given, settings, strategies as st

from repro.core import campaign as ref_campaign
from repro.core import suite as ref_suite
from repro.core.arch import arch as ref_arch
from repro.core.mapper import MapperConfig as RefConfig
from repro.core.workers import WorkerPool as RefPool
from repro.launch import campaign as ref_launch
import repro_torch
from repro_torch.convert import dfg_from_graph
from repro_torch.core import campaign as port_campaign
from repro_torch.core import suite
from repro_torch.core.arch import arch
from repro_torch.core.campaign import (CampaignDataset, CellRecord,
                                       CorpusItem, CorpusSpec, N_FEATURES,
                                       build_corpus, canonical_dfg,
                                       canonical_key, cell_features,
                                       cell_key, corpus_digest, mutate_dfg,
                                       random_dfg, run_campaign)
from repro_torch.core.dfg import DFG
from repro_torch.core.mapper import MapperConfig
from repro_torch.core.service import dfg_signature
from repro_torch.core.workers import WorkerPool
from repro_torch.launch import campaign as launch

repro_torch.set_default_device("cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(seed=3, n_random=6, n_mutants=4, include_suite=False,
             min_nodes=5, max_nodes=9)
FEATURE_FABRICS = ("2x2", "3x3", "4x4", "4x4-torus:r8")


# ----------------------------------------------------------- determinism

@pytest.mark.parametrize("seed", [0, 1])
def test_corpus_digest_and_keys_equal_the_reference(seed):
    ours, stats = build_corpus(CorpusSpec(seed=seed, n_random=8,
                                          n_mutants=6))
    ref, ref_stats = ref_campaign.build_corpus(
        ref_campaign.CorpusSpec(seed=seed, n_random=8, n_mutants=6))
    assert stats == ref_stats
    assert corpus_digest(ours) == ref_campaign.corpus_digest(ref)
    assert [(i.name, i.kind, i.key) for i in ours] == \
        [(i.name, i.kind, i.key) for i in ref]
    # the reference's DFGs, carried across as plain data, key alike
    for a, b in zip(ours, ref):
        assert canonical_key(dfg_from_graph(b.dfg)) == a.key


def _digest_in_subprocess(package: str, hashseed: str) -> str:
    prog = ("import sys; sys.path.insert(0, 'src')\n"
            f"from {package}.core.campaign import (CorpusSpec, "
            "build_corpus, corpus_digest)\n"
            "items, _ = build_corpus(CorpusSpec(seed=3, n_random=6, "
            "n_mutants=4, include_suite=False, min_nodes=5, max_nodes=9))\n"
            "print(corpus_digest(items))\n")
    env = dict(os.environ, PYTHONHASHSEED=hashseed, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_corpus_same_digest_across_hash_seeds():
    """The port's corpus is byte-identical under two PYTHONHASHSEEDs, and
    equal to the reference's."""
    digests = {_digest_in_subprocess("repro_torch", s)
               for s in ("0", "12345")}
    assert len(digests) == 1
    digest = digests.pop()
    assert digest == _digest_in_subprocess("repro", "777")
    items, _ = build_corpus(CorpusSpec(**SMALL))
    assert corpus_digest(items) == digest


def test_random_and_mutated_dfgs_equal_the_reference():
    """Same rng stream, same grammar DFG and the same mutant of it, for
    every mutation kind."""
    spec, ref_spec = CorpusSpec(**SMALL), ref_campaign.CorpusSpec(**SMALL)
    for i in range(6):
        g = random_dfg(random.Random(i), spec, f"g{i}")
        rg = ref_campaign.random_dfg(random.Random(i), ref_spec, f"g{i}")
        assert dfg_signature(g) == dfg_signature(dfg_from_graph(rg))
        hist, _mem = g.execute(3)
        assert len(hist) == 3
        for kind in ref_campaign.MUTATION_KINDS:
            m, _ = mutate_dfg(g, random.Random(100 + i), kind=kind,
                              spec=spec)
            rm, _ = ref_campaign.mutate_dfg(rg, random.Random(100 + i),
                                            kind=kind, spec=ref_spec)
            assert canonical_key(m) == ref_campaign.canonical_key(rm), kind


@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.sampled_from(suite.names()), st.integers(0, 10_000))
def test_relabel_mutants_collapse_to_one_canonical_key(name, seed):
    g = suite.get(name)
    mut, kind = mutate_dfg(g, random.Random(seed), kind="relabel")
    assert kind == "relabel"
    assert canonical_key(mut) == canonical_key(g)
    assert dfg_signature(canonical_dfg(mut)) == \
        dfg_signature(canonical_dfg(g))


# -------------------------------------------------------------- features

@pytest.mark.parametrize("fabric", FEATURE_FABRICS)
def test_cell_features_equal_the_reference_bit_for_bit(fabric):
    for name in suite.names():
        ours = cell_features(suite.get(name), arch(fabric))
        ref = ref_campaign.cell_features(ref_suite.get(name),
                                         ref_arch(fabric))
        assert ours.shape == (N_FEATURES,) and ours.dtype == np.float32
        assert ours.tobytes() == ref.tobytes(), (name, fabric)


@pytest.mark.parametrize("fabric", FEATURE_FABRICS)
def test_cell_key_bytes_equal_the_reference(fabric):
    dfg_key = ref_campaign.canonical_key(ref_suite.get("gsm"))
    for kw in ({}, {"timeout_s": 25.0}, {"solver": "walksat", "seed": 3},
               {"guide": "campaign", "amo": "sequential"}):
        for width in (1, 4):
            assert cell_key(dfg_key, arch(fabric), MapperConfig(**kw),
                            width) == \
                ref_campaign.cell_key(dfg_key, ref_arch(fabric),
                                      RefConfig(**kw), width)


# --------------------------------------------------------------- dataset

def _mk_cell(key_byte: int, ii=4, witness=None) -> CellRecord:
    key = bytes([key_byte]) + bytes(31)
    return CellRecord(
        key=key, dfg_key=bytes(32), name=f"c{key_byte}", kind="random",
        fabric="2x2", n_nodes=7,
        features=np.full(N_FEATURES, float(key_byte), dtype=np.float32),
        mii=2, ii=ii, success=ii is not None, infeasible=False,
        attempts=((2, "UNSAT", "cdcl", 0.01), (ii or 9, "SAT", "walksat",
                                               0.02)),
        total_time=0.05, witness=witness)


def test_dataset_roundtrip_and_sharding(tmp_path):
    ds = CampaignDataset(str(tmp_path / "cells"), n_shards=3)
    recs = [_mk_cell(b, witness=b"\x01\x02" if b % 2 else None)
            for b in range(17)]
    for r in recs:
        ds.append(r)
    got = {r.key: r for r in ds}
    assert len(got) == len(recs)
    for r in recs:
        back = got[r.key]
        assert back.offset == r.ii - r.mii
        assert back.attempts == r.attempts
        assert back.witness == r.witness
        assert np.array_equal(back.features, r.features)
    d = ds.describe()
    assert d["cells"] == len(recs) and d["corrupt_shards"] == 0
    assert d["foreign_cells"] == 0
    used = [s for s in range(3) if os.path.exists(ds.shard_path(s))]
    assert len(used) > 1
    # the same shard routing as the reference's dataset
    ref = ref_campaign.CampaignDataset(str(tmp_path / "ref"), n_shards=3)
    assert [ds.shard_of(r.key) for r in recs] == \
        [ref.shard_of(r.key) for r in recs]


def test_dataset_tolerates_torn_tail_and_corrupt_shard(tmp_path):
    ds = CampaignDataset(str(tmp_path / "cells"), n_shards=2)
    for b in range(8):
        ds.append(_mk_cell(b))
    n = ds.count()
    with open(ds.shard_path(0), "ab") as f:
        f.write(b"\x00" * 11)
    assert ds.count() == n
    with open(ds.shard_path(1), "r+b") as f:
        f.seek(60)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    survivors = list(ds)
    assert ds.corrupt_shards >= 1
    assert 0 < len(survivors) < n


def test_reference_written_records_are_foreign(tmp_path):
    """A shard the JAX package wrote holds records that name
    ``repro.core.campaign.CellRecord``: the port skips and counts them,
    never imports them, and still reads its own records beside them."""
    path = str(tmp_path / "cells")
    ref = ref_campaign.CampaignDataset(path, n_shards=2)
    for b in range(5):
        r = _mk_cell(b)
        ref.append(ref_campaign.CellRecord(**r.__dict__))
    ours = CampaignDataset(path, n_shards=2)
    assert list(ours) == [] and ours.foreign_cells == 5
    for b in range(5, 8):
        ours.append(_mk_cell(b))
    got = sorted(r.key[0] for r in ours)
    assert got == [5, 6, 7] and ours.foreign_cells == 5
    assert ours.describe()["foreign_cells"] == 5
    # the reference reads both kinds (its pickles may import the port)
    assert ref.count() == 8


# -------------------------------------------------------------- campaign

def _small_items(ref: bool):
    mod = ref_campaign if ref else port_campaign
    items, _ = mod.build_corpus(mod.CorpusSpec(
        seed=5, n_random=4, n_mutants=2, include_suite=False,
        min_nodes=5, max_nodes=7))
    return items


def test_run_campaign_records_equal_the_reference(tmp_path):
    """An inline pool over a small grid: every record's key, MII, II,
    success and infeasibility equal the JAX package's; a refuted cell's
    witness re-solves UNSAT."""
    fabrics = ["2x2", "3x3"]
    ds = CampaignDataset(str(tmp_path / "cells"), n_shards=2)
    with WorkerPool(workers=0, store_path=str(tmp_path / "store")) as pool:
        stats, recs = run_campaign(_small_items(False),
                                   [arch(f) for f in fabrics], pool,
                                   dataset=ds,
                                   cfg=MapperConfig(timeout_s=30.0))
    with RefPool(workers=0, store_path=str(tmp_path / "ref")) as pool:
        ref_stats, ref_recs = ref_campaign.run_campaign(
            _small_items(True), [ref_arch(f) for f in fabrics], pool,
            cfg=RefConfig(timeout_s=30.0))
    assert stats.errors == 0 and stats.cells == len(recs) == len(ref_recs)
    for k in ("cells", "mapped", "failed", "infeasible", "witnesses"):
        assert getattr(stats, k) == getattr(ref_stats, k), k
    assert [(r.key, r.mii, r.ii, r.success, r.infeasible) for r in recs] == \
        [(r.key, r.mii, r.ii, r.success, r.infeasible) for r in ref_recs]
    assert ds.count() == stats.cells


@pytest.mark.parametrize("name,fabric", [("patricia", "4x4"),
                                         ("sha", "2x2")])
def test_mii_witness_equals_the_reference(name, fabric):
    """The MII projection's arena (a refuted cell's witness) is the
    reference's byte for byte, and re-solves to the same verdict."""
    from repro.core.cnf import ClauseArena as RefArena
    from repro.core.sat.cdcl import solve_arena_worker as ref_solve
    from repro_torch.core.campaign import _mii_witness
    from repro_torch.core.cnf import ClauseArena
    from repro_torch.core.sat.cdcl import solve_arena_worker
    ours = _mii_witness(suite.get(name), arch(fabric), "pairwise")
    ref = ref_campaign._mii_witness(ref_suite.get(name), ref_arch(fabric),
                                    "pairwise")
    assert ours is not None and ours == ref
    a, r = ClauseArena.from_bytes(ours), RefArena.from_bytes(ref)
    status, _ = solve_arena_worker(a.max_var(), a.lits_view(),
                                   a.offs_view())
    assert status == ref_solve(r.max_var(), r.lits_view(),
                               r.offs_view())[0]


def test_run_campaign_keeps_the_errors_messages():
    """A cell whose mapping raises is counted, as in the reference, and
    its message kept (the reference only counts it)."""
    from concurrent.futures import Future

    class FailingPool:
        def submit(self, dfg, fabric, cfg, sweep_width=1):
            fut = Future()
            fut.set_exception(AssertionError("invalid mapping"))
            return fut

    items = _small_items(False)[:2]
    stats, recs = run_campaign(items, [arch("2x2")], FailingPool())
    assert stats.errors == 2 and stats.cells == 0 and recs == []
    assert stats.error_samples == [
        f"{it.name} on {arch('2x2')}: AssertionError: invalid mapping"
        for it in items]


# -------------------------------------------------------------- launcher

def test_holdout_cells_equal_the_reference():
    items, ref_items = _small_items(False), _small_items(True)
    ours = launch._holdout_cells(items, launch.build_gallery("2x2,3x3,4x4"),
                                 MapperConfig(timeout_s=25.0))
    ref = ref_launch._holdout_cells(ref_items,
                                    ref_launch.build_gallery("2x2,3x3,4x4"),
                                    RefConfig(timeout_s=25.0))
    assert [(i.name, str(f)) for i, f in ours] == \
        [(i.name, str(f)) for i, f in ref]


def _summary(**over):
    s = {"campaign": {"cells": 250, "errors": 0},
         "corpus": {"duplicates": 3},
         "dataset": {"cells": 250}, "dataset_roundtrip_ok": True,
         "eval": {"ii_mismatches": 0, "attempts_guided": 80,
                  "attempts_unguided": 100},
         "suite_gate": {"ok": True, "mismatches": []}}
    for k, v in over.items():
        s[k] = v if not isinstance(v, dict) else {**s.get(k, {}), **v}
    return s


GATE_CASES = {
    "pass": _summary(),
    "few_cells": _summary(campaign={"cells": 12}),
    "no_dedup": _summary(corpus={"duplicates": 0}),
    "roundtrip": _summary(dataset_roundtrip_ok=False),
    "errors": _summary(campaign={"errors": 2}),
    "mismatch": _summary(eval={"ii_mismatches": 1}),
    "no_saving": _summary(eval={"attempts_guided": 100}),
    "suite": _summary(suite_gate={"ok": False,
                                  "mismatches": [{"kernel": "sha"}]}),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_check_gates_equal_the_reference(case):
    s = GATE_CASES[case]
    assert launch.check_gates(s) == ref_launch.check_gates(s)
    assert (launch.check_gates(s) == []) == (case == "pass")


def test_run_small_campaign_end_to_end(tmp_path):
    """The whole launcher at a tiny size on an inline pool and the CPU:
    dataset round trip, a trained guide saved and registered, the
    held-out attempts comparison and the suite gate on 2x2, all without
    an II mismatch."""
    from repro_torch.core.guide import IIGuide, clear_guides, resolve_guide
    out = str(tmp_path / "c")
    summary = launch.run(seed=1, out=out, workers=0, n_random=6,
                         n_mutants=4, fabrics="2x2,3x3", timeout_s=25.0,
                         sweep_width=4, eval_cells=4, suite_sizes=("2x2",))
    try:
        assert summary["dataset_roundtrip_ok"]
        assert summary["campaign"]["errors"] == 0
        assert summary["guide"]["device"] == "cpu"
        assert summary["guide"]["n_train"] > 0
        assert summary["eval"]["ii_mismatches"] == 0
        assert summary["suite_gate"]["ok"]
        assert summary["suite_gate"]["cells"] == len(suite.names())
        live = resolve_guide("campaign")
        saved = IIGuide.load(summary["guide_path"])
        for name in suite.names():
            x = cell_features(suite.get(name), arch("3x3"))
            assert live.suggest(x) == saved.suggest(x)
        errs = launch.check_gates(summary, min_cells=10)
        assert all("saved no attempts" in e for e in errs), errs
    finally:
        clear_guides()


def test_main_writes_the_summary(tmp_path, capsys):
    import json
    bench = str(tmp_path / "bench.json")
    launch.main(["--out", str(tmp_path / "c"), "--workers", "0",
                 "--n-random", "3", "--n-mutants", "2", "--fabrics", "2x2",
                 "--skip-train", "--bench-out", bench, "--device", "cpu"])
    s = json.load(open(bench))
    assert s["campaign"]["cells"] == s["dataset"]["cells"] > 0
    assert "campaign done" in capsys.readouterr().out
