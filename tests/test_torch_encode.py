"""The port's copied encoder, scheduler, register allocator and simulator
against the JAX package's on all 33 suite cells (11 kernels x 2x2/3x3/4x4):
the same MII and KMS, the same clause arena (``lits``/``offs``) cold and
through the incremental ``project(ii)``, and the same regalloc and
simulator verdicts on the reference's own mapping."""
import numpy as np
import pytest

from repro.core import MapRequest as RefMapRequest, compile as ref_compile
from repro.core import suite as ref_suite
from repro.core.cgra import CGRA as RefCGRA
from repro.core.encode import (EncoderSession as RefEncoderSession,
                               IncrementalEncoding as RefIncremental)
from repro.core.regalloc import allocate as ref_allocate
from repro.core.schedule import (build_kms as ref_build_kms,
                                 min_ii as ref_min_ii,
                                 node_latencies as ref_lat)
from repro.core.simulator import verify_mapping as ref_verify
from repro_torch.convert import dfg_from_arrays, dfg_from_graph
from repro_torch.core import suite
from repro_torch.core.cgra import CGRA
from repro_torch.core.encode import EncoderSession, IncrementalEncoding
from repro_torch.core.regalloc import allocate
from repro_torch.core.schedule import build_kms, min_ii, node_latencies
from repro_torch.core.simulator import verify_mapping

CELLS = [(size, name) for size in ("2x2", "3x3", "4x4")
         for name in suite.names()]


def _arena(cnf):
    return cnf.n_vars, cnf.arena.lits_view().copy(), \
        cnf.arena.offs_view().copy()


def _same_arena(a, b):
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("size,name", CELLS)
def test_encoder_and_verdicts_equal_reference(size, name):
    r, c = int(size[0]), int(size[2])
    g, gr = suite.get(name), ref_suite.get(name)
    cgra, rcgra = CGRA(r, c), RefCGRA(r, c)
    mii = min_ii(g, cgra)
    assert mii == ref_min_ii(gr, rcgra)
    iis = [max(mii, 1), max(mii, 1) + 1]
    lat = node_latencies(g, cgra)
    assert lat == ref_lat(gr, rcgra)
    for ii in iis:
        assert vars(build_kms(g, ii, lat)) == vars(ref_build_kms(gr, ii, lat))

    # cold encodings
    sess, rsess = EncoderSession(g, cgra), RefEncoderSession(gr, rcgra)
    for ii in iis:
        enc, renc = sess.encode(ii), rsess.encode(ii)
        _same_arena(_arena(enc.cnf), _arena(renc.cnf))
        assert enc.stats == renc.stats

    # the incremental layered formula and its per-II projections
    inc, rinc = IncrementalEncoding(sess), RefIncremental(rsess)
    for ii in iis:
        inc.ensure_ii(ii)
        rinc.ensure_ii(ii)
    for ii in iis:
        _same_arena(_arena(inc.project(ii)), _arena(rinc.project(ii)))
        assert inc.assumptions(ii) == rinc.assumptions(ii)

    # regalloc + simulator verdicts on the reference mapper's placement
    res = ref_compile(RefMapRequest(dfg=gr, arch=rcgra))
    if not res.success:
        return
    ra, rra = (allocate(g, cgra, res.placement, res.ii),
               ref_allocate(gr, rcgra, res.placement, res.ii))
    assert vars(ra) == vars(rra)
    chk = verify_mapping(g, cgra, res.placement, res.ii)
    rchk = ref_verify(gr, rcgra, res.placement, res.ii)
    assert chk.ok and rchk.ok and chk.errors == rchk.errors
    # and a broken placement is refused by both alike
    bad = dict(res.placement)
    n0, n1 = sorted(bad)[:2]
    bad[n1] = bad[n0]
    assert verify_mapping(g, cgra, bad, res.ii).ok == \
        ref_verify(gr, rcgra, bad, res.ii).ok


@pytest.mark.parametrize("name", suite.names())
def test_dfg_carried_across_as_plain_data(name):
    """``convert.dfg_from_graph`` rebuilds the reference's DFG in the port
    (nodes, ops, immediates, slot-ordered inputs with distances); it
    behaves as the port's own copy of the suite kernel does."""
    gr = ref_suite.get(name)
    g = dfg_from_graph(gr)
    assert g.name == gr.name and g.edges() == gr.edges()
    assert [(n.op, n.imm, n.ins, n.name) for n in g.nodes.values()] == \
        [(n.op, n.imm, n.ins, n.name) for n in gr.nodes.values()]
    assert g.execute(4)[0] == gr.execute(4)[0]
    mine = suite.get(name)
    for ii in (min_ii(g, CGRA(3, 3)),):
        assert ii == min_ii(mine, CGRA(3, 3))
        _same_arena(_arena(EncoderSession(g, CGRA(3, 3)).encode(ii).cnf),
                    _arena(EncoderSession(mine, CGRA(3, 3)).encode(ii).cnf))


def test_dfg_from_arrays_rejects_malformed_graphs():
    with pytest.raises(ValueError):   # slot 1 without slot 0
        dfg_from_arrays("g", ["const", "not"], [0, 0], [(0, 1, 1, 0)])
    with pytest.raises(ValueError):   # unknown source
        dfg_from_arrays("g", ["const", "not"], [0, 0], [(5, 1, 0, 0)])
    with pytest.raises(ValueError):   # forward cycle at distance 0
        dfg_from_arrays("g", ["not", "not"], [0, 0],
                        [(0, 1, 0, 0), (1, 0, 0, 0)])
    g = dfg_from_arrays("g", ["not", "not"], [0, 0],
                        [(0, 1, 0, 0), (1, 0, 0, 1)])   # a back-edge
    assert g.edges() == [(1, 0, 1), (0, 1, 0)]
