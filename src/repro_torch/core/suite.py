"""Benchmark loop kernels (MiBench / Rodinia-style, paper §V).

The paper maps pragma-annotated loop bodies from MiBench and Rodinia. The
original C sources (and the authors' LLVM pass output) are not shipped here,
so each kernel below is a faithful *DFG-level* reconstruction of the loop
body the paper names: same computation family, realistic op mix, loads and
stores, and loop-carried dependencies. Every DFG is executable, so mappings
are always validated observationally against sequential semantics.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .dfg import DFG

_REGISTRY: Dict[str, Callable[[], DFG]] = {}


def register(fn: Callable[[], DFG]) -> Callable[[], DFG]:
    _REGISTRY[fn.__name__] = fn
    return fn


def names() -> List[str]:
    return list(_REGISTRY)


def get(name: str) -> DFG:
    g = _REGISTRY[name]()
    g.validate()
    return g


def all_dfgs() -> Dict[str, DFG]:
    return {n: get(n) for n in names()}


def run_suite(cgra, cfg=None, sweep_width: int = 1,
              names_subset: Optional[List[str]] = None,
              service=None) -> Dict[str, object]:
    """Map every suite kernel on ``cgra`` and return {name: MappingResult}.

    ``sweep_width=1`` runs the paper-faithful sequential Fig. 3 loop;
    ``sweep_width>1`` runs the parallel II-sweep engine
    (``repro_torch.core.sweep``). The two modes find the same II on every kernel
    (asserted by the JAX package's tests/test_sweep.py); this is the convenience entry point
    for batch runs over the whole suite.

    ``service`` is handed to ``compile``: ``None`` maps each kernel
    standalone, ``"default"`` or a
    :class:`~repro_torch.core.service.MappingService` routes every kernel
    through that service's cache and warm solver pool.

    This is now a thin batch shim over the unified front door: each kernel
    becomes one ``MapRequest`` served by ``repro_torch.core.api.compile`` (which
    also accepts fabric *names* and heterogeneous ``ArchSpec``s for
    ``cgra``).
    """
    from .api import MapRequest, compile as compile_request
    from .mapper import MapperConfig
    cfg = cfg or MapperConfig()
    out: Dict[str, object] = {}
    for name in (names_subset or names()):
        out[name] = compile_request(MapRequest(
            dfg=get(name), arch=cgra, config=cfg, sweep_width=sweep_width,
            service=service))
    return out


def _carry(g: DFG, nid: int, src: int, slot: int = 0, dist: int = 1) -> None:
    """Patch input ``slot`` of node ``nid`` to read ``src`` from ``dist``
    iterations earlier (loop-carried back-edge)."""
    ins = list(g.nodes[nid].ins)
    ins[slot] = (src, dist)
    g.nodes[nid].ins = tuple(ins)
    g.touch()


@register
def sha() -> DFG:
    """SHA-1 round flavour: rotate-left by 5/30, xor mixing, adds; carried
    working variables."""
    g = DFG("sha")
    a0 = g.add("const", imm=0x67452301, name="a0")
    iv = g.add("iv", name="i")
    w = g.add("load", [(iv, 0)], imm=100, name="w")
    s5 = g.add("shl", [(a0, 0), (g.add("const", imm=5, name="c5"), 0)], name="s5")
    r27 = g.add("shr", [(a0, 0), (g.add("const", imm=27, name="c27"), 0)], name="r27")
    rot5 = g.add("or", [(s5, 0), (r27, 0)], name="rot5")
    fx = g.add("xor", [(a0, 0), (w, 0)], name="fx")
    fa = g.add("and", [(fx, 0), (rot5, 0)], name="fa")
    t1 = g.add("add", [(rot5, 0), (fa, 0)], name="t1")
    t2 = g.add("add", [(t1, 0), (w, 0)], name="t2")
    e = g.add("add", [(t2, 0), (a0, 0)], name="e")
    st = g.add("store", [(iv, 0), (e, 0)], imm=200, name="st")
    # carried: a0 of next iteration is e
    _carry(g, s5, e, 0)
    _carry(g, r27, e, 0)
    _carry(g, fx, e, 0)
    _carry(g, e, e, 1)
    return g


@register
def sha2() -> DFG:
    """SHA-256 sigma flavour: two rotate-xor ladders + adds; longer chains."""
    g = DFG("sha2")
    iv = g.add("iv", name="i")
    x = g.add("load", [(iv, 0)], imm=0, name="x")
    c7 = g.add("const", imm=7, name="c7")
    c18 = g.add("const", imm=18, name="c18")
    c3 = g.add("const", imm=3, name="c3")
    r7 = g.add("shr", [(x, 0), (c7, 0)], name="r7")
    l25 = g.add("shl", [(x, 0), (c18, 0)], name="l25")
    rot1 = g.add("or", [(r7, 0), (l25, 0)], name="rot1")
    r18 = g.add("shr", [(x, 0), (c18, 0)], name="r18")
    l14 = g.add("shl", [(x, 0), (c7, 0)], name="l14")
    rot2 = g.add("or", [(r18, 0), (l14, 0)], name="rot2")
    sh3 = g.add("shr", [(x, 0), (c3, 0)], name="sh3")
    x1 = g.add("xor", [(rot1, 0), (rot2, 0)], name="x1")
    s0 = g.add("xor", [(x1, 0), (sh3, 0)], name="s0")
    acc = g.add("add", [(s0, 0), (s0, 0)], name="acc")
    w16 = g.add("load", [(iv, 0)], imm=300, name="w16")
    t = g.add("add", [(acc, 0), (w16, 0)], name="t")
    st = g.add("store", [(iv, 0), (t, 0)], imm=400, name="st")
    _carry(g, acc, acc, 1)   # running sum
    return g


@register
def gsm() -> DFG:
    """GSM add/mult with saturation: mul, shift, clamp via min/max."""
    g = DFG("gsm")
    iv = g.add("iv", name="i")
    a = g.add("load", [(iv, 0)], imm=0, name="a")
    b = g.add("load", [(iv, 0)], imm=100, name="b")
    m = g.add("mul", [(a, 0), (b, 0)], name="m")
    c1 = g.add("const", imm=1, name="c1")
    cmax = g.add("const", imm=32767, name="cmax")
    cmin = g.add("const", imm=-32768, name="cmin")
    sh = g.add("shr", [(m, 0), (c1, 0)], name="sh")
    lo = g.add("max", [(sh, 0), (cmin, 0)], name="lo")
    hi = g.add("min", [(lo, 0), (cmax, 0)], name="hi")
    st = g.add("store", [(iv, 0), (hi, 0)], imm=200, name="st")
    return g


@register
def patricia() -> DFG:
    """Patricia trie bit test: load node, extract bit, select child, reload."""
    g = DFG("patricia")
    iv = g.add("iv", name="i")
    p = g.add("load", [(iv, 0)], imm=0, name="p")
    key = g.add("load", [(iv, 0)], imm=100, name="key")
    c31 = g.add("const", imm=31, name="c31")
    c1 = g.add("const", imm=1, name="c1")
    bitpos = g.add("and", [(p, 0), (c31, 0)], name="bitpos")
    sh = g.add("shr", [(key, 0), (bitpos, 0)], name="sh")
    bit = g.add("and", [(sh, 0), (c1, 0)], name="bit")
    l = g.add("add", [(p, 0), (c1, 0)], name="l")
    r = g.add("add", [(p, 0), (bit, 0)], name="r")
    nxt = g.add("select", [(bit, 0), (l, 0), (r, 0)], name="nxt")
    cmp = g.add("lt", [(nxt, 0), (key, 0)], name="cmp")
    acc = g.add("add", [(cmp, 0), (cmp, 0)], name="acc")
    st = g.add("store", [(iv, 0), (acc, 0)], imm=200, name="st")
    _carry(g, acc, acc, 1)
    return g


@register
def bitcount() -> DFG:
    """Kernighan popcount step: n &= n-1; count++ (carried n and count)."""
    g = DFG("bitcount")
    iv = g.add("iv", name="i")
    n0 = g.add("load", [(iv, 0)], imm=0, name="n0")
    c1 = g.add("const", imm=1, name="c1")
    nm1 = g.add("sub", [(n0, 0), (c1, 0)], name="nm1")
    nn = g.add("and", [(n0, 0), (nm1, 0)], name="nn")
    ne0 = g.add("ne", [(nn, 0), (g.add("const", imm=0, name="c0"), 0)], name="ne0")
    cnt = g.add("add", [(ne0, 0), (ne0, 0)], name="cnt")
    st = g.add("store", [(iv, 0), (cnt, 0)], imm=100, name="st")
    _carry(g, cnt, cnt, 1)
    return g


@register
def backprop() -> DFG:
    """Rodinia backprop weight update: w += lr * delta * x, layered loads."""
    g = DFG("backprop")
    iv = g.add("iv", name="i")
    x = g.add("load", [(iv, 0)], imm=0, name="x")
    delta = g.add("load", [(iv, 0)], imm=100, name="delta")
    w = g.add("load", [(iv, 0)], imm=200, name="w")
    lr = g.add("const", imm=3, name="lr")
    dx = g.add("mul", [(delta, 0), (x, 0)], name="dx")
    upd = g.add("mul", [(dx, 0), (lr, 0)], name="upd")
    mom = g.add("mul", [(w, 0), (lr, 0)], name="mom")
    s1 = g.add("add", [(upd, 0), (mom, 0)], name="s1")
    wn = g.add("add", [(w, 0), (s1, 0)], name="wn")
    st = g.add("store", [(iv, 0), (wn, 0)], imm=200, name="st")
    err = g.add("add", [(upd, 0), (upd, 0)], name="err")
    _carry(g, err, err, 1)
    return g


@register
def nw() -> DFG:
    """Needleman-Wunsch cell: max of three neighbours + score, store."""
    g = DFG("nw")
    iv = g.add("iv", name="i")
    nw_ = g.add("load", [(iv, 0)], imm=0, name="nw")
    n_ = g.add("load", [(iv, 0)], imm=100, name="n")
    w_ = g.add("load", [(iv, 0)], imm=200, name="w")
    sc = g.add("load", [(iv, 0)], imm=300, name="sc")
    pen = g.add("const", imm=1, name="pen")
    diag = g.add("add", [(nw_, 0), (sc, 0)], name="diag")
    up = g.add("sub", [(n_, 0), (pen, 0)], name="up")
    left = g.add("sub", [(w_, 0), (pen, 0)], name="left")
    m1 = g.add("max", [(diag, 0), (up, 0)], name="m1")
    m2 = g.add("max", [(m1, 0), (left, 0)], name="m2")
    st = g.add("store", [(iv, 0), (m2, 0)], imm=400, name="st")
    return g


@register
def srand() -> DFG:
    """LCG pseudo-random step: seed = (a*seed + c) & mask (carried seed)."""
    g = DFG("srand")
    a = g.add("const", imm=1103515245, name="a")
    c = g.add("const", imm=12345, name="c")
    mask = g.add("const", imm=0x7FFFFFFF, name="mask")
    iv = g.add("iv", name="i")
    mul = g.add("mul", [(a, 0), (a, 0)], name="mul")
    addc = g.add("add", [(mul, 0), (c, 0)], name="addc")
    seed = g.add("and", [(addc, 0), (mask, 0)], name="seed")
    st = g.add("store", [(iv, 0), (seed, 0)], imm=0, name="st")
    _carry(g, mul, seed, 1)
    return g


@register
def hotspot() -> DFG:
    """Rodinia hotspot 5-point stencil: weighted neighbour sum + update."""
    g = DFG("hotspot")
    iv = g.add("iv", name="i")
    c_ = g.add("load", [(iv, 0)], imm=0, name="c")
    n_ = g.add("load", [(iv, 0)], imm=100, name="n")
    s_ = g.add("load", [(iv, 0)], imm=200, name="s")
    e_ = g.add("load", [(iv, 0)], imm=300, name="e")
    w_ = g.add("load", [(iv, 0)], imm=400, name="w")
    p_ = g.add("load", [(iv, 0)], imm=500, name="p")
    ns = g.add("add", [(n_, 0), (s_, 0)], name="ns")
    ew = g.add("add", [(e_, 0), (w_, 0)], name="ew")
    c2 = g.add("const", imm=2, name="c2")
    cc = g.add("mul", [(c_, 0), (c2, 0)], name="cc")
    nsc = g.add("sub", [(ns, 0), (cc, 0)], name="nsc")
    ewc = g.add("sub", [(ew, 0), (cc, 0)], name="ewc")
    lap = g.add("add", [(nsc, 0), (ewc, 0)], name="lap")
    heat = g.add("add", [(lap, 0), (p_, 0)], name="heat")
    out = g.add("add", [(c_, 0), (heat, 0)], name="out")
    st = g.add("store", [(iv, 0), (out, 0)], imm=600, name="st")
    return g


@register
def basicmath() -> DFG:
    """Cubic polynomial step (Horner) with carried accumulator."""
    g = DFG("basicmath")
    iv = g.add("iv", name="i")
    a3 = g.add("const", imm=2, name="a3")
    a2 = g.add("const", imm=-5, name="a2")
    a1 = g.add("const", imm=7, name="a1")
    a0 = g.add("const", imm=-11, name="a0")
    h1 = g.add("mul", [(a3, 0), (iv, 0)], name="h1")
    h2 = g.add("add", [(h1, 0), (a2, 0)], name="h2")
    h3 = g.add("mul", [(h2, 0), (iv, 0)], name="h3")
    h4 = g.add("add", [(h3, 0), (a1, 0)], name="h4")
    h5 = g.add("mul", [(h4, 0), (iv, 0)], name="h5")
    h6 = g.add("add", [(h5, 0), (a0, 0)], name="h6")
    acc = g.add("add", [(h6, 0), (h6, 0)], name="acc")
    st = g.add("store", [(iv, 0), (acc, 0)], imm=0, name="st")
    _carry(g, acc, acc, 1)
    return g


@register
def stringsearch() -> DFG:
    """Boyer-Moore-Horspool flavour: compare text/pattern chars, update skip."""
    g = DFG("stringsearch")
    iv = g.add("iv", name="i")
    t = g.add("load", [(iv, 0)], imm=0, name="t")
    p = g.add("load", [(iv, 0)], imm=100, name="p")
    eq = g.add("eq", [(t, 0), (p, 0)], name="eq")
    c1 = g.add("const", imm=1, name="c1")
    sk = g.add("load", [(t, 0)], imm=200, name="sk")
    adv = g.add("select", [(eq, 0), (c1, 0), (sk, 0)], name="adv")
    pos = g.add("add", [(adv, 0), (adv, 0)], name="pos")
    st = g.add("store", [(iv, 0), (pos, 0)], imm=300, name="st")
    _carry(g, pos, pos, 1)
    return g
