"""The unified mapping front door: ``compile(MapRequest(...))``.

The entry points that grew over time each exposed one call shape —
``map_loop`` (the sequential Fig. 3 loop, plus routing retries),
``map_sweep`` (the parallel II window engine), ``MappingService.map``
(pool/cache routed), session-injected solves, and ``suite.run_suite``
(batch) — all with overlapping keyword sprawl. :class:`MapRequest` is the
one declarative request object that names every axis of that space, and
:func:`compile` is the one function that serves it:

    from repro_torch.core import MapRequest, compile, arch

    compile(MapRequest(dfg=g, arch="4x4"))                    # Fig. 3 loop
    compile(MapRequest(dfg=g, arch="4x4-torus:r8",
                       sweep_width=4))                        # parallel sweep
    compile(MapRequest(dfg=g, arch=arch("4x4-onehop", mem="col0"),
                       service="default"))                    # pooled + cached
    compile(MapRequest(dfg=g, arch="5x5", routing=True))      # route retries

``arch`` accepts a fabric name (parsed by :func:`repro_torch.core.arch.arch`),
a declarative :class:`~repro_torch.core.arch.ArchSpec`, or a legacy
:class:`~repro_torch.core.cgra.CGRA`. ``service="default"`` routes through the
process-wide :class:`~repro_torch.core.service.MappingService`; a service
instance routes through that instance; ``None`` (default) solves
standalone.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Union

from .arch import ArchSpec, arch as _parse_arch
from .cgra import CGRA
from .dfg import DFG
from .mapper import MapperConfig, MappingResult, map_loop
from .schedule import Infeasible


@dataclass
class MapRequest:
    """One mapping request: what to map, onto what, and how.

    ``config`` carries the full :class:`~repro_torch.core.mapper.MapperConfig`;
    the convenience fields (``solver``/``timeout_s``/``routing``/
    ``max_ii``) override it when set, so simple requests never construct a
    config at all. ``session`` injects a warm
    :class:`~repro_torch.core.sat.portfolio.SolverSession` whose formula matches
    this (dfg, arch, amo) shape; ``use_cache=False`` forces a solve on a
    service-routed request (the warm-vs-cold benchmark knob). ``lat`` is a
    per-op-class latency table ({"mul": 2, ...}) applied when ``arch`` is
    a fabric *name* — equivalent to the name's ``:mulK``-style suffixes;
    use an explicit :class:`ArchSpec` to combine latencies with other
    structural knobs.
    """
    dfg: DFG
    arch: Union[str, CGRA, ArchSpec] = "4x4"
    config: Optional[MapperConfig] = None
    sweep_width: int = 1
    service: Union[None, str, object] = None   # None | "default" | instance
    session: Optional[object] = None
    use_cache: bool = True
    lat: Optional[Dict[str, int]] = None
    # convenience overrides onto ``config``
    solver: Optional[str] = None
    timeout_s: Optional[float] = None
    routing: Optional[bool] = None
    max_ii: Optional[int] = None
    guide: Optional[str] = None   # learned II guidance (name or .npz path)

    def resolved_arch(self) -> Union[CGRA, ArchSpec]:
        if isinstance(self.arch, str):
            return _parse_arch(self.arch, lat=self.lat)
        if self.lat is not None:
            raise ValueError("MapRequest.lat needs a fabric *name*; give "
                             "an ArchSpec/CGRA its latency table directly")
        return self.arch

    def resolved_config(self) -> MapperConfig:
        cfg = self.config or MapperConfig()
        overrides = {k: getattr(self, k)
                     for k in ("solver", "timeout_s", "routing", "max_ii",
                               "guide")
                     if getattr(self, k) is not None}
        return replace(cfg, **overrides) if overrides else cfg


def compile(request: Union[MapRequest, DFG], /, **kw) -> MappingResult:
    """Serve one :class:`MapRequest` -> :class:`MappingResult`.

    Accepts either a ready request or ``compile(dfg, arch=..., ...)``
    shorthand (keywords become :class:`MapRequest` fields). Dispatch:
    a resolved service (``"default"`` -> the process-wide pool) serves the
    request through cache + warm solver pool; otherwise the engine runs
    standalone — the sequential Fig. 3 loop for ``sweep_width=1`` (or when
    routing retries are on), the parallel II-sweep engine above that —
    optionally on an injected warm session.

    A structurally infeasible request (an op class in the DFG with zero
    capable PEs on the fabric — ``MappingResult.infeasible``) raises
    :class:`repro_torch.core.schedule.Infeasible` with the precise reason
    instead of returning an ordinary "no mapping found" failure: no II
    sweep could ever succeed, and silently reporting one as exhausted
    would hide a spec bug.
    """
    if isinstance(request, MapRequest):
        if kw:
            raise TypeError("pass either a MapRequest or keyword fields, "
                            "not both")
        req = request
    else:
        req = MapRequest(dfg=request, **kw)
    arch_obj = req.resolved_arch()
    # structural-feasibility gate *before* dispatch so the caller gets the
    # original exception with its structured fields (op_class, n_ops)
    # rather than a reconstruction from the engines' flattened string
    from .schedule import res_mii
    res_mii(req.dfg, arch_obj)        # raises Infeasible with the reason
    cfg = req.resolved_config()
    svc = req.service
    if isinstance(svc, str):
        if svc != "default":
            raise ValueError(f"unknown service {svc!r}: expected None, "
                             f"'default', or a MappingService instance")
        from .service import get_service
        svc = get_service()
    if svc is not None:
        res = svc.map(req.dfg, arch_obj, cfg, sweep_width=req.sweep_width,
                      use_cache=req.use_cache)
    else:
        res = map_loop(req.dfg, arch_obj, cfg, sweep_width=req.sweep_width,
                       session=req.session)
    if res.infeasible:
        # belt-and-braces for engine- or cache-produced verdicts the gate
        # above could not see (message-only: the gate is the typed path)
        raise Infeasible(res.infeasible)
    return res
