"""Serving front doors of the port: the async batched *compile* server
and the batched LM decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b \\
        --smoke --batch 4 --steps 16 --device cpu --offload-cgra 4x4

Prompts go through ``LM.prefill_with_cache`` (prefill attention on the
flash kernel when the config says ``attn_impl="flash"``), then a greedy
loop of ``LM.decode_step`` over the ring-buffer cache (int8 with scales
when the config says ``kv_quant=True``). Every configuration of
``repro_torch.configs`` serves, the MoE ones (``--arch deepseek_moe_16b``,
``llama4_maverick_400b_a17b``) included. :func:`serve_lm` is
the driver that ``main`` and ``chip_smoke.py`` both call. Unlike the
reference, whose ``--smoke`` flag cannot be turned off, ``main`` serves
the published widths unless ``--smoke`` is given.

``--offload-cgra SIZE`` first maps the architecture's representative
scalar inner loops (``launch/map_cgra.py::loops_for``, traced by the
torch.fx frontend) onto a CGRA sidecar through the process-wide
:class:`repro_torch.core.service.MappingService`. ``--offload-guide`` (a
registered guide name or a ``repro_torch.launch.campaign`` ``.npz``) maps
them with a guided sweep of width 4; guidance never changes a final II.

:class:`CompileFrontDoor` is the mapping-as-a-service tier: an asyncio
front door that accepts ``compile``-shaped requests from thousands of
concurrent clients, micro-batches them in a short window, coalesces
identical requests, routes each family to its affinity shard in a
:class:`repro_torch.core.workers.WorkerPool` (the event loop keeps
admitting requests while the shard processes grind), enforces
per-request deadlines, and exerts backpressure through a bounded queue.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import sys
import time
from dataclasses import astuple, dataclass
from typing import Dict, Hashable, List, Optional

import torch

from .. import device as device_mod
from .. import tracing
from ..configs import get_config
from ..models.layers import _laid_out, is_sharded
from ..models.model import LM
from . import mesh as mesh_mod


@dataclass
class ServeResult:
    fed: torch.Tensor            # [B, steps] the token fed at each step
    tokens: torch.Tensor         # [B, steps] the greedy token after each step
    logits: List[torch.Tensor]   # prefill's last logits, then each step's
    prefill_s: float
    decode_s: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _greedy(lg: torch.Tensor, vocab: int) -> torch.Tensor:
    """The greedy tokens [B, 1] of logits [B, 1, Vp] over the first
    ``vocab`` entries. Logits of the partitioned LM whose vocabulary is
    split over a mesh axis of several ranks are gathered over it first:
    DTensor's own argmax of split logits fails where a rank holds one
    row (torch 2.13)."""
    if is_sharded(lg):
        from torch.distributed.tensor import Replicate
        mesh = lg.device_mesh
        lg = _laid_out(lg, [Replicate() if p.is_shard(2) and mesh.size(i) > 1
                            else p for i, p in enumerate(lg.placements)])
    return torch.argmax(lg[:, :, :vocab], dim=-1)


def serve_lm(lm: LM, prompts: torch.Tensor, steps: int, *,
             window: Optional[int] = None,
             feed: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``prompts`` [B, S] (token ids on the LM's device) into a
    ring buffer of ``window`` slots (default ``min(S, attn_window)``, or S
    without a window), then decode ``steps`` tokens greedily from
    t = S. ``feed`` [B, steps], when given, is fed instead of the greedy
    tokens (to hold two runs to the same inputs). Each logits tensor is
    [B, 1, Vp] f32; the times end in a device synchronize.

    On the partitioned LM (a host world's mesh) every rank passes the
    whole ``prompts`` (and ``feed``); each keeps its rows over "data"
    (:meth:`LM.split_rows`), and the result's tokens and logits are
    gathered whole on every rank after the timed run. While tracing is on
    it counts the cache's bytes by kind (``LM.cache_bytes``), outside any
    span of the LM's."""
    vocab = lm.cfg.vocab
    b, s = prompts.shape
    prompts = lm.split_rows(prompts)
    if feed is not None:
        feed = lm.split_rows(feed)
    with lm.sharded():
        _sync(lm.device)
        t0 = time.perf_counter()
        lg, cache = lm.prefill_with_cache(prompts, window=window)
        _sync(lm.device)
        prefill_s = time.perf_counter() - t0
        if tracing.active():
            for name, n in lm.cache_bytes(cache).items():
                tracing.count(name, n)
        logits = [lg]
        tok = _greedy(lg, vocab)
        fed, outs = [], []
        t0 = time.perf_counter()
        for i in range(steps):
            x = feed[:, i:i + 1] if feed is not None else tok
            fed.append(x[:, 0])
            lg, cache = lm.decode_step(cache, x, s + i)
            tok = _greedy(lg, vocab)
            logits.append(lg)
            outs.append(tok[:, 0])
        _sync(lm.device)
        decode_s = time.perf_counter() - t0
        if lm.mesh is not None:
            fed, outs, logits = ([t.full_tensor() for t in ts]
                                 for ts in (fed, outs, logits))
    empty = torch.empty((b, 0), dtype=torch.long, device=lm.device)
    return ServeResult(
        fed=torch.stack(fed, dim=1) if fed else empty,
        tokens=torch.stack(outs, dim=1) if outs else empty,
        logits=logits, prefill_s=prefill_s, decode_s=decode_s)


class DeadlineExceeded(Exception):
    """A request's per-request deadline elapsed before its result."""


@dataclass
class ServeStats:
    """Front-door counters (client latency percentiles are the client's to
    measure — the server only counts what it alone can see: batching,
    coalescing, backpressure, deadlines)."""
    submitted: int = 0
    served: int = 0
    failed: int = 0
    batches: int = 0
    coalesced: int = 0           # requests served by another's solve
    deadline_violations: int = 0
    queue_peak: int = 0
    max_batch_seen: int = 0

    def snapshot(self) -> Dict[str, int]:
        return dict(self.__dict__)


@dataclass
class _Pending:
    key: Hashable
    dfg: object
    cgra: object
    cfg: object
    sweep_width: int
    use_cache: bool
    future: "asyncio.Future"


class CompileFrontDoor:
    """Async batched compile server over a :class:`WorkerPool`.

    ``await door.compile(dfg, cgra, ...)`` enqueues one request; a single
    batcher task drains the queue in ``window_ms`` micro-batches (up to
    ``max_batch``), coalesces identical cacheable requests onto one
    worker solve, and dispatches the rest to their affinity shards. The
    queue is bounded (``max_pending``): when the solvers fall behind,
    ``compile`` suspends *before* enqueueing — backpressure reaches the
    client as latency, never as an unbounded memory balloon. Each request
    carries a deadline (``deadline_s`` or the constructor default);
    expiry raises :class:`DeadlineExceeded` for that caller while the
    in-flight shard solve continues and still populates the caches.
    """

    def __init__(self, pool, window_ms: float = 4.0, max_batch: int = 64,
                 max_pending: int = 4096,
                 default_deadline_s: float = 120.0):
        self.pool = pool
        self.window_s = max(0.0, window_ms) / 1e3
        self.max_batch = max(1, max_batch)
        self.max_pending = max_pending
        self.default_deadline_s = default_deadline_s
        self.stats = ServeStats()
        self._queue: Optional[asyncio.Queue] = None
        self._batcher: Optional[asyncio.Task] = None
        self._closed = False

    # --------------------------------------------------------- lifecycle
    async def start(self) -> "CompileFrontDoor":
        self._queue = asyncio.Queue(maxsize=self.max_pending)
        self._closed = False
        self._batcher = asyncio.create_task(self._run())
        return self

    async def stop(self) -> None:
        self._closed = True
        if self._batcher is not None:
            self._batcher.cancel()
            try:
                await self._batcher
            except (asyncio.CancelledError, Exception):
                pass
            self._batcher = None

    async def __aenter__(self) -> "CompileFrontDoor":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # --------------------------------------------------------------- API
    async def compile(self, dfg, cgra, cfg=None, sweep_width: int = 1,
                      use_cache: bool = True,
                      deadline_s: Optional[float] = None):
        """One client request -> :class:`MappingResult` (or raises
        :class:`DeadlineExceeded`)."""
        from ..core.mapper import MapperConfig
        from ..core.service import dfg_signature, topology_signature
        if self._queue is None:
            raise RuntimeError("front door not started: call start() "
                               "before compile()")
        cfg = cfg or MapperConfig()
        deadline = time.monotonic() + (deadline_s
                                       if deadline_s is not None
                                       else self.default_deadline_s)
        key = (dfg_signature(dfg), topology_signature(cgra), astuple(cfg),
               sweep_width)
        fut = asyncio.get_running_loop().create_future()
        item = _Pending(key, dfg, cgra, cfg, sweep_width, use_cache, fut)
        self.stats.submitted += 1
        try:
            await asyncio.wait_for(self._queue.put(item),
                                   timeout=max(0.0,
                                               deadline - time.monotonic()))
            self.stats.queue_peak = max(self.stats.queue_peak,
                                        self._queue.qsize())
            res = await asyncio.wait_for(
                fut, timeout=max(0.0, deadline - time.monotonic()))
        except asyncio.TimeoutError:
            self.stats.deadline_violations += 1
            raise DeadlineExceeded(
                f"compile request missed its deadline "
                f"({deadline_s or self.default_deadline_s:.1f}s)") from None
        self.stats.served += 1
        return res

    # ----------------------------------------------------------- batcher
    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._closed:
            try:
                first = await self._queue.get()
            except asyncio.CancelledError:
                return
            batch = [first]
            t_end = loop.time() + self.window_s
            while len(batch) < self.max_batch:
                rem = t_end - loop.time()
                if rem <= 0 and self._queue.empty():
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self._queue.get(), timeout=max(rem, 0.0)))
                except (asyncio.TimeoutError, asyncio.CancelledError):
                    break
            self.stats.batches += 1
            self.stats.max_batch_seen = max(self.stats.max_batch_seen,
                                            len(batch))
            self._dispatch(batch)

    def _dispatch(self, batch: List[_Pending]) -> None:
        # coalesce identical cacheable requests: one shard solve feeds
        # every waiter. use_cache=False requests are never coalesced —
        # each explicitly asked for its own solve.
        groups: "Dict[Hashable, List[_Pending]]" = {}
        singles: List[List[_Pending]] = []
        for p in batch:
            if p.use_cache:
                g = groups.setdefault(p.key, [])
                if g:
                    self.stats.coalesced += 1
                g.append(p)
            else:
                singles.append([p])
        # dispatch sorted by affinity shard so one micro-batch's
        # submissions to a shard's queue are contiguous (same-session
        # requests run back-to-back on their warm worker)
        work = list(groups.values()) + singles
        work.sort(key=lambda ps: self.pool.shard_of(
            ps[0].dfg, ps[0].cgra, ps[0].cfg))
        for members in work:
            lead = members[0]
            cf = self.pool.submit(lead.dfg, lead.cgra, lead.cfg,
                                  sweep_width=lead.sweep_width,
                                  use_cache=lead.use_cache)
            afut = asyncio.wrap_future(cf)
            asyncio.ensure_future(self._settle(afut, members))

    async def _settle(self, afut, members: List[_Pending]) -> None:
        try:
            res = await afut
        except Exception as exc:
            self.stats.failed += len(members)
            for p in members:
                if not p.future.done():
                    p.future.set_exception(exc)
            return
        for p in members:
            if not p.future.done():
                p.future.set_result(res)


def offload_report(cfg, cgra_name: str, guide: Optional[str] = None,
                   sweep_width: int = 1) -> Dict:
    """Map the arch's offloadable inner loops via the shared service —
    one ``compile(MapRequest(...))`` per loop, ``service="default"``
    resolving to the same process-wide pool every entry point shares. The
    fabric name takes the full grammar (``4x4``, ``4x4-torus:r8``, ...).
    ``guide`` (a registered guide name or campaign ``.npz`` checkpoint)
    seeds the sweep windows when ``sweep_width > 1`` — learned guidance
    never changes the final II, only where the sweep starts looking.
    Returns ``{loop name: MappingResult}``."""
    from ..core.api import MapRequest, compile as compile_request
    from ..core.arch import arch
    from ..core.frontend import trace_loop_body
    from ..core.service import get_service
    from .map_cgra import loops_for

    fabric = arch(cgra_name)
    mode = f", sweep k={sweep_width}" if sweep_width > 1 else ""
    if guide:
        mode = f", guided sweep k={sweep_width}"
    results = {}
    print(f"CGRA offload ({fabric}) via MappingService{mode}:")
    for name, fn, n_carry, loads in loops_for(cfg):
        g, _ = trace_loop_body(fn, n_carry=n_carry, loads=loads, name=name)
        r = compile_request(MapRequest(dfg=g, arch=fabric, timeout_s=60,
                                       service="default", guide=guide,
                                       sweep_width=sweep_width))
        results[name] = r
        status = f"II={r.ii}" if r.success else "NO MAPPING"
        guid = r.guidance
        gtxt = (f" guide_offset={guid['offset']}"
                if guid and guid.get("used") else "")
        print(f"  {name:16s} {status} via={r.service.via} "
              f"pruned={r.service.iis_pruned} "
              f"[{r.service.request_time*1e3:.1f}ms]{gtxt}")
    print(f"  service: {get_service().describe()}")
    return results


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen_large")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced same-family config (default: "
                         "the published widths)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--offload-cgra", default=None, metavar="RxC",
                    help="also map this arch's scalar inner loops onto a "
                         "CGRA sidecar (e.g. 4x4) through the shared "
                         "MappingService before serving")
    ap.add_argument("--offload-guide", default=None, metavar="NAME_OR_NPZ",
                    help="learned II guidance for the offload mappings (a "
                         "registered guide name or a repro_torch.launch."
                         "campaign .npz checkpoint); implies a "
                         "sweep_width=4 guided sweep per loop, final IIs "
                         "unchanged by contract")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--spans", action="store_true",
                    help="serve inside repro_torch.tracing.recording() and "
                         "print the LM's spans (calls, host ms, device ms "
                         "by path), the MoE slots dropped and the "
                         "other counters (the SSD's calls by route)")
    args = ap.parse_args(argv)

    if args.device is not None:
        device_mod.set_default_device(args.device)
    if mesh_mod.world_env() is None and mesh_mod.host_ranks() > 1:
        # a plain start on a host of several cards: one rank a card
        mesh_mod.launch(main, (sys.argv[1:] if argv is None else argv,))
        return
    cfg = get_config(args.arch)
    if args.offload_cgra and (mesh_mod.world_env() or (0,))[0] == 0:
        offload_report(cfg, args.offload_cgra, guide=args.offload_guide,
                       sweep_width=4 if args.offload_guide else 1)
    if args.smoke:
        cfg = cfg.smoke()
    if mesh_mod.world_env() is None:
        _serve_main(cfg, args, device_mod.resolve_device(), None)
    else:
        with mesh_mod.host_world() as dm:
            _serve_main(cfg, args, mesh_mod.mesh_device(dm), dm)


def _serve_main(cfg, args, dev: torch.device, mesh) -> None:
    """``main``'s serving run: the LM of ``cfg`` from seed 0 (partitioned
    on ``mesh`` where given), ``args.batch`` seeded prompts of 8 tokens,
    ``args.steps`` greedy tokens; rank 0 prints, with ``args.spans`` the
    run's spans and counters too (``repro_torch.tracing``)."""
    lm = LM(cfg, dev, mesh=mesh).init(
        torch.Generator(device=dev).manual_seed(0))
    prompt_len = 8
    prompts = torch.randint(0, cfg.vocab, (args.batch, prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    with tracing.recording() if args.spans else contextlib.nullcontext():
        res = serve_lm(lm, prompts, args.steps, window=args.window)
    if not mesh_mod.is_rank0(mesh):
        return
    dt = res.decode_s
    print(f"decoded {args.steps} tokens x {args.batch} requests "
          f"in {dt:.2f}s ({args.batch*args.steps/dt:.1f} tok/s)")
    for b in range(args.batch):
        print(f"  req{b}: {res.tokens[b, :12].tolist()}...")
    if args.spans:
        print(tracing.report(tracing.snapshot()))


if __name__ == "__main__":
    main()
