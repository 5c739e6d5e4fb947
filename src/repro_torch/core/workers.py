"""Multi-process solve workers: the parallelism layer of the serving tier.

:class:`WorkerPool` fans ``map()`` requests out over N solver *shards*.
Each shard is a single-worker process running its own
:class:`~repro_torch.core.service.MappingService` over the **shared**
:class:`~repro_torch.core.store.MappingStore` directory — so every shard
sees every other shard's persisted mappings and proven-UNSAT cores, while
its in-memory warm state (pooled solver sessions, learnt clauses,
near-shape lattice) stays process-local and lock-free.

Requests are routed by **affinity**: the shard index is a stable hash of
(topology signature, near-shape lattice bucket), so every request in one
kernel *family* lands on the same shard and keeps hitting that shard's
warm sessions — the near-shape admission of
:func:`repro_torch.core.service.near_shape_key` only pays off if family
members actually meet. Different families ride different shards and solve
in true parallel (separate processes, no GIL).

Where this departs from the JAX package's ``core/workers.py``:

* **Shards are spawned, not forked.** A process forked after its parent
  initialised CUDA cannot use CUDA, and a server that maps and serves in
  one process (or ``chip_smoke.py``) has initialised it long before it
  starts a pool. A spawned shard starts clean: it imports ``repro_torch``
  afresh, takes the parent's resolved default device (which spawn does not
  inherit) in its initialiser, and its walk racer opens a CUDA context of
  its own. Inside a shard, the CDCL process pool still forks, before any
  GPU work, as in a standalone process. The walk's two kernels are built
  in the parent before the shards start; a shard only loads them
  (``kernels._cuda.forbid_builds``).
* **No silent fall-back to threads.** A pool whose shards fail to start
  raises :class:`WorkerStartError`. ``workers=0`` or ``inline=True`` ask
  for thread shards over one shared thread-safe service explicitly: same
  API, same affinity serialisation, no process isolation.
"""
from __future__ import annotations

import multiprocessing
import os
import struct
from concurrent.futures import Future, ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, List, Optional

from .cgra import CGRA
from .dfg import DFG
from .mapper import MapperConfig, MappingResult
from .service import (MappingService, near_shape_key, shape_signature,
                      topology_signature)
from .store import MappingStore, key_hash

# the CUDA sources that a shard's walk launches
WALK_KERNELS = ("clause_eval", "flip_update")
# seconds a spawned shard may take to import the port and start its service
START_TIMEOUT_S = 300.0


class WorkerStartError(RuntimeError):
    """The pool's shard processes did not start."""


# ------------------------------------------------- worker-process globals

_WORKER_SVC: Optional[MappingService] = None


def _worker_init(store_path: Optional[str], near_delta: int,
                 max_sessions: int, cache_size: int, device: str) -> None:
    global _WORKER_SVC
    from .. import device as device_mod
    device_mod.set_default_device(device)
    if device != "cpu":
        from ..kernels import _cuda
        _cuda.forbid_builds()
    store = MappingStore(store_path) if store_path else None
    _WORKER_SVC = MappingService(max_sessions=max_sessions,
                                 cache_size=cache_size, store=store,
                                 near_delta=near_delta)


def _svc() -> MappingService:
    # real raise, not assert: shard entrypoints must guard under -O too
    if _WORKER_SVC is None:
        raise RuntimeError("worker not initialised: _worker_init() did not "
                           "run in this process")
    return _WORKER_SVC


def _worker_map(dfg: DFG, cgra: CGRA, cfg: MapperConfig, sweep_width: int,
                use_cache: bool) -> MappingResult:
    return _svc().map(dfg, cgra, cfg, sweep_width=sweep_width,
                      use_cache=use_cache)


def _worker_stats() -> Dict:
    return _svc().describe()


def _probe() -> Dict:
    """The process's pid, its resolved device and the walk kernels' launch
    counts so far (the CPU route counts none). Not part of ``stats()``:
    ``chip_smoke.py`` and the tests submit it to a shard to see where the
    shard's walks ran."""
    from ..device import resolve_device
    from ..kernels.clause_eval import true_counts, true_counts_window
    from ..kernels.flip_update import walk_chunk
    return {"pid": os.getpid(), "device": resolve_device().type,
            "launches": {"clause_eval_window": true_counts_window.launches,
                         "clause_eval": true_counts.launches,
                         "walk_chunk": walk_chunk.launches}}


def _probe_shards(pool: "WorkerPool") -> List[Dict]:
    """:func:`_probe` in every shard of ``pool`` (for an inline pool, the
    calling process, once per thread shard)."""
    return [ex.submit(_probe).result(timeout=60) for ex in pool._shards]


# ------------------------------------------------------------------ pool


class WorkerPool:
    """N affinity-routed solver shards over one shared store directory.

    ``submit()`` returns a ``concurrent.futures.Future`` resolving to the
    shard's :class:`MappingResult`; ``map()`` is the blocking convenience.
    ``workers=0`` (or ``inline=True``) runs inline thread shards over one
    shared service — identical semantics minus process isolation. Process
    shards are spawned on the port's default device, which must exist
    (``repro_torch.device``); a failure to start them raises
    :class:`WorkerStartError`.
    """

    def __init__(self, workers: Optional[int] = None,
                 store_path: Optional[str] = None, near_delta: int = 1,
                 max_sessions: int = 64, cache_size: int = 512,
                 inline: bool = False):
        if workers is None:
            workers = max(1, min(4, (os.cpu_count() or 2) - 1))
        self.n_workers = max(1, workers)
        self.store_path = store_path
        self.near_delta = near_delta
        self.inline = inline or workers == 0
        self._shards: List = []
        self._inline_svc: Optional[MappingService] = None
        if self.inline:
            store = MappingStore(store_path) if store_path else None
            self._inline_svc = MappingService(
                max_sessions=max_sessions, cache_size=cache_size,
                store=store, near_delta=near_delta)
            self._shards = [ThreadPoolExecutor(max_workers=1)
                            for _ in range(self.n_workers)]
            return
        from ..device import resolve_device
        device = resolve_device().type     # raises if it does not exist
        if device == "cuda":
            from ..kernels import _cuda
            _cuda.build(WALK_KERNELS)      # the shards load, never build
        ctx = multiprocessing.get_context("spawn")
        try:
            for _ in range(self.n_workers):
                self._shards.append(ProcessPoolExecutor(
                    max_workers=1, mp_context=ctx, initializer=_worker_init,
                    initargs=(store_path, near_delta, max_sessions,
                              cache_size, device)))
            # start every shard now, so that a shard that cannot start
            # fails here and not under the first request
            for f in [ex.submit(os.getpid) for ex in self._shards]:
                f.result(timeout=START_TIMEOUT_S)
        except Exception as err:
            self._kill()
            raise WorkerStartError(
                f"{self.n_workers} spawned shard(s) on {device} did not "
                f"start: {type(err).__name__}: {err}") from err

    # ---------------------------------------------------------- routing
    def shard_of(self, dfg: DFG, cgra: CGRA,
                 cfg: Optional[MapperConfig] = None) -> int:
        """Affinity shard for a request: one kernel family (same topology
        + near-shape bucket + solver knobs), one shard, forever."""
        cfg = cfg or MapperConfig()
        shape = shape_signature(dfg, cgra)
        fam = (topology_signature(cgra),
               near_shape_key(shape, max(1, self.near_delta)),
               cfg.amo, cfg.solver, cfg.seed)
        h = key_hash(fam)
        return struct.unpack("<Q", h[:8])[0] % self.n_workers

    # -------------------------------------------------------------- API
    def submit(self, dfg: DFG, cgra: CGRA,
               cfg: Optional[MapperConfig] = None, sweep_width: int = 1,
               use_cache: bool = True) -> Future:
        cfg = cfg or MapperConfig()
        shard = self._shards[self.shard_of(dfg, cgra, cfg)]
        if self.inline:
            svc = self._inline_svc
            return shard.submit(svc.map, dfg, cgra, cfg,
                                sweep_width=sweep_width,
                                use_cache=use_cache)
        return shard.submit(_worker_map, dfg, cgra, cfg, sweep_width,
                            use_cache)

    def map(self, dfg: DFG, cgra: CGRA, cfg: Optional[MapperConfig] = None,
            sweep_width: int = 1, use_cache: bool = True,
            timeout: Optional[float] = None) -> MappingResult:
        return self.submit(dfg, cgra, cfg, sweep_width,
                           use_cache).result(timeout=timeout)

    # -------------------------------------------------------- inspection
    def stats(self) -> Dict:
        """Aggregated per-shard service counters (sum across shards, plus
        the per-shard breakdown under ``"shards"``)."""
        if self.inline:
            per = [self._inline_svc.describe()]
        else:
            per = []
            for ex in self._shards:
                try:
                    per.append(ex.submit(_worker_stats).result(timeout=30))
                except Exception:
                    per.append({})
        total: Dict = {}
        for d in per:
            for k, v in d.items():
                if isinstance(v, (int, float)):
                    total[k] = total.get(k, 0) + v
        total["shards"] = per
        total["n_workers"] = self.n_workers
        total["inline"] = self.inline
        return total

    def shutdown(self, wait: bool = True) -> None:
        for ex in self._shards:
            ex.shutdown(wait=wait, cancel_futures=not wait)
        self._shards = []

    def _kill(self) -> None:
        """Stop every shard process now (a pool that failed to start)."""
        procs = [p for ex in self._shards
                 for p in list((getattr(ex, "_processes", None)
                                or {}).values())]
        for p in procs:
            p.terminate()
        self.shutdown(wait=False)
        for p in procs:
            p.join(timeout=10)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
