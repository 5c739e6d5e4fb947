"""Disk-backed mapping cache + proven-UNSAT-core registry.

:class:`MappingStore` is the persistence layer of the serving tier: one
append-only write-ahead log (``store.log``) holding three record kinds,
all keyed by the SHA-256 of a canonical encoding of the existing
in-memory cache keys (``(topology_signature, shape_signature /
dfg_signature, config, ...)`` tuples — see :mod:`repro_torch.core.service`):

  * **mapping records** — a served :class:`~repro_torch.core.mapper.MappingResult`
    for one canonical request key. A cold process that opens the store
    starts with yesterday's mapping cache warm (``via="disk"`` hits).
    They are pickles, read back through a restricted unpickler that admits
    only this package's classes, numpy and a few builtins: a record that
    names any other module (the JAX package's ``repro.core.mapper``, say,
    in a directory both packages write) is never imported and counts as a
    miss (``StoreStats.mappings_foreign``).
  * **core records** — one proven-UNSAT II per record for a solver-session
    key: the failed-assumption core that refuted ``base + layer_ii``, plus
    (optionally) the refuted projection's clause arena as a self-certifying
    witness — ``verify_core`` re-solves the stored formula and confirms the
    recorded UNSAT, so a registry entry is checkable long after the session
    that produced it is gone. Loaded cores let a fresh session *skip* IIs
    proven infeasible by any earlier process (``via="core"`` attempts).
  * **arena records** — a raw ``(n_vars, lits, offs)`` CSR triple under an
    arbitrary key (the clause arena is the stack-wide interchange format;
    see ``ClauseArena.to_bytes``).

Core and arena records are plain bytes in the JAX package's format, so a
store directory that either package wrote is readable by both.

Durability/concurrency model: the log is the store — every mutation is one
appended record (header + CRC-checked payload), serialised across
processes by an exclusive ``flock`` on a sidecar lock file; readers take a
shared lock only while scanning newly appended bytes (``refresh``), so
many worker processes share one store directory safely. Torn tails (a
writer died mid-append) are truncated away on the next open/append;
*corrupted* bytes (bad magic / CRC inside a complete record) quarantine
the whole log — it is renamed aside and the store restarts empty rather
than crash the service or trust a garbled cache. Array payloads are
8-byte aligned so an mmap-holding reader can ``np.frombuffer`` the arena
segments without copying.
"""
from __future__ import annotations

import hashlib
import io
import os
import pickle
import struct
import threading
import time
from dataclasses import dataclass
from typing import Dict, Hashable, Optional, Tuple
from zlib import crc32

import numpy as np

from .cnf import ArenaFormatError, CNF, ClauseArena

try:
    import fcntl
except ImportError:          # non-POSIX host: single-process store only
    fcntl = None

_MAGIC = b"SMS1"
# record header: magic | rtype u8 | pad[3] | key sha256 | payload_len u64 |
# payload crc32 u32 — 56 bytes, 8-byte aligned so aligned payloads stay
# aligned in the file
_HEAD = struct.Struct("<4sB3x32sQI4x")
RT_MAPPING, RT_CORE, RT_ARENA = 1, 2, 3

# core-record payload head: ii i64 | n_core i32 | has_arena u8 | pad[3] |
# n_vars u64
_CORE_HEAD = struct.Struct("<qiB3xQ")


class StoreCorruption(Exception):
    """Internal scan verdict: complete-but-invalid bytes in the log."""


class ForeignRecord(Exception):
    """A mapping record names a class outside the port's allow-list."""


# what a mapping record may name: this package's classes, numpy's, and the
# builtins a dataclass pickle can hold; anything else is a foreign record
_ALLOWED_BUILTINS = frozenset({"set", "frozenset", "dict", "list", "tuple",
                               "int", "float", "bool", "str", "bytes",
                               "complex", "slice", "range", "bytearray"})


def _allowed(module: str, name: str) -> bool:
    if module.split(".")[0] in ("repro_torch", "numpy"):
        return True
    return module == "builtins" and name in _ALLOWED_BUILTINS


class _RecordUnpickler(pickle.Unpickler):
    """Unpickles a mapping record without importing anything outside the
    allow-list (above): a foreign name raises :class:`ForeignRecord` before
    its module is looked up."""

    def find_class(self, module, name):
        if not _allowed(module, name):
            raise ForeignRecord(f"{module}.{name}")
        return super().find_class(module, name)


# ------------------------------------------------------------- log framing
# The record framing is shared infrastructure: MappingStore's WAL and the
# JAX package's campaign dataset shards are both sequences of these frames,
# so torn-tail tolerance and CRC screening behave identically in every log
# this repo writes.


def write_framed(f, rtype: int, key: bytes, payload: bytes) -> int:
    """Append one framed record (header + payload + 8-byte-alignment pad)
    to an open binary file; returns the number of bytes written."""
    head = _HEAD.pack(_MAGIC, rtype, key, len(payload),
                      crc32(payload) & 0xFFFFFFFF)
    pad = b"\x00" * ((-len(payload)) % 8)
    f.write(head + payload + pad)
    return len(head) + len(payload) + len(pad)


def iter_framed(path: str, start: int = 0):
    """Yield ``(rtype, key, payload, record_off, end_off)`` for every
    complete record in ``[start, EOF)``. A torn tail (partial header or
    payload — a writer died mid-append) ends iteration silently; the
    caller detects it by comparing the last ``end_off`` against the file
    size. Complete-but-invalid bytes raise :class:`StoreCorruption`."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        f.seek(start)
        pos = start
        while pos + _HEAD.size <= size:
            head = f.read(_HEAD.size)
            if len(head) < _HEAD.size:
                break                              # torn header
            magic, rtype, key, plen, crc = _HEAD.unpack(head)
            if magic != _MAGIC:
                raise StoreCorruption(f"bad record magic at {pos}")
            padded = plen + (-plen) % 8
            if pos + _HEAD.size + padded > size:
                break                              # torn payload
            payload = f.read(padded)[:plen]
            if crc32(payload) & 0xFFFFFFFF != crc:
                raise StoreCorruption(f"payload CRC mismatch at {pos}")
            end = pos + _HEAD.size + padded
            yield rtype, key, payload, pos, end
            pos = end


def canonical_bytes(obj) -> bytes:
    """Deterministic byte encoding of the nested-tuple cache keys.

    Handles exactly the types the service keys contain (ints, floats,
    strings, bools, None, bytes, nested tuples/lists, frozensets — the
    last sorted by element encoding so set iteration order never leaks
    into the key). Raises ``TypeError`` on anything else rather than
    fall back to ``repr``/``pickle``, whose output is not canonical."""
    if obj is None:
        return b"N"
    if obj is True:
        return b"T"
    if obj is False:
        return b"F"
    if isinstance(obj, int):
        return b"i" + str(obj).encode()
    if isinstance(obj, float):
        return b"f" + struct.pack("<d", obj)
    if isinstance(obj, str):
        raw = obj.encode()
        return b"s" + str(len(raw)).encode() + b":" + raw
    if isinstance(obj, bytes):
        return b"b" + str(len(obj)).encode() + b":" + obj
    if isinstance(obj, (tuple, list)):
        return b"(" + b",".join(canonical_bytes(x) for x in obj) + b")"
    if isinstance(obj, frozenset):
        return b"{" + b",".join(sorted(canonical_bytes(x)
                                       for x in obj)) + b"}"
    raise TypeError(f"cannot canonicalise {type(obj).__name__} in store key")


def key_hash(key: Hashable) -> bytes:
    """SHA-256 digest of the canonical encoding — the on-disk key."""
    return hashlib.sha256(canonical_bytes(key)).digest()


@dataclass
class StoreStats:
    mappings_written: int = 0
    mappings_read: int = 0
    mappings_foreign: int = 0      # records naming a module outside the
    #                                port's allow-list: misses, never loaded
    cores_written: int = 0
    arenas_written: int = 0
    refreshes: int = 0
    torn_tail_truncated: int = 0
    quarantined: int = 0
    write_errors: int = 0
    compactions: int = 0

    def snapshot(self) -> Dict[str, int]:
        return dict(self.__dict__)


@dataclass
class _CoreRec:
    ii: int
    core: Tuple[int, ...]
    # (offset, length) of the optional arena witness blob + its n_vars
    witness: Optional[Tuple[int, int, int]] = None


class MappingStore:
    """Shared disk store under ``path`` (a directory; created if absent).

    Thread-safe (one internal lock) and multi-process-safe (``flock`` on
    ``store.lock``); every worker opens its own instance on the same
    directory. ``readonly=True`` never appends (useful for inspection).
    """

    def __init__(self, path: str, readonly: bool = False,
                 fsync: bool = False):
        self.path = os.path.abspath(path)
        self.readonly = readonly
        self.fsync = fsync
        os.makedirs(self.path, exist_ok=True)
        self.log_path = os.path.join(self.path, "store.log")
        self._lock_path = os.path.join(self.path, "store.lock")
        self._lock = threading.RLock()
        self.stats = StoreStats()
        # key hash -> (offset, payload_len) of the *latest* record
        self._mappings: Dict[bytes, Tuple[int, int]] = {}
        self._arenas: Dict[bytes, Tuple[int, int]] = {}
        # session key hash -> {ii: core record}
        self._cores: Dict[bytes, Dict[int, _CoreRec]] = {}
        self._scanned = 0          # bytes of the log already indexed
        if not os.path.exists(self.log_path) and not readonly:
            with open(self.log_path, "ab"):
                pass
        self.refresh()

    # ------------------------------------------------------------ locking
    def _flock(self, exclusive: bool):
        """Cross-process advisory lock context (no-op without fcntl)."""
        return _FileLock(self._lock_path, exclusive)

    # ----------------------------------------------------------- scanning
    def _index_record(self, rtype: int, key: bytes, off: int, length: int,
                      payload: bytes) -> None:
        if rtype == RT_MAPPING:
            self._mappings[key] = (off, length)
        elif rtype == RT_ARENA:
            self._arenas[key] = (off, length)
        elif rtype == RT_CORE:
            ii, n_core, has_arena, n_vars = _CORE_HEAD.unpack_from(payload)
            lits_end = _CORE_HEAD.size + 4 * n_core
            core = tuple(np.frombuffer(payload, dtype="<i4", count=n_core,
                                       offset=_CORE_HEAD.size).tolist())
            witness = None
            if has_arena:
                # witness blob sits 8-byte aligned after the core literals
                w_off = lits_end + (-lits_end) % 8
                witness = (off + w_off, length - w_off, int(n_vars))
            self._cores.setdefault(key, {})[ii] = _CoreRec(ii, core, witness)
        # unknown rtypes are skipped (forward compatibility)

    def _scan_from(self, start: int) -> None:
        """Index records in ``[start, EOF)``; tolerate a torn tail, raise
        :class:`StoreCorruption` on complete-but-invalid bytes."""
        size = os.path.getsize(self.log_path)
        if size <= start:
            self._scanned = max(self._scanned, size if start <= size
                                else self._scanned)
            return
        pos = start
        for rtype, key, payload, off, end in iter_framed(self.log_path,
                                                         start):
            self._index_record(rtype, key, off + _HEAD.size, len(payload),
                               payload)
            pos = end
        if pos < size:
            self.stats.torn_tail_truncated += 1
        self._scanned = pos

    def _quarantine(self) -> None:
        """Move the corrupt log aside and restart empty (service keeps
        running; the quarantined file is kept for post-mortem)."""
        dst = f"{self.log_path}.corrupt-{os.getpid()}-{int(time.time())}"
        try:
            os.replace(self.log_path, dst)
        except OSError:
            pass
        self._mappings.clear()
        self._arenas.clear()
        self._cores.clear()
        self._scanned = 0
        self.stats.quarantined += 1
        if not self.readonly:
            with open(self.log_path, "ab"):
                pass

    def refresh(self) -> None:
        """Index any records other writers appended since the last scan."""
        with self._lock:
            self.stats.refreshes += 1
            try:
                with self._flock(exclusive=False):
                    self._scan_from(self._scanned)
            except StoreCorruption:
                with self._flock(exclusive=True):
                    self._quarantine()
            except FileNotFoundError:
                self._scanned = 0

    # ------------------------------------------------------------ writing
    def _append(self, rtype: int, key: bytes, payload: bytes) -> bool:
        if self.readonly:
            return False
        with self._lock:
            try:
                with self._flock(exclusive=True):
                    # index (and validate) everything written since our
                    # last scan, then drop any torn tail before appending
                    try:
                        self._scan_from(self._scanned)
                    except StoreCorruption:
                        self._quarantine()
                    with open(self.log_path, "r+b" if os.path.exists(
                            self.log_path) else "w+b") as f:
                        f.truncate(self._scanned)
                        f.seek(self._scanned)
                        off = self._scanned + _HEAD.size
                        written = write_framed(f, rtype, key, payload)
                        f.flush()
                        if self.fsync:
                            os.fsync(f.fileno())
                    self._index_record(rtype, key, off, len(payload),
                                       payload)
                    self._scanned += written
                return True
            except OSError:
                self.stats.write_errors += 1
                return False

    def _read_payload(self, off: int, length: int) -> Optional[bytes]:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(off)
                data = f.read(length)
            return data if len(data) == length else None
        except OSError:
            return None

    # ----------------------------------------------------------- mappings
    def put_mapping(self, key: Hashable, result) -> bool:
        """Persist one served result under its canonical request key."""
        payload = pickle.dumps(_trim_result(result),
                               protocol=pickle.HIGHEST_PROTOCOL)
        ok = self._append(RT_MAPPING, key_hash(key), payload)
        if ok:
            self.stats.mappings_written += 1
        return ok

    def get_mapping(self, key: Hashable):
        """The stored result for ``key``, or None. A miss re-scans the log
        tail once so hits from concurrent writer processes are visible."""
        kh = key_hash(key)
        with self._lock:
            loc = self._mappings.get(kh)
            if loc is None:
                self.refresh()
                loc = self._mappings.get(kh)
            if loc is None:
                return None
            payload = self._read_payload(*loc)
        if payload is None:
            return None
        try:
            res = _RecordUnpickler(io.BytesIO(payload)).load()
        except ForeignRecord:
            with self._lock:
                self.stats.mappings_foreign += 1
            return None
        except Exception:
            # a record that indexed clean but unpickles dirty: treat as a
            # miss (the CRC already screens bit rot; this guards version
            # skew between writer and reader processes)
            return None
        self.stats.mappings_read += 1
        return res

    @property
    def n_mappings(self) -> int:
        with self._lock:
            return len(self._mappings)

    # -------------------------------------------------------------- cores
    def put_core(self, session_key: Hashable, ii: int,
                 core: Tuple[int, ...],
                 witness: Optional[CNF] = None) -> bool:
        """Record a proven-UNSAT II for a session key. ``witness`` (the
        refuted per-II projection) makes the record self-certifying — see
        :meth:`verify_core`."""
        core_arr = np.asarray(list(core), dtype="<i4")
        blob = b""
        n_vars = 0
        if witness is not None:
            blob = witness.arena.to_bytes()
            n_vars = witness.n_vars
        head = _CORE_HEAD.pack(ii, core_arr.size, 1 if witness is not None
                               else 0, n_vars)
        body = head + core_arr.tobytes()
        body += b"\x00" * ((-len(body)) % 8) + blob
        ok = self._append(RT_CORE, key_hash(session_key), body)
        if ok:
            self.stats.cores_written += 1
        return ok

    def cores_for(self, session_key: Hashable) -> Dict[int, Tuple[int, ...]]:
        """Every proven-UNSAT II recorded for ``session_key`` (by any
        process, ever): ``{ii: failed-assumption core}``."""
        kh = key_hash(session_key)
        with self._lock:
            if kh not in self._cores:
                self.refresh()
            recs = self._cores.get(kh, {})
            return {ii: r.core for ii, r in recs.items()}

    def core_witness(self, session_key: Hashable, ii: int,
                     ) -> Optional[Tuple[int, ClauseArena]]:
        """The stored ``(n_vars, arena)`` of the projection refuted at
        ``ii``, when the writer attached one."""
        with self._lock:
            rec = self._cores.get(key_hash(session_key), {}).get(ii)
            if rec is None or rec.witness is None:
                return None
            off, length, n_vars = rec.witness
            blob = self._read_payload(off, length)
        if blob is None:
            return None
        try:
            return n_vars, ClauseArena.from_bytes(blob)
        except ArenaFormatError:
            return None

    def verify_core(self, session_key: Hashable, ii: int) -> Optional[bool]:
        """Re-solve the stored witness formula and check the recorded
        refutation: True = witness is UNSAT as claimed, False = the store
        holds a wrong verdict, None = no witness recorded."""
        got = self.core_witness(session_key, ii)
        if got is None:
            return None
        n_vars, arena = got
        from .sat.cdcl import solve_arena_worker
        status, _ = solve_arena_worker(n_vars, arena.lits_view(),
                                       arena.offs_view())
        return status == "UNSAT"

    # ------------------------------------------------------------- arenas
    def put_arena(self, key: Hashable, n_vars: int,
                  arena: ClauseArena) -> bool:
        body = struct.pack("<Q", n_vars) + arena.to_bytes()
        ok = self._append(RT_ARENA, key_hash(key), body)
        if ok:
            self.stats.arenas_written += 1
        return ok

    def get_arena(self, key: Hashable) -> Optional[Tuple[int, ClauseArena]]:
        with self._lock:
            loc = self._arenas.get(key_hash(key))
            if loc is None:
                self.refresh()
                loc = self._arenas.get(key_hash(key))
            if loc is None:
                return None
            payload = self._read_payload(*loc)
        if payload is None or len(payload) < 8:
            return None
        n_vars = struct.unpack_from("<Q", payload)[0]
        try:
            return int(n_vars), ClauseArena.from_bytes(payload[8:])
        except ArenaFormatError:
            return None

    # ---------------------------------------------------------- compaction
    def compact(self) -> Dict[str, int]:
        """Rewrite the append-only log keeping only *live* records: the
        latest mapping and arena per key and the latest core per
        (session key, II). Long campaigns overwrite the same cells over
        and over, and an append-only WAL grows without bound — compaction
        reclaims the dead versions while preserving every current
        ``key -> value`` lookup bit-for-bit (witness blobs included; their
        offsets are re-derived by the post-rewrite rescan).

        The rewrite goes to a temp file in the store directory and lands
        via ``os.replace`` under the exclusive cross-process lock, so
        concurrent readers either see the old log or the complete new one,
        never a half-written hybrid. A log that scans corrupt is
        quarantined exactly as ``refresh`` would have done. Returns
        ``{bytes_before, bytes_after, records_kept, records_dropped}``."""
        out = {"bytes_before": 0, "bytes_after": 0, "records_kept": 0,
               "records_dropped": 0}
        if self.readonly:
            return out
        with self._lock:
            try:
                with self._flock(exclusive=True):
                    out["bytes_before"] = os.path.getsize(self.log_path)
                    # one full scan collecting the latest raw payload per
                    # live key (insertion order = first-write order, so the
                    # compacted log keeps a stable, deterministic layout)
                    live: "Dict[Tuple, Tuple[int, bytes, bytes]]" = {}
                    total = 0
                    try:
                        for rtype, key, payload, _off, _end in iter_framed(
                                self.log_path):
                            total += 1
                            if rtype == RT_CORE:
                                ii = _CORE_HEAD.unpack_from(payload)[0]
                                dedup = (rtype, key, ii)
                            else:
                                dedup = (rtype, key)
                            live[dedup] = (rtype, key, payload)
                    except StoreCorruption:
                        self._quarantine()
                        return out
                    tmp = self.log_path + f".compact-{os.getpid()}"
                    with open(tmp, "wb") as f:
                        for rtype, key, payload in live.values():
                            write_framed(f, rtype, key, payload)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, self.log_path)
                    # drop the stale index (every payload offset moved) and
                    # rebuild from the compacted log
                    self._mappings.clear()
                    self._arenas.clear()
                    self._cores.clear()
                    self._scanned = 0
                    self._scan_from(0)
                    self.stats.compactions += 1
                    out["bytes_after"] = os.path.getsize(self.log_path)
                    out["records_kept"] = len(live)
                    out["records_dropped"] = total - len(live)
            except OSError:
                self.stats.write_errors += 1
        return out

    # ---------------------------------------------------------- inspection
    def describe(self) -> Dict[str, int]:
        with self._lock:
            d = self.stats.snapshot()
            d["mappings"] = len(self._mappings)
            d["core_sessions"] = len(self._cores)
            d["cores"] = sum(len(v) for v in self._cores.values())
            d["arenas"] = len(self._arenas)
            d["log_bytes"] = self._scanned
            return d


class _FileLock:
    """``flock`` context on a sidecar lock file (shared or exclusive);
    degrades to a no-op where fcntl is unavailable."""

    def __init__(self, path: str, exclusive: bool):
        self._path = path
        self._exclusive = exclusive
        self._fd: Optional[int] = None

    def __enter__(self):
        if fcntl is not None:
            self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(self._fd, fcntl.LOCK_EX if self._exclusive
                        else fcntl.LOCK_SH)
        return self

    def __exit__(self, *exc):
        if self._fd is not None:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
            self._fd = None
        return False


def _trim_result(result):
    """A pickling-safe shallow copy of a MappingResult: the per-request
    ``service`` report describes the request that *produced* the entry,
    not the one that will read it — every disk hit gets a fresh one."""
    from copy import copy
    out = copy(result)
    out.service = None
    return out
