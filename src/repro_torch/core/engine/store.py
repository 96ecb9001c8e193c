"""Persistent, content-addressed topology store (the serving back end).

Discovery results become durable artifacts here: a finished ``Topology``
(plus request metadata and per-family timings) and the engine's
``SampleCache`` entries are persisted on disk, keyed by a hash of the
*discovery request* — the same signature the engine already uses to key
sample streams (``simulate._KeyedSampler``).  Because simulated runners draw
request-keyed samples, a stored topology is byte-for-byte what re-running
the request would produce, so repeated discovery of a known device is a pure
cache hit: ``discover_sim(store=...)`` returns the stored topology without
touching the runner at all.

Layout under the store root::

    topologies/<key>.json   # {"meta": {...}, "topology": Topology.to_json()}
    samples/<key>.npz       # SampleCache entries (manifest + row arrays)
    checkpoints/<key>.npz   # in-progress discovery state (resume path)
    corrupt/                # quarantined unreadable files (recovery path)

Writes are atomic (temp file + ``os.replace``); reads that hit corrupted
files quarantine them into ``corrupt/`` and report a miss, so a damaged
store degrades to re-discovery instead of failing the request.

Concurrent discoveries on one store additionally take an **advisory write
lock** (``fcntl.flock`` on ``<root>/.lock``; an exclusive-create lockfile
where ``fcntl`` is unavailable): atomic replace already keeps individual
files intact, but a discovery persists a topology *and* its sample archive
as a pair, and two processes interleaving those writes could leave a
topology from one run next to samples from another.  ``lock()`` is
re-entrant within a thread, so callers can span multi-file transactions
while the store's own writes stay safe when used bare.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import threading
import time
import zipfile
from dataclasses import dataclass, field

import numpy as np

from ..topology import Topology

__all__ = ["TopologyStore", "StoredTopology", "StoreLock", "GcPolicy",
           "request_key"]

SCHEMA_VERSION = 1

try:
    import fcntl
except ImportError:                                    # non-POSIX fallback
    fcntl = None


class StoreLock:
    """Advisory, re-entrant, cross-process write lock for one store root.

    POSIX: ``flock`` on a dedicated lock file — released automatically by
    the OS if the holder dies, so no stale-lock handling is needed.
    Fallback: an exclusive-create lockfile holding the owner pid, polled
    with a timeout; locks older than ``stale_seconds`` whose recorded
    holder pid is verifiably dead are broken (the holder crashed before
    unlinking).

    File locks only order *processes* reliably: ``flock`` semantics between
    two descriptors in one process are platform-dependent (fcntl-emulated
    flock — NFS mounts, some libcs — treats record locks as per-process, so
    a second thread "acquires" immediately).  A process-wide
    ``threading.Lock`` layered *under* the file lock serializes threads
    first, so the file lock only ever arbitrates between processes.

    The stale break is liveness-checked and atomic (``_break_stale``): a
    lock whose holder pid is still alive is never broken regardless of
    age, and the break renames the lockfile aside and verifies (by stat
    identity) that the renamed file is the one it sampled — so a breaker
    racing a fresh acquisition can never unlink a lockfile another holder
    just created, the race the pre-fix docstring documented.
    """

    def __init__(self, path: str, *, timeout: float = 30.0,
                 poll: float = 0.05, stale_seconds: float = 300.0):
        self.path = path
        self.timeout = timeout
        self.poll = poll
        self.stale_seconds = stale_seconds
        self._tls = threading.local()
        self._thread_gate = threading.Lock()

    @property
    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    def acquire(self) -> None:
        if self._depth:                                # re-entrant
            self._tls.depth += 1
            return
        self._thread_gate.acquire()                    # threads first...
        if fcntl is not None:                          # ...then processes
            fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(fd, fcntl.LOCK_EX)
            self._tls.fd = fd
        else:
            deadline = time.monotonic() + self.timeout
            while True:
                try:
                    fd = os.open(self.path,
                                 os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
                    os.write(fd, str(os.getpid()).encode())
                    self._tls.fd = fd
                    break
                except FileExistsError:
                    if self._break_stale():
                        continue
                    if time.monotonic() > deadline:
                        self._thread_gate.release()
                        raise TimeoutError(
                            f"store lock busy for >{self.timeout}s: "
                            f"{self.path}")
                    time.sleep(self.poll)
        self._tls.depth = 1

    def _break_stale(self) -> bool:
        """Safely break a stale fallback lockfile; True = retry the acquire.

        Guards (in order) against the documented race where an age-only
        break unlinks a lockfile another holder just created:

        1. a lock younger than ``stale_seconds`` is never touched;
        2. a lock whose recorded holder pid is still alive is never
           touched, regardless of age (a long critical section is not a
           crash);
        3. the break renames the lockfile aside and verifies by stat
           identity (inode + mtime) that the renamed file is the one it
           sampled — a mismatch means a fresh sibling lock was displaced,
           and it is restored via ``os.link`` (which cannot clobber a
           newer lockfile) instead of being destroyed.
        """
        try:
            st = os.stat(self.path)
        except OSError:
            return True                    # holder released: retry at once
        if time.time() - st.st_mtime <= self.stale_seconds:
            return False
        pid = None
        try:
            with open(self.path) as f:
                pid = int(f.read().strip() or "0")
        except (OSError, ValueError):
            pid = None                     # unreadable pid: treat as dead
        if pid:
            try:
                os.kill(pid, 0)
                return False               # holder alive: never break
            except ProcessLookupError:
                pass                       # verifiably dead: break below
            except OSError:
                return False               # alive under another uid, etc.
        trash = f"{self.path}.stale.{os.getpid()}.{threading.get_ident()}"
        try:
            os.rename(self.path, trash)
        except OSError:
            return True                    # lost the break race: retry
        restored = False
        try:
            st2 = os.stat(trash)
            if (st2.st_ino, st2.st_mtime_ns) != (st.st_ino, st.st_mtime_ns):
                # We displaced a FRESH lock created after our stat: put it
                # back (link fails harmlessly if yet another lock appeared
                # meanwhile — it never overwrites).
                with contextlib.suppress(OSError):
                    os.link(trash, self.path)
                restored = True
        except OSError:
            pass
        with contextlib.suppress(OSError):
            os.unlink(trash)
        return not restored

    def release(self) -> None:
        depth = self._depth
        if depth > 1:
            self._tls.depth = depth - 1
            return
        fd = getattr(self._tls, "fd", None)
        self._tls.depth = 0
        self._tls.fd = None
        if fd is None:
            return
        try:
            if fcntl is not None:
                fcntl.flock(fd, fcntl.LOCK_UN)
                os.close(fd)
            else:
                os.close(fd)
                with contextlib.suppress(OSError):
                    os.unlink(self.path)
        finally:
            self._thread_gate.release()

    @property
    def held(self) -> bool:
        return self._depth > 0

    def __enter__(self) -> "StoreLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


def request_key(descriptor: dict) -> str:
    """Content address of a discovery request.

    The descriptor must contain everything that determines the result
    (device identity + seed, sample count, element restriction) and nothing
    that does not (worker counts, engine vs legacy — both produce
    bit-identical topologies).  The store's schema version is folded in
    here, so a schema bump invalidates every old key instead of serving
    old-layout documents.
    """
    blob = json.dumps({"_schema": SCHEMA_VERSION, **descriptor},
                      sort_keys=True, separators=(",", ":"),
                      default=str).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


@dataclass(frozen=True)
class GcPolicy:
    """Retention policy for ``TopologyStore.gc`` / ``discover(gc_policy=)``.

    ``max_entries`` keeps at most that many newest topologies;
    ``max_age_s`` evicts entries whose ``created_at`` is older than the
    horizon.  Both are opt-in (None = unlimited), and eviction always
    removes the topology *and* its sample archive as one pair.
    """

    max_entries: int | None = None
    max_age_s: float | None = None


@dataclass
class StoredTopology:
    """One store entry: the topology plus its request/provenance metadata."""

    key: str
    topology: Topology
    meta: dict = field(default_factory=dict)


class TopologyStore:
    """Content-addressed on-disk store for discovered topologies + samples."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._topo_dir = os.path.join(self.root, "topologies")
        self._samples_dir = os.path.join(self.root, "samples")
        self._ckpt_dir = os.path.join(self.root, "checkpoints")
        self._corrupt_dir = os.path.join(self.root, "corrupt")
        for d in (self._topo_dir, self._samples_dir, self._ckpt_dir):
            os.makedirs(d, exist_ok=True)
        self._lock = StoreLock(os.path.join(self.root, ".lock"))
        self.hits = 0
        self.misses = 0
        self.corrupt = 0

    def lock(self) -> StoreLock:
        """The store's advisory write lock (re-entrant context manager).

        Individual ``put``/``put_samples``/``delete`` calls take it on
        their own; wrap multi-file transactions — a topology plus its
        sample archive — in one ``with store.lock():`` block so concurrent
        discoveries cannot interleave the pair.
        """
        return self._lock

    # ------------------------------------------------------------- paths
    def _topo_path(self, key: str) -> str:
        return os.path.join(self._topo_dir, f"{key}.json")

    def _samples_path(self, key: str) -> str:
        return os.path.join(self._samples_dir, f"{key}.npz")

    def _ckpt_path(self, key: str) -> str:
        return os.path.join(self._ckpt_dir, f"{key}.npz")

    @staticmethod
    def _atomic_write(path: str, data: bytes) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def _quarantine(self, path: str) -> None:
        """Move an unreadable file aside so the key reads as a miss."""
        os.makedirs(self._corrupt_dir, exist_ok=True)
        dest = os.path.join(self._corrupt_dir,
                            f"{os.path.basename(path)}.{int(time.time())}")
        try:
            os.replace(path, dest)
        except OSError:
            pass
        self.corrupt += 1

    # --------------------------------------------------------- topologies
    def put(self, key: str, topo: Topology, meta: dict | None = None) -> str:
        """Persist a topology under ``key``; returns the key.

        ``meta`` is merged over the defaults derived from the topology
        (model/vendor/backend identity, creation time, schema version) —
        the query service filters and ranks entries on these fields.
        """
        doc_meta = {
            "schema": SCHEMA_VERSION,
            "model": topo.model,
            "vendor": topo.vendor,
            "backend": topo.backend,
            "created_at": time.time(),
        }
        if meta:
            doc_meta.update(meta)
        doc = {"meta": doc_meta, "topology": topo.to_json()}
        with self._lock:
            self._atomic_write(self._topo_path(key),
                               json.dumps(doc, sort_keys=True).encode())
        return key

    def _read_doc(self, key: str) -> dict | None:
        """Raw store document, quarantining unreadable files; no counters."""
        path = self._topo_path(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read())
            if not isinstance(doc, dict) or "topology" not in doc:
                raise KeyError("topology")
            return doc
        except (json.JSONDecodeError, KeyError, TypeError, UnicodeDecodeError,
                OSError):
            self._quarantine(path)
            return None

    def get(self, key: str) -> StoredTopology | None:
        """Load a stored topology; corrupted entries quarantine + miss.

        The hit/miss counters track this key-addressed serving path only —
        meta scans (``index``/``find``) do not inflate them.
        """
        doc = self._read_doc(key)
        if doc is not None:
            try:
                topo = Topology.from_json(doc["topology"])
            except (KeyError, TypeError, AttributeError):
                self._quarantine(self._topo_path(key))
                doc = None
        if doc is None:
            self.misses += 1
            return None
        self.hits += 1
        return StoredTopology(key=key, topology=topo, meta=doc.get("meta", {}))

    def has(self, key: str) -> bool:
        return os.path.exists(self._topo_path(key))

    def generation(self, key: str) -> tuple | None:
        """Opaque freshness token for ``key``'s on-disk document, or None
        when the key has no document (never stored, GC'd, or quarantined).

        Derived from the file's stat identity (mtime_ns + size + inode), so
        it changes on every ``put`` — including cross-process writers the
        in-process service never saw — and disappears on eviction.  Callers
        caching deserialized topologies (``TopologyService``'s LRU) compare
        tokens to decide whether a cached object may still be served.
        """
        try:
            st = os.stat(self._topo_path(key))
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size, st.st_ino)

    def is_quarantined(self, key: str) -> bool:
        """True when ``key``'s topology document was moved to ``corrupt/``
        (and no fresh document has replaced it) — the serving layer maps
        this to 503-retry-later rather than 404-unknown."""
        if self.has(key):
            return False
        prefix = f"{key}.json."
        try:
            names = os.listdir(self._corrupt_dir)
        except OSError:
            return False
        return any(n.startswith(prefix) for n in names)

    def delete(self, key: str) -> None:
        """Remove every artifact of ``key``: topology, samples, checkpoint."""
        with self._lock:
            for path in (self._topo_path(key), self._samples_path(key),
                         self._ckpt_path(key)):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass

    def keys(self) -> list[str]:
        return sorted(os.path.splitext(f)[0]
                      for f in os.listdir(self._topo_dir)
                      if f.endswith(".json"))

    def index(self) -> list[tuple[str, dict]]:
        """``(key, meta)`` for every readable entry — a meta-only scan that
        skips topology deserialization and leaves the serving counters
        untouched (corrupted files still quarantine)."""
        out = []
        for key in self.keys():
            doc = self._read_doc(key)
            if doc is not None:
                out.append((key, doc.get("meta", {})))
        return out

    def entries(self) -> list[StoredTopology]:
        """All readable entries (corrupted files are quarantined, not raised)."""
        out = []
        for key in self.keys():
            entry = self.get(key)
            if entry is not None:
                out.append(entry)
        return out

    def find(self, *, model: str | None = None, vendor: str | None = None,
             backend: str | None = None) -> list[StoredTopology]:
        """Entries matching the given identity fields, newest first.

        Filters on the meta index, then loads only the matching topologies.
        """
        matches = [(key, meta) for key, meta in self.index()
                   if (model is None or meta.get("model") == model)
                   and (vendor is None or meta.get("vendor") == vendor)
                   and (backend is None or meta.get("backend") == backend)]
        matches.sort(key=lambda km: km[1].get("created_at", 0.0), reverse=True)
        out = []
        for key, _meta in matches:
            entry = self.get(key)
            if entry is not None:
                out.append(entry)
        return out

    # ------------------------------------------------------------ samples
    def put_samples(self, key: str, entries: dict) -> None:
        """Persist ``SampleCache`` entries: tuple keys -> sample arrays.

        Keys are flat tuples of str/int (the runner request signatures);
        they serialize through a JSON manifest, arrays positionally.
        """
        manifest = []
        arrays = {}
        for i, (k, arr) in enumerate(entries.items()):
            manifest.append(list(k))
            arrays[f"a{i}"] = np.asarray(arr)
        buf = io.BytesIO()
        np.savez_compressed(buf, manifest=json.dumps(manifest), **arrays)
        with self._lock:
            self._atomic_write(self._samples_path(key), buf.getvalue())

    def load_samples(self, key: str) -> dict | None:
        """Load persisted sample entries; corrupted archives miss (+quarantine)."""
        path = self._samples_path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as data:
                manifest = json.loads(str(data["manifest"]))
                return {tuple(k): data[f"a{i}"]
                        for i, k in enumerate(manifest)}
        except (ValueError, KeyError, OSError, json.JSONDecodeError,
                zipfile.BadZipFile):
            self._quarantine(path)
            return None

    # -------------------------------------------------------- checkpoints
    def put_checkpoint(self, key: str, entries: dict,
                       families: list | None = None) -> None:
        """Persist an in-progress discovery's state under ``key``.

        ``entries`` is the live ``SampleCache`` snapshot (tuple keys ->
        sample arrays) and ``families`` the completed work-item keys, so an
        interrupted ``discover()`` resumes by preloading the rows and — via
        the request-keyed cache — re-probes zero of them.  Written
        atomically under the store lock, same as the sample archive it
        will become.
        """
        manifest = []
        arrays = {}
        for i, (k, arr) in enumerate(entries.items()):
            manifest.append(list(k))
            arrays[f"a{i}"] = np.asarray(arr)
        buf = io.BytesIO()
        np.savez_compressed(buf, manifest=json.dumps(manifest),
                            families=json.dumps([list(f) if isinstance(f, (list, tuple)) else f
                                                 for f in (families or [])]),
                            **arrays)
        with self._lock:
            self._atomic_write(self._ckpt_path(key), buf.getvalue())

    def load_checkpoint(self, key: str) -> tuple[dict, list] | None:
        """``(entries, completed families)`` for ``key``, or None.

        Corrupted checkpoints quarantine and miss — a damaged checkpoint
        degrades to a from-scratch run, never a crash.
        """
        path = self._ckpt_path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as data:
                manifest = json.loads(str(data["manifest"]))
                families = json.loads(str(data["families"]))
                entries = {tuple(k): data[f"a{i}"]
                           for i, k in enumerate(manifest)}
            return entries, [tuple(f) if isinstance(f, list) else f
                             for f in families]
        except (ValueError, KeyError, OSError, json.JSONDecodeError,
                zipfile.BadZipFile):
            self._quarantine(path)
            return None

    def clear_checkpoint(self, key: str) -> None:
        """Drop ``key``'s checkpoint (called after a successful persist)."""
        with self._lock:
            try:
                os.remove(self._ckpt_path(key))
            except FileNotFoundError:
                pass

    def has_checkpoint(self, key: str) -> bool:
        """True while an interrupted discovery's checkpoint exists."""
        return os.path.exists(self._ckpt_path(key))

    # ----------------------------------------------------------------- gc
    def gc(self, *, max_entries: int | None = None,
           max_age_s: float | None = None,
           now: float | None = None) -> dict:
        """Retention sweep: evict oldest entries beyond the given ceilings.

        Ranking is oldest-``created_at``-first (entries without a readable
        timestamp rank oldest, so damaged metadata cannot pin an entry
        forever).  Each eviction removes the topology document and its
        sample archive as one pair; orphaned sample archives (samples whose
        topology is gone — e.g. after a quarantine) are swept as well.
        Checkpoints are deliberately NOT swept as orphans: they exist
        precisely for keys that have no topology yet (an interrupted
        discovery awaiting resume); they are removed by ``delete`` /
        ``clear_checkpoint``.  The
        whole sweep runs under the store's advisory write lock so a
        concurrent discovery cannot interleave a persist with the unlink
        pair.  Returns ``{"evicted": [keys...], "kept": n, "orphans": n}``.
        """
        now = time.time() if now is None else now
        with self._lock:
            aged = sorted(self.index(),
                          key=lambda km: km[1].get("created_at", 0.0))
            evict: list[str] = []
            if max_age_s is not None:
                horizon = now - max_age_s
                evict.extend(k for k, meta in aged
                             if meta.get("created_at", 0.0) < horizon)
            if max_entries is not None and len(aged) - len(evict) > max_entries:
                overflow = len(aged) - len(evict) - max_entries
                remaining = [k for k, _ in aged if k not in set(evict)]
                evict.extend(remaining[:overflow])
            for key in evict:
                self.delete(key)
            # orphaned sample archives: samples/<key>.npz without a topology
            orphans = 0
            live = set(self.keys())
            for f in os.listdir(self._samples_dir):
                if not f.endswith(".npz"):
                    continue
                key = os.path.splitext(f)[0]
                if key not in live:
                    try:
                        os.remove(os.path.join(self._samples_dir, f))
                        orphans += 1
                    except FileNotFoundError:
                        pass
            return {"evicted": evict, "kept": len(live), "orphans": orphans}

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "corrupt": self.corrupt, "entries": len(self.keys())}
