"""Parameter streaming — paper §3.2: the 'big model' tier (PyTorch port of
``repro.core.streaming``).

The global topic-word matrix φ̂_{W×K} lives in *external storage* (a
memory-mapped file standing in for the paper's HDF5 store); only the rows of
the current batch's vocabulary W_s and a hot-word LRU buffer of ``W*`` rows
are resident.  Because the canonical state is externalised, a crash loses at
most the current minibatch (§3.2).

This module is host code, like the JAX package's: the store is host I/O,
and the device sees only the rows a batch fetches (torch appears only as
the CPU container of bf16 snapshot storage, which numpy lacks).  **The
on-disk format is the JAX store's, byte for byte** (``store.json``
manifest with its crc, ``phi_wk.mmap`` backing file, ``store.wal`` commit
record), so a store that the JAX ``FOEMTrainer`` wrote opens here as it
is, and the other way round.

This slice carries:

* :class:`ParameterStore` — array-backed write-back LRU, vectorized
  ``fetch_rows``/``write_rows``, the WAL-committed crash-consistent
  ``flush`` with its seeded fault points, ``_recover`` on open, and the
  readonly ``attach`` used by serving processes;
* :func:`store_from_arrays` — writes a store straight into the memmap in
  row blocks (a full-width φ̂ never goes through a WAL record);
* :class:`PhiSnapshot` / :class:`SnapshotPublisher` — the lifelong
  train-while-serve publish protocol: immutable, crc-manifested φ
  versions committed by a WAL flush (crcs equal the JAX package's for one
  store state);
* :class:`HotRowCache` — the serving-side read-only hot-word row LRU, with
  per-version epoch invalidation under the publish protocol;
* :class:`StreamPrefetcher` — the training pipeline's background row
  fetch, whose items carry the ``write_version`` they are consistent with
  so the trainer can reconcile them against newer write-backs.
"""
from __future__ import annotations

import dataclasses
import io
import itertools
import json
import os
import struct
import threading
import time
import zlib
from typing import Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime import faults as fault_lib
from repro_torch.sparse.minibatch import prefetch_iterator


class StoreCorruptionError(RuntimeError):
    """The on-disk store state is not recoverable to a consistent version
    (externally corrupted manifest with no valid WAL to rebuild from)."""


_WAL_MAGIC = b"FOEMWAL1"


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync (durability of renames on POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_record(path: str, arrays: dict, meta: dict) -> None:
    """Shadow-write a checksummed record file (fsync'd, NOT renamed —
    the caller owns the atomic-rename commit point)."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    meta_bytes = json.dumps(meta, sort_keys=True).encode()
    body = struct.pack("<II", len(meta_bytes), len(payload)) + meta_bytes + payload
    with open(path, "wb") as f:
        f.write(_WAL_MAGIC)
        f.write(struct.pack("<I", zlib.crc32(body)))
        f.write(body)
        f.flush()
        os.fsync(f.fileno())


def _read_record(path: str) -> Optional[Tuple[dict, dict]]:
    """Read a record written by ``_write_record``; ``None`` when torn or
    corrupt (bad magic / truncated / checksum mismatch)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    hdr = len(_WAL_MAGIC) + 4
    if len(raw) < hdr + 8 or raw[: len(_WAL_MAGIC)] != _WAL_MAGIC:
        return None
    (crc,) = struct.unpack_from("<I", raw, len(_WAL_MAGIC))
    body = raw[hdr:]
    if zlib.crc32(body) != crc:
        return None
    meta_len, payload_len = struct.unpack_from("<II", body, 0)
    if len(body) != 8 + meta_len + payload_len:
        return None
    meta = json.loads(body[8 : 8 + meta_len].decode())
    with np.load(io.BytesIO(body[8 + meta_len :])) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, meta


@dataclasses.dataclass
class StoreStats:
    """I/O accounting of one store."""

    disk_reads: int = 0      # rows read from the backing store
    disk_writes: int = 0     # rows written to the backing store
    buffer_hits: int = 0     # rows served from the hot buffer
    evictions: int = 0
    promotions: int = 0      # rows promoted into the buffer by insert-on-read
    prefetch_hits: int = 0   # minibatches whose rows were already staged
    overlap_seconds: float = 0.0  # host I/O time hidden behind device compute

    def reset(self) -> None:
        self.disk_reads = self.disk_writes = 0
        self.buffer_hits = self.evictions = self.promotions = 0
        self.prefetch_hits = 0
        self.overlap_seconds = 0.0

    def snapshot(self) -> "StoreStats":
        return dataclasses.replace(self)


class ParameterStore:
    """Disk-backed φ̂_{W×K} with a write-back LRU hot-word buffer.

    All row I/O is *vectorized*: a batch's W_s rows move as one
    fancy-indexed gather/scatter against the memmap and one partitioned
    gather against the hot buffer.  The LRU is array-backed — a contiguous
    ``(W*, K)`` row buffer plus id/clock/dirty vectors and a word→slot
    index.  Every public mutator takes ``_lock``, so a background
    prefetcher (``StreamPrefetcher``) can fetch while the trainer writes
    back.  ``write_version`` increments on every value-changing write; a
    fetch tagged with an older version may miss those writes and must be
    reconciled by the caller (see ``fetch_rows_versioned``).

    Row ids within one ``fetch_rows``/``write_rows`` call must be unique.

    Parameters
    ----------
    path:            directory for the backing file + manifest.
    num_topics:      K.
    vocab_capacity:  pre-allocated W capacity (rows of the backing file).
    buffer_rows:     W* — max rows resident in the hot buffer (0 = unbuffered,
                     every access hits the backing store).
    readonly:        attach to an existing store without taking ownership:
                     the memmap opens mode "r", recovery never rewrites disk
                     state (a committed-but-unapplied WAL is overlaid on
                     reads in memory instead of replayed), and every mutator
                     raises.
    """

    MANIFEST = "store.json"
    BACKING = "phi_wk.mmap"
    WAL = "store.wal"

    def __init__(
        self,
        path: str,
        num_topics: int,
        vocab_capacity: int,
        buffer_rows: int = 0,
        dtype=np.float32,
        faults: Optional[fault_lib.FaultPlan] = None,
        readonly: bool = False,
    ):
        self.path = path
        self.K = int(num_topics)
        self.capacity = int(vocab_capacity)
        self.buffer_rows = int(buffer_rows)
        self.dtype = np.dtype(dtype)
        self.live_vocab = 0                      # W high-watermark
        self.phi_k = np.zeros((self.K,), np.float64)  # lint: host-f64 — RAM accumulator
        self.step = 0                            # minibatch cursor (restart point)
        self.stats = StoreStats()
        self.write_version = 0                   # bumps on every write_rows
        self.flush_version = 0                   # bumps on every committed flush
        # rows written since the last take_changed() — the publish delta a
        # SnapshotPublisher turns into per-version cache epoch invalidation
        self._changed = np.zeros((self.capacity,), bool)
        self.faults = faults                     # seeded fault-injection plan
        self.recovered_from_wal = False          # last open replayed a WAL
        self.readonly = bool(readonly)
        # readonly attach: committed-but-unapplied WAL rows, overlaid on
        # fetches in memory (sorted ids + rows) — disk is never touched
        self._overlay: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._lock = threading.RLock()
        # ---- array-backed LRU (empty slots carry id == -1) ----
        W_star = self.buffer_rows
        self._buf = np.zeros((W_star, self.K), self.dtype)
        self._buf_ids = np.full((W_star,), -1, np.int64)
        self._buf_clock = np.zeros((W_star,), np.int64)
        self._buf_dirty = np.zeros((W_star,), bool)
        self._slot_of = np.full((self.capacity,), -1, np.int64)
        self._clock = 0
        backing = os.path.join(path, self.BACKING)
        if self.readonly:
            if not os.path.exists(backing):
                raise FileNotFoundError(
                    f"no store to attach to under {path} (missing "
                    f"{self.BACKING}); readonly attach never creates one"
                )
            self._mm = np.memmap(
                backing, dtype=self.dtype, mode="r",
                shape=(self.capacity, self.K),
            )
            self._arr = np.asarray(self._mm)
            self._attach()
            return
        os.makedirs(path, exist_ok=True)
        mode = "r+" if os.path.exists(backing) else "w+"
        self._mm = np.memmap(
            backing, dtype=self.dtype, mode=mode, shape=(self.capacity, self.K)
        )
        # Plain ndarray view of the same mapping: fancy gathers/scatters on it
        # skip np.memmap.__getitem__'s subclass overhead; durability still
        # goes through self._mm.flush().
        self._arr = np.asarray(self._mm)
        if mode == "r+":
            self._recover()

    # -------------------------------------------------- readonly attach

    @classmethod
    def attach(cls, path: str, num_topics: int, vocab_capacity: int,
               buffer_rows: int = 0, dtype=np.float32) -> "ParameterStore":
        """Open an existing store read-only, without taking ownership: no
        recovery writes, no WAL replay (a committed WAL is overlaid on
        reads in memory), and all mutators raise."""
        return cls(path, num_topics, vocab_capacity,
                   buffer_rows=buffer_rows, dtype=dtype, readonly=True)

    def _attach(self) -> None:
        """Readonly recovery scan: load the manifest, overlay (in memory)
        any committed-but-unapplied WAL — never write a byte to disk."""
        wal = self._wal_path()
        if os.path.exists(wal):
            rec = _read_record(wal)
            if rec is not None:          # committed: newer than the memmap
                arrays, meta = rec
                ids = arrays["ids"].astype(np.int64)
                order = np.argsort(ids)
                self._overlay = (
                    ids[order], arrays["rows"].astype(self.dtype)[order]
                )
                self._apply_manifest(
                    {**meta, "phi_k": arrays["phi_k"].tolist()}
                )
                self.recovered_from_wal = True
                return
        self._load_manifest()

    def _check_writable(self) -> None:
        if self.readonly:
            raise PermissionError(
                "ParameterStore opened readonly (attach): serving "
                "processes never write through the store"
            )

    def _read_backing(self, ids: np.ndarray) -> np.ndarray:
        """Backing-store gather, patched with the readonly WAL overlay."""
        rows = self._arr[ids]
        if self._overlay is not None:
            o_ids, o_rows = self._overlay
            pos = np.searchsorted(o_ids, ids)
            pos = np.minimum(pos, len(o_ids) - 1)
            hit = o_ids[pos] == ids
            if hit.any():
                rows = np.array(rows)          # un-alias the memmap view
                rows[hit] = o_rows[pos[hit]]
        return rows

    # ------------------------------------------------------------------ I/O

    def fetch_rows(
        self, word_ids: np.ndarray, promote: bool = True
    ) -> np.ndarray:
        """Read φ̂ rows for a batch's unique vocabulary — one block I/O.

        Buffer hits are gathered from the hot buffer, misses from the memmap
        with a single fancy-indexed read; missed rows are then *promoted*
        into the buffer (insert-on-read, clean).  ``promote=False`` skips
        that insert: a layered read cache (``HotRowCache``) that already
        retains the miss must not also promote it here.
        """
        return self.fetch_rows_versioned(word_ids, promote=promote)[0]

    def fetch_rows_versioned(
        self, word_ids: np.ndarray, promote: bool = True
    ) -> Tuple[np.ndarray, int]:
        """``fetch_rows`` plus the ``write_version`` the read is consistent
        with — the prefetch pipeline's reconciliation token."""
        with self._lock:
            ids = np.asarray(word_ids, np.int64)
            if len(ids) and int(ids.max()) >= self.capacity:
                raise ValueError(
                    f"word id {int(ids.max())} exceeds store capacity "
                    f"{self.capacity}; grow capacity at construction"
                )
            if self.buffer_rows == 0:
                out = self._read_backing(ids)
                self.stats.disk_reads += len(ids)
                return out, self.write_version
            slots = self._slot_of[ids]
            hit = slots >= 0
            n_hit = int(hit.sum())
            if n_hit == len(ids):                 # warm stream fast path
                out = self._buf[slots]
                self._touch(slots)
                self.stats.buffer_hits += n_hit
                return out, self.write_version
            if n_hit == 0:                        # cold stream fast path
                out = self._read_backing(ids)
                self.stats.disk_reads += len(ids)
                if promote:
                    self.stats.promotions += len(ids)
                    self._insert(ids, out, dirty=False)
                return out, self.write_version
            out = np.empty((len(ids), self.K), self.dtype)
            hit_idx = np.flatnonzero(hit)
            miss_idx = np.flatnonzero(~hit)
            hit_slots = slots[hit_idx]
            out[hit_idx] = self._buf[hit_slots]
            self._touch(hit_slots)
            self.stats.buffer_hits += n_hit
            miss_ids = ids[miss_idx]
            rows = self._read_backing(miss_ids)
            out[miss_idx] = rows
            self.stats.disk_reads += len(miss_ids)
            if promote:
                self.stats.promotions += len(miss_ids)
                self._insert(miss_ids, rows, dirty=False)
            return out, self.write_version

    def write_rows(self, word_ids: np.ndarray, rows: np.ndarray) -> int:
        """Write updated rows back (coalesced) — buffered words stay dirty
        until eviction.  Returns the new ``write_version``."""
        self._check_writable()
        with self._lock:
            ids = np.asarray(word_ids, np.int64)
            rows = np.asarray(rows, self.dtype)
            self._changed[ids] = True
            if self.buffer_rows > 0:
                self._insert(ids, rows, dirty=True)
            else:
                order = np.argsort(ids)           # sorted scatter: sequential I/O
                self._arr[ids[order]] = rows[order]
                self.stats.disk_writes += len(ids)
            self.write_version += 1
            return self.write_version

    # ----------------------------------------------------- LRU internals

    def _touch(self, slots: np.ndarray) -> None:
        """Recency bump: later position in the batch == more recent."""
        n = len(slots)
        if n:
            self._buf_clock[slots] = np.arange(self._clock, self._clock + n)
            self._clock += n

    def _insert(self, ids: np.ndarray, rows: np.ndarray, dirty: bool) -> None:
        """Vectorized buffer insertion with batched LRU eviction, equivalent
        to inserting ``ids`` one by one (in order) into a per-row LRU."""
        W_star = self.buffer_rows
        slots = self._slot_of[ids]
        have = slots >= 0
        n_have = int(have.sum())
        if n_have == len(ids):                    # pure overwrite (write-back)
            self._buf[slots] = rows
            if dirty:
                self._buf_dirty[slots] = True
            self._touch(slots)
            return
        if n_have:
            have_idx = np.flatnonzero(have)
            have_slots = slots[have_idx]
            self._buf[have_slots] = rows[have_idx]
            if dirty:
                self._buf_dirty[have_slots] = True
            # Bump residents now so batched eviction can never pick them.
            self._touch(have_slots)
            new_idx = np.flatnonzero(~have)
            new_ids, new_rows = ids[new_idx], rows[new_idx]
        else:
            new_ids, new_rows = ids, rows
        n_new = len(new_ids)
        if n_new > W_star:
            # The leading n_new - W* fresh rows would be inserted then
            # immediately evicted by the per-row LRU — spill them straight to
            # the store (write back if dirty, count the pass-through evictions).
            head = n_new - W_star
            if dirty:
                order = np.argsort(new_ids[:head])
                self._arr[new_ids[:head][order]] = new_rows[:head][order]
                self.stats.disk_writes += head
            self.stats.evictions += head
            new_ids, new_rows = new_ids[head:], new_rows[head:]
            n_new = W_star
        free = np.flatnonzero(self._buf_ids < 0)
        need = n_new - len(free)
        if need > 0:
            occupied = np.flatnonzero(self._buf_ids >= 0)
            oldest = occupied[
                np.argpartition(self._buf_clock[occupied], need - 1)[:need]
            ]
            self._evict_slots(oldest)
            free = np.concatenate([free, oldest])
        tgt = free[:n_new]
        self._buf[tgt] = new_rows
        self._buf_ids[tgt] = new_ids
        self._buf_dirty[tgt] = dirty
        self._slot_of[new_ids] = tgt
        self._touch(tgt)

    def _evict_slots(self, slots: np.ndarray) -> None:
        """Batched eviction: one sorted scatter writes back the dirty rows."""
        vict_ids = self._buf_ids[slots]
        dirty = self._buf_dirty[slots]
        if dirty.any():
            d_ids = vict_ids[dirty]
            d_slots = slots[dirty]
            order = np.argsort(d_ids)       # sorted scatter, single gather pass
            self._arr[d_ids[order]] = self._buf[d_slots[order]]
            self.stats.disk_writes += len(d_ids)
        self.stats.evictions += len(slots)
        self._slot_of[vict_ids] = -1
        self._buf_ids[slots] = -1
        self._buf_dirty[slots] = False

    # -------------------------------------------------------------- vocab

    def ensure_vocab(self, max_word_id: int) -> None:
        """Watermark growth: the paper's W ← W + 1 on unseen words."""
        if max_word_id >= self.capacity:
            raise ValueError(
                f"word id {max_word_id} exceeds store capacity "
                f"{self.capacity}; grow capacity at construction"
            )
        self.live_vocab = max(self.live_vocab, max_word_id + 1)

    # ---------------------------------------------------------- persistence

    def _fire(self, point: str) -> None:
        if self.faults is not None:
            self.faults.fire(point, step=self.step)

    def flush(self) -> None:
        """Crash-consistent flush: WAL-committed write-back of all dirty
        buffer rows + memmap + manifest.

        Protocol (every on-disk transition is shadow-write → fsync →
        atomic rename, so a kill at ANY point leaves the store
        recoverable to a consistent version — see ``_recover``):

          1. snapshot the dirty rows + scalars into ``store.wal.tmp``
             (checksummed, fsync'd);                       [kill → old version]
          2. rename to ``store.wal`` — the COMMIT point;   [kill → new version]
          3. apply the rows to the memmap and msync;       [kill → new version]
          4. atomically replace the manifest;              [kill → new version]
          5. retire the WAL.

        The seeded fault points: ``mid-flush`` fires between 1 and 2,
        ``pre-publish`` between 3 and 4.
        """
        self._check_writable()
        with self._lock:
            dirty_slots = np.flatnonzero(self._buf_dirty)
            d_ids = self._buf_ids[dirty_slots]
            order = np.argsort(d_ids)
            d_ids = d_ids[order]
            d_rows = self._buf[dirty_slots[order]]
            wal = self._wal_path()
            _write_record(
                wal + ".tmp",
                {"ids": d_ids, "rows": d_rows, "phi_k": self.phi_k},
                self._manifest_payload(version=self.flush_version + 1),
            )
            self._fire(fault_lib.MID_FLUSH)
            os.replace(wal + ".tmp", wal)              # ---- COMMIT ----
            _fsync_dir(self.path)
            if len(d_ids):
                self._arr[d_ids] = d_rows
                self.stats.disk_writes += len(d_ids)
                self._buf_dirty[dirty_slots] = False
            self._mm.flush()
            self._fire(fault_lib.PRE_PUBLISH)
            self.flush_version += 1
            self._save_manifest()
            os.unlink(wal)

    def _manifest_path(self) -> str:
        return os.path.join(self.path, self.MANIFEST)

    def _wal_path(self) -> str:
        return os.path.join(self.path, self.WAL)

    def _manifest_payload(self, version: Optional[int] = None) -> dict:
        return {
            "K": self.K,
            "capacity": self.capacity,
            "live_vocab": self.live_vocab,
            "step": self.step,
            "phi_k": self.phi_k.tolist(),
            "dtype": self.dtype.name,
            "version": self.flush_version if version is None else version,
        }

    def _save_manifest(self) -> None:
        tmp = self._manifest_path() + ".tmp"
        payload = self._manifest_payload()
        payload["crc"] = zlib.crc32(
            json.dumps(payload, sort_keys=True).encode()
        )
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())   # atomic rename
        _fsync_dir(self.path)

    def _apply_manifest(self, payload: dict) -> None:
        assert payload["K"] == self.K, "topic count mismatch on restart"
        self.live_vocab = int(payload["live_vocab"])
        self.step = int(payload["step"])
        self.phi_k = np.asarray(payload["phi_k"], np.float64)  # lint: host-f64
        self.flush_version = int(payload.get("version", 0))

    def _recover(self) -> None:
        """Recovery scan on open: roll the store to its last consistent
        version.

        * stale ``*.tmp`` shadows (a kill before a commit rename) are
          deleted;
        * a valid committed WAL is replayed — rows into the memmap,
          scalars into the manifest — and retired (idempotent);
        * a torn/corrupt WAL means the flush never committed: it is
          discarded and the previous manifest version stands;
        * a corrupt manifest with no WAL to rebuild from raises
          ``StoreCorruptionError``.
        """
        self.recovered_from_wal = False
        for stale in (self._wal_path() + ".tmp",
                      self._manifest_path() + ".tmp"):
            if os.path.exists(stale):
                os.unlink(stale)
        wal = self._wal_path()
        if os.path.exists(wal):
            rec = _read_record(wal)
            if rec is None:                      # torn: never committed
                os.unlink(wal)
            else:
                arrays, meta = rec
                ids = arrays["ids"].astype(np.int64)
                if len(ids):
                    self._arr[ids] = arrays["rows"].astype(self.dtype)
                self._mm.flush()
                self._apply_manifest(
                    {**meta, "phi_k": arrays["phi_k"].tolist()}
                )
                self._save_manifest()
                os.unlink(wal)
                self.recovered_from_wal = True
                return
        self._load_manifest()

    def _load_manifest(self) -> None:
        p = self._manifest_path()
        if not os.path.exists(p):
            return
        try:
            with open(p) as f:
                payload = json.load(f)
            crc = payload.pop("crc", None)
        except (OSError, ValueError) as e:
            raise StoreCorruptionError(
                f"unreadable store manifest {p} and no WAL to rebuild from"
            ) from e
        if crc is not None and crc != zlib.crc32(
            json.dumps(payload, sort_keys=True).encode()
        ):
            raise StoreCorruptionError(
                f"store manifest {p} fails its checksum and no WAL exists"
            )
        self._apply_manifest(payload)

    # ------------------------------------------------------------- helpers

    def stats_window(self, reset: bool = True) -> StoreStats:
        """Snapshot the I/O counters, optionally zeroing them."""
        with self._lock:
            snap = self.stats.snapshot()
            if reset:
                self.stats.reset()
            return snap

    def bump_pipeline_stats(
        self, overlap_seconds: float = 0.0, prefetch_hit: bool = False
    ) -> Tuple[int, int, int]:
        """Credit the prefetch pipeline's counters and return the current
        ``(disk_reads, disk_writes, buffer_hits)`` totals — one locked
        read-modify-read, so a concurrent ``stats_window(reset=True)`` can
        neither lose the bump nor observe a torn triple."""
        with self._lock:
            self.stats.overlap_seconds += overlap_seconds
            if prefetch_hit:
                self.stats.prefetch_hits += 1
            return (
                self.stats.disk_reads,
                self.stats.disk_writes,
                self.stats.buffer_hits,
            )

    def take_changed(self, reset: bool = True) -> np.ndarray:
        """Row ids written since the last take — the delta one φ publish
        covers.  ``SnapshotPublisher.publish`` drains this under the store
        lock, so per-version cache invalidation drops exactly the rows that
        changed instead of the whole cache.  Rows written by
        :func:`store_from_arrays` before the store opened are not in it."""
        with self._lock:
            ids = np.flatnonzero(self._changed)
            if reset:
                self._changed[ids] = False
            return ids

    def dense_phi(self) -> np.ndarray:
        """Materialise the live (W, K) matrix (tests / small corpora only).
        A writable store flushes first."""
        if self.readonly:
            n = max(self.live_vocab, 1)
            return np.asarray(self._read_backing(np.arange(n)))
        self.flush()
        return np.asarray(self._mm[: max(self.live_vocab, 1)])

    def resident_rows(self) -> int:
        return int((self._buf_ids >= 0).sum())


def store_from_arrays(
    path: str,
    phi_wk,
    phi_k: Optional[np.ndarray] = None,
    *,
    live_vocab: int,
    step: int = 0,
    vocab_capacity: Optional[int] = None,
) -> ParameterStore:
    """Write a committed store at ``path`` from host arrays.

    ``phi_wk`` is a (W, K) array, an iterable of consecutive (n, K) row
    blocks (then ``vocab_capacity`` gives W), or a ``GlobalStats`` whose
    fields are numpy arrays — the JAX package's whole-vocabulary training
    state, carried into the port: its ``phi_wk`` rows, its ``phi_k`` totals
    and its ``step`` counter (which then override ``phi_k`` and
    ``step``).  The rows go straight into
    the memmap, one block at a time, followed by an msync and one committed
    flush that carries only the manifest: a full-width φ̂ (5.6 GB at
    W = 141,043, K = 10⁴) never passes through a WAL record or exists as
    one host array.  ``phi_k`` defaults to the float64 column sums of the
    rows written.  The path must not hold a store yet.
    """
    if os.path.exists(os.path.join(path, ParameterStore.BACKING)):
        raise FileExistsError(f"a store already exists under {path}")
    if type(phi_wk).__name__ == "GlobalStats":
        stats = phi_wk
        phi_wk = np.asarray(stats.phi_wk, np.float32)
        phi_k = np.asarray(stats.phi_k, np.float64)  # lint: host-f64
        step = int(np.asarray(stats.step))
    if isinstance(phi_wk, np.ndarray):
        if vocab_capacity is None:
            vocab_capacity = phi_wk.shape[0]
        blocks = iter([phi_wk])
    elif vocab_capacity is None:
        raise ValueError("vocab_capacity is required for row blocks")
    else:
        blocks = iter(phi_wk)
    first = next(blocks)
    K = first.shape[1]
    store = ParameterStore(path, num_topics=K, vocab_capacity=vocab_capacity)
    sums = np.zeros((K,), np.float64)  # lint: host-f64 — RAM accumulator
    lo = 0
    for block in itertools.chain([first], blocks):
        hi = lo + block.shape[0]
        if hi > vocab_capacity:
            raise ValueError(
                f"row blocks exceed vocab_capacity {vocab_capacity}")
        store._arr[lo:hi] = block
        sums += block.sum(0, dtype=np.float64)  # lint: host-f64
        lo = hi
    store._mm.flush()
    store.phi_k[:] = sums if phi_k is None else np.asarray(phi_k, np.float64)  # lint: host-f64
    store.live_vocab = int(live_vocab)
    store.step = int(step)
    store.flush()
    return store


# ---------------------------------------------------------------------------
# Versioned φ snapshots — the lifelong train-while-serve publish protocol
# ---------------------------------------------------------------------------

#: Rows a block of :func:`_host_quantize_rows`: one pass over a whole
#: (capacity, K) φ at the stream_1k width would make several 5.64 GB
#: temporaries on the host.
QUANT_BLOCK_ROWS = 4096


def _host_quantize_rows(phi: np.ndarray, phi_dtype: Optional[str]):
    """Host-side serving storage of a snapshot's φ: ``(values, scale)``.

    * ``"float32"`` (or None): ``phi`` itself, no scale;
    * ``"bfloat16"``: a CPU ``torch.bfloat16`` tensor, rounded to nearest
      even (the bits of ``ml_dtypes.bfloat16``); numpy has no bf16, and the
      JAX package's quiet float32 fallback without ``ml_dtypes`` is not
      copied — bf16 storage is always bf16;
    * ``"int8"``: symmetric per-row int8 with ``scale_w = max_k |φ_w(k)| /
      127`` (1.0 for all-zero rows), the JAX function's float32 arithmetic
      element for element (``np.round`` rounds half to even), so the
      values and scales are bitwise the JAX package's.

    Both quantized forms are computed ``QUANT_BLOCK_ROWS`` rows at a time.
    """
    if phi_dtype in (None, "float32"):
        return phi, None
    n = phi.shape[0]
    blocks = [(lo, min(lo + QUANT_BLOCK_ROWS, n))
              for lo in range(0, n, QUANT_BLOCK_ROWS)]
    if phi_dtype == "bfloat16":
        out = torch.empty(phi.shape, dtype=torch.bfloat16)
        for lo, hi in blocks:
            out[lo:hi] = torch.from_numpy(np.array(phi[lo:hi], np.float32))
        return out, None
    if phi_dtype == "int8":
        q = np.empty(phi.shape, np.int8)
        scale = np.empty((n,), np.float32)
        for lo, hi in blocks:
            blk = phi[lo:hi]
            amax = np.abs(blk).max(axis=-1)
            s = np.where(amax > 0, amax / np.float32(127.0),
                         np.float32(1.0)).astype(np.float32)
            q[lo:hi] = np.clip(np.round(blk / s[:, None]), -127, 127)
            scale[lo:hi] = s
        return q, scale
    raise ValueError(
        f"unknown phi_dtype {phi_dtype!r}; expected float32/bfloat16/int8"
    )


class PhiSnapshot:
    """One immutable, crc-manifested φ version — the publish unit of the
    lifelong train-while-serve protocol.

    A snapshot owns read-only copies of the full (capacity, K) φ̂ block and
    the (K,) topic totals as of one committed flush, stamped with the
    publish ``version`` (the subscriber-facing epoch), the store's
    ``write_version``/``flush_version`` it captured, and the row ids the
    publish changed (``changed_ids`` — what per-version cache invalidation
    drops).  ``crc`` is computed over the copied bytes at publish (φ, then
    φ(k), then the ``version:step:write_version`` header — the JAX
    package's manifest, so one store state gives one crc in both);
    ``verify()`` recomputes it, so a reader holding a torn or mutated φ
    fails loudly instead of serving garbage.

    Readers *pin* a version by holding the reference: nothing the trainer
    does after publish can change these arrays, so an in-flight request
    batch is consistent end to end.  ``quantize`` memoizes the bf16/int8
    serving storage per dtype — built once per version at hot-swap time,
    shared by every later launch on this version.
    """

    def __init__(self, *, version: int, phi: np.ndarray, phi_k: np.ndarray,
                 step: int, live_vocab: int, write_version: int,
                 flush_version: int, changed_ids: np.ndarray):
        phi = np.ascontiguousarray(phi)
        phi.setflags(write=False)
        phi_k = np.ascontiguousarray(phi_k)
        phi_k.setflags(write=False)
        changed_ids = np.ascontiguousarray(np.asarray(changed_ids, np.int64))
        changed_ids.setflags(write=False)
        self.version = int(version)
        self.phi = phi                 # (capacity, K) read-only
        self.phi_k = phi_k             # (K,) read-only
        self.step = int(step)
        self.live_vocab = int(live_vocab)
        self.write_version = int(write_version)
        self.flush_version = int(flush_version)
        self.changed_ids = changed_ids
        self.crc = self._crc()
        self._quant: dict = {}
        self._quant_lock = threading.Lock()

    @property
    def K(self) -> int:
        return self.phi.shape[1]

    def _crc(self) -> int:
        crc = zlib.crc32(self.phi)
        crc = zlib.crc32(self.phi_k, crc)
        header = f"{self.version}:{self.step}:{self.write_version}".encode()
        return zlib.crc32(header, crc)

    def verify(self) -> bool:
        """Recompute the manifest crc — a torn/mutated φ fails here."""
        return self._crc() == self.crc

    def fetch_rows(self, word_ids: np.ndarray) -> np.ndarray:
        """Gather (len(ids), K) f32 rows — always from THIS version."""
        return np.asarray(
            self.phi[np.asarray(word_ids, np.int64)], np.float32
        )

    def quantize(self, phi_dtype: Optional[str]):
        """Memoized ``(values, scale)`` serving storage of this version
        (:func:`_host_quantize_rows`; thread-safe: the first caller
        builds, everyone else shares)."""
        key = phi_dtype or "float32"
        with self._quant_lock:
            got = self._quant.get(key)
            if got is None:
                got = _host_quantize_rows(self.phi, key)
                self._quant[key] = got
            return got


class SnapshotPublisher:
    """Versioned φ publish/subscribe over a :class:`ParameterStore`.

    ``publish()`` is the trainer-side commit: under the store lock it
    drives the WAL-committed ``ParameterStore.flush()`` (the durable commit
    point — a crash mid-publish recovers to a consistent version), captures
    an immutable :class:`PhiSnapshot` of the post-flush state (a copy of
    the whole backing block and its crc, all under the lock), drains the
    store's changed-row delta, and stamps the next monotonically increasing
    snapshot version.  The last ``retain`` versions stay referenced so
    readers pinned to an older epoch finish their in-flight batches before
    the arrays are dropped; the staleness of any launch is therefore ≤
    ``retain`` versions by construction.

    Readers never block writers: ``latest()`` is one lock-protected list
    read, ``wait_for(version)`` parks on a condition until the trainer
    catches up.  ``publish_log`` keeps one ``{version, step, changed_rows,
    seconds}`` record per publish.
    """

    def __init__(self, store: ParameterStore, retain: int = 2):
        if retain < 1:
            raise ValueError("retain must be >= 1")
        self.store = store
        self.retain = int(retain)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._snaps: List[PhiSnapshot] = []
        self.version = 0                  # last published version (0 = none)
        self.publish_log: List[dict] = []

    def publish(self) -> PhiSnapshot:
        """Commit the current φ (WAL flush) and publish it as a snapshot."""
        t0 = time.perf_counter()
        with self._cond:                      # serialize publishers
            with self.store._lock:            # atomic wrt trainer writes
                self.store.flush()            # ---- the COMMIT point ----
                snap = PhiSnapshot(
                    version=self.version + 1,
                    phi=self.store._arr.copy(),
                    phi_k=self.store.phi_k.copy(),
                    step=self.store.step,
                    live_vocab=self.store.live_vocab,
                    write_version=self.store.write_version,
                    flush_version=self.store.flush_version,
                    changed_ids=self.store.take_changed(reset=True),
                )
            self.version = snap.version
            self._snaps.append(snap)
            del self._snaps[: -self.retain]
            self.publish_log.append({
                "version": snap.version,
                "step": snap.step,
                "changed_rows": int(len(snap.changed_ids)),
                "seconds": time.perf_counter() - t0,
            })
            self._cond.notify_all()
        return snap

    def latest(self) -> Optional[PhiSnapshot]:
        with self._lock:
            return self._snaps[-1] if self._snaps else None

    def get(self, version: int) -> Optional[PhiSnapshot]:
        """A still-retained snapshot by version (None once aged out)."""
        with self._lock:
            for snap in self._snaps:
                if snap.version == version:
                    return snap
            return None

    def wait_for(self, version: int,
                 timeout: Optional[float] = None) -> Optional[PhiSnapshot]:
        """Block until ``version`` (or newer) is published; None on timeout."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self.version >= version, timeout=timeout
            )
            return self._snaps[-1] if ok else None


# ---------------------------------------------------------------------------
# Serving-side hot-word row cache — read-only LRU above the store
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    """Hit/miss accounting for one :class:`HotRowCache` window."""

    hits: int = 0            # rows served from the cache
    misses: int = 0          # rows fetched through the store
    invalidations: int = 0   # epoch installs / whole-cache drops
    rows_dropped: int = 0    # resident rows evicted by invalidation

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class HotRowCache:
    """Read-only hot-word φ̂-row LRU layered over a :class:`ParameterStore`.

    Serving traffic is Zipf-skewed: a few hundred head words dominate every
    request batch.  This cache keeps those rows in a serving-owned,
    read-only buffer:

    * misses fall through with ``store.fetch_rows(..., promote=False)`` so
      a serving miss is cached exactly once (here);
    * an unpinned cache invalidates whole when ``store.write_version``
      moves — the frozen-φ serving contract means version changes are rare;
    * under the lifelong publish protocol the server instead calls
      ``install_version(v, changed_ids)`` at each hot-swap: only the rows
      the publish changed are dropped (per-version *epoch* invalidation),
      so the Zipf head survives a publish; fetches then pass the pinned
      epoch and the snapshot source, so a straggler launch on an older
      version bypasses the cache instead of mixing epochs;
    * hit/miss counters are windowed (``window_stats``).

    Rows within one ``fetch`` must be unique.
    """

    def __init__(self, store: ParameterStore, capacity: int):
        self.store = store
        self.capacity = int(capacity)
        self.K = store.K
        self._version = store.write_version
        self._lock = threading.Lock()
        self._buf = np.zeros((self.capacity, self.K), store.dtype)
        self._ids = np.full((self.capacity,), -1, np.int64)
        self._clock_v = np.zeros((self.capacity,), np.int64)
        self._slot_of = np.full((store.capacity,), -1, np.int64)
        self._clock = 0
        self._pinned = False             # True once install_version() ran
        self.stats = CacheStats()        # cumulative
        self._window = CacheStats()      # since last window_stats(reset=True)

    def _count(self, hits: int = 0, misses: int = 0, inval: int = 0,
               rows_dropped: int = 0) -> None:
        for s in (self.stats, self._window):
            s.hits += hits
            s.misses += misses
            s.invalidations += inval
            s.rows_dropped += rows_dropped

    def _invalidate(self) -> None:
        dropped = int((self._ids >= 0).sum())
        self._ids.fill(-1)
        self._slot_of.fill(-1)
        self._count(inval=1, rows_dropped=dropped)

    def install_version(self, version: int,
                        changed_ids: Optional[np.ndarray] = None) -> int:
        """Pin the cache to a published φ epoch, dropping only the rows the
        publish changed (``changed_ids=None`` drops everything).  Returns
        the number of rows dropped.  After the first call the cache stops
        invalidating on raw ``store.write_version`` movement — the publish
        protocol owns epoch transitions."""
        with self._lock:
            if changed_ids is None:
                dropped = int((self._ids >= 0).sum())
                self._ids.fill(-1)
                self._slot_of.fill(-1)
            else:
                ids = np.asarray(changed_ids, np.int64)
                ids = ids[ids < len(self._slot_of)]
                slots = self._slot_of[ids]
                res = slots >= 0
                dropped = int(res.sum())
                if dropped:
                    s = slots[res]
                    self._slot_of[self._ids[s]] = -1
                    self._ids[s] = -1
            self._pinned = True
            self._version = int(version)
            self._count(inval=1, rows_dropped=dropped)
            return dropped

    def fetch(self, word_ids: np.ndarray, source=None,
              version: Optional[int] = None) -> np.ndarray:
        """Gather φ̂ rows for a request batch's unique vocabulary.

        ``source`` (anything with ``fetch_rows(ids) -> (n, K) f32``, e.g. a
        pinned snapshot view) replaces the store as the miss path;
        ``version`` is the caller's pinned epoch — if it differs from the
        cache's installed epoch the fetch bypasses the cache entirely (a
        straggler on an old version must not pollute the new epoch, and
        must not read rows cached from it)."""
        ids = np.asarray(word_ids, np.int64)
        if source is not None:
            fill = source.fetch_rows
        else:
            def fill(miss):
                return self.store.fetch_rows(miss, promote=False)
        if self.capacity == 0:
            with self._lock:
                self._count(misses=len(ids))
            return fill(ids)
        with self._lock:
            if version is not None and int(version) != self._version:
                self._count(misses=len(ids))
                return fill(ids)
            if not self._pinned and self.store.write_version != self._version:
                self._invalidate()
                self._version = self.store.write_version
            slots = self._slot_of[ids]
            hit = slots >= 0
            n_hit = int(hit.sum())
            if n_hit == len(ids):                 # head-word fast path
                out = self._buf[slots]
                self._touch(slots)
                self._count(hits=n_hit)
                return out
            miss_idx = np.flatnonzero(~hit)
            miss_ids = ids[miss_idx]
            rows = fill(miss_ids)
            if n_hit == 0:
                out = rows
            else:
                out = np.empty((len(ids), self.K), self._buf.dtype)
                hit_idx = np.flatnonzero(hit)
                hit_slots = slots[hit_idx]
                out[hit_idx] = self._buf[hit_slots]
                self._touch(hit_slots)
                out[miss_idx] = rows
            self._count(hits=n_hit, misses=len(miss_ids))
            self._insert(miss_ids, rows)
            return out

    def _touch(self, slots: np.ndarray) -> None:
        n = len(slots)
        if n:
            self._clock_v[slots] = np.arange(self._clock, self._clock + n)
            self._clock += n

    def _insert(self, ids: np.ndarray, rows: np.ndarray) -> None:
        n_new = len(ids)
        if n_new > self.capacity:                 # keep the batch's tail
            ids, rows = ids[-self.capacity:], rows[-self.capacity:]
            n_new = self.capacity
        if n_new == 0:
            return
        free = np.flatnonzero(self._ids < 0)
        need = n_new - len(free)
        if need > 0:
            occupied = np.flatnonzero(self._ids >= 0)
            oldest = occupied[
                np.argpartition(self._clock_v[occupied], need - 1)[:need]
            ]
            self._slot_of[self._ids[oldest]] = -1
            self._ids[oldest] = -1
            free = np.concatenate([free, oldest])
        tgt = free[:n_new]
        self._buf[tgt] = rows
        self._ids[tgt] = ids
        self._slot_of[ids] = tgt
        self._touch(tgt)

    def resident_rows(self) -> int:
        return int((self._ids >= 0).sum())

    def reset_stats(self) -> None:
        """Zero both counters under the lock (prewarm discards warm-up
        traffic without racing a concurrent launcher fetch)."""
        with self._lock:
            self.stats = CacheStats()
            self._window = CacheStats()

    def window_stats(self, reset: bool = True) -> CacheStats:
        """Hit/miss counters since the last window."""
        with self._lock:
            snap = dataclasses.replace(self._window)
            if reset:
                self._window = CacheStats()
            return snap


# ---------------------------------------------------------------------------
# Asynchronous prefetch — double-buffered fetch stage of the training pipeline
# ---------------------------------------------------------------------------


class PrefetchedBatch(NamedTuple):
    """A minibatch staged by the worker: its φ̂ rows, the store version the
    fetch is consistent with, and how long the host I/O took."""

    minibatch: object            # sparse.minibatch.Minibatch
    phi_rows: np.ndarray         # (W_s, K)
    version: int                 # store.write_version at fetch time
    fetch_seconds: float


class StreamPrefetcher:
    """Background fetch of upcoming minibatches' φ̂ rows (double buffering).

    A worker thread (``sparse.minibatch.prefetch_iterator``) drains
    ``stream`` — so bucketization and ``localize_vocab`` also run off the
    critical path — fetches each minibatch's rows, and stages
    ``PrefetchedBatch`` items in a bounded queue.  With ``depth=1`` the
    worker is fetching minibatch s+1 while the consumer computes on
    minibatch s.

    Because a staged fetch may predate the consumer's most recent
    ``write_rows``, each item carries the store ``write_version`` it saw;
    the consumer patches rows overlapping any newer write-back (the trainer
    keeps the last few write sets) — that reconciliation is what makes
    prefetched and sequential execution bitwise-identical.
    """

    def __init__(self, store: ParameterStore, stream: Iterable,
                 depth: int = 1):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")

        def staged() -> Iterator[PrefetchedBatch]:
            for mb in stream:
                t0 = time.perf_counter()
                rows, version = store.fetch_rows_versioned(mb.local_vocab)
                yield PrefetchedBatch(
                    mb, rows, version, time.perf_counter() - t0
                )

        self._inner = prefetch_iterator(staged(), depth=depth)

    def __iter__(self) -> Iterator[Tuple[PrefetchedBatch, float]]:
        """Yields ``(staged_batch, wait_seconds)`` — wait_seconds is how long
        the consumer blocked on the queue (≈0 ⇒ the fetch fully overlapped)."""
        while True:
            t0 = time.perf_counter()
            try:
                item = next(self._inner)
            except StopIteration:
                return
            yield item, time.perf_counter() - t0

    def close(self) -> None:
        """Stop the worker and release the source (safe to call repeatedly)."""
        self._inner.close()
