"""Append-only file-segment backend with checkpoint compaction.

The "DB for metadata, files for logs" split: transaction records live in
append-only *segment files* (binary length+crc framed, pickled op lists),
while a small JSON *sidecar index* names the files that constitute the
store — the current checkpoint image plus the ordered segment list. All
record I/O is sequential appends to the active segment; SQLite-style page
management never touches the hot path, which is why ``segment+group``
out-runs ``sqlite+group`` on ``benchmarks/logstore_throughput.py``.

Layout of the store directory::

    index.json            {"format": 1, "filegen": N,
                           "checkpoint": "ckpt-000007.binz" | null,
                           "segments": ["seg-000008.logz", "seg-000009.log"]}
    seg-000009.log        active segment (append + fsync)
    seg-000008.logz       sealed segment (zlib, background sealer thread)
    ckpt-000007.binz      checkpoint image (pickled tables + floors)

Record frame: ``<u32 payload_len, u32 crc32, i64 epoch>`` + payload. A torn
tail frame (killed mid-append) fails the length/crc check and is dropped —
it can only ever be the one in-flight commit whose durability was never
acknowledged. ``epoch >= 0`` tags 2PC prepare records of the global-flush-
epoch protocol (see ``logstore/epoch.py``); records of epochs that never
committed are skipped on open and physically purged by an immediate
compaction, so a reissued epoch id can never resurrect them.

**Checkpoint compaction** (Sec. 3.6 meets write-ahead-lineage truncation):
``compact()`` garbage-collects done events, captures the whole table image
(plus the ssn/ack floors that pin the recovery counters past the truncated
records) into a new checkpoint file, opens a fresh active segment, and
atomically swaps ``index.json`` (write-tmp + fsync + ``os.replace`` +
directory fsync). A crash at ANY point leaves either the complete old index
or the complete new one — never a torn store — because every file the new
index references is fsynced before the swap and old files are deleted only
after it. Recovery then loads the checkpoint image and replays only the
records after it: O(checkpoint interval), not O(pipeline lifetime).
"""
from __future__ import annotations

import json
import os
import pickle
import struct
import threading
import zlib
from typing import List, Optional, Tuple

from repro_torch.core.logstore.base import LineageFilter, TxnAborted
from repro_torch.core.logstore.memory import MemoryLogStore

_FRAME = struct.Struct("<IIq")      # payload_len, crc32(payload), epoch|-1
_INDEX = "index.json"


def _read_frames(fpath: str):
    """Yield (epoch|None, ops) per intact frame of one segment file; a
    torn/corrupt tail frame (killed mid-append) ends the segment."""
    try:
        with open(fpath, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return
    if fpath.endswith(".logz"):
        data = zlib.decompress(data)
    off = 0
    while off + _FRAME.size <= len(data):
        ln, crc, ep = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        if start + ln > len(data):
            break
        payload = data[start:start + ln]
        if zlib.crc32(payload) != crc:
            break
        yield (None if ep < 0 else ep), pickle.loads(payload)
        off = start + ln


def _summarize_lineage(summ: dict, ops):
    """Fold a record's put_lineage rows into a per-sender [min_eid, max_eid]
    segment summary — the sidecar skip index of the lineage reader."""
    for op in ops:
        if op[0] != "put_lineage":
            continue
        eid, sop = op[1], op[2]
        rng = summ.get(sop)
        if rng is None:
            summ[sop] = [eid, eid]
        else:
            if eid < rng[0]:
                rng[0] = eid
            if eid > rng[1]:
                rng[1] = eid


def _fsync_dir(path: str):
    """Make a rename/create in ``path`` durable (no-op where unsupported)."""
    if hasattr(os, "O_DIRECTORY"):
        fd = os.open(path, os.O_DIRECTORY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


class SegmentLogStore(MemoryLogStore):
    """Durable LogBackend over append-only segment files + sidecar index.

    ``path`` is a directory (created on demand). ``segment_bytes`` is the
    rotation threshold for the active segment; sealed segments are zlib-
    compressed when ``compress`` is set. ``checkpoint_interval`` > 0 makes
    ``checkpoint_due()`` fire every that-many appended records — the engine
    supervision loops call ``maybe_checkpoint()``; 0 leaves compaction to
    explicit ``checkpoint()``/``compact()`` calls.
    """

    supports_checkpoint = True

    def __init__(self, path: str, *, segment_bytes: int = 4 * 1024 * 1024,
                 compress: bool = True, checkpoint_interval: int = 0,
                 epoch_coord=None):
        super().__init__(eager_serialize=True)
        self.path = path
        self.segment_bytes = segment_bytes
        self.compress = compress
        self.checkpoint_interval = checkpoint_interval
        self.epoch_coord = epoch_coord
        self.replayed_records = 0
        self.records_since_checkpoint = 0
        self.compactions = 0
        self.rotations = 0
        # test hook: called with a stage label at compaction/rotation
        # control points so crash tests can die at an exact protocol point
        self.test_hook = None
        self._fh = None
        # background sealer: zlib of sealed segments runs OFF the commit
        # path (a 4MB zlib-6 pass inline would stall every committer for
        # tens of ms at each rotation)
        self._gen = 0
        self._seal_q: List[Tuple[str, int]] = []
        self._seal_cv = threading.Condition()
        self._seal_thread: Optional[threading.Thread] = None
        self._closing = False
        self._open()

    # ---- filenames -------------------------------------------------------
    def _next_name(self, prefix: str, suffix: str) -> str:
        self._filegen += 1
        return f"{prefix}-{self._filegen:06d}{suffix}"

    def _fpath(self, name: str) -> str:
        return os.path.join(self.path, name)

    def _hook(self, stage: str):
        if self.test_hook is not None:
            self.test_hook(stage)

    # ---- open / replay ---------------------------------------------------
    def _open(self):
        self._gen += 1          # invalidate queued background seals
        with self._seal_cv:
            self._seal_q.clear()
        os.makedirs(self.path, exist_ok=True)
        ipath = self._fpath(_INDEX)
        if os.path.exists(ipath):
            with open(ipath, "r") as f:
                idx = json.load(f)
        else:
            idx = {"format": 1, "filegen": 0, "checkpoint": None,
                   "segments": []}
        self._filegen = idx["filegen"]
        self._checkpoint_file: Optional[str] = idx["checkpoint"]
        self._segments: List[str] = list(idx["segments"])

        if self._checkpoint_file is not None:
            self._load_checkpoint(self._checkpoint_file)

        self.replayed_records = 0
        dead_epochs = False
        per_seg: dict = {}
        for name in self._segments:
            summ = per_seg.setdefault(name, {})
            for epoch, ops in self._read_segment(name):
                if epoch is not None and self.epoch_coord is not None \
                        and not self.epoch_coord.is_committed(epoch):
                    # 2PC prepare record of an epoch that never committed
                    dead_epochs = True
                    continue
                try:
                    self._validate(ops)
                except TxnAborted:
                    continue
                self._apply_ops(ops)
                _summarize_lineage(summ, ops)
                self.replayed_records += 1
        self.records_since_checkpoint = self.replayed_records

        if self._segments and self._segments[-1].endswith(".log"):
            active = self._segments[-1]
            fresh_index = False
        else:
            active = self._next_name("seg", ".log")
            self._segments.append(active)
            fresh_index = True
        # sidecar lineage summaries: frozen (non-active) segments carry a
        # per-sender event-id range so a reader can skip them wholesale; the
        # active segment keeps accumulating in _active_lin and is always
        # scanned until rotation freezes it
        self._lin_summary = {n: per_seg.get(n, {}) for n in self._segments
                             if n != active}
        self._active_lin = per_seg.get(active, {})
        self._fh = open(self._fpath(active), "ab")
        self._active_size = os.path.getsize(self._fpath(active))
        if fresh_index:
            self._write_index()
        self._clean_orphans()
        if dead_epochs:
            # physically purge the dead prepare records: the coordinator may
            # reissue the same epoch id after a restart, and a later commit
            # of the reissued id must not resurrect these
            self.compact()
        if self.compress:
            # sealed segments whose background compression a crash cut
            # short are plain .log files before the active one — resume
            for name in self._segments[:-1]:
                if name.endswith(".log"):
                    self._enqueue_seal(name)

    def _load_checkpoint(self, name: str):
        with open(self._fpath(name), "rb") as f:
            blob = f.read()
        if name.endswith("z"):
            blob = zlib.decompress(blob)
        img = pickle.loads(blob)
        self.event_log = img["event_log"]
        self.event_data = img["event_data"]
        self.read_actions = img["read_actions"]
        self.state = img["state"]
        self.lineage = img["lineage"]
        self._ssn_floor = img["ssn_floor"]
        self._ack_floor = img["ack_floor"]
        self._reindex()

    def _read_segment(self, name: str):
        """Yield (epoch|None, ops) per intact frame; a torn/corrupt tail
        frame (killed mid-append) ends the segment."""
        yield from _read_frames(self._fpath(name))

    def _clean_orphans(self):
        """Remove segment/checkpoint files the index no longer references —
        leftovers of a crash between file creation and index swap (either
        direction: the swap is the only commit point)."""
        live = set(self._segments)
        if self._checkpoint_file is not None:
            live.add(self._checkpoint_file)
        for name in os.listdir(self.path):
            if name == _INDEX or name in live:
                continue
            if name.startswith(("seg-", "ckpt-", _INDEX + ".")):
                try:
                    os.remove(self._fpath(name))
                except OSError:
                    pass

    # ---- index swap (the atomicity point) --------------------------------
    def _write_index(self):
        idx = {"format": 1, "filegen": self._filegen,
               "checkpoint": self._checkpoint_file,
               "segments": self._segments,
               "lineage_summary": self._lin_summary}
        tmp = self._fpath(_INDEX + ".tmp")
        with open(tmp, "w") as f:
            json.dump(idx, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._fpath(_INDEX))
        _fsync_dir(self.path)

    # ---- append path -----------------------------------------------------
    def _append_record(self, ops, epoch: Optional[int] = None):
        payload = pickle.dumps(ops)
        frame = _FRAME.pack(len(payload), zlib.crc32(payload),
                            -1 if epoch is None else epoch)
        self._fh.write(frame)
        self._fh.write(payload)
        _summarize_lineage(self._active_lin, ops)
        self._active_size += _FRAME.size + len(payload)
        self.bytes_written += _FRAME.size + len(payload)
        self.records_since_checkpoint += 1

    def _sync(self):
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def _commit(self, ops):
        with self.lock:
            self._validate(ops)
            self._apply_ops(ops)
            self._append_record(ops)
            self._sync()                          # durable point
            self._maybe_rotate()
        return None

    def _commit_routed(self, ops):
        """Shard-protocol entry: caller holds ``shard_lock``, already
        validated."""
        self._apply_ops(ops)
        self._append_record(ops)
        self._sync()
        self._maybe_rotate()
        return None

    def apply_many(self, batches: List[List[Tuple]],
                   epoch: Optional[int] = None):
        """One fsync for the whole batch (the group-commit win: sequential
        appends + a single durable point). With ``epoch`` the records are
        2PC prepare records — durable but conditional on the epoch-commit
        record."""
        with self.lock:
            for ops in batches:
                try:
                    self._validate(ops)
                except TxnAborted:
                    continue
                self._apply_ops(ops)
                self._append_record(ops, epoch=epoch)
            self._sync()                          # durable point, once
            self._maybe_rotate()
        return None

    # ---- rotation + background sealed-segment compression ----------------
    def _maybe_rotate(self):
        """Seal the active segment and start a fresh one. The hot path only
        opens the new file and swaps the index; compressing the sealed
        segment happens on the background sealer thread — the index simply
        keeps referencing the plain ``.log`` until the durable ``.logz``
        swap lands (a second index write), so every crash window still
        resolves to a complete store."""
        if self._active_size < self.segment_bytes:
            return
        old = self._segments[-1]
        self._fh.close()
        active = self._next_name("seg", ".log")
        self._segments.append(active)
        self._fh = open(self._fpath(active), "ab")
        self._active_size = 0
        # freeze the sealed segment's lineage summary (an empty dict is
        # meaningful: it proves the segment holds no lineage rows)
        self._lin_summary[old] = self._active_lin
        self._active_lin = {}
        self._hook("rotate:pre_index")
        self._write_index()                       # commit point of rotation
        self.rotations += 1
        if self.compress:
            self._enqueue_seal(old)

    def _enqueue_seal(self, name: str):
        with self._seal_cv:
            self._seal_q.append((name, self._gen))
            if self._seal_thread is None or not self._seal_thread.is_alive():
                self._seal_thread = threading.Thread(
                    target=self._seal_loop, daemon=True, name="seg-sealer")
                self._seal_thread.start()
            self._seal_cv.notify()

    def _seal_loop(self):
        while True:
            with self._seal_cv:
                while not self._seal_q and not self._closing:
                    self._seal_cv.wait()
                if not self._seal_q:
                    return
                name, gen = self._seal_q.pop(0)
            try:
                self._seal_one(name, gen)
            except OSError:
                pass    # store dir vanished under us (tests tearing down)

    def _seal_one(self, name: str, gen: int):
        """Compress one sealed segment and durably swap it into the index.
        zlib runs without any lock; only the swap itself synchronizes with
        committers. A generation or membership mismatch (crash()/reopen or
        a compaction truncated the segment meanwhile) abandons the swap."""
        # level 1: sealed segments are short-lived once checkpointing runs
        # (the next compaction deletes them), and on small machines the
        # sealer shares cores with committers — cheap beats dense here
        with open(self._fpath(name), "rb") as f:
            zdata = zlib.compress(f.read(), 1)
        sealed = name[:-len(".log")] + ".logz"
        tmp = self._fpath(sealed + ".tmp")
        with open(tmp, "wb") as f:
            f.write(zdata)
            f.flush()
            os.fsync(f.fileno())
        with self.lock:
            if gen != self._gen or name not in self._segments:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return
            os.replace(tmp, self._fpath(sealed))
            self._segments[self._segments.index(name)] = sealed
            if name in self._lin_summary:
                self._lin_summary[sealed] = self._lin_summary.pop(name)
            self._write_index()
            try:
                os.remove(self._fpath(name))
            except OSError:
                pass

    def _drain_seals(self, timeout: float = 10.0):
        """Wait for queued background compressions to finish (close path —
        keeps test tmpdirs and shutdowns deterministic)."""
        with self._seal_cv:
            self._closing = True
            self._seal_cv.notify_all()
            t = self._seal_thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._closing = False

    # ---- checkpoint compaction (the truncation watermark) ----------------
    def _advance_floors(self):
        """Pin the per-port recovery counters at their pre-truncation
        maxima, so GC of done rows cannot rewind ``last_sent_ssn`` /
        ``last_acked`` after a restart from the checkpoint."""
        for k, r in self.event_log.items():
            if k[1] is not None:
                key = (k[0], k[1])
                if k[2] > self._ssn_floor.get(key, -1):
                    self._ssn_floor[key] = k[2]
            if k[4] is not None and r["rec_op"] is not None:
                key = (r["rec_op"], r["rec_port"])
                if k[2] > self._ack_floor.get(key, -1):
                    self._ack_floor[key] = k[2]

    def compact(self, keep_rows: Optional[bool] = None):
        """Checkpoint + truncate: GC done events, write the live image as a
        checkpoint file, start a fresh active segment, atomically swap the
        index, and only then delete the truncated files. Kill -9 anywhere
        in here leaves either the old store or the new one — never a torn
        mix — because ``os.replace`` of the index is the single commit
        point and both sides' files are fsynced before it. ``keep_rows``
        overrides the local lineage guard — a sharded stack evaluates it
        globally."""
        with self.lock:
            self._advance_floors()
            self.gc(self.gc_protect, keep_rows=keep_rows)
            img = {"event_log": self.event_log,
                   "event_data": self.event_data,
                   "read_actions": self.read_actions,
                   "state": self.state,
                   "lineage": self.lineage,
                   "ssn_floor": self._ssn_floor,
                   "ack_floor": self._ack_floor}
            blob = pickle.dumps(img)
            if self.compress:
                blob = zlib.compress(blob, 6)
            ckpt = self._next_name("ckpt", ".binz" if self.compress
                                   else ".bin")
            with open(self._fpath(ckpt), "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())

            self._fh.close()
            active = self._next_name("seg", ".log")
            self._fh = open(self._fpath(active), "ab")
            self._active_size = 0

            old_files = list(self._segments)
            if self._checkpoint_file is not None:
                old_files.append(self._checkpoint_file)
            self._checkpoint_file = ckpt
            self._segments = [active]
            # truncated segments' lineage rows now live in the checkpoint
            # image; the summaries die with the files they described
            self._lin_summary = {}
            self._active_lin = {}
            self._hook("compact:pre_swap")
            self._write_index()                   # the atomic swap
            self._hook("compact:post_swap")
            for name in old_files:
                try:
                    os.remove(self._fpath(name))
                except OSError:
                    pass
            self.records_since_checkpoint = 0
            self.compactions += 1

    # LogBackend checkpoint interface
    def checkpoint(self):
        self.compact()

    def checkpoint_due(self) -> bool:
        return self.checkpoint_interval > 0 and \
            self.records_since_checkpoint >= self.checkpoint_interval

    def recovery_replay_count(self) -> int:
        return self.replayed_records

    # ---- disk accounting (the bounded-size acceptance metric) ------------
    def disk_bytes(self) -> int:
        with self.lock:
            total = 0
            for name in os.listdir(self.path):
                try:
                    total += os.path.getsize(self._fpath(name))
                except OSError:
                    pass
            return total

    # ---- crash / close ---------------------------------------------------
    def crash(self):
        """Simulated process crash: every acknowledged commit was fsynced,
        so rebuilding from the files IS the durable image; prepared-but-
        uncommitted epoch records are skipped (and purged) like a real
        restart would."""
        with self.lock:
            try:
                self._fh.close()
            except OSError:
                pass
            self.event_log = {}
            self.event_data = {}
            self.read_actions = {}
            self.state = {}
            self.lineage = []
            self._ssn_floor = {}
            self._ack_floor = {}
            self._reindex()
            self._open()

    def close(self):
        with self.lock:
            if self._fh is not None and not self._fh.closed:
                self._sync()
                self._fh.close()
        self._drain_seals()

    def lineage_reader(self) -> "SegmentLineageReader":
        """Offline lineage scanner over this store's directory (flushes
        first so every committed row is on disk)."""
        with self.lock:
            self._sync()
        return SegmentLineageReader(self.path)


class SegmentLineageReader:
    """Read-only lineage scanner over a SegmentLogStore directory — the
    "audit the log without opening the store" path.

    Answers the filtered lineage-row queries straight from the files: the
    checkpoint image contributes its (already-compacted) lineage list, and
    segments are visited only when their sidecar ``lineage_summary`` entry
    (per-sender [min_eid, max_eid] ranges, frozen at rotation) can overlap
    the filter — a segment with no entry (the active one) is always
    scanned. Within a scanned segment, 2PC epoch tags are matched against
    the filter's ``epoch_min``/``epoch_max`` hints frame by frame.

    The reader sees the durable image only (unflushed commits are
    invisible) and does not consult an epoch coordinator — on a store using
    global flush epochs, quiesce or close the store before auditing.
    ``stats`` exposes the skip/scan counters the pushdown benchmark
    asserts on.
    """

    def __init__(self, path: str):
        self.path = path
        self.stats = {"segments_scanned": 0, "segments_skipped": 0,
                      "frames_scanned": 0, "rows_scanned": 0,
                      "rows_returned": 0}

    def _fpath(self, name: str) -> str:
        return os.path.join(self.path, name)

    def _load_index(self) -> dict:
        with open(self._fpath(_INDEX), "r") as f:
            return json.load(f)

    @staticmethod
    def _skip(summ: Optional[dict], flt: Optional[LineageFilter]) -> bool:
        """True iff the summary proves no row in the segment matches."""
        if summ is None:
            return False            # no summary (active segment): must scan
        if flt is None:
            return not summ         # empty summary == provably no lineage
        for sop, (lo, hi) in summ.items():
            if flt.ops is not None and sop not in flt.ops:
                continue
            if flt.ssn_min is not None and hi < flt.ssn_min:
                continue
            if flt.ssn_max is not None and lo > flt.ssn_max:
                continue
            return False            # this sender's range may overlap
        return True

    def _iter_rows(self, flt: Optional[LineageFilter]):
        """Yield every durable (send_op, send_port, event_id, inset) row a
        matching query must consider; counts scan effort in ``stats``."""
        idx = self._load_index()
        summary = idx.get("lineage_summary", {})
        if idx.get("checkpoint"):
            with open(self._fpath(idx["checkpoint"]), "rb") as f:
                blob = f.read()
            if idx["checkpoint"].endswith("z"):
                blob = zlib.decompress(blob)
            for (eid, so, sp, ins) in pickle.loads(blob)["lineage"]:
                self.stats["rows_scanned"] += 1
                yield so, sp, eid, ins
        for name in idx["segments"]:
            if self._skip(summary.get(name), flt):
                self.stats["segments_skipped"] += 1
                continue
            self.stats["segments_scanned"] += 1
            for epoch, ops in _read_frames(self._fpath(name)):
                if flt is not None and epoch is not None:
                    if flt.epoch_min is not None and epoch < flt.epoch_min:
                        continue
                    if flt.epoch_max is not None and epoch > flt.epoch_max:
                        continue
                self.stats["frames_scanned"] += 1
                for op in ops:
                    if op[0] == "put_lineage":
                        self.stats["rows_scanned"] += 1
                        yield op[2], op[3], op[1], op[4]

    def query_lineage(self, flt: Optional[LineageFilter] = None
                      ) -> List[Tuple]:
        out = sorted((so, sp, eid, ins)
                     for (so, sp, eid, ins) in self._iter_rows(flt)
                     if flt is None or flt.matches(so, sp, eid))
        self.stats["rows_returned"] += len(out)
        return out

    def query_lineage_insets(self, event_key,
                             flt: Optional[LineageFilter] = None
                             ) -> List[str]:
        so, sp, eid = tuple(event_key)
        if flt is not None and not flt.matches(so, sp, eid):
            return []
        key_flt = LineageFilter(ops=frozenset([so]), ssn_min=eid,
                                ssn_max=eid,
                                epoch_min=None if flt is None
                                else flt.epoch_min,
                                epoch_max=None if flt is None
                                else flt.epoch_max)
        out = [ins for (so2, sp2, eid2, ins) in self._iter_rows(key_flt)
               if (so2, sp2, eid2) == (so, sp, eid)]
        self.stats["rows_returned"] += len(out)
        return out

    def query_inset_outputs(self, send_op: str, inset_id: str,
                            flt: Optional[LineageFilter] = None
                            ) -> List[Tuple]:
        base = LineageFilter(ops=frozenset([send_op]))
        out = sorted((so, sp, eid)
                     for (so, sp, eid, ins) in self._iter_rows(base)
                     if so == send_op and ins == inset_id
                     and (flt is None or flt.matches(so, sp, eid)))
        self.stats["rows_returned"] += len(out)
        return out

    def query_stats(self):
        return dict(self.stats)

    def reset_query_stats(self):
        for k in self.stats:
            self.stats[k] = 0
