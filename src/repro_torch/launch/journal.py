"""Durable chunk journal + decode integrity sentinel.

The counterpart of ``repro.launch.journal``, byte for byte in what it
writes, so a journal written by either package recovers under the other.

* :class:`ChunkJournal` — an append-only write-ahead log of everything the
  service admitted but has not yet durably handed to the client, plus
  atomic checkpoints of per-stream session state. PBVD blocks decode
  identically whatever the batch, so re-feeding the journaled chunks into
  restored sessions reproduces the uninterrupted run's bits exactly; only
  the small session snapshot (overlap tail + puncture phase + counters)
  needs to persist.

  Record format: ``[u32 length][u32 crc32][pickle payload]`` per record,
  payload ``(seq, kind, *fields)`` with a journal-global monotone ``seq``.
  A SIGKILL can land mid-``write()``; recovery tolerates the torn tail by
  stopping at the first incomplete or checksum-failing record. Payloads
  hold only numpy arrays, ints and strings, never a tensor.

  Checkpoints are written tmp → fsync → ``os.replace`` (atomic on POSIX)
  and carry ``last_seq``; recovery skips every record with
  ``seq <= last_seq``, so a crash between the rename and the log
  truncation cannot double-apply records.

* :class:`IntegritySentinel` — the end-to-end screen against silent data
  corruption: re-encode each delivered block with the stream's code
  (:func:`repro_torch.core.encoder.encode_np` from the tracked encoder
  state) and compare the re-encoded symbols with the sign of the received
  soft symbols. The ML path agrees with the channel on all but the
  channel-noise fraction of symbols; a post-decode bit flip changes up to
  (v+1)·R re-encoded symbols at once, so an agreement fraction below
  ``min_agreement`` flags corruption rather than noise. Punctured slots
  (exact 0.0) and the zero-padded flush tail are excluded.

A journal serves engines of one process: :func:`check_journal_engine`
refuses an engine whose mesh spans processes.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib

import numpy as np

from repro_torch.core.encoder import encode_np
from repro_torch.launch.faults import IntegrityError

__all__ = ["ChunkJournal", "IntegritySentinel", "check_journal_engine"]

_HDR = struct.Struct("<II")  # (payload length, crc32 of payload)

# journal record kinds (the full vocabulary):
#   ("open",   sid)                — stream sid admitted to the service
#   ("admit",  sid, chunk)         — chunk buffered into sid's session
#   ("ack",    sid, acked_bits)    — client durably holds sid's first N bits
#   ("commit", dispatches)         — a coalesced dispatch completed
#   ("finish", sid)                — sid flushed + fully delivered
#   ("fail",   sid, message)       — sid quarantined (replay drops it)


def check_journal_engine(engine) -> None:
    """Refuse, with ``ValueError``, to journal the streams of an engine whose
    mesh spans processes. Recovery rebuilds a crashed process's streams in a
    fresh process from its journal; a fleet that loses a rank loses its
    whole process group, so no rank could recover into it."""
    mesh = getattr(engine, "mesh", None)
    if mesh is not None and mesh.spans_processes:
        raise ValueError(
            f"ChunkJournal: the engine's mesh spans {mesh.process_count} processes; a "
            f"journal recovers a crashed process into a fresh one, but a lost rank ends "
            f"the whole process group, so there is no fleet to recover into"
        )


class ChunkJournal:
    """Append-only WAL + checkpoint pair under one directory.

    Parameters
    ----------
    path: directory holding ``journal.log`` and ``checkpoint.bin`` (created
        if missing).
    fsync: fsync the log after every append.  Default False: a ``flush()``
        hands the bytes to the OS, which survives SIGKILL / process death
        (the crash model of this layer); fsync additionally survives kernel
        panics and power loss at a per-record latency cost.
    """

    def __init__(self, path: str, *, fsync: bool = False):
        self.dir = str(path)
        os.makedirs(self.dir, exist_ok=True)
        self.log_path = os.path.join(self.dir, "journal.log")
        self.ckpt_path = os.path.join(self.dir, "checkpoint.bin")
        self._fsync = bool(fsync)
        self._f = open(self.log_path, "ab")
        ckpt = self.load_checkpoint()
        recs = self.records()
        # seq continues past everything durably recorded so far, whether it
        # lives in the log or was folded into the checkpoint
        self._seq = max(
            ckpt["last_seq"] if ckpt is not None else 0,
            recs[-1][0] if recs else 0,
        )

    # ---- appending -----------------------------------------------------------------
    @property
    def seq(self) -> int:
        """Sequence number of the most recently appended record."""
        return self._seq

    def append(self, kind: str, *fields) -> int:
        """Durably append one record; returns its sequence number.

        Header + payload go down in a single ``write()`` so a torn record
        can only be a truncated tail, never an interleaving.
        """
        self._seq += 1
        payload = pickle.dumps((self._seq, kind, *fields), protocol=4)
        self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)) + payload)
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())
        return self._seq

    # ---- reading -------------------------------------------------------------------
    def records(self) -> list[tuple]:
        """Every intact record in the log, in append order.

        Torn-tail tolerant: scanning stops at the first incomplete,
        checksum-failing, or unpicklable record — the crash frontier.  The
        records before it were flushed earlier and are intact.
        """
        try:
            with open(self.log_path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return []
        out, off = [], 0
        while off + _HDR.size <= len(data):
            n, crc = _HDR.unpack_from(data, off)
            lo = off + _HDR.size
            if lo + n > len(data):
                break  # torn tail: the record's bytes never fully landed
            payload = data[lo : lo + n]
            if zlib.crc32(payload) != crc:
                break  # corrupt record: nothing after it is trustworthy
            try:
                rec = pickle.loads(payload)
            except Exception:  # noqa: BLE001 - a passing crc makes this ~unreachable
                break
            out.append(rec)
            off = lo + n
        return out

    def load_checkpoint(self) -> dict | None:
        """The latest checkpoint state, or None (absent or unreadable).

        The checkpoint is fsync'd before its atomic rename, so "unreadable"
        means pre-rename garbage was never promoted — treat it as absent.
        """
        try:
            with open(self.ckpt_path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None
        if len(data) < _HDR.size:
            return None
        n, crc = _HDR.unpack_from(data, 0)
        payload = data[_HDR.size : _HDR.size + n]
        if len(payload) != n or zlib.crc32(payload) != crc:
            return None
        try:
            return pickle.loads(payload)
        except Exception:  # noqa: BLE001
            return None

    def load(self) -> tuple[dict | None, list[tuple]]:
        """(checkpoint state, unapplied records) — the recovery inputs.

        Records already folded into the checkpoint (``seq <= last_seq``)
        are filtered out, which is what makes the checkpoint-rename /
        log-truncate pair crash-safe in either order.
        """
        ckpt = self.load_checkpoint()
        last = ckpt["last_seq"] if ckpt is not None else 0
        return ckpt, [r for r in self.records() if r[0] > last]

    # ---- checkpointing -------------------------------------------------------------
    def write_checkpoint(self, state: dict) -> None:
        """Atomically persist ``state`` and truncate the superseded log.

        ``last_seq`` is stamped into the state; every record in the log at
        this moment is ≤ it (appends and checkpoints are issued from the
        same event loop), so the whole log is superseded and truncates.
        """
        state = dict(state)
        state["last_seq"] = self._seq
        payload = pickle.dumps(state, protocol=4)
        tmp = self.ckpt_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_HDR.pack(len(payload), zlib.crc32(payload)) + payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.ckpt_path)
        self._f.truncate(0)

    def close(self) -> None:
        self._f.close()


class IntegritySentinel:
    """Sampled re-encode screen over delivered blocks (module docstring).

    ``rate`` is the sampling knob: 1.0 checks every delivery, 0.02 checks
    ~2% of them (i.i.d. from a seeded rng, so a schedule is reproducible
    for a fixed consultation order) — the check is O(block) numpy work on
    the host, so sampling makes it cost ~0 at full load.
    """

    def __init__(
        self,
        *,
        rate: float = 1.0,
        min_agreement: float = 0.85,
        seed: int = 0,
    ):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        if not 0.0 < min_agreement <= 1.0:
            raise ValueError(
                f"min_agreement must be in (0, 1], got {min_agreement}"
            )
        self.rate = float(rate)
        self.min_agreement = float(min_agreement)
        self._rng = np.random.default_rng([int(seed), len("sentinel")])
        self.checked = 0
        self.flagged = 0

    def sample(self) -> bool:
        """Should this delivery be checked? (consumes one rng draw iff 0<rate<1)"""
        if self.rate >= 1.0:
            return True
        if self.rate <= 0.0:
            return False
        return bool(self._rng.random() < self.rate)

    def check(self, bits, window, code, init_state: int, *, stream=None):
        """Screen ``bits`` (delivered payload) against ``window`` (the soft
        symbols those stages decoded from, first stage aligned with
        ``bits[0]``); returns an :class:`IntegrityError` or None.

        ``init_state`` is the encoder state at ``bits[0]`` (the last ``v``
        previously delivered bits — see :func:`repro_torch.core.encoder
        .encoder_state`).  Symbols that are exactly 0.0 (punctured erasure
        slots, zero-padded tail stages) carry no channel evidence and are
        excluded; a window shorter than ``bits`` (flush past the buffered
        tail) is implicitly all-excluded padding.
        """
        bits = np.asarray(bits)
        self.checked += 1
        if bits.size == 0:
            return None
        w = np.asarray(window, np.float32)[: len(bits)]
        coded = encode_np(bits, code, init_state)[: len(w)]
        sgn = (1 - 2 * coded).astype(np.float32)  # bit 0 → +1 (BPSK map)
        mask = w != 0.0
        n = int(mask.sum())
        if n == 0:
            return None
        agreement = float(np.mean((w * sgn)[mask] > 0.0))
        if agreement >= self.min_agreement:
            return None
        self.flagged += 1
        return IntegrityError(
            f"integrity sentinel: re-encoded block agrees with received "
            f"hard decisions on {agreement:.3f} of {n} symbols, below the "
            f"bound {self.min_agreement} — delivered bits are suspected "
            f"corrupt (not channel noise)",
            stream=stream,
            agreement=agreement,
            bound=self.min_agreement,
        )
