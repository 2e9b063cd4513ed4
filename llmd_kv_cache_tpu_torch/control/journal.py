"""Append-only, checksummed action journal (the recovery journal's framing).

Every controller decision is journaled *before* the actuator runs and
again after it settles, so a controller restart can tell three cases
apart:

- ``executed``/``failed`` after ``planned`` — the action settled; replay
  only restores its cooldown/budget accounting.
- ``planned`` with no settlement — the controller died mid-action. The
  action is **in flight**: the successor re-verifies it against observed
  topology instead of repeating it blindly, and the restored cooldown
  prevents an immediate reversal.
- ``would_act`` — dry-run mode; replay restores the record history only.

Record framing is exactly the event journal's (``recovery/journal.py``)::

    +-----------+-----------+------------------------------+
    | u32 length| u32 crc32 | canonical CBOR               |
    | (of body) | (of body) | {action_id, seq, ts, phase,  |
    |           |           |  kind, target, params,       |
    |           |           |  reason, signal, result}     |
    +-----------+-----------+------------------------------+

Appends flush per record and fsync every ``sync_every`` records; a torn
tail (crash mid-append) stops replay cleanly at the last good record.

Port of ``llmd_kv_cache_tpu/control/journal.py``: the same records
write the same bytes in both packages.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

from ..utils.lockdep import new_lock
from ..utils.atomic_io import fsync_dir
from ..utils.cbor import CBORDecodeError, canonical_cbor_decode, canonical_cbor_encode
from ..utils.logging import get_logger

logger = get_logger("control.journal")

_HEADER = struct.Struct("<II")  # body length, body crc32

PHASE_PLANNED = "planned"
PHASE_EXECUTED = "executed"
PHASE_FAILED = "failed"
PHASE_WOULD_ACT = "would_act"
# The proposer lost the epoch race: a newer committed topology epoch was
# observed between propose (``planned``) and commit, so the action was
# abandoned and this controller self-fenced (split-brain loser's record).
PHASE_FENCED = "fenced"


def _jsonable(obj) -> object:
    """CBOR-encodable deep copy of an arbitrary signal payload (anything
    exotic goes through its JSON repr rather than poisoning the append)."""
    try:
        return json.loads(json.dumps(obj, default=repr))
    except (TypeError, ValueError):
        return repr(obj)


@dataclass
class ActionRecord:
    """One journaled phase transition of one action."""

    action_id: str
    seq: int
    ts: float
    phase: str  # planned|executed|failed|would_act|fenced
    kind: str
    target: str
    params: dict = field(default_factory=dict)
    reason: str = ""
    signal: dict = field(default_factory=dict)
    result: dict = field(default_factory=dict)
    # Topology epoch the action proposes/committed (two-phase controller
    # mutations). 0 on records written before the epoch plane existed —
    # decoded tolerantly like params/reason, so old journals replay.
    epoch: int = 0

    def to_wire(self) -> dict:
        return {
            "action_id": self.action_id,
            "seq": int(self.seq),
            "ts": float(self.ts),
            "phase": self.phase,
            "kind": self.kind,
            "target": self.target,
            "params": _jsonable(self.params or {}),
            "reason": self.reason,
            "signal": _jsonable(self.signal or {}),
            "result": _jsonable(self.result or {}),
            "epoch": int(self.epoch),
        }

    @classmethod
    def from_wire(cls, data: dict) -> "ActionRecord":
        return cls(
            action_id=str(data["action_id"]),
            seq=int(data["seq"]),
            ts=float(data["ts"]),
            phase=str(data["phase"]),
            kind=str(data["kind"]),
            target=str(data["target"]),
            params=dict(data.get("params") or {}),
            reason=str(data.get("reason", "")),
            signal=dict(data.get("signal") or {}),
            result=dict(data.get("result") or {}),
            epoch=int(data.get("epoch", 0) or 0),
        )


class ActionJournal:
    """Crash-tolerant append log of controller action records."""

    def __init__(self, path: str, sync_every: int = 1):
        self.path = path
        self.sync_every = max(1, sync_every)
        self._mu = new_lock()
        self._f = None
        self._since_sync = 0
        self._seq = 0
        self.appended = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # Resume the seq counter past any existing records so replayed +
        # new records stay totally ordered.
        for rec in self.replay():
            self._seq = max(self._seq, rec.seq)

    def _file(self):
        if self._f is None:
            self._f = open(self.path, "ab")
        return self._f

    def append(self, record: ActionRecord) -> ActionRecord:
        """Assign the next seq, frame, flush (fsync per ``sync_every``)."""
        with self._mu:
            self._seq += 1
            record.seq = self._seq
            body = canonical_cbor_encode(record.to_wire())
            rec = _HEADER.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF) + body
            f = self._file()
            f.write(rec)
            f.flush()
            self.appended += 1
            self._since_sync += 1
            if self._since_sync >= self.sync_every:
                os.fsync(f.fileno())  # lint: allow-blocking (durability point: seq/_since_sync must match on-disk state, so fsync stays under _mu; bounded by sync_every)
                self._since_sync = 0
        return record

    def close(self) -> None:
        with self._mu:
            if self._f is not None:
                if self._since_sync:
                    self._f.flush()
                    os.fsync(self._f.fileno())  # lint: allow-blocking (final durability barrier on close; no concurrent appends after this)
                    self._since_sync = 0
                self._f.close()
                self._f = None
            fsync_dir(os.path.dirname(self.path) or ".")

    def replay(self) -> Iterator[ActionRecord]:
        """Yield records in append order; stops cleanly at a torn tail."""
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        pos = 0
        while pos + _HEADER.size <= len(data):
            length, want_crc = _HEADER.unpack_from(data, pos)
            body_start = pos + _HEADER.size
            body_end = body_start + length
            if body_end > len(data):
                logger.warning(
                    "action journal %s: torn tail at offset %d "
                    "(%d bytes abandoned)", self.path, pos, len(data) - pos)
                return
            body = data[body_start:body_end]
            if (zlib.crc32(body) & 0xFFFFFFFF) != want_crc:
                logger.warning(
                    "action journal %s: crc mismatch at offset %d; stopping "
                    "replay (%d bytes abandoned)",
                    self.path, pos, len(data) - pos)
                return
            try:
                item = canonical_cbor_decode(body)
                record = ActionRecord.from_wire(item)
            except (CBORDecodeError, ValueError, TypeError, KeyError):
                logger.warning(
                    "action journal %s: undecodable record at offset %d; "
                    "stopping", self.path, pos)
                return
            pos = body_end
            yield record


def unresolved_actions(records: List[ActionRecord]) -> List[ActionRecord]:
    """``planned`` records with no later ``executed``/``failed``/``fenced``
    for the same action id — the in-flight actions a restart must
    re-verify. A fenced action is settled: a newer topology epoch already
    won, so replay must not resurrect it."""
    settled = {
        r.action_id for r in records
        if r.phase in (PHASE_EXECUTED, PHASE_FAILED, PHASE_FENCED)
    }
    out: List[ActionRecord] = []
    seen: set = set()
    for rec in records:
        if (rec.phase == PHASE_PLANNED and rec.action_id not in settled
                and rec.action_id not in seen):
            seen.add(rec.action_id)
            out.append(rec)
    return out


def last_settlement_ts(records: List[ActionRecord]) -> dict:
    """``kind`` → latest planned/executed ts (cooldown restoration)."""
    out: dict = {}
    for rec in records:
        if rec.phase in (PHASE_PLANNED, PHASE_EXECUTED):
            out[rec.kind] = max(out.get(rec.kind, 0.0), rec.ts)
    return out
