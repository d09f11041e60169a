"""Durable write-ahead request journal: the crash-safety control plane.

The JAX package's ``repro/serving/journal.py``, record for record: the same
``JOURNAL_VERSION`` and ``RECORD_FIELDS``, the same JSON lines, so a journal
either package wrote replays to the same :class:`JournalState` in the other.

Recovery (see :mod:`repro_torch.distributed.checkpoint` for the data plane)
rests on two facts the serving stack already guarantees:

* every slot's decode state is snapshottable token-exactly per state kind
  (:class:`repro_torch.serving.swap.SwapRecord`, the preemption machinery),
  and
* decode is deterministic under seeded sampling (a function of the request's
  seed and its local step), so replaying rounds past a snapshot regenerates
  bitwise-identical tokens for non-MoE archs.

What a snapshot alone cannot rebuild is the request history: which requests
entered the scheduler, which finished (with which tokens), and which were in
flight or queued at the crash.  This module is that history: an append-only
JSONL journal, fsync'd per record, written *ahead of* the state mutation it
describes, so a crash between the two is always recoverable.

Record kinds (the golden-pinned schema — ``RECORD_FIELDS`` below is the
contract, ``tests/golden/journal_schema.json`` the pin):

* ``SUBMIT`` — full :class:`~repro_torch.serving.multitenant.Request` (prompt
  tokens, sampling seed, priority, deadline, serialized extra inputs plus
  their sha256) keyed by a stable monotone ``rid``.  A rid with a SUBMIT
  but no terminal record and no checkpointed state is *re-queued* on
  recovery, never lost.
* ``ADMIT`` — the rid entered a slot (bucket/ring recorded for audit).
* ``ROUND_COMMIT`` — one collected decode micro-round: cumulative emitted
  token counts per live rid.  Recovery uses the counts past the last
  checkpoint to report rounds/tokens replayed (the tokens themselves are
  regenerated deterministically, so they are *not* journaled per round).
* ``RETIRE`` — terminal completion, with the full token list: a request
  that retired before the crash is surfaced from the journal without
  re-decoding, and one that retired *after* the last checkpoint is
  replayed and cross-checked bitwise against this record.
* ``REJECT`` / ``FAIL`` — terminal non-completions (admission retry
  budget / shed, fault-injection limit).
* ``PREEMPT`` / ``RESTORE`` — the rid moved to / returned from the host
  swap tier (ticket recorded; the record itself rides the checkpoint).
* ``CHECKPOINT`` — an engine checkpoint of this step landed on disk (the
  recovery baseline: everything before it is in the snapshot, everything
  after it is replayed).
* ``RECOVER`` — a recovery ran: the journal stays append-only across
  process generations, so a second crash during replay recovers too.

Torn tails: a crash can truncate the final record mid-line.  The reader
drops an unparseable *last* line silently (the WAL discipline means the
corresponding mutation never happened) but raises on corruption anywhere
else — silent mid-file damage is not a state we recover through.  The
writer enforces the same invariant on reopen: :class:`JournalWriter`
truncates a torn tail before its first append (so the next generation's
records never concatenate onto a partial line) and seeds its sequence
counter past the surviving records.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.obs.telemetry import get_telemetry

JOURNAL_VERSION = 1

# The journal schema contract: record kind -> exact payload field set
# (envelope fields ``v``/``seq``/``kind`` ride on every record).  append()
# enforces it, tests/golden/journal_schema.json pins it — widening or
# renaming a field is an explicit golden-file update, never silent drift.
RECORD_FIELDS: Dict[str, List[str]] = {
    "SUBMIT": ["arrival_s", "deadline_s", "extras", "extras_hash",
               "max_new_tokens", "priority", "prompt", "rid", "seed",
               "temperature", "tenant", "top_k"],
    "ADMIT": ["bucket", "rid", "ring", "slot"],
    "ROUND_COMMIT": ["emitted", "rnd"],
    "RETIRE": ["rid", "tokens"],
    "REJECT": ["rid", "shed"],
    "FAIL": ["preemptions", "rid"],
    "PREEMPT": ["rid", "ticket"],
    "RESTORE": ["rid", "ticket"],
    "CHECKPOINT": ["rnd", "step"],
    "RECOVER": ["requeued", "restored_live", "restored_swapped",
                "rounds_replayed", "step"],
}


# ----------------------------------------------------------------------
# Request <-> record
# ----------------------------------------------------------------------
def extras_hash(extra_inputs: Optional[Dict[str, Any]]) -> str:
    """sha256 over the request's non-token inputs (sorted name + bytes) —
    the same salt material the prefix-sharing chain keys fold in, so two
    requests share pages only when this hash matches."""
    if not extra_inputs:
        return ""
    h = hashlib.sha256()
    for name in sorted(extra_inputs):
        arr = np.ascontiguousarray(np.asarray(extra_inputs[name]))
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _encode_extras(extra_inputs: Optional[Dict[str, Any]]
                   ) -> Optional[Dict[str, Dict[str, Any]]]:
    if not extra_inputs:
        return None
    out = {}
    for name in sorted(extra_inputs):
        arr = np.ascontiguousarray(np.asarray(extra_inputs[name]))
        out[name] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                     "b64": base64.b64encode(arr.tobytes()).decode("ascii")}
    return out


def _decode_extras(enc: Optional[Dict[str, Dict[str, Any]]]
                   ) -> Optional[Dict[str, np.ndarray]]:
    if not enc:
        return None
    return {name: np.frombuffer(
        base64.b64decode(spec["b64"]), dtype=np.dtype(spec["dtype"])
    ).reshape(spec["shape"]).copy() for name, spec in enc.items()}


def request_to_record(rid: int, req: Any) -> Dict[str, Any]:
    """Serialize a Request to the SUBMIT payload (json-able, lossless:
    :func:`request_from_record` rebuilds an equivalent Request, extra
    inputs included)."""
    extras = getattr(req, "extra_inputs", None)
    temp = getattr(req, "temperature", None)
    dl = getattr(req, "deadline_s", None)
    return {
        "rid": int(rid),
        "tenant": str(req.tenant),
        "prompt": [int(t) for t in np.asarray(req.prompt).reshape(-1)],
        "max_new_tokens": int(req.max_new_tokens),
        "temperature": None if temp is None else float(temp),
        "top_k": int(getattr(req, "top_k", 0)),
        "seed": int(getattr(req, "seed", 0) or 0),
        "priority": int(getattr(req, "priority", 1)),
        "deadline_s": None if dl is None else float(dl),
        "arrival_s": float(req.arrival_s),
        "extras": _encode_extras(extras),
        "extras_hash": extras_hash(extras),
    }


def request_from_record(rec: Dict[str, Any]) -> Any:
    """Rebuild a Request from a SUBMIT payload (inverse of
    :func:`request_to_record`)."""
    from repro_torch.serving.multitenant import Request   # circular import
    return Request(
        tenant=rec["tenant"],
        prompt=np.asarray(rec["prompt"], np.int32),
        max_new_tokens=rec["max_new_tokens"],
        temperature=rec["temperature"],
        top_k=rec["top_k"],
        seed=rec["seed"],
        arrival_s=rec["arrival_s"],
        priority=rec["priority"],
        deadline_s=rec["deadline_s"],
        extra_inputs=_decode_extras(rec["extras"]),
    )


# ----------------------------------------------------------------------
# Writer
# ----------------------------------------------------------------------
class JournalWriter:
    """Append-only JSONL journal with per-record fsync.

    Durability discipline: ``append`` returns only after the record's
    bytes are flushed and fsync'd, so any state mutation sequenced after
    an append is guaranteed to be *at or behind* the journal on disk —
    SIGKILL at any instruction leaves a journal whose replay is a safe
    over-approximation of what the process had done."""

    def __init__(self, path: str, fsync: bool = True,
                 telemetry: Optional[Any] = None):
        self.path = path
        self.fsync = fsync
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._seq = self._repair_and_seed(path)
        self._f = open(path, "ab")
        self.appends = 0
        self.bytes_written = 0
        self.tel = get_telemetry(telemetry)

    @staticmethod
    def _repair_and_seed(path: str) -> int:
        """Reopen discipline. A prior generation SIGKILLed mid-append
        leaves a torn final line (no trailing newline); truncate it away
        *before* this generation appends, or its first record would be
        concatenated onto the partial one — turning a recoverable torn
        tail into the mid-file corruption :func:`read_journal` refuses.
        Dropping the partial record is safe by the WAL ordering: its
        mutation never happened.  Returns the next sequence number,
        seeded past the surviving tail so seqs stay monotone across
        process generations instead of restarting at 0."""
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            return 0
        with open(path, "rb") as f:
            raw = f.read()
        if not raw.endswith(b"\n"):
            keep = raw.rfind(b"\n") + 1        # 0 when no newline at all
            os.truncate(path, keep)
            raw = raw[:keep]
        lines = raw.split(b"\n")[:-1]
        if not lines:
            return 0
        try:
            return int(json.loads(lines[-1])["seq"]) + 1
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            return len(lines)   # mid-file damage: read_journal will raise

    def append(self, kind: str, **fields: Any) -> int:
        """Durably append one record; returns its sequence number."""
        want = RECORD_FIELDS.get(kind)
        if want is None:
            raise ValueError(f"unknown journal record kind {kind!r}")
        if sorted(fields) != want:
            raise ValueError(
                f"journal {kind} payload {sorted(fields)} != schema {want}")
        seq = self._seq
        self._seq += 1
        rec = {"v": JOURNAL_VERSION, "seq": seq, "kind": kind, **fields}
        line = (json.dumps(rec, sort_keys=True, separators=(",", ":"))
                + "\n").encode()
        self._f.write(line)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.appends += 1
        self.bytes_written += len(line)
        if self.tel.enabled:
            self.tel.count("journal.appends")
            self.tel.count("journal.bytes", len(line))
        return seq

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._f.close()


# ----------------------------------------------------------------------
# Reader / replay
# ----------------------------------------------------------------------
def read_journal(path: str) -> List[Dict[str, Any]]:
    """Read every record; a torn *final* line (crash mid-append) is
    dropped, corruption anywhere else raises."""
    records: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return records
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    # a well-formed file ends with newline -> last split element is empty
    tail_open = lines and lines[-1] != b""
    body = lines[:-1]
    for i, line in enumerate(body):
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            raise ValueError(
                f"journal {path}: corrupt record at line {i} "
                f"(not the torn tail)")
    if tail_open:
        try:
            records.append(json.loads(lines[-1]))
        except json.JSONDecodeError:
            pass                       # torn tail: mutation never happened
    return records


@dataclasses.dataclass
class JournalState:
    """Replay of a journal: everything recovery needs to decide each
    rid's fate (requeue / restore / surface-from-journal)."""
    submitted: Dict[int, Dict[str, Any]]     # rid -> SUBMIT payload
    terminal: Dict[int, str]                 # rid -> RETIRE|REJECT|FAIL
    retired_tokens: Dict[int, List[int]]     # rid -> final tokens
    emitted: Dict[int, int]                  # rid -> last cumulative count
    admitted: set                            # rids that ever held a slot
    preemptions: Dict[int, int]              # rid -> PREEMPT count
    last_checkpoint: Optional[Dict[str, Any]]   # last CHECKPOINT record
    rounds_after_checkpoint: int
    tokens_after_checkpoint: int
    next_rid: int
    last_round: int = 0                      # highest committed round seen

    def pending(self) -> List[int]:
        """Rids with a SUBMIT but no terminal outcome, in rid order."""
        return sorted(r for r in self.submitted if r not in self.terminal)


def replay(records: List[Dict[str, Any]]) -> JournalState:
    """Fold the journal into a :class:`JournalState`.  Records from
    *before* the latest RECOVER marker are still folded — rids are stable
    across process generations — but checkpoint bookkeeping restarts at
    each CHECKPOINT *and* each RECOVER record: a recovery re-commits the
    replayed rounds under fresh rnd numbers, so counting generation N's
    post-checkpoint rounds alongside generation N+1's re-commits would
    double-count the same logical rounds after a second crash."""
    st = JournalState(submitted={}, terminal={}, retired_tokens={},
                      emitted={}, admitted=set(), preemptions={},
                      last_checkpoint=None, rounds_after_checkpoint=0,
                      tokens_after_checkpoint=0, next_rid=0)
    emitted_at_ckpt: Dict[int, int] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "SUBMIT":
            st.submitted[rec["rid"]] = rec
            st.next_rid = max(st.next_rid, rec["rid"] + 1)
        elif kind == "ADMIT":
            st.admitted.add(rec["rid"])
        elif kind == "ROUND_COMMIT":
            st.rounds_after_checkpoint += 1
            st.last_round = max(st.last_round, int(rec["rnd"]))
            for rid, n in rec["emitted"].items():
                st.emitted[int(rid)] = int(n)
        elif kind == "RETIRE":
            st.terminal[rec["rid"]] = kind
            st.retired_tokens[rec["rid"]] = list(rec["tokens"])
        elif kind in ("REJECT", "FAIL"):
            st.terminal[rec["rid"]] = kind
        elif kind == "PREEMPT":
            st.preemptions[rec["rid"]] = (
                st.preemptions.get(rec["rid"], 0) + 1)
        elif kind == "CHECKPOINT":
            st.last_checkpoint = rec
            st.rounds_after_checkpoint = 0
            emitted_at_ckpt = dict(st.emitted)
        elif kind == "RECOVER":
            # the new generation replays from the checkpoint and
            # re-commits those rounds; only its own commits count as
            # replay work from here on (the emitted-token baseline stays
            # at the checkpoint — counts are cumulative, so the re-
            # committed rounds overwrite rather than add)
            st.rounds_after_checkpoint = 0
    st.tokens_after_checkpoint = sum(
        n - emitted_at_ckpt.get(rid, 0) for rid, n in st.emitted.items()
        if n > emitted_at_ckpt.get(rid, 0))
    return st


@dataclasses.dataclass
class RecoverySummary:
    """What a :meth:`MultiTenantScheduler.recover` call did."""
    checkpoint_step: Optional[int]
    restored_live: int               # slots rebuilt into the fresh pool
    restored_swapped: int            # host-tier records re-parked
    requeued: int                    # journaled-never-recovered rids
    already_complete: Dict[int, List[int]]   # retired pre-checkpoint
    replay_check: Dict[int, List[int]]   # retired post-ckpt: replay oracle
    rounds_replayed: int             # committed rounds past the checkpoint
    tokens_preserved: int            # tokens carried by restored records
    tokens_replayed: int             # emitted post-checkpoint, re-decoded
