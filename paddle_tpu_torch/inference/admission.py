"""SLO-aware admission queue for the serving engine (a copy of
``paddle_tpu/inference/admission.py``, which is plain Python; the port
keeps its own so that it imports nothing of the JAX package).

Semantics:

- **priority classes** are small ints, LOWER = more urgent (0 is the
  most urgent class). The default class is 1.
- **FIFO within a class**: entries carry a monotonically increasing
  submission sequence number; requeued (preempted) entries KEEP their
  original sequence number, so a victim re-enters the line where it
  originally stood.
- **deadline** (``deadline_s``, relative to submit) bounds QUEUE WAIT:
  an entry still queued past its deadline is expired rather than
  admitted late. Entries whose service already STARTED (a preempted
  decode slot being requeued) are never expired.
- **starvation-freedom** via aging: an entry's EFFECTIVE class drops by
  one for every ``aging_s`` seconds it has waited. ``aging_s=None``
  disables aging (strict priority).

The queue is a plain list with an O(n) best-entry scan: effective
priority is time-dependent, and serving queues are tens of entries. A
``clock`` callable is injected for tests.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

__all__ = ["AdmissionQueue", "QueueEntry"]


class QueueEntry:
    """One queued request plus its scheduling metadata."""

    __slots__ = ("item", "cls", "seq", "submit_t", "deadline_s",
                 "requeues", "started")

    def __init__(self, item, cls: int, seq: int, submit_t: float,
                 deadline_s: Optional[float], started: bool = False):
        self.item = item
        self.cls = int(cls)
        self.seq = int(seq)
        self.submit_t = float(submit_t)
        self.deadline_s = deadline_s
        self.requeues = 0          # times this entry was put back
        self.started = started     # service began (preempted resume)

    def expired(self, now: float) -> bool:
        """Queued past the admission deadline (started entries never
        expire — their admission SLO was already met)."""
        return (not self.started and self.deadline_s is not None
                and (now - self.submit_t) > self.deadline_s)


class AdmissionQueue:
    """Priority + deadline + aging admission queue (module docstring)."""

    def __init__(self, aging_s: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if aging_s is not None and aging_s <= 0:
            raise ValueError("aging_s must be positive (or None)")
        self.aging_s = aging_s
        self.clock = clock
        self._entries: List[QueueEntry] = []
        self._next_seq = 0

    # -- mutation -----------------------------------------------------
    def push(self, item, cls: int = 1, submit_t: Optional[float] = None,
             deadline_s: Optional[float] = None,
             seq: Optional[int] = None,
             started: bool = False) -> QueueEntry:
        """Enqueue ``item``. ``seq`` lets a requeue keep the original
        line position; fresh pushes take the next sequence number."""
        if seq is None:
            seq = self._next_seq
            self._next_seq += 1
        e = QueueEntry(item, cls, seq,
                       self.clock() if submit_t is None else submit_t,
                       deadline_s, started=started)
        self._entries.append(e)
        return e

    def requeue(self, entry: QueueEntry) -> QueueEntry:
        """Put a previously popped entry back, keeping its class,
        sequence number and submit time (preemption path: the victim
        re-enters the line where it originally stood)."""
        entry.requeues += 1
        entry.started = True
        self._entries.append(entry)
        return entry

    def remove(self, entry: QueueEntry):
        self._entries.remove(entry)

    # -- ordering -----------------------------------------------------
    def effective_class(self, entry: QueueEntry,
                        now: Optional[float] = None) -> int:
        """Class after aging: one promotion per ``aging_s`` waited,
        floored at 0 (class can only improve with waiting)."""
        if self.aging_s is None:
            return entry.cls
        now = self.clock() if now is None else now
        boost = int(max(0.0, now - entry.submit_t) / self.aging_s)
        return max(0, entry.cls - boost)

    def _key(self, entry: QueueEntry, now: float):
        return (self.effective_class(entry, now), entry.seq)

    def best(self, now: Optional[float] = None,
             pred=None) -> Optional[QueueEntry]:
        """The entry next in line: minimum (effective class, seq),
        optionally restricted to entries matching ``pred``."""
        entries = (self._entries if pred is None
                   else [e for e in self._entries if pred(e)])
        if not entries:
            return None
        now = self.clock() if now is None else now
        return min(entries, key=lambda e: self._key(e, now))

    def pop(self, now: Optional[float] = None) -> Optional[QueueEntry]:
        e = self.best(now)
        if e is not None:
            self._entries.remove(e)
        return e

    def pop_expired(self, now: Optional[float] = None
                    ) -> List[QueueEntry]:
        """Remove and return every entry whose admission deadline has
        passed (rejection accounting belongs to the caller)."""
        now = self.clock() if now is None else now
        dead = [e for e in self._entries if e.expired(now)]
        for e in dead:
            self._entries.remove(e)
        return dead

    # -- introspection ------------------------------------------------
    def snapshot(self, limit: int = 16,
                 now: Optional[float] = None) -> List[dict]:
        """Line order (up to ``limit``) for stall dumps."""
        now = self.clock() if now is None else now
        ordered = sorted(self._entries, key=lambda e: self._key(e, now))
        return [{"cls": e.cls,
                 "effective_cls": self.effective_class(e, now),
                 "seq": e.seq, "requeues": e.requeues,
                 "started": e.started,
                 "waited_s": round(now - e.submit_t, 6)}
                for e in ordered[:limit]]

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)

    def __iter__(self):
        return iter(sorted(self._entries,
                           key=lambda e: self._key(e, self.clock())))
