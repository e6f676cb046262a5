"""Continuous-batching slot/queue state machine (port of
``repro.launch.slots``; pure Python, line for line).

The solver service (``launch/solver_serve.py``) serves a request stream
through a fixed bank of batch slots.  It needs free-slot detection, FIFO
refill, per-slot age since admission, round-deadline eviction with
re-queue-at-tail and a give-up bound; ``SlotBoard`` is that bookkeeping,
kept apart from the engine's domain work (admit/launch for the solver).

The board is deliberately engine-agnostic: a "request" is anything with
``done`` (bool) and ``evictions`` (int) attributes.  Admission work is
injected as ``admit_fn(req, slot)`` so the board never touches solver
state; the engine calls ``place`` from its ``admit`` so direct (test)
admissions and queue refills share the bookkeeping too.

Lifecycle per scheduler iteration (the order the eviction-determinism test
pins down):

    while board.pending():
        board.refill(engine.admit)   # retire finished, admit queue head
        if board.live():
            engine.step()            # board.tick() ages live slots
        board.evict_stale()          # deadline → re-queue tail / give up
    finished = board.drain()
"""
from __future__ import annotations


class SlotBoard:
    """Fixed-width slot bank + FIFO queue + finished list.

    ``max_rounds`` is the per-slot deadline in ticks since admission
    (None disables eviction); a request evicted more than
    ``max_evictions`` times is given up on — marked done with whatever
    partial result it carries and moved to ``finished``.
    """

    def __init__(self, num_slots: int, *, max_rounds: int | None = None,
                 max_evictions: int = 2):
        self.slots: list = [None] * num_slots
        self.age: list[int] = [0] * num_slots
        self.queue: list = []
        self.finished: list = []
        self.max_rounds = max_rounds
        self.max_evictions = max_evictions

    # -- queries ----------------------------------------------------------
    def free_slots(self) -> list[int]:
        """Slots holding nothing or a finished request (refillable)."""
        return [i for i, r in enumerate(self.slots)
                if r is None or r.done]

    def live(self) -> bool:
        """Any slot still working?"""
        return any(r is not None and not r.done for r in self.slots)

    def pending(self) -> bool:
        """Anything left to do (queued or in-flight)?"""
        return bool(self.queue) or self.live()

    def occupancy(self) -> float:
        """Fraction of slots holding a live request (the slot-occupancy
        sample)."""
        return sum(r is not None and not r.done
                   for r in self.slots) / max(1, len(self.slots))

    # -- transitions ------------------------------------------------------
    def place(self, req, slot: int) -> None:
        """Bookkeeping half of admission: occupy ``slot`` and reset its
        deadline clock.  Engines call this from their ``admit``."""
        self.slots[slot] = req
        self.age[slot] = 0

    def refill(self, admit_fn) -> list[int]:
        """Retire finished occupants and admit from the queue head into
        every free slot, in slot order.  ``admit_fn(req, slot)`` does the
        engine-specific admission (and must call ``place``).  Returns the
        slots refilled this call."""
        refilled = []
        for slot in self.free_slots():
            old = self.slots[slot]
            if old is not None and old.done:
                self.finished.append(old)
                self.slots[slot] = None
            if self.queue:
                admit_fn(self.queue.pop(0), slot)
                refilled.append(slot)
        return refilled

    def tick(self) -> None:
        """Age every live slot by one scheduler step."""
        for i, r in enumerate(self.slots):
            if r is not None and not r.done:
                self.age[i] += 1

    def evict_stale(self) -> list[int]:
        """Round-deadline eviction, in slot order: an unfinished slot at or
        past ``max_rounds`` ticks is cleared and its request re-queued at
        the TAIL (stragglers cannot pin a slot; fresh requests get served
        in between) — unless it has already been evicted ``max_evictions``
        times, in which case it is given up on.  Returns evicted slots."""
        if self.max_rounds is None:
            return []
        evicted = []
        for i, r in enumerate(self.slots):
            if r is None or r.done or self.age[i] < self.max_rounds:
                continue
            r.evictions += 1
            self.slots[i] = None
            if r.evictions > self.max_evictions:
                r.done = True              # give up; keep partial output
                self.finished.append(r)
            else:
                self.queue.append(r)       # re-queue at the tail
            evicted.append(i)
        return evicted

    def drain(self) -> list:
        """Move any remaining occupants to ``finished`` and return it."""
        for i, r in enumerate(self.slots):
            if r is not None:
                self.finished.append(r)
                self.slots[i] = None
        return self.finished
