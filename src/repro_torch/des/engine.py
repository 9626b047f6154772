"""Deterministic discrete-event simulation engine (port of ``repro/des/engine.py``).

A minimal event-heap simulator for the host-side wireless/system timeline:
events are ``(time, seq, kind, data)`` tuples popped in ``(time, seq)``
order, where ``seq`` is the monotonically increasing scheduling counter —
so simultaneous events fire in the exact order they were scheduled and a
run is a *pure function of its inputs*: the engine owns no RNG, reads no
clock, and two runs fed identical schedules produce identical traces.
That is the property the campaign engine's bit-reproducibility contract
needs from an asynchronous timeline: every
execution schedule (``repro_torch.des.schedules``) replays exactly under
checkpoint resume because its event order is a function of
``(RunConfig, seed)``, never of host timing.

    sim = EventSim()
    for k, t in enumerate(completion_times):
        sim.schedule(t, "complete", client=k)
    trace = sim.run(on_event)     # handler may sim.schedule(...) more

Everything is host-side and stdlib-only.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class Event:
    """One scheduled occurrence.  Ordered by ``(time, seq)`` — ``seq`` is
    assigned at scheduling time, so ties in simulated time resolve in
    scheduling order (deterministically), never by payload comparison."""

    time: float
    seq: int
    kind: str = field(compare=False)
    data: dict = field(compare=False, default_factory=dict)

    def __lt__(self, other: "Event") -> bool:
        return (self.time, self.seq) < (other.time, other.seq)


class EventSim:
    """Pure event-heap simulator.

    ``schedule`` enqueues an event at an absolute simulated time (which may
    equal, but never precede, the current time while running); ``run`` pops
    events in ``(time, seq)`` order, advances ``now``, appends each popped
    event to ``trace`` and hands it to the handler — which may schedule
    further events.  ``run`` returns the trace (the per-event timing record
    the campaign attaches to its round records).
    """

    def __init__(self):
        self.now = 0.0
        self.trace: list[Event] = []
        self._heap: list[Event] = []
        self._seq = 0
        self._stopped = False

    def stop(self) -> None:
        """Ask ``run`` to return after the current event (handlers call this
        when their termination condition — e.g. enough aggregations — is
        met; queued events stay queued)."""
        self._stopped = True

    def schedule(self, time: float, kind: str, **data) -> Event:
        """Enqueue ``kind`` at absolute simulated ``time``."""
        if time < self.now:
            raise ValueError(
                f"cannot schedule {kind!r} at t={time} in the past "
                f"(now={self.now})")
        ev = Event(float(time), self._seq, kind, data)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def after(self, delay: float, kind: str, **data) -> Event:
        """Enqueue ``kind`` at ``now + delay``."""
        if delay < 0:
            raise ValueError(f"negative delay {delay} for {kind!r}")
        return self.schedule(self.now + float(delay), kind, **data)

    def run(self, handler: Optional[Callable[["EventSim", Event], None]] = None,
            until: Optional[float] = None,
            max_events: int = 1_000_000) -> list[Event]:
        """Drain the heap in ``(time, seq)`` order.

        ``handler(sim, event)`` runs per popped event and may schedule more;
        ``until`` stops the clock (events strictly later stay queued);
        ``max_events`` guards against a handler that schedules forever.
        Returns ``self.trace`` (all events popped so far, in order).
        """
        popped = 0
        self._stopped = False
        while self._heap and not self._stopped:
            if until is not None and self._heap[0].time > until:
                break
            ev = heapq.heappop(self._heap)
            self.now = ev.time
            self.trace.append(ev)
            if handler is not None:
                handler(self, ev)
            popped += 1
            if popped >= max_events:
                raise RuntimeError(
                    f"event budget exhausted ({max_events}) — a handler is "
                    f"likely scheduling unconditionally")
        return self.trace

    @property
    def pending(self) -> int:
        """Events still queued (not yet popped by ``run``)."""
        return len(self._heap)
