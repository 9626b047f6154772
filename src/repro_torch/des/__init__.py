"""Event-driven execution (port of ``repro/des``): discrete-event simulator,
queueing, schedules.

``engine`` is the deterministic event-heap simulator (events popped in
``(time, seq)`` order — a run is a pure function of its inputs);
``queueing`` adds shared-resource service models (FIFO / processor-sharing
backhaul and GPU, downlink broadcast cost, the M/D/1 reference formula);
``schedules`` exposes the execution discipline as the 6th name registry —
``sync`` | ``pipelined`` | ``async`` | ``semi-async``.
"""

from repro_torch.des import queueing
from repro_torch.des.engine import Event, EventSim
from repro_torch.des.schedules import (RoundPlan, Schedule, get_schedule,
                                       schedules)

__all__ = ["Event", "EventSim", "queueing",
           "RoundPlan", "Schedule", "get_schedule", "schedules"]
