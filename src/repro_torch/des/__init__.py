"""Shared-resource queueing models (port of ``repro/des``): FIFO and
processor-sharing service, the downlink broadcast cost and the M/D/1 and PS
reference formulas. The event engine and the execution schedules come with
the experiment facade.
"""

from repro_torch.des import queueing

__all__ = ["queueing"]
