"""Campaign simulation (port of ``repro/sim``): ``scenario`` defines the
channel dynamics as name-registered objects (``frozen`` | ``blockfade`` |
``geo-blockfade`` | ``drift`` | ``hetero`` | ``outage`` | ``shadowing``),
splitting the once-per-campaign large-scale state from per-round fading;
``events`` generates the other per-round events (elastic cohorts, deadline
straggler masks, stale-allocation retiming, topology-localized round draws)
keyed by ``(campaign_seed, round)``. The campaign engine and the sweep come
with the experiment facade.
"""

from repro_torch.sim import events
from repro_torch.sim.scenario import Scenario, get_scenario, scenarios

__all__ = ["Scenario", "get_scenario", "scenarios", "events"]
