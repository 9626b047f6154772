"""Campaign simulation (port of ``repro/sim``): multi-round scenarios over
time-varying channels.

``campaign`` drives an ``Experiment`` through many global rounds (the engine
behind ``Experiment.run``); ``scenario`` defines the channel dynamics as
name-registered objects (``frozen`` | ``blockfade`` | ``geo-blockfade`` |
``drift`` | ``hetero`` | ``outage`` | ``shadowing``), splitting the
once-per-campaign large-scale state from per-round fading; ``events``
generates the other per-round events (elastic cohorts, deadline straggler
masks, stale-allocation retiming, topology-localized round draws) keyed by
``(campaign_seed, round)``; ``sweep`` fans a grid of topologies × scenarios
× allocators into one tidy records table (``Experiment.sweep``).
"""

from repro_torch.sim import events
from repro_torch.sim.campaign import (CampaignResult, RoundRecord, run_campaign,
                                      stream_batcher)
from repro_torch.sim.scenario import Scenario, get_scenario, scenarios
from repro_torch.sim.sweep import SweepResult, run_sweep

__all__ = ["CampaignResult", "RoundRecord", "run_campaign", "stream_batcher",
           "Scenario", "get_scenario", "scenarios",
           "SweepResult", "run_sweep",
           "events"]
