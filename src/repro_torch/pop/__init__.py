"""Client-population models (the 9th pluggable strategy axis; port of
``repro/pop``).

``exact`` (default, bit-identical) | ``compact`` (O(cohort) device batches)
| ``meanfield`` (O(cohort) timelines + analytic queues) — see
``repro_torch.pop.population`` for the axis contract and
``repro_torch.pop.meanfield`` for the mean-field validity regime.
"""

from repro_torch.pop.meanfield import (MeanFieldPopulation, meanfield_backhaul_hop,
                                 REP_STREAM_TAG)
from repro_torch.pop.population import (CompactPopulation, ExactPopulation,
                                  Population, get_population, populations)

__all__ = [
    "Population", "ExactPopulation", "CompactPopulation",
    "MeanFieldPopulation", "get_population", "populations",
    "meanfield_backhaul_hop", "REP_STREAM_TAG",
]
