"""Unified FedsLLM experiment API (port of ``repro/api``).

One config-driven entry point replaces the loose function factories that
every launcher, example and benchmark used to re-wire by hand:

    from repro_torch.api import Experiment
    from repro_torch.config import RunConfig, SHAPES, get_arch

    run_cfg = RunConfig(model=get_arch("fedsllm-100m"), shape=SHAPES["train_4k"])
    exp = Experiment.from_config(run_cfg)          # on the card; device="cpu" for the CPU
    res = exp.run_round(batches)                   # one Algorithm-1+2 global round
    res.metrics, res.timing.total                  # training + simulated wall-clock

    camp = exp.run(num_rounds=20, stream=stream,   # multi-round campaign:
                   cohort=8, deadline=5.0)         # fading + cohorts + stragglers
    camp.history("loss_round_start"), camp.total_time

Seven pluggable strategy axes, each a named registry (mirroring
``config.register_arch`` — unknown names raise ``KeyError`` listing the
known ones):

  ``aggregators``  fed-server reduction: ``fedavg`` | ``weighted`` (D_k) |
                   ``median`` | ``trimmed_mean``  (mask/straggler-aware)
  ``allocators``   §IV delay-minimisation strategies: ``proposed`` | ``EB`` |
                   ``FE`` | ``BA``
  ``compressors``  smashed-activation uplink codecs: ``none`` | ``int8`` |
                   ``randk`` | ``topk`` — the codec's ratio rescales the
                   delay model's ``s`` bits and its quantisation error flows
                   through training (straight-through; ``int8``/``randk``
                   are the stable in-loop choices, see the module docstring)
  ``scenarios``    channel dynamics across campaign rounds: ``frozen`` |
                   ``blockfade`` (default, the legacy bit-frozen semantics) |
                   ``geo-blockfade`` | ``drift`` | ``hetero`` | ``outage`` |
                   ``shadowing`` (AR(1)-correlated) — each splits the
                   once-per-campaign large-scale state from per-round
                   fading (``repro_torch.sim.scenario``)
  ``topologies``   the network graph: ``star`` (default, the legacy flat
                   FedsLLM graph, bit-identical) | ``edge-cloud`` |
                   ``edge-agg`` | ``relay`` — multi-hop client→edge→cloud
                   splits with per-hop delay composition and per-edge-cell
                   resource allocation (``repro_torch.net.topology``)
  ``schedules``    the execution discipline: ``sync`` (default, the
                   round-synchronous engine, bit-identical) | ``pipelined``
                   (microbatch overlap across the wireless split) |
                   ``async`` | ``semi-async`` (no round barrier — clients
                   rejoin on completion, arrivals aggregate
                   staleness-weighted; ``repro_torch.des.schedules``)
  ``local_algos``  the client local-update rule on problem (4): ``gd``
                   (default, the paper's plain descent, bit-identical) |
                   ``fedprox`` (proximal pull to the broadcast state) |
                   ``scaffold`` (control-variate-corrected steps with
                   per-client variates carried across rounds and
                   checkpointed; ``repro_torch.fl.local_algos``)

Data heterogeneity is a first-class *workload* on the same footing
(``repro_torch.fl.workloads``): ``iid`` (default, the legacy stream semantics) |
``quantity-skew`` | ``length-skew`` | ``dirichlet`` domain skew — the
non-IID client-drift regimes where the local algorithms (and aggregators,
schedules) actually separate.

The client *population* model is the 9th axis (``repro_torch.pop``): ``exact``
(default, every simulated client materialised — bit-identical) |
``compact`` (async rounds gather arrivals into a fixed-size window, so
device cost per round is O(cohort) not O(K)) | ``meanfield`` (compact
windows plus analytic queue pricing and representative-client allocation
— the 10⁵-client campaign regime).

``Experiment.sweep`` fans a grid of topologies × scenarios × allocators ×
schedules × local algorithms × workloads × populations into one tidy
records table (``repro_torch.sim.sweep``) for cross-family comparisons.
"""

from repro_torch.api.aggregators import aggregators, get_aggregator
from repro_torch.api.allocators import allocators, get_allocator
from repro_torch.api.compressors import Compressor, compressors, get_compressor
from repro_torch.api.experiment import Experiment, RoundResult
from repro_torch.des.schedules import Schedule, get_schedule, schedules
from repro_torch.fl.local_algos import LocalAlgo, get_local_algo, local_algos
from repro_torch.fl.workloads import Workload, get_workload, workloads
from repro_torch.net.topology import Topology, get_topology, topologies
from repro_torch.pop import Population, get_population, populations
from repro_torch.registry import Registry
from repro_torch.sim.campaign import CampaignResult, RoundRecord
from repro_torch.sim.scenario import Scenario, get_scenario, scenarios
from repro_torch.sim.sweep import SweepResult, run_sweep

__all__ = [
    "Experiment", "RoundResult", "Registry",
    "CampaignResult", "RoundRecord",
    "SweepResult", "run_sweep",
    "aggregators", "get_aggregator",
    "allocators", "get_allocator",
    "compressors", "get_compressor", "Compressor",
    "scenarios", "get_scenario", "Scenario",
    "topologies", "get_topology", "Topology",
    "schedules", "get_schedule", "Schedule",
    "local_algos", "get_local_algo", "LocalAlgo",
    "workloads", "get_workload", "Workload",
    "populations", "get_population", "Population",
]
