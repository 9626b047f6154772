"""End-to-end FedsLLM (the paper, in one script) via the unified API (port
of ``examples/fedsllm_end_to_end.py``):

  1. sample the wireless network of §IV (50 users, 500 m cell, FDMA),
  2. run the delay-minimisation allocator (problem (17) + η sweep) to get
     (T*, η*, b*, t*) — and the EB/FE/BA baselines for comparison, each a
     named strategy in the ``repro_torch.api.allocators`` registry,
  3. run a *multi-round campaign* (``Experiment.run``) on the device:
     per-round channel evolution under a named scenario, an elastic 8-of-50
     cohort, and a round deadline that turns slow realisations into
     masked-out stragglers — the fed server aggregates survivors only
     (Algorithm 1's masked reduction),
  4. report: convergence + simulated total training delay under each policy.

    PYTHONPATH=src python -m repro_torch.examples.fedsllm_end_to_end [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.fedsllm_end_to_end --scenario drift
    PYTHONPATH=src python -m repro_torch.examples.fedsllm_end_to_end \\
        --topology edge-cloud --scenario geo-blockfade
    PYTHONPATH=src python -m repro_torch.examples.fedsllm_end_to_end \\
        --schedule pipelined          # or: async / semi-async (no barrier)
    PYTHONPATH=src python -m repro_torch.examples.fedsllm_end_to_end \\
        --local-algo scaffold --workload dirichlet   # drift-corrected non-IID
"""

import argparse
import time

import numpy as np

from repro_torch.api import (Experiment, allocators, get_local_algo, get_schedule,
                             get_scenario, get_topology, get_workload, local_algos,
                             scenarios, schedules, topologies, workloads)
from repro_torch.config import (FedsLLMConfig, LoRAConfig, RunConfig, SHAPES,
                                get_arch, smoke_variant)
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device

COHORT = 8  # clients trained per round (of the K=50 simulated radio users)
ROUNDS = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scenario", default="blockfade",
                    help=f"channel dynamics, one of {scenarios.names()}")
    ap.add_argument("--topology", default="star",
                    help=f"network graph, one of {topologies.names()}; "
                         f"non-star needs a geometry scenario "
                         f"(e.g. --scenario geo-blockfade)")
    ap.add_argument("--schedule", default="sync",
                    help=f"execution discipline, one of {schedules.names()}; "
                         f"pipelined overlaps client/server microbatches, "
                         f"async/semi-async drop the round barrier and "
                         f"aggregate arrivals staleness-weighted")
    ap.add_argument("--local-algo", default="gd",
                    help=f"client local-update rule, one of "
                         f"{local_algos.names()}; fedprox/scaffold correct "
                         f"for client drift under non-IID workloads")
    ap.add_argument("--workload", default="iid",
                    help=f"per-client data distribution, one of "
                         f"{workloads.names()}")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # unknown names fail fast with the knowns listed, like every registry
    scenario = get_scenario(args.scenario)
    topology = get_topology(args.topology)
    schedule = get_schedule(args.schedule)
    local_algo = get_local_algo(args.local_algo)
    workload = get_workload(args.workload)

    # --- model: LoRA-adapted small LM, split at A_min of the depth ---------
    cfg = smoke_variant(get_arch("fedsllm-100m")).replace(lora=LoRAConfig(rank=4))
    fcfg = FedsLLMConfig(num_clients=50)

    # --- paper §IV wireless simulation + problem (17), every strategy ------
    # (hierarchical graphs re-anchor each client on its attached edge and
    # solve per edge cell — the same registry strategies, combined)
    net, assign = topology.localize(fcfg, scenario.initial_network(fcfg, seed=0))
    alloc = {}
    for strat in allocators.names():  # BA / EB / FE / proposed
        alloc[strat] = topology.allocate(fcfg, net, assign, allocators.get(strat),
                                         strategy=strat, eta_search="coarse")
        print(f"  {strat:9s}: T*={alloc[strat].T:10.1f}s  η={alloc[strat].eta:.2f}")
    best = alloc["proposed"]
    print(f"  reduction vs BA: {100*(1-best.T/alloc['BA'].T):.2f}% (paper avg: 47.63%)")

    # --- multi-round campaign under η*, one Experiment (reusing the network
    # realisation + allocation solved above — no second η sweep).  Rounds
    # evolve the channel per the scenario; the stale allocation is re-priced
    # under each draw, and clients missing the deadline are masked out. -----
    run_cfg = RunConfig(model=cfg, shape=SHAPES["train_4k"], fedsllm=fcfg)
    exp = Experiment.from_config(run_cfg, allocator="proposed", net=net,
                                 alloc=best, scenario=scenario,
                                 topology=topology, schedule=schedule,
                                 local_algo=local_algo, workload=workload, device=dev)
    print(exp.describe())
    deadline = float(np.quantile(exp.timing.total, 0.8))  # cuts slowest ~20%

    stream = TokenStream(2, 64, cfg.vocab_size, seed=0, device=dev)
    t0 = time.time()

    def log(rec):
        print(f"round {rec.round}: cohort {rec.client_ids.tolist()} "
              f"survivors {rec.survivors}/{rec.cohort_size}  "
              f"loss {rec.metrics['loss_round_start']:.4f} "
              f"-> {rec.metrics['loss_local_final']:.4f}   "
              f"simulated wall-clock {rec.cumulative_time:9.1f}s", flush=True)

    res = exp.run(num_rounds=ROUNDS, stream=stream, cohort=COHORT,
                  deadline=deadline, resample_channel=True, on_round=log)

    ba_round = float(np.max(
        topology.round_timing(fcfg, net, alloc["BA"], 0.1, assign).total))
    print(f"\n{res.num_rounds} rounds in {time.time()-t0:.1f}s real, "
          f"{res.total_time:.1f}s simulated wireless time, "
          f"straggler rate {res.straggler_rate:.1%}, "
          f"{exp.trace_count} round function(s) built "
          f"(BA policy would need {ROUNDS*ba_round:.1f}s)")
    return res


if __name__ == "__main__":
    main()
