"""Resource-allocation demo: reproduce the shape of the paper's Fig. 2 on a
reduced grid and show the Lemma-3 structure of the optimal solution (port
of ``examples/resource_allocation_demo.py``). The allocator is host-side
numpy: nothing here runs on the device, and ``--device`` is taken for the
examples' common command line only.

    PYTHONPATH=src python -m repro_torch.examples.resource_allocation_demo
"""

import argparse

import numpy as np

from repro_torch.api import allocators
from repro_torch.config import FedsLLMConfig
from repro_torch.core import delay_model as dm
from repro_torch.core import resource_alloc as ra


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.parse_args(argv)
    cfg = FedsLLMConfig(num_clients=20)
    print("power   proposed        EB        FE        BA    η*")
    reductions = []
    for p_dbm in (0.0, 10.0, 20.0):
        net = dm.sample_network(cfg, seed=0, p_max_dbm=p_dbm)
        prop = allocators.get("proposed")(cfg, net, eta_search="coarse")
        eb = allocators.get("EB")(cfg, net)
        fe = allocators.get("FE")(cfg, net)
        ba = allocators.get("BA")(cfg, net)
        reductions.append(1 - prop.T / ba.T)
        print(f"{p_dbm:5.1f} {prop.T:9.1f} {eb.T:9.1f} {fe.T:9.1f} {ba.T:9.1f}"
              f"   {prop.eta:.2f}")
    print(f"\navg reduction vs BA: {100*np.mean(reductions):.2f}%  (paper: 47.63%)")

    # Lemma 3 structure at the optimum
    net = dm.sample_network(cfg, seed=0)
    a = ra.solve_fixed_eta_exact(cfg, net, 0.1)
    V = dm.local_iters(cfg, 0.1)
    I0 = dm.global_rounds(cfg, 0.1)
    R = a.T / I0 - dm.compute_time(cfg, net, 0.1, a.A)
    print("\nLemma 3 checks at the optimum:")
    print("  max |t_c + V·t_s − budget| =", float(np.max(np.abs(a.t_c + V * a.t_s - R))))
    print("  bandwidth budgets used:   ",
          f"fed {a.b_c.sum()/net.B_c*100:.1f}%  main {a.b_s.sum()/net.B_s*100:.1f}%")
    print("  worst-channel user gets   ",
          f"{a.b_s[np.argmin(net.g_s)]/np.mean(a.b_s):.2f}x mean main-server bandwidth")
    return reductions


if __name__ == "__main__":
    main()
