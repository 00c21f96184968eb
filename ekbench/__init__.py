"""The benchmark of `ekpnp_torch`, the PyTorch/CUDA port of the EK-PNP-3D
solver: one command runs one cell once and prints one JSON line.

    python3 -m ekbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the checkout's root names the cells, the configurations,
the metrics and their bounds.  Everything that belongs to one of them is a
file of its own, found by name:

  configs/<config>.json    a deployment: grid, physics, lattices, precision,
                           mesh, with its source and what was assumed
  traffic/<traffic>.json   the series cadence and the seeded perturbation of
                           the cold start (read by `perturb`)
  limits/<cell>.json       the limit of every number the check compares
  metrics/<metric>.py      the reader of one per-layer metric

The harness drives the program's time loop (`ekpnp_torch.kernels.step
.multi_step`, or the sharded loop of `ekpnp_torch.parallel.mesh` over NCCL
processes) at the series cadence of the CLI, and holds what that loop
produced to the plain reference in `reference/`, which imports nothing of
the program.  Nothing here imports JAX or the JAX package `ekpnp`.
"""
