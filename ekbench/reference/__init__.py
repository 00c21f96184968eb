"""The plain reference of the EK-PNP-thermal solver: the same physics as
the program under test, written again in plain PyTorch from the
configuration file's numbers alone.

It imports nothing of the program (`ekpnp_torch`), of the JAX package or
of JAX, and takes nothing the program computed: the benchmark hands both
sides the same seed-made inputs (`ekbench.perturb`) and the reference
works out everything else itself, the Poisson-Boltzmann cold start
included.  Matrix products appear only in the spectral solve, in full
float32 (TF32 off); `tf32=True` rounds their operands to TF32 first,
which is the control of the comparison (`ekbench.compare`).

  params.py   the configuration's numbers: lattices, rates, sound speeds
  solve.py    DST-I / Hartley solve, E = -grad(phi), the PB cold start
  lbm.py      moments, equilibria, TRT collide, bounce-back, stream, the
              scalar wall rules, one step, the series values
  shards.py   how a slab mesh cuts the grid (the pod's shard split)
"""
