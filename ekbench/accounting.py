"""Bytes, bounds and peaks: the yardstick of the per-layer metrics.

Copied from the port's own accounting (chip_smoke.py `_design_bytes` and
its bounds; ekpnp_torch/benchmark.py `_HBM_BW`) so that a later change to
the program cannot move it.  Bytes per node and step: every population
read once and written once, phi read once and the Poisson right-hand side
written once: (Qf + 3 Qs) * 2 * itemsize + 2 * itemsize, 872 B with every
field on D3Q27 and 392 B with D3Q7 scalars in float32.  The x-Hartley
(phi_hx) form of the fused pass is three launches: the decode of phi
(psi read, phi written), the pass, the product of the RHS rows (read and
written): its "composed" bound adds those trips.  A slab shard's pass also
reads the neighbours' edge rows: every direction with ey != 0 of every
field, one row of NZ x NX each, and phi's two halo rows.
"""
from __future__ import annotations

import subprocess

# device-memory rate by card name (NVIDIA data sheets); the first entry
# whose tags the name holds wins
HBM_BW = ((("H100", "PCIe"), 2.0e12), (("H100", "NVL"), 3.9e12),
          (("H100", "HBM3"), 3.35e12), (("H100",), 3.35e12))


def hbm_bandwidth(kind: str) -> float:
    """Published peak device-memory rate [B/s] of the card `kind`."""
    for tags, bw in HBM_BW:
        if all(t in kind for t in tags):
            return bw
    raise ValueError(f"no published memory rate for the card {kind!r}")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or why
    it could not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else f"nvidia-smi failed: {out.stderr.strip()[:200]}"
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


def _crossing(q: int) -> int:
    """Directions of a lattice with ey != 0 (D3Q27: 18, D3Q19: 10, D3Q7: 2)."""
    return {27: 18, 19: 10, 7: 2}[q]


def step_bytes_per_node(q_f: int, q_s: int, itemsize: int) -> int:
    """The step's byte floor per node: 872 / 392 B in float32."""
    return (q_f + 3 * q_s) * 2 * itemsize + 2 * itemsize


def pass_bytes(q_f: int, q_s: int, itemsize: int, shape, shard: bool = False,
               phi_hx: bool = True) -> int:
    """Bytes of one fused pass over a block of `shape` (NZ, NY, NX): the
    one-device pass, or with `shard` a slab shard's (edge rows read from
    the y-neighbours); `phi_hx` adds the composed trips of the decode and
    the RHS product."""
    nz, ny, nx = shape
    total = nz * ny * nx * step_bytes_per_node(q_f, q_s, itemsize)
    halo = 0
    if shard:
        halo = 2
        total += (_crossing(q_f) + 3 * _crossing(q_s)) * nz * nx * itemsize
        total += halo * nz * nx * itemsize
    if phi_hx:
        total += 2 * (nz - 2) * ny * nx * itemsize
        total += 2 * nz * ny * nx * itemsize + 2 * halo * nz * nx * itemsize
    return total
