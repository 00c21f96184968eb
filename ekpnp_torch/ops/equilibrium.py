"""Equilibrium distributions and moments (port of ekpnp/ops/equilibrium.py).

One vectorized `feq` serves all four populations: the ions pass a drift
velocity u + K E, the fluid and temperature pass u.  Physical-unit
formulation: lattice velocities have magnitude 1/CFL and
cs^2 = cs2_lat / CFL^2.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..lattice import Lattice


@lru_cache(maxsize=None)
def lattice_consts(lat: Lattice, dtype: torch.dtype, device: torch.device):
    """E and W as broadcastable (Q,1,1,1) tensors: (ex, ey, ez, w)."""
    E = torch.as_tensor(lat.E.astype("float64")).to(device=device, dtype=dtype)
    w = torch.as_tensor(lat.W.copy()).to(device=device, dtype=dtype)
    col = lambda a: a.reshape(-1, 1, 1, 1)
    return col(E[:, 0]), col(E[:, 1]), col(E[:, 2]), col(w)


@lru_cache(maxsize=None)
def opp_index(lat: Lattice, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(lat.OPP.astype("int64"), device=device)


def feq(lat: Lattice, m, v, cfl: float, cs2: float):
    """feq_i = w_i m [1 - |v|^2/(2 cs^2) + t_i (1 + t_i/2)],
    t_i = (e_i . v) / (cs^2 CFL).   m: (Z,Y,X); v: (3,Z,Y,X) -> (Q,Z,Y,X).

    The products and sums are taken in the order of the formula (each
    in-place update rounds as the out-of-place expression would): the CUDA
    kernel repeats this order.  In place because fresh full-size
    temporaries cost more than the arithmetic on the CPU."""
    ex, ey, ez, w = lattice_consts(lat, m.dtype, m.device)
    t = ex * v[0]
    t += ey * v[1]
    t += ez * v[2]
    t *= 1.0 / (cs2 * cfl)
    vsq = v[0] * v[0]
    vsq += v[1] * v[1]
    vsq += v[2] * v[2]
    vsq *= 0.5
    vsq *= 1.0 / cs2
    out = t * 0.5
    out += 1.0
    out *= t
    out += 1.0 - vsq
    return out.mul_(w * m[None])


def dir_sum(a):
    """Sum over the direction axis, accumulated in direction order.

    The fluid moments are small differences of O(rho0 w) populations, so
    the last digits of u depend on the summation order; accumulating
    d = 0, 1, ..., Q-1 in turn keeps the port's f64 results on the JAX
    package's golden values (tests/test_golden.py) to 1e-9."""
    acc = a[0].clone()
    for d in range(1, a.shape[0]):
        acc += a[d]
    return acc


def dir_sum_weighted(a, e):
    """dir_sum(a * e) for a (Q,1,1,1) weight e, without the (Q, ...)
    product."""
    acc = a[0] * e[0]
    for d in range(1, a.shape[0]):
        acc += a[d] * e[d]
    return acc


def moments(lat: Lattice, pops, cfl: float):
    """(m, mom): zeroth moment (Z,Y,X) and raw first moment / CFL (3,Z,Y,X)."""
    ex, ey, ez, _ = lattice_consts(lat, pops.dtype, pops.device)
    inv_cfl = 1.0 / cfl
    mom = torch.stack([dir_sum_weighted(pops, e) * inv_cfl
                       for e in (ex, ey, ez)])
    return dir_sum(pops), mom


def trt_split(lat: Lattice, a):
    """Even/odd (TRT) parts along the direction axis:
    a+ = (a_i + a_opp(i))/2,  a- = (a_i - a_opp(i))/2."""
    a_opp = torch.index_select(a, 0, opp_index(lat, a.device))
    plus = a + a_opp
    minus = a - a_opp
    return plus.mul_(0.5), minus.mul_(0.5)
