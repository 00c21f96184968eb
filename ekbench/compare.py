"""The check that decides `correct`: what the timed path produced, held to
the plain reference (`ekbench.reference`), once the window has closed.

The reference follows the program from the program's own state over the
chunk the seed picked: it takes the state that went into that chunk, runs
its n steps and compares the state that came out and the series values
the program reported after it.  The start, which that skips, is checked by
itself: the reference's own Poisson-Boltzmann cold start against the
program's, and the equilibrium populations it builds from that and the
seed's perturbation against the program's initial state on the z planes
the seed drew.  The numbers compared (each with its limit in
`limits/<cell>.json`):

  cold.phi     max|phi - phi_ref| / max|phi_ref - lifting| after the cold start
  cold.ions    max over c+, c- of max|c - c_ref| / max|c_ref - chargeinf|
  init         max over f, h, hn, g of max|X - X_ref| / max|X_ref| on the planes
  chunk.pops   max over f, h, hn, g of max|X - X_ref| / max|X_ref| over the
               state the chunk produced
  chunk.phi    max|phi - phi_ref| / max|phi_ref - lifting| after the chunk
  series.current  |I - I_ref| / |I_ref| of the ionic current reported after
               the chunk
  nonfinite    series points of the window whose state held a NaN or Inf

`tf32=True` computes the reference's matrix products (its solve) from
TF32-rounded operands: put in the program's place, that is the control.
"""
from __future__ import annotations

import torch

from .perturb import apply, perturbation
from .reference import lbm, solve

POPS = lbm.POPS
SERIES = ("umax", "umag", "current", "mean_T")


def _maxabs(a) -> float:
    return float(a.abs().max())


def _rel(a, b, scale) -> float:
    """max|a - b| / scale (the comparisons here are float64 numbers)."""
    d = max(_maxabs(x - y) for x, y in zip(a, b))
    return d / scale if scale > 0 else float("inf") if d > 0 else 0.0


def _lifting_gap(P, phi) -> float:
    z = torch.arange(P.nz, dtype=torch.float64, device=phi.device)
    lift = P.voltage + (P.voltage2 - P.voltage) * z / (P.nz - 1)
    return _maxabs(phi.double() - lift[:, None, None])


def check_cold(P, prog_cold: dict, ref_cold) -> dict:
    phi_r, c_r, cn_r = ref_cold
    out = {"cold.phi": _rel([prog_cold["phi"].double()], [phi_r.double()],
                            _lifting_gap(P, phi_r))}
    out["cold.ions"] = max(
        _rel([prog_cold[k].double()], [r.double()],
             _maxabs(r.double() - P.chargeinf))
        for k, r in (("charge", c_r), ("chargen", cn_r)))
    return out


def initial_planes(P, ref_cold, traffic, seed, planes, device):
    """The reference's initial populations on `planes`, from its own cold
    start and the seed's perturbation (whole fields, then the planes)."""
    phi, c, cn = ref_cold
    dtype = phi.dtype
    rho = torch.full(P.shape, P.rho0, dtype=dtype, device=device)
    u = torch.zeros((3,) + P.shape, dtype=dtype, device=device)
    temp = solve.temperature_profile(P, device, dtype)
    d = perturbation(P.shape, traffic, seed, device)
    rho, u, c, cn, temp = apply(rho, u, c, cn, temp, d, P.TH)
    del d
    st = lbm.initial_state(P, rho, u, c, cn, temp, phi, solve.efield(P, phi))
    idx = torch.tensor(planes, device=device)
    return {k: torch.index_select(st[k], -3, idx) for k in POPS}


def check_init(prog_init: dict, ref_init: dict) -> dict:
    return {"init": max(_rel([prog_init[k].double()], [ref_init[k].double()],
                             _maxabs(ref_init[k].double())) for k in POPS)}


def field_errors(st_in: dict, prog_out: dict, ref_out: dict) -> dict:
    """Per population field: the largest error, the field's largest value
    and the chunk's largest change, direction by direction (float64)."""
    out = {}
    for k in POPS:
        err = mag = change = 0.0
        for d in range(ref_out[k].shape[0]):
            r = ref_out[k][d].double()
            err = max(err, _maxabs(prog_out[k][d].double() - r))
            mag = max(mag, _maxabs(r))
            change = max(change, _maxabs(r - st_in[k][d].double()))
        out[k] = (err, mag, change)
    return out


def check_chunk(P, st_in: dict, prog_out: dict, ref_out: dict,
                detail: dict = None) -> dict:
    errs = field_errors(st_in, prog_out, ref_out)
    if detail is not None:
        for k, (e, m, c) in errs.items():
            detail[f"{k}.err_over_value"] = e / m if m else float("inf")
            detail[f"{k}.err_over_change"] = e / c if c else float("inf")
            detail[f"{k}.change_over_value"] = c / m if m else float("inf")
        for k in ("h", "hn"):
            c_r = ref_out[k].double().sum(0)
            c_p = prog_out[k].double().sum(0)
            c_i = st_in[k].double().sum(0)
            detail[f"{k}.moment_err_over_edl"] = _maxabs(c_p - c_r) / _maxabs(
                c_r - P.chargeinf)
            detail[f"{k}.moment_err_over_change"] = _maxabs(c_p - c_r) / _maxabs(
                c_r - c_i)
    return {"chunk.pops": max(e / m if m else float("inf")
                              for e, m, _ in errs.values()),
            "chunk.phi": _rel([prog_out["phi"].double()],
                              [ref_out["phi"].double()],
                              _lifting_gap(P, ref_out["phi"]))}


def check_series(prog_vals, ref_vals: dict, detail: dict = None) -> dict:
    """prog_vals: the program's (max uz, max |u|, current, mean T) floats.
    Compared: the current (the control moves neither u, resolved by
    float32 populations to ~1e-2 at these speeds, nor T); every value's
    error goes to `detail`."""
    errs = {}
    for k, v in zip(SERIES, prog_vals):
        r = ref_vals[k]
        errs[k] = abs(v - r) / abs(r) if r else (0.0 if v == r else float("inf"))
        if detail is not None:
            detail[f"series.{k}"] = errs[k]
    return {"series.current": errs["current"]}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number the cell's limits
    name at or below its limit; a limit without a number fails.  A number
    without a limit is not compared (the control does not separate it on
    that cell, PERF.md section 2)."""
    rows = {}
    ok = True
    for name in sorted(limits):
        v, lim = numbers.get(name), limits.get(name)
        good = v is not None and lim is not None and v == v and v <= lim
        ok = ok and good
        rows[name] = {"value": v, "limit": lim}
    return ok, rows
