"""Carry a state across between the JAX package and the port.

Both packages keep populations as (Q, Z, Y, X) and phi as (Z, Y, X), so the
crossing is a plain copy through numpy with no transposes.  The dict keys
are the `State` field names: {f, h, hn, g, phi, t}; absent physics are
missing keys or `None`.  The tests build one numpy state and hand it to
both packages (`state_from_numpy` here, `jnp.asarray` on the JAX side).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device, torch_dtype
from .state import State

_FIELDS = ("f", "h", "hn", "g", "phi")


def state_from_numpy(cfg, arrays, device="cuda", dtype=None) -> State:
    """Port `State` from a dict of numpy arrays (e.g. `np.asarray` of each
    field of a JAX `State`).  Shapes are checked against `cfg`."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.run.dtype)
    p = cfg.physics
    want = {
        "f": (cfg.lattice.Q,) + cfg.grid.shape,
        "h": (cfg.scalar_lat.Q,) + cfg.grid.shape if p.enable_ek else None,
        "hn": ((cfg.scalar_lat.Q,) + cfg.grid.shape
               if p.enable_ek and p.two_species else None),
        "g": (cfg.scalar_lat.Q,) + cfg.grid.shape if p.enable_thermal else None,
        "phi": cfg.grid.shape if p.enable_ek else None,
    }
    out = {}
    for name in _FIELDS:
        a = arrays.get(name)
        if want[name] is None:
            if a is not None:
                raise ValueError(f"field {name!r} is not active in this config")
            out[name] = None
            continue
        if a is None:
            raise ValueError(f"field {name!r} is required by this config")
        a = np.asarray(a)
        if a.shape != want[name]:
            raise ValueError(f"field {name!r} has shape {a.shape}, "
                             f"config wants {want[name]}")
        out[name] = torch.as_tensor(a).to(device=dev, dtype=dtype).contiguous()
    t = float(np.asarray(arrays.get("t", 0.0)))
    return State(t=torch.tensor(t, dtype=dtype, device=dev), **out)


def state_to_numpy(state: State) -> dict:
    """dict of numpy arrays {f, h, hn, g, phi, t} (None for absent fields)."""
    out = {name: (None if getattr(state, name) is None
                  else getattr(state, name).detach().cpu().numpy())
           for name in _FIELDS}
    out["t"] = state.t.detach().cpu().numpy()
    return out
