"""Checkpoints and restore (port of ekpnp/io/checkpoint.py).

The file formats are the JAX package's, so either package reads the
other's checkpoints:
  - `save_npz` / `load_npz`: the macroscopic fields and t (the reference's
    lossy restart: populations are re-derived from equilibria on load);
  - `save_reference_ascii` / `load_reference_ascii`: the reference's
    12-column data_end.dat (formatted and parsed in C++, io/native.py);
  - `save_full_npz` / `load_full_npz`: every population, phi and t in
    their own dtype, a lossless restore;
  - `save_sharded` / `load_sharded`: the lossless state of a sharded run,
    one `shard_<pid>.npz` a process with each block under its global
    start offsets (`name@o0_o1_..`) and `meta.json`.  The restore is
    mesh-elastic: each block the restoring mesh asks for (or the whole
    domain, with no mesh) is stitched from the saved pieces that overlap
    it.

Loaders put the state on `device` ("cuda" unless the caller asks for
"cpu"); a sharded restore puts each shard on its mesh device.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device, torch_dtype
from ..init import state_from_macro
from ..state import Macro, State
from . import native
from .tecplot import to_numpy, wall_extrapolate_np

_POPS = ("f", "h", "hn", "g")


def _check_grid(cfg: Config, grid, what="checkpoint"):
    g = cfg.grid
    if tuple(int(v) for v in grid) != (g.nx, g.ny, g.nz):
        raise ValueError(f"{what} grid {tuple(grid)} != config grid "
                         f"{(g.nx, g.ny, g.nz)}")


def _check_lattices(cfg: Config, qs):
    if tuple(int(v) for v in qs) != (cfg.lattice.Q, cfg.scalar_lat.Q):
        raise ValueError(f"checkpoint lattices Q={tuple(qs)} != config "
                         f"Q={(cfg.lattice.Q, cfg.scalar_lat.Q)}")


def _check_dtype(cfg: Config, name, dtype):
    if np.dtype(dtype) != np.dtype(cfg.run.dtype):
        raise ValueError(f"checkpoint field {name} is {np.dtype(dtype)}, "
                         f"config wants {cfg.run.dtype}; a lossless restore "
                         f"requires matching precision")


def _shapes(cfg: Config) -> dict:
    """The global shape of each active state field."""
    p, g = cfg.physics, cfg.grid
    qs = (cfg.scalar_lat.Q,) + g.shape
    return {"f": (cfg.lattice.Q,) + g.shape,
            "h": qs if p.enable_ek else None,
            "hn": qs if p.enable_ek and p.two_species else None,
            "g": qs if p.enable_thermal else None,
            "phi": g.shape if p.enable_ek else None}


def save_npz(path: str, cfg: Config, macro: Macro, phi, E, t: float) -> None:
    g = cfg.grid
    shape = g.shape
    u = to_numpy(macro.u, (3,) + shape)
    E_a = to_numpy(E, (3,) + shape)
    np.savez_compressed(
        path,
        t=np.float64(t),
        rho=to_numpy(macro.rho, shape),
        ux=u[0], uy=u[1], uz=u[2],
        charge=to_numpy(macro.charge, shape),
        chargen=to_numpy(macro.chargen, shape),
        phi=to_numpy(phi, shape),
        Ex=E_a[0], Ey=E_a[1], Ez=E_a[2],
        temp=to_numpy(macro.temp, shape),
        grid=np.array([g.nx, g.ny, g.nz]),
    )


def _from_macro(cfg: Config, get, t: float, device) -> State:
    """Equilibrium state from the fields `get(name)` returns (numpy)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.run.dtype)
    arr = lambda k: torch.as_tensor(np.ascontiguousarray(get(k)),
                                    dtype=dtype, device=dev)
    p = cfg.physics
    ek = p.enable_ek
    macro = Macro(rho=arr("rho"),
                  u=torch.stack([arr("ux"), arr("uy"), arr("uz")]),
                  charge=arr("charge") if ek else None,
                  chargen=arr("chargen") if ek else None,
                  temp=arr("temp") if p.enable_thermal else None)
    E = torch.stack([arr("Ex"), arr("Ey"), arr("Ez")]) if ek else None
    return state_from_macro(cfg, macro, arr("phi") if ek else None, E, t)


def load_npz(path: str, cfg: Config, device="cuda") -> State:
    """Restore from `save_npz`'s file: populations re-equilibrated."""
    with np.load(path) as d:
        _check_grid(cfg, d["grid"])
        return _from_macro(cfg, lambda k: d[k], float(d["t"]), device)


def save_reference_ascii(path: str, cfg: Config, macro: Macro, phi, E,
                         t: float) -> None:
    """data_end.dat in the reference's 12-column ASCII layout, with its
    wall extrapolation applied first."""
    g = cfg.grid
    shape = g.shape
    rho = wall_extrapolate_np(to_numpy(macro.rho, shape))
    u = wall_extrapolate_np(to_numpy(macro.u, (3,) + shape))
    charge = wall_extrapolate_np(to_numpy(macro.charge, shape))
    chargen = wall_extrapolate_np(to_numpy(macro.chargen, shape))
    phi_a, temp = to_numpy(phi, shape), to_numpy(macro.temp, shape)
    E_a = to_numpy(E, (3,) + shape)
    cols = [np.full(g.num_nodes, t), u[0], u[1], u[2], rho, charge, chargen,
            phi_a, E_a[0], E_a[1], E_a[2], temp]
    native.write_table(path, cols)


_ASCII_COLS = ("t", "ux", "uy", "uz", "rho", "charge", "chargen", "phi",
               "Ex", "Ey", "Ez", "temp")


def load_reference_ascii(path: str, cfg: Config, device="cuda") -> State:
    """Restore from the reference's data_end.dat (read_data,
    LBM.cu:2629-2671): populations re-equilibrated."""
    g = cfg.grid
    with open(path, "rb") as f:
        data = native.parse_table(f.read(), g.num_nodes, 12)
    cols = {k: data[:, i].reshape(g.shape) for i, k in enumerate(_ASCII_COLS)}
    return _from_macro(cfg, cols.__getitem__, float(data[0, 0]), device)


def save_full_npz(path: str, cfg: Config, state: State) -> None:
    """Lossless checkpoint: every population tensor, phi and t in their
    own dtype."""
    g = cfg.grid
    payload = {
        "t": state.t.detach().cpu().numpy(),
        "f_pop": state.f.detach().cpu().numpy(),
        "grid": np.array([g.nx, g.ny, g.nz]),
        "lattice_q": np.array([cfg.lattice.Q, cfg.scalar_lat.Q]),
    }
    for name in ("h", "hn", "g", "phi"):
        a = getattr(state, name)
        if a is not None:
            key = name if name == "phi" else name + "_pop"
            payload[key] = a.detach().cpu().numpy()
    np.savez_compressed(path, **payload)


def is_full_checkpoint(path: str) -> bool:
    """True if `path` is a lossless full-state checkpoint (save_full_npz)."""
    if not path.endswith(".npz") or not os.path.isfile(path):
        return False
    with np.load(path) as d:
        return "f_pop" in d.files


def load_full_npz(path: str, cfg: Config, device="cuda") -> State:
    """Restore a lossless checkpoint exactly (no re-equilibration)."""
    dev = resolve_device(device)
    with np.load(path) as d:
        _check_grid(cfg, d["grid"])
        _check_lattices(cfg, d["lattice_q"])

        def arr(name, key):
            if key not in d.files:
                if _shapes(cfg)[name] is not None:
                    raise ValueError(f"checkpoint {path} lacks {key}")
                return None
            a = d[key]
            _check_dtype(cfg, key, a.dtype)
            return torch.as_tensor(a).to(dev)

        return State(f=arr("f", "f_pop"), h=arr("h", "h_pop"),
                     hn=arr("hn", "hn_pop"), g=arr("g", "g_pop"),
                     phi=arr("phi", "phi"),
                     t=torch.as_tensor(d["t"], dtype=torch_dtype(
                         cfg.run.dtype)).to(dev))


def save_sharded(dirpath: str, cfg: Config, state: State, mesh,
                 pid: int = 0, nprocs: int = 1) -> None:
    """Lossless checkpoint of a sharded state (fields: lists of shards in
    mesh order, None where another process holds one): this process's
    blocks to `dirpath`/shard_<pid>.npz under their global start offsets
    (0 on the unsharded leading axes), and from process 0 meta.json (grid,
    lattices, dtype, t, process count)."""
    os.makedirs(dirpath, exist_ok=True)
    payload = {}
    for name in _POPS + ("phi",):
        shards = getattr(state, name)
        if shards is None:
            continue
        for i, a in enumerate(shards):
            if a is None:
                continue
            y0, _, x0, _ = mesh.block(cfg, i)
            off = [0] * (a.ndim - 2) + [y0, x0]
            payload[f"{name}@{'_'.join(map(str, off))}"] = \
                a.detach().cpu().numpy()
    np.savez_compressed(os.path.join(dirpath, f"shard_{pid}.npz"), **payload)
    if pid == 0:
        g = cfg.grid
        meta = {"grid": [g.nx, g.ny, g.nz],
                "lattice_q": [cfg.lattice.Q, cfg.scalar_lat.Q],
                "dtype": str(np.dtype(cfg.run.dtype)),
                "t": float(state.t), "nprocs": nprocs}
        with open(os.path.join(dirpath, "meta.json"), "w") as f:
            json.dump(meta, f)


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and \
        os.path.exists(os.path.join(path, "meta.json"))


def _stitch(pieces, name, lo, hi, dirpath):
    """The block [lo, hi) of field `name` from the saved pieces that
    overlap it (numpy)."""
    want = tuple(h - l for l, h in zip(lo, hi))
    out, filled = None, None
    for off, fl, key in pieces.get(name, ()):
        data = fl[key]
        a = [max(l, o) for l, o in zip(lo, off)]
        b = [min(h, o + s) for h, o, s in zip(hi, off, data.shape)]
        if any(x >= y for x, y in zip(a, b)):
            continue
        if tuple(off) == tuple(lo) and data.shape == want:
            return data  # the saving mesh's own block
        if out is None:
            out = np.empty(want, data.dtype)
            filled = np.zeros(want, bool)
        dst = tuple(slice(x - l, y - l) for x, y, l in zip(a, b, lo))
        src = tuple(slice(x - o, y - o) for x, y, o in zip(a, b, off))
        out[dst] = data[src]
        filled[dst] = True
    if out is None or not filled.all():
        raise ValueError(f"checkpoint {dirpath} does not cover the {name} "
                         f"block [{lo}, {hi}): missing shard files?")
    return out


def load_sharded(dirpath: str, cfg: Config, mesh=None, device="cuda") -> State:
    """Restore `save_sharded`'s directory exactly, onto `mesh` (a sharded
    state: each of this process's shards stitched from the saved pieces
    and placed on its mesh device, None for the others) or, with no mesh,
    as one state on `device`.  The saving mesh and process count may
    differ from the restoring ones."""
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    _check_grid(cfg, meta["grid"])
    _check_lattices(cfg, meta["lattice_q"])
    _check_dtype(cfg, "state", meta["dtype"])
    g = cfg.grid
    if mesh is None:
        devices = [resolve_device(device)]
        blocks = [(0, g.ny, 0, g.nx)]
    else:
        devices = mesh.each(mesh.device)
        blocks = mesh.each(lambda i: mesh.block(cfg, i))
    pieces = {}
    files = [np.load(p) for p in
             sorted(glob.glob(os.path.join(dirpath, "shard_*.npz")))]
    try:
        for fl in files:
            for key in fl.files:
                name, off_s = key.split("@")
                off = tuple(int(v) for v in off_s.split("_"))
                pieces.setdefault(name, []).append((off, fl, key))

        def lift(name, shape):
            if shape is None:
                return None
            if name not in pieces:
                raise ValueError(f"field {name} not present in {dirpath}")
            out = []
            for dev, block in zip(devices, blocks):
                if block is None:  # another process's shard
                    out.append(None)
                    continue
                y0, ny, x0, nx = block
                lead = len(shape) - 2
                lo = [0] * lead + [y0, x0]
                hi = list(shape[:lead]) + [y0 + ny, x0 + nx]
                out.append(torch.as_tensor(
                    _stitch(pieces, name, lo, hi, dirpath)).to(dev))
            return out if mesh is not None else out[0]

        shapes = _shapes(cfg)
        fields = {k: lift(k, shapes[k]) for k in _POPS + ("phi",)}
    finally:
        for fl in files:
            fl.close()
    t = torch.tensor(meta["t"], dtype=torch_dtype(cfg.run.dtype),
                     device=next(d for d in devices if d is not None))
    return State(**fields, t=t)
