"""Per-shard field dumps of a sharded run and their offline merge (port of
ekpnp/io/fields.py).

A sharded run (`run --mesh`) writes, at each save event, the fields of
every shard to `fields_NNNNNN.shards/shard_<pid>.npz` instead of gathering
a tecplot zone: keys `name@o0_o1_..` with each block's global start
offsets (0 on the unsharded leading axes), and `meta.json` with the grid,
t and the process count.  That is the JAX package's format exactly, so
either package's `merge_run_dir` reads either's dumps, and `merge` writes
the data.dat (and data_end.dat / .npz) a single-device run would have
written.  Each process of a distributed run writes the shards it holds
(pid = its rank, nprocs = the world size); one process holds them all.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from ..config import Config
from ..state import Macro
from .checkpoint import save_npz, save_reference_ascii
from .tecplot import write_zone
from .vtk import write_vtk


def save_fields_sharded(dirpath: str, cfg: Config, mesh, macros, phi, E,
                        t: float, pid: int = 0, nprocs: int = 1) -> None:
    """Write the shards of the save-cadence fields to
    `dirpath`/shard_<pid>.npz (uncompressed) and, from process 0,
    meta.json.  macros: per shard `Macro`; phi, E: per shard tensors or
    numpy arrays (None without EK); a shard of another process is None
    in each."""
    os.makedirs(dirpath, exist_ok=True)
    payload = {}

    def put(name, shards):
        if shards is None:
            return
        for i, a in enumerate(shards):
            if a is None:  # another process's shard, or an absent field
                continue
            y0, _, x0, _ = mesh.block(cfg, i)
            off = [0] * (a.ndim - 2) + [y0, x0]
            payload[f"{name}@{'_'.join(map(str, off))}"] = (
                a.detach().cpu().numpy() if hasattr(a, "detach")
                else np.asarray(a))

    for name in Macro._fields:
        put(name, [None if m is None else getattr(m, name) for m in macros])
    put("phi", phi)
    put("E", E)
    np.savez(os.path.join(dirpath, f"shard_{pid}.npz"), **payload)
    if pid == 0:
        g = cfg.grid
        meta = {"grid": [g.nx, g.ny, g.nz], "t": float(t), "nprocs": nprocs}
        with open(os.path.join(dirpath, "meta.json"), "w") as f:
            json.dump(meta, f)


def _assemble(dirpath: str, cfg: Config):
    """Read every shard file of one dump dir and stitch the global numpy
    fields: (Macro, phi, E, t)."""
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    g = cfg.grid
    if tuple(meta["grid"]) != (g.nx, g.ny, g.nz):
        raise ValueError(f"dump grid {tuple(meta['grid'])} != config grid "
                         f"{(g.nx, g.ny, g.nz)}")
    vec = (3,) + g.shape
    shapes = dict(rho=g.shape, u=vec, charge=g.shape, chargen=g.shape,
                  temp=g.shape, phi=g.shape, E=vec)
    out, filled = {}, {}
    for p in sorted(glob.glob(os.path.join(dirpath, "shard_*.npz"))):
        with np.load(p) as fl:
            for key in fl.files:
                name, off_s = key.split("@")
                off = tuple(int(v) for v in off_s.split("_"))
                data = fl[key]
                if name not in out:
                    out[name] = np.empty(shapes[name], data.dtype)
                    filled[name] = np.zeros(shapes[name], bool)
                dst = tuple(slice(o, o + s) for o, s in zip(off, data.shape))
                out[name][dst] = data
                filled[name][dst] = True
    for name, mask in filled.items():
        if not mask.all():
            raise ValueError(f"dump {dirpath} does not cover field {name}: "
                             f"missing shard files?")
    macro = Macro(*(out.get(k) for k in Macro._fields))
    return macro, out.get("phi"), out.get("E"), float(meta["t"])


def list_dump_dirs(outdir: str) -> list[str]:
    """fields_NNNNNN.shards dump dirs under a run dir, in step order."""
    dirs = glob.glob(os.path.join(outdir, "fields_*.shards"))
    return sorted(dirs, key=lambda d: int(
        os.path.basename(d)[len("fields_"):-len(".shards")]))


def merge_run_dir(outdir: str, cfg: Config, data_path: str = None,
                  end_path: str = None, end_npz_path: str = None,
                  vtk: bool = False) -> int:
    """Assemble every per-shard dump under `outdir` into the artifacts a
    non-sharded run writes: the tecplot zones (data.dat) and, from the last
    dump, data_end.dat and data_end.npz; vtk=True also writes
    fieldsNNNNNN.vtk per dump (what `run --vtk` writes without a mesh).
    Returns the number of zones."""
    dirs = list_dump_dirs(outdir)
    if not dirs:
        raise ValueError(f"no fields_*.shards dumps under {outdir}")
    data_path = data_path or os.path.join(outdir, "data.dat")
    with open(data_path, "w") as fout:
        for i, d in enumerate(dirs):
            macro, phi, E, t = _assemble(d, cfg)
            write_zone(fout, cfg, macro, phi, E, t, first=(i == 0))
            if vtk:
                step = os.path.basename(d)[len("fields_"):-len(".shards")]
                write_vtk(os.path.join(outdir, f"fields{step}.vtk"), cfg,
                          macro, phi, E, t)
    save_reference_ascii(end_path or os.path.join(outdir, "data_end.dat"),
                         cfg, macro, phi, E, t)
    save_npz(end_npz_path or os.path.join(outdir, "data_end.npz"), cfg, macro,
             phi, E, t)
    return len(dirs)
