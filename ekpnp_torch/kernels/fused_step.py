"""The fused LBM step on the card: hand-written CUDA kernels for Hopper.

Replaces the TPU kernel `build_fused_step` of ekpnp/pallas/fused_step.py
(its `kernel` closure and the `pl.pallas_call`) in all five forms: one step
of every active population (collide, fluid bounce-back, periodic pull
stream, scalar wall BCs, E from phi, and the Poisson RHS), with the RHS
plain, or already transformed along x (`hartley_x`), and phi taken plain
or as psi_hx and decoded on the card (`phi_hx`); on one device, or on
one shard of a mesh (`halo`: y-slab; `shard_x`: pencil), where the
neighbours' edge data come in as halo tensors (`PhiHalo` for phi,
post-collision `rows` for the pass and the stream, and on a pencil `cols`
for the pass; parallel/halo.py exchanges them).

Design (csrc/fused_step.cu), x fastest, one thread per node.  The
one-device time loop (kernels/step.py `_chunk`) runs a chunk of n steps
as one `collide` (`collide_kernel`: post-collision populations, the
fluid's reflected pre-collision populations at the plates, and the plain
RHS), n - 1 `fused_pass` launches (`fused_pass_kernel`: the previous
step's post-collision set pulled into each node by the stream's rules,
then the collide of this step on those values: one pass, 872 B per node
all-D3Q27 in f32, 392 B with D3Q7 scalars, against the 1736 / 776 B of a
collide + stream pair) and one `stream_bc` (`stream_bc_kernel`: pull
stream and scalar wall BCs), each collide or pass followed by the solve.
The collide and the pass read each value from device memory once, into
shared memory, and collide from there; the collide's copies are aligned
(16-byte pieces where the node count allows).  The stream reads through
the pass's pull tables, 16 bytes a load and a store where NX allows.
A shard's chunk (parallel/halo.py `make_halo_multi_step`) is cut the same
way, its pass pulling across the shard's edges from the exchanged rows
and columns (`fused_pass_halo_kernel`); a one-step
call (`fused_step`) and a shard's two-launch step (`step_halo`) are a
collide and a stream.  The order of every operation is the plain step's
(ekpnp_torch/step.py), so the chunk equals its two-launch steps bit for
bit.  The x-Hartley forms are composed here from the collide (or the
pass) and the row product `hartley_rows_kernel` (`hartley_rows`: rows @
H, H the (NX, NX) cas matrix, register-tiled on the FMA pipes):
hartley_x takes the product of the RHS rows after the launch; phi_hx
first decodes psi_hx into phi (the product plus the lifting profile, each
row once, a shard's two psi halo rows too).  The TPU kernel's lane
padding, strip sizing, VMEM knobs and its EKPNP_HXRHS / EKPNP_PHIHX
switches have no counterpart: a CUDA thread indexes any NX and NY, and the
form is an argument.

Bound: device-memory bytes (above).  The x-Hartley forms add 2 NX
operations per RHS value and per decoded phi value, and send the rows
they transform through device memory once more (read and written by the
product).

Build: `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared` of the
source in this checkout into `ekpnp_torch/_build/`, one library per
element type (-DEKPNP_REAL=float / double, two nvcc processes started
together), keyed by a hash of the source and flags, at first use; loaded
with ctypes.  A failed build or a launch error raises.

Every wrapper dispatches on the tensors' device, launch by launch: CUDA
tensors launch the kernels, CPU tensors run each launch's plain version
(`collide_reference` with the plain RHS, `fused_pass_reference`,
`hartley_rows_reference`, `stream_bc_reference`), so the CPU runs the
composition the card runs.  There is no fallback from the card to the
plain version.  `launches` counts the launches of each kernel form; it is
changed nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..ops.poisson import PhiHalo, charge_rhs, efield, phi_from_psi_hx
from ..parallel.fft import _hartley_matrix, hartley_x_local
from ..state import State
from ..step import PostCollision, collide_and_reflect, stream_and_bcs

# the collide launch of each form (plain RHS, hartley_x, phi_hx), the
# fused pass of each form, the row product the x-Hartley forms add (every
# launch, any form), and the stream launch, on one device; then the
# collide launch of the same forms on a y-slab shard (.halo), the
# plain-RHS collide on a pencil shard (.shard_x), and the shards' stream
# launch (.halo: stream_bc_halo_kernel; on a pencil the wrap-column repair
# of parallel/halo.py follows); then the shards' fused pass in the same
# forms (.halo, .shard_x: fused_pass_halo_kernel)
KERNELS = ("collide_kernel", "collide_kernel.hartley_x",
           "collide_kernel.phi_hx", "fused_pass_kernel",
           "fused_pass_kernel.hartley_x", "fused_pass_kernel.phi_hx",
           "hartley_rows_kernel", "stream_bc_kernel",
           "collide_kernel.halo", "collide_kernel.hartley_x.halo",
           "collide_kernel.phi_hx.halo", "collide_kernel.shard_x",
           "stream_bc_kernel.halo", "fused_pass_kernel.halo",
           "fused_pass_kernel.hartley_x.halo",
           "fused_pass_kernel.phi_hx.halo", "fused_pass_kernel.shard_x")
_FORMS = {(False, False): "", (True, False): ".hartley_x",
          (True, True): ".phi_hx"}
# launches of each kernel form on the card, counted where it is launched
launches = {name: 0 for name in KERNELS}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_step.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
# --fmad=false: no contraction into fused multiply-adds, so the kernels
# round as their plain version does (f64 golden values hold through them)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# field order of HostInts / HostConsts in csrc/fused_step.cu
_INTS = ("nx", "ny", "nz", "qf", "qs", "ek", "nspec", "thermal", "cbc",
         "joule_on", "wneg_h", "wneg_hn", "wneg_g")
_SCALARS = ("inv_cfl", "half_dt", "dt", "kappa", "rhs_scale", "ext_field",
            "exf", "buoy", "hdx", "hdy", "hdz", "f_tscale", "f_ics2", "f_op",
            "f_om", "f_splus", "f_sminus", "s_tscale", "s_ics2", "h_op", "h_om",
            "K", "hn_op", "hn_om", "Kn", "g_op", "g_om", "joule")
_ARRAYS27 = ("wf", "ws", "mw", "gjw", "fwics2")
_CBC = {"noflux": 0, "injection": 1, "zerograd-top": 2}
# csrc RowsTile: the output tile (rows, columns) one block of
# hartley_rows_kernel computes, by element size
ROWS_TILE = {4: (128, 128), 8: (128, 64)}

# the element type of each library, by the wrappers' is_f64
REALS = {0: "float", 1: "double"}
_libs = None
build_info = {}  # seconds, paths, log of the build this process loaded


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def collide_form(hartley_x: bool, phi_hx: bool,
                 phi_halo: Optional[PhiHalo] = None) -> str:
    """The launch-count name of a collide call."""
    name = "collide_kernel" + _FORMS[(hartley_x, phi_hx)]
    if phi_halo is None:
        return name
    return name + (".shard_x" if phi_halo.xlo is not None else ".halo")


def pass_form(hartley_x: bool, phi_hx: bool, rows=None, cols=None) -> str:
    """The launch-count name of a fused pass: on a shard (edge `rows`) the
    .halo form, on a pencil shard (also `cols`) the .shard_x form."""
    name = "fused_pass_kernel" + _FORMS[(hartley_x, phi_hx)]
    if rows is None:
        return name
    return name + (".shard_x" if cols is not None else ".halo")


def edge_dirs(lat, sign: int, axis: int = 1):
    """The directions of `lat` whose component along `axis` (0 = x, 1 = y)
    is `sign`, in direction order.  Along y: those that pull across the
    y = -1 edge (sign +1) or the y = NY edge (sign -1), the rows a shard's
    stream takes from its neighbours (the kernel's edge_slot table follows
    this order)."""
    return [d for d in range(lat.Q) if int(lat.E[d][axis]) == sign]


def _pad_edges(lat, post, lo, hi, axis):
    """post (Q, NZ, NY, NX) with the neighbours' edge values as planes -1
    and N along `axis` (2: y, 3: x), the directions `edge_dirs(lat, +1 /
    -1, 3 - axis)` taken from lo / hi (n, NZ, the other extent), the other
    directions zero there (nothing reads them)."""
    shape = post.shape[:axis] + post.shape[axis + 1:]
    edge = lambda rows, sign: post.new_zeros(shape).index_copy_(
        0, torch.tensor(edge_dirs(lat, sign, 3 - axis), device=post.device),
        rows).unsqueeze(axis)
    return torch.cat([edge(lo, 1), post, edge(hi, -1)], dim=axis)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the fused step "
                           "kernel is built from csrc/fused_step.cu")
    return found


def library_path(real: str) -> str:
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS + [real]).encode())
    return os.path.join(BUILD_DIR, f"fused_step_{real}_{key.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile the kernel libraries (f32 and f64, one nvcc each, started
    together) unless this source's builds exist; returns {is_f64: path}.
    Raises with nvcc's output on failure."""
    paths = {k: library_path(real) for k, real in REALS.items()}
    todo = [k for k, path in paths.items() if not os.path.exists(path)]
    if not todo:
        build_info.update(paths=paths, seconds=0.0, log="(cached build)")
        return paths
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    tmps, procs = {}, {}
    try:
        for k in todo:
            fd, tmps[k] = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            log = open(tmps[k] + ".log", "w+")
            procs[k] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, f"-DEKPNP_REAL={REALS[k]}", "-o",
                 tmps[k], SOURCE], stdout=log, stderr=subprocess.STDOUT), log)
        logs = {}
        for k, (proc, log) in procs.items():
            proc.wait()
            log.seek(0)
            logs[k] = log.read()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc ({REALS[k]}) failed "
                                   f"({proc.returncode}):\n{logs[k]}")
        for k in todo:
            os.replace(tmps[k], paths[k])
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        for tmp in tmps.values():
            for f in (tmp, tmp + ".log"):
                if os.path.exists(f):
                    os.remove(f)
    build_info.update(paths=paths, seconds=time.perf_counter() - t0,
                      log="".join(logs.values()))
    return paths


def _load():
    """The kernel libraries {is_f64: lib}, built and loaded at first use."""
    global _libs
    if _libs is not None:
        return _libs
    vp, ip, ci = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int
    want = (len(_INTS), len(_SCALARS) + 27 * len(_ARRAYS27) + 2 * 3 * 27)
    libs = {}
    for k, path in build().items():
        lib = ctypes.CDLL(path)
        lib.ekpnp_abi.argtypes = [ip, ip]
        lib.ekpnp_abi.restype = ci
        # pointers: f, h, hn, g, phi + halo (array), post x 4, rhs;
        # stream_bc: {post, lo, hi} x 4 (array), out x 4
        lib.ekpnp_collide.argtypes = [ci, vp, vp] + [vp] * 10 + [vp]
        lib.ekpnp_collide.restype = ci
        # is_f64, bm, bn, blocks, in, H, out, m, nx, lift, rows_per_z, nz,
        # volt, volt2, stream
        ll, dbl = ctypes.c_longlong, ctypes.c_double
        lib.ekpnp_hartley_rows.argtypes = ([ci, ci, ci, ll, vp, vp, vp, ll]
                                           + [ci] * 4 + [dbl, dbl, vp])
        lib.ekpnp_hartley_rows.restype = ci
        lib.ekpnp_stream_bc.argtypes = [ci, vp, vp] + [vp] * 5 + [vp]
        lib.ekpnp_stream_bc.restype = ci
        # is_f64, ints, consts, post (array), phi, out x 4, rhs, stream;
        # the shard's: {post, lo, hi, xlo, xhi} x 4 and phi + halo (arrays)
        for fn in (lib.ekpnp_fused_pass, lib.ekpnp_fused_pass_shard):
            fn.argtypes = [ci, vp, vp, vp, vp] + [vp] * 6
            fn.restype = ci
        n_i, n_c = ctypes.c_int(), ctypes.c_int()
        lib.ekpnp_abi(ctypes.byref(n_i), ctypes.byref(n_c))
        if (n_i.value, n_c.value) != want:
            raise RuntimeError(f"kernel constant blocks {(n_i.value, n_c.value)}"
                               f" != Python packing {want}")
        libs[k] = lib
    _libs = libs
    return libs


# ---------------------------------------------------------------------------
# constants, folded in double on the host
# ---------------------------------------------------------------------------

def pack_constants(cfg: Config):
    """(ints, consts) numpy blocks for the kernels, in the field order of
    HostInts / HostConsts."""
    g = cfg.grid
    p = cfg.physics
    lat, lat_s = cfg.lattice, cfg.scalar_lat
    if p.charge_bc not in _CBC:
        raise ValueError(f"unknown charge_bc {p.charge_bc!r}")
    dt = p.dt(g.dx)
    om = cfg.omegas()
    cs2, cs2_s = cfg.cs2, cfg.cs2_s
    ek, th = p.enable_ek, p.enable_thermal
    nspec = (2 if p.two_species else 1) if ek else 0
    inj = p.charge_bc == "injection"
    ints = dict(nx=g.nx, ny=g.ny, nz=g.nz, qf=lat.Q, qs=lat_s.Q, ek=int(ek),
                nspec=nspec, thermal=int(th), cbc=_CBC[p.charge_bc],
                joule_on=int(th and ek and p.joule != 0.0),
                wneg_h=int(inj), wneg_hn=int(inj), wneg_g=1)
    sc = dict(
        inv_cfl=1.0 / p.cfl, half_dt=0.5 * dt, dt=dt,
        kappa=p.convert_c_to_charge, rhs_scale=p.convert_c_to_charge / p.eps,
        ext_field=p.ext_field, exf=p.exf, buoy=p.rho0 * p.Ra * p.nu * p.D,
        hdx=0.5 / g.dx, hdy=0.5 / g.dy, hdz=0.5 / g.dz,
        f_tscale=1.0 / (cs2 * p.cfl), f_ics2=1.0 / cs2,
        f_op=dt * om["omega_plus"], f_om=dt * om["omega_minus"],
        f_splus=1.0 - 0.5 * dt * om["omega_plus"],
        f_sminus=1.0 - 0.5 * dt * om["omega_minus"],
        s_tscale=1.0 / (cs2_s * p.cfl), s_ics2=1.0 / cs2_s,
        h_op=dt * om["omega_c_plus"], h_om=dt * om["omega_c_minus"], K=p.K,
        hn_op=dt * om["omega_cn_plus"], hn_om=dt * om["omega_cn_minus"],
        Kn=p.Kn, g_op=dt * om["omega_T_plus"], g_om=dt * om["omega_T_minus"],
        joule=p.joule,
    )

    def pad27(a):
        out = np.zeros(27)
        out[: len(a)] = a
        return out

    exq = lat.E[:, 0].astype(float)
    if p.compat_ref_multis and lat.Q > 3:
        exq[3] += 1.0
    ws = lat_s.W
    arrays = dict(
        wf=pad27(lat.W), ws=pad27(ws),
        mw=pad27((2.0 * p.rho0 * p.uw / cs2 / p.cfl) * lat.W * exq),
        gjw=pad27(dt * ws), fwics2=pad27(lat.W * (1.0 / cs2)),
    )
    wadd = np.zeros((3, 2, 27))
    if inj:
        wadd[0, 0] = pad27(2.0 * p.charge0 * ws)
        wadd[0, 1] = pad27(2.0 * p.charge1 * ws)
        wadd[1, 0] = pad27(2.0 * p.charge0n * ws)
        wadd[1, 1] = pad27(2.0 * p.charge1n * ws)
    wadd[2, 0] = pad27(2.0 * p.TH * ws)
    consts = np.concatenate([np.array([sc[k] for k in _SCALARS])]
                            + [arrays[k] for k in _ARRAYS27] + [wadd.ravel()])
    return (np.array([ints[k] for k in _INTS], dtype=np.int32),
            np.ascontiguousarray(consts, dtype=np.float64))


# ---------------------------------------------------------------------------
# the x-Hartley forms
# ---------------------------------------------------------------------------

def resolve_hartley_x(cfg: Config, hartley_x: Optional[bool] = None,
                      phi_hx: bool = False) -> bool:
    """The RHS form a call takes, as the TPU kernel resolves it
    (ekpnp/pallas/fused_step.py build_fused_step): None means on whenever
    the solve consumes an x-Hartley RHS (EK on, fft_method != "fft");
    phi_hx implies it.  The port pads no x axis, so the TPU kernel's
    unpadded-x condition always holds."""
    ek = cfg.physics.enable_ek
    if hartley_x is None:
        hartley_x = phi_hx or (ek and cfg.run.fft_method != "fft")
    if hartley_x and not ek:
        raise ValueError("hartley_x RHS emission needs EK on")
    if phi_hx and not hartley_x:
        raise ValueError("phi_hx ingestion requires hartley_x emission")
    return bool(hartley_x)


def hartley_rows_grid(m: int, nx: int, itemsize: int):
    """(tile rows bm, tile columns bn, blocks) of a hartley_rows_kernel
    launch over m rows of nx values: block b computes the output rows
    (b // nc) bm .. + bm and the columns (b % nc) bn .. + bn, clipped to
    (m, nx), nc = ceil(nx / bn).  The kernel refuses any other."""
    bm, bn = ROWS_TILE[itemsize]
    return bm, bn, -(-m // bm) * -(-nx // bn)


# ---------------------------------------------------------------------------
# plain versions (the CPU path; compared with the kernels on the card)
# ---------------------------------------------------------------------------

def hartley_rows_reference(a, *, lift: Optional[Config] = None):
    """Plain version of hartley_rows_kernel: `a @ H` along the last axis
    (x) of a (NZ', NY, NX) block or (NZ', NX) rows (`hartley_x_local`).
    lift: the config whose lifting profile is added per z (the first axis,
    NZ of the grid): the psi_hx decode `phi_from_psi_hx`."""
    a3 = a if a.dim() == 3 else a[:, None]
    out = (phi_from_psi_hx(lift, a3) if lift is not None
           else hartley_x_local(a3))
    return out.reshape(a.shape)


def collide_reference(cfg: Config, f, h=None, hn=None, g=None, phi=None, *,
                      hartley_x: Optional[bool] = None, phi_hx: bool = False,
                      phi_halo: Optional[PhiHalo] = None):
    """Plain version of the collide launch: (post_f, post_h, post_hn,
    post_g, rhs); post_f holds the reflected pre-collision walls.
    hartley_x: rhs is the plain RHS times H along x.  phi_hx: `phi` is
    psi_hx, decoded with `phi_from_psi_hx` first (its halo rows too).
    phi_halo: a shard's halo; E reads it in place of the local wrap."""
    hartley_x = resolve_hartley_x(cfg, hartley_x, phi_hx)
    if phi_hx:
        phi = hartley_rows_reference(phi, lift=cfg)
        if phi_halo is not None:
            phi_halo = phi_halo._replace(
                ylo=hartley_rows_reference(phi_halo.ylo, lift=cfg),
                yhi=hartley_rows_reference(phi_halo.yhi, lift=cfg))
    state = State(f=f, h=h, hn=hn, g=g, phi=phi, t=f.new_zeros(()))
    E = (efield(cfg, phi, phi_halo)
         if phi_halo is not None and cfg.physics.enable_ek else None)
    post, macro = collide_and_reflect(cfg, state, E=E)
    rhs = (charge_rhs(cfg, macro.charge, macro.chargen)
           if cfg.physics.enable_ek else None)
    if hartley_x:
        rhs = hartley_rows_reference(rhs)
    return post.f, post.h, post.hn, post.g, rhs


def stream_bc_reference(cfg: Config, pf, ph=None, phn=None, pg=None,
                        rows=None, cols=None):
    """Plain version of stream_bc_kernel: (f1, h1, hn1, g1).  rows: on a
    shard, the (lo, hi) post-collision edge rows of each field (f, h, hn,
    g; see stream_bc); cols: on a pencil shard, the (xlo, xhi) edge columns
    of each field, the rows then widened to columns -1 .. NX (see
    fused_pass).  The stream runs on the block padded with them (x first,
    then y), whose inner nodes need no wrap, and keeps the inner nodes."""
    post = PostCollision(f=pf, h=ph, hn=phn, g=pg)
    if rows is None:
        return stream_and_bcs(cfg, post)
    lats = (cfg.lattice,) + (cfg.scalar_lat,) * 3
    cols = cols if cols is not None else (None,) * 4

    def pad(a, lat, r, c):
        if c is not None:
            a = _pad_edges(lat, a, *c, axis=3)
        return _pad_edges(lat, a, *r, axis=2)

    padded = PostCollision(*(None if a is None else pad(a, lat, r, c)
                             for a, lat, r, c in zip(post, lats, rows, cols)))
    crop = (slice(None), slice(None), slice(1, -1),
            slice(1, -1) if cols[0] is not None else slice(None))
    return tuple(None if a is None else a[crop].contiguous()
                 for a in stream_and_bcs(cfg, padded))


def fused_step_reference(cfg: Config, f, h=None, hn=None, g=None, phi=None,
                         *, hartley_x: Optional[bool] = None,
                         phi_hx: bool = False):
    """Plain version of the fused step on one device: (f1, h1, hn1, g1,
    rhs)."""
    pf, ph, phn, pg, rhs = collide_reference(cfg, f, h, hn, g, phi,
                                             hartley_x=hartley_x,
                                             phi_hx=phi_hx)
    return (*stream_bc_reference(cfg, pf, ph, phn, pg), rhs)


def fused_pass_reference(cfg: Config, pf, ph=None, phn=None, pg=None,
                         phi=None, *, hartley_x: Optional[bool] = None,
                         phi_hx: bool = False, rows=None, cols=None,
                         phi_halo: Optional[PhiHalo] = None):
    """Plain version of the fused pass: `stream_bc_reference` of one step's
    post-collision set (on a shard with its edge `rows` and `cols`), then
    `collide_reference` of the next step (with phi, or psi_hx for phi_hx,
    and the shard's `phi_halo`): (post_f, post_h, post_hn, post_g, rhs)."""
    f, h, hn, g = stream_bc_reference(cfg, pf, ph, phn, pg, rows=rows,
                                      cols=cols)
    return collide_reference(cfg, f, h, hn, g, phi, hartley_x=hartley_x,
                             phi_hx=phi_hx, phi_halo=phi_halo)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _fields(cfg: Config, with_phi: bool = True):
    """(name, Q or None for phi) of the tensors this config passes."""
    p = cfg.physics
    qs = cfg.scalar_lat.Q
    out = [("f", cfg.lattice.Q)]
    if p.enable_ek:
        out.append(("h", qs))
        if p.two_species:
            out.append(("hn", qs))
    if p.enable_thermal:
        out.append(("g", qs))
    if p.enable_ek and with_phi:
        out.append(("phi", None))
    return out


def _check_tensor(name, t, shape, device, dtype):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_step: {name!r} has shape {tuple(t.shape)},"
                         f" wants {tuple(shape)}")
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"fused_step: {name!r} is {t.dtype} on {t.device},"
                         f" wants {dtype} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"fused_step: {name!r} is not contiguous")


def _check(cfg: Config, tensors: dict, device, dtype):
    """Every tensor this config needs is present, of its shape, dtype and
    device, and contiguous; no inactive field is passed.  `phi` is checked
    where `tensors` has that key."""
    g = cfg.grid
    if g.nz < 4:
        raise ValueError("the fused step needs nz >= 4")
    want = dict(_fields(cfg, with_phi="phi" in tensors))
    for name, q in want.items():
        t = tensors.get(name)
        if t is None:
            raise ValueError(f"fused_step: {name!r} is required by this config")
        _check_tensor(name, t, g.shape if q is None else (q,) + g.shape,
                      device, dtype)
    for name in tensors:
        if tensors[name] is not None and name not in want:
            raise ValueError(f"fused_step: {name!r} is not active in this config")


def _check_phi_halo(cfg: Config, halo: Optional[PhiHalo], hartley_x: bool,
                    device, dtype):
    """A shard's phi halo: rows (NZ, NX) always, columns (NZ, NY) on a
    pencil, where the x-Hartley forms cannot run (they need x whole)."""
    if halo is None:
        return
    if not cfg.physics.enable_ek:
        raise ValueError("fused_step: phi_halo without EK")
    nz, ny, nx = cfg.grid.shape
    for name in ("ylo", "yhi"):
        _check_tensor(name, getattr(halo, name), (nz, nx), device, dtype)
    if (halo.xlo is None) != (halo.xhi is None):
        raise ValueError("fused_step: phi_halo needs both x columns or none")
    if halo.xlo is not None:
        if hartley_x:
            raise ValueError("fused_step: the x-Hartley forms need x whole; "
                             "a pencil shard (x halo) takes the plain RHS")
        for name in ("xlo", "xhi"):
            _check_tensor(name, getattr(halo, name), (nz, ny), device, dtype)


def _check_rows(cfg: Config, rows, pops, device, dtype, cols=None):
    """A shard's post-collision edge data: rows (lo, hi) per active field,
    of shape (directions with ey = +1 / -1, NZ, NX), or on a pencil
    (`cols` given) NX + 2 wide, with columns (xlo, xhi) per active field,
    (directions with ex = +1 / -1, NZ, NY)."""
    if rows is None:
        if cols is not None:
            raise ValueError("fused_step: x columns without y rows")
        return
    nz, ny, nx = cfg.grid.shape
    lats = (cfg.lattice,) + (cfg.scalar_lat,) * 3
    edges = [("row", rows, 1, nx + (2 if cols is not None else 0))]
    if cols is not None:
        edges.append(("column", cols, 0, ny))
    for kind, pairs, axis, width in edges:
        for name, a, lat, r in zip(("f", "h", "hn", "g"), pops, lats, pairs):
            if (a is None) != (r is None):
                raise ValueError(f"fused_step: {kind}s of {name!r} do not "
                                 f"match its field")
            if a is None:
                continue
            for side, t, sign in (("lo", r[0], 1), ("hi", r[1], -1)):
                _check_tensor(f"{name} {side} {kind}", t,
                              (len(edge_dirs(lat, sign, axis)), nz, width),
                              device, dtype)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _ptrs(*ts):
    """A C array of the tensors' device pointers (NULL for None)."""
    return (ctypes.c_void_p * len(ts))(*map(_ptr, ts))


def _empty_like_fields(cfg, like):
    """Population tensors (f, h, hn, g) of this config, uninitialized."""
    shapes = dict(_fields(cfg))
    return tuple(
        torch.empty((shapes[n],) + cfg.grid.shape, dtype=like.dtype,
                    device=like.device) if n in shapes else None
        for n in ("f", "h", "hn", "g"))


def _check_apart(outs, ins):
    """No output tensor shares storage with an input: a pull reads its
    neighbours' values while other threads write theirs."""
    base = lambda t: t.untyped_storage().data_ptr()
    taken = {base(t) for t in ins if t is not None}
    if any(t is not None and base(t) in taken for t in outs):
        raise ValueError("fused_pass: an output aliases an input")


def _launch(fn, name, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1


def _prep(cfg: Config, tensors: dict, like):
    """Device/dtype/shape checks for a CUDA launch; returns (lib, ints,
    consts, is_f64, stream)."""
    if like.device.type != "cuda":
        raise ValueError(f"fused_step: unsupported device {like.device}")
    if like.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused_step: unsupported dtype {like.dtype}")
    _check(cfg, tensors, like.device, like.dtype)
    is_f64 = int(like.dtype == torch.float64)
    ints, consts = pack_constants(cfg)
    return (_load()[is_f64], ints, consts, is_f64,
            torch.cuda.current_stream(like.device).cuda_stream)


# the cas matrix of each (NX, dtype, device), made once: making it per
# launch (numpy, then a host-to-device copy, which waits for the
# stream) would stall the host in the step loop
_H = {}


def _cas(nx: int, like: torch.Tensor) -> torch.Tensor:
    key = (nx, like.dtype, like.device)
    if key not in _H:
        _H[key] = _hartley_matrix(nx, like.dtype, like.device)
    return _H[key]


def hartley_rows(a, *, lift: Optional[Config] = None):
    """The x-Hartley row product: `a @ H` along the last axis (x) of a
    contiguous (NZ', NY, NX) block or (NZ', NX) rows, H the (NX, NX) cas
    matrix; with `lift` (a config), plus its lifting profile per z (the
    first axis, the grid's NZ): the psi_hx decode.  CUDA tensors launch
    hartley_rows_kernel, CPU tensors run `hartley_rows_reference`."""
    if a.dim() not in (2, 3):
        raise ValueError(f"hartley_rows: wants (NZ, [NY,] NX), got "
                         f"{tuple(a.shape)}")
    if lift is not None and (a.shape[0] != lift.grid.nz
                             or a.shape[-1] != lift.grid.nx):
        raise ValueError(f"hartley_rows: lifted rows {tuple(a.shape)} do "
                         f"not match the grid {lift.grid.shape}")
    if a.device.type == "cpu":
        return hartley_rows_reference(a, lift=lift)
    if a.device.type != "cuda" or a.dtype not in (torch.float32,
                                                  torch.float64):
        raise ValueError(f"hartley_rows: unsupported {a.dtype} on {a.device}")
    if not a.is_contiguous():
        raise ValueError("hartley_rows: the rows are not contiguous")
    nx = a.shape[-1]
    m = a.numel() // nx
    is_f64 = int(a.dtype == torch.float64)
    bm, bn, blocks = hartley_rows_grid(m, nx, a.element_size())
    out = torch.empty_like(a)
    p = lift.physics if lift is not None else None
    with torch.cuda.device(a.device):
        _launch(_load()[is_f64].ekpnp_hartley_rows, "hartley_rows_kernel",
                is_f64, bm, bn, blocks, _ptr(a), _ptr(_cas(nx, a)), _ptr(out),
                m, nx, int(lift is not None), m // a.shape[0], a.shape[0],
                p.voltage if p else 0.0, p.voltage2 if p else 0.0,
                torch.cuda.current_stream(a.device).cuda_stream)
    return out


def _decode(cfg: Config, psi, psi_halo: Optional[PhiHalo]):
    """phi and its halo rows from psi_hx and a slab shard's psi halo rows
    (`hartley_rows` with the lifting profile): the phi_hx forms' first
    launches."""
    phi = hartley_rows(psi, lift=cfg)
    if psi_halo is not None:
        psi_halo = psi_halo._replace(ylo=hartley_rows(psi_halo.ylo, lift=cfg),
                                     yhi=hartley_rows(psi_halo.yhi, lift=cfg))
    return phi, psi_halo


def _collide_plain_rhs(cfg: Config, name: str, f, h, hn, g, phi, post,
                       phi_halo):
    """The collide launch with the plain RHS (collide_kernel, counted as
    `name`), or its plain version for CPU tensors."""
    if f.device.type == "cpu":
        return collide_reference(cfg, f, h, hn, g, phi, hartley_x=False,
                                 phi_halo=phi_halo)
    lib, ints, consts, is_f64, stream = _prep(
        cfg, dict(f=f, h=h, hn=hn, g=g, phi=phi), f)
    post = post if post is not None else _empty_like_fields(cfg, f)
    rhs = (torch.empty((cfg.grid.nz - 2,) + cfg.grid.shape[1:], dtype=f.dtype,
                       device=f.device) if cfg.physics.enable_ek else None)
    halo = phi_halo if phi_halo is not None else PhiHalo(None, None)
    with torch.cuda.device(f.device):
        _launch(lib.ekpnp_collide, name, is_f64, ints.ctypes.data,
                consts.ctypes.data, *map(_ptr, (f, h, hn, g)),
                _ptrs(phi, *halo), *map(_ptr, post), _ptr(rhs), stream)
    return (*post, rhs)


def collide(cfg: Config, f, h=None, hn=None, g=None, phi=None, post=None, *,
            hartley_x: Optional[bool] = None, phi_hx: bool = False,
            phi_halo: Optional[PhiHalo] = None):
    """Collide + fluid bounce-back + RHS: (post_f, post_h, post_hn, post_g,
    rhs).  The form follows `resolve_hartley_x`: the plain RHS, rhs @ H
    (hartley_x: the collide, then `hartley_rows` on the RHS rows) or, with
    `phi` holding psi_hx, phi decoded first (phi_hx: `hartley_rows` with
    the lifting profile, then as hartley_x).  On a shard (`cfg` its local
    grid), `phi_halo` holds the neighbours' rows of phi (psi_hx, decoded
    the same way) and, on a pencil, columns: the .halo / .shard_x forms.
    Each launch runs its kernel on CUDA tensors and its plain version on
    CPU tensors; the collide launch counts under the form's name.  `post`
    may hold a preallocated population set."""
    hartley_x = resolve_hartley_x(cfg, hartley_x, phi_hx)
    _check_phi_halo(cfg, phi_halo, hartley_x, f.device, f.dtype)
    _check(cfg, dict(f=f, h=h, hn=hn, g=g, phi=phi), f.device, f.dtype)
    name = collide_form(hartley_x, phi_hx, phi_halo)
    if phi_hx:
        phi, phi_halo = _decode(cfg, phi, phi_halo)
    *pops, rhs = _collide_plain_rhs(cfg, name, f, h, hn, g, phi, post,
                                    phi_halo)
    if hartley_x:
        rhs = hartley_rows(rhs)
    return (*pops, rhs)


def stream_bc(cfg: Config, pf, ph=None, phn=None, pg=None, out=None,
              rows=None):
    """Pull stream + scalar wall BCs: (f1, h1, hn1, g1).  On a shard,
    `rows` holds one (lo, hi) pair per field (f, h, hn, g; None where
    inactive): the y-neighbours' post-collision rows y = -1 / y = NY, of
    the directions `edge_dirs(lat, +1)` / `edge_dirs(lat, -1)` only,
    (n, NZ, NX) each: the .halo form.  x wraps locally either way.  CUDA
    tensors launch stream_bc_kernel, CPU tensors run
    `stream_bc_reference`.  `out` may hold a preallocated population set
    (not aliasing the inputs)."""
    pops = (pf, ph, phn, pg)
    _check_rows(cfg, rows, pops, pf.device, pf.dtype)
    if pf.device.type == "cpu":
        _check(cfg, dict(f=pf, h=ph, hn=phn, g=pg), pf.device,
               pf.dtype)
        return stream_bc_reference(cfg, pf, ph, phn, pg, rows=rows)
    lib, ints, consts, is_f64, stream = _prep(
        cfg, dict(f=pf, h=ph, hn=phn, g=pg), pf)
    out = out if out is not None else _empty_like_fields(cfg, pf)
    rows = rows if rows is not None else (None,) * 4
    srcs = [t for a, r in zip(pops, rows)
            for t in (a, *(r if r is not None else (None, None)))]
    name = "stream_bc_kernel" if rows[0] is None else "stream_bc_kernel.halo"
    with torch.cuda.device(pf.device):
        _launch(lib.ekpnp_stream_bc, name, is_f64, ints.ctypes.data,
                consts.ctypes.data, _ptrs(*srcs), *map(_ptr, out), stream)
    return out


def _fused_pass_plain_rhs(cfg: Config, name: str, pf, ph, phn, pg, phi,
                          out, rows=None, cols=None, phi_halo=None):
    """The fused pass with the plain RHS (fused_pass_kernel, counted as
    `name`; on a shard fused_pass_halo_kernel), or its plain version
    for CPU tensors."""
    if pf.device.type == "cpu":
        return fused_pass_reference(cfg, pf, ph, phn, pg, phi,
                                    hartley_x=False, rows=rows, cols=cols,
                                    phi_halo=phi_halo)
    lib, ints, consts, is_f64, stream = _prep(
        cfg, dict(f=pf, h=ph, hn=phn, g=pg, phi=phi), pf)
    out = out if out is not None else _empty_like_fields(cfg, pf)
    pops = (pf, ph, phn, pg)
    none2 = (None, None)
    edges = [t for pair in (*(rows or ()), *(cols or ())) for t in pair or ()]
    _check_apart(out, pops + tuple(edges))
    rhs = (torch.empty((cfg.grid.nz - 2,) + cfg.grid.shape[1:],
                       dtype=pf.dtype, device=pf.device)
           if cfg.physics.enable_ek else None)
    with torch.cuda.device(pf.device):
        if rows is None:
            _launch(lib.ekpnp_fused_pass, name, is_f64, ints.ctypes.data,
                    consts.ctypes.data, _ptrs(*pops), _ptr(phi),
                    *map(_ptr, out), _ptr(rhs), stream)
        else:
            srcs = [t for a, r, c in zip(pops, rows, cols or (None,) * 4)
                    for t in (a, *(r or none2), *(c or none2))]
            halo = phi_halo if phi_halo is not None else PhiHalo(None, None)
            _launch(lib.ekpnp_fused_pass_shard, name, is_f64,
                    ints.ctypes.data, consts.ctypes.data, _ptrs(*srcs),
                    _ptrs(phi, *halo), *map(_ptr, out), _ptr(rhs), stream)
    return (*out, rhs)


def fused_pass(cfg: Config, pf, ph=None, phn=None, pg=None, phi=None,
               out=None, *, hartley_x: Optional[bool] = None,
               phi_hx: bool = False, rows=None, cols=None,
               phi_halo: Optional[PhiHalo] = None):
    """One pass of the time loop: the stream of step k-1 and the collide
    of step k.  (pf, ph, phn, pg): step k-1's post-collision set; phi:
    phi_k (psi_hx for phi_hx).  Returns step k's post-collision set and
    RHS (post_f, post_h, post_hn, post_g, rhs), the RHS from step k's
    pre-collision ion moments: what `stream_bc` then `collide` return, bit
    for bit.  The forms compose as `collide`'s do: phi_hx decodes psi by
    `hartley_rows` first (a shard's two psi halo rows too), the x-Hartley
    forms take the RHS product after the pass.

    On a shard (`cfg` its local grid) the pass pulls across its edges:
    `rows` as `stream_bc` takes them, the .halo form, where x wraps
    locally; on a pencil also `cols`, one (xlo, xhi) pair per field (f, h,
    hn, g; None where inactive), the x-neighbours' post-collision columns
    x = -1 / x = NX of the directions `edge_dirs(lat, +1 / -1, axis=0)`,
    (n, NZ, NY) each, with the rows then NX + 2 wide (columns -1 .. NX,
    the corners the diagonal shard's): the .shard_x form.  `phi_halo`
    holds the shard's phi halo as `collide` takes it.  CUDA tensors launch
    fused_pass_kernel, on a shard fused_pass_halo_kernel (counted under
    the form's name), CPU tensors run `fused_pass_reference`.  `out` may
    hold a preallocated population set that does not alias the inputs."""
    hartley_x = resolve_hartley_x(cfg, hartley_x, phi_hx)
    pops = (pf, ph, phn, pg)
    _check_phi_halo(cfg, phi_halo, hartley_x, pf.device, pf.dtype)
    _check_rows(cfg, rows, pops, pf.device, pf.dtype, cols=cols)
    if cfg.physics.enable_ek and (rows is None) != (phi_halo is None):
        raise ValueError("fused_pass: a shard's pass takes edge rows and "
                         "a phi halo together")
    if phi_halo is not None and (cols is None) != (phi_halo.xlo is None):
        raise ValueError("fused_pass: a pencil shard takes x columns of "
                         "the populations and of phi together")
    _check(cfg, dict(f=pf, h=ph, hn=phn, g=pg, phi=phi), pf.device, pf.dtype)
    name = pass_form(hartley_x, phi_hx, rows, cols)
    if phi_hx:
        phi, phi_halo = _decode(cfg, phi, phi_halo)
    *pops, rhs = _fused_pass_plain_rhs(cfg, name, pf, ph, phn, pg, phi, out,
                                       rows, cols, phi_halo)
    if hartley_x:
        rhs = hartley_rows(rhs)
    return (*pops, rhs)


def fused_step(cfg: Config, f, h=None, hn=None, g=None, phi=None, *,
               hartley_x: Optional[bool] = None, phi_hx: bool = False):
    """One fused step: (f, h, hn, g, phi) -> (f1, h1, hn1, g1, rhs), rhs the
    interior Poisson RHS planes z = 1..NZ-2 (None without EK): the same
    contract as the TPU kernel's `apply`.  `hartley_x` / `phi_hx` choose
    the collide form (`resolve_hartley_x`; the caller passes the resolved
    flag on to the solve as `rhs_hx`).

    CUDA tensors run the collide and the stream on the current stream; CPU
    tensors run the plain versions."""
    pf, ph, phn, pg, rhs = collide(cfg, f, h, hn, g, phi,
                                   hartley_x=hartley_x, phi_hx=phi_hx)
    f1, h1, hn1, g1 = stream_bc(cfg, pf, ph, phn, pg)
    return f1, h1, hn1, g1, rhs
