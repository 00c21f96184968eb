"""The fused LBM step on the card: hand-written CUDA kernels for Hopper.

Replaces the TPU kernel `build_fused_step` of ekpnp/pallas/fused_step.py
(its `kernel` closure and the `pl.pallas_call`), its three single-device
forms: one step of every active population (collide, fluid bounce-back,
periodic pull stream, scalar wall BCs, E from phi, and the Poisson RHS),
with the RHS plain, or already transformed along x (`hartley_x`), and phi
taken plain or as psi_hx and decoded in the kernel (`phi_hx`).

Design (csrc/fused_step.cu): two launches per step, x fastest.  The
collide launch writes the post-collision populations into a scratch set of
state size (the fluid's reflected pre-collision populations at the plates)
and the RHS: `collide_kernel` (plain RHS, one thread per node) or
`collide_rows_kernel` (the x-Hartley forms, one block per z and tile of y
rows, so the block can take each row's product with the (NX, NX) cas
matrix H in shared memory).  `stream_bc_kernel` pulls from the scratch set
and applies the scalar wall BCs.  The order is the plain step's exactly
(ekpnp_torch/step.py).  The TPU kernel's lane padding, strip sizing, VMEM
knobs and its EKPNP_HXRHS / EKPNP_PHIHX switches have no counterpart: a
CUDA thread indexes any NX and NY, and the form is an argument.

Bound: device-memory bytes.  Per node and step the pair moves 1736 B with
every field on D3Q27 in f32 (776 B with D3Q7 scalars): twice the
population traffic of one fused pass (872 / 392 B).  Fusing the two
launches is the first item of the perf queue.  The x-Hartley forms add
2 NX operations per RHS value and per decoded phi value (30 phi rows per
8-row tile) and one read of H from L2 per block and product.

Build: `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared` of the
source in this checkout into `ekpnp_torch/_build/`, keyed by a hash of the
source and flags, at first use; loaded with ctypes.  A failed build or a
launch error raises.

`fused_step` dispatches on the tensors' device: CUDA tensors launch the
kernels, CPU tensors run the plain version `fused_step_reference`.  There
is no fallback from the card to the plain version.  `launches` counts the
launches of each kernel; it is changed nowhere else.
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
from ..ops.poisson import charge_rhs, phi_from_psi_hx
from ..parallel.fft import _hartley_matrix, hartley_x_local
from ..state import State
from ..step import PostCollision, collide_and_reflect, stream_and_bcs

# the collide forms (plain RHS, hartley_x, phi_hx) and the stream launch
KERNELS = ("collide_kernel", "collide_rows_kernel.hartley_x",
           "collide_rows_kernel.phi_hx", "stream_bc_kernel")
_COLLIDE_FORMS = {(False, False): "collide_kernel",
                  (True, False): "collide_rows_kernel.hartley_x",
                  (True, True): "collide_rows_kernel.phi_hx"}
# launches of each kernel on the card, counted where it is launched
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
            "K", "hn_op", "hn_om", "Kn", "g_op", "g_om", "joule", "volt",
            "volt2")
_ARRAYS27 = ("wf", "ws", "mw", "gjw", "fwics2")
_CBC = {"noflux": 0, "injection": 1, "zerograd-top": 2}
# row-block launch limits, csrc kRowsMax / kSmemMax
ROWS_MAX = 8
SMEM_MAX = 232448

_lib = None
build_info = {}  # seconds, path, log of the build this process loaded


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


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


def library_path() -> str:
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"fused_step_{key}.so")


def build() -> str:
    """Compile the kernel library unless this source's build exists;
    returns its path.  Raises with nvcc's output on failure."""
    path = library_path()
    if os.path.exists(path):
        build_info.update(path=path, seconds=0.0, log="(cached build)")
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_info.update(path=path, seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr)
    return path


def _load():
    """The kernel library, built and loaded at first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    vp, ip, ci = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int
    lib.ekpnp_abi.argtypes = [ip, ip]
    lib.ekpnp_abi.restype = ci
    lib.ekpnp_collide.argtypes = [ci, vp, vp] + [vp] * 10 + [vp]
    lib.ekpnp_collide.restype = ci
    lib.ekpnp_collide_rows.argtypes = [ci, ci, ci, vp, vp] + [vp] * 11 + [vp]
    lib.ekpnp_collide_rows.restype = ci
    lib.ekpnp_stream_bc.argtypes = [ci, vp, vp] + [vp] * 8 + [vp]
    lib.ekpnp_stream_bc.restype = ci
    n_i, n_c = ctypes.c_int(), ctypes.c_int()
    lib.ekpnp_abi(ctypes.byref(n_i), ctypes.byref(n_c))
    want = (len(_INTS), len(_SCALARS) + 27 * len(_ARRAYS27) + 2 * 3 * 27)
    if (n_i.value, n_c.value) != want:
        raise RuntimeError(f"kernel constant blocks {(n_i.value, n_c.value)}"
                           f" != Python packing {want}")
    _lib = lib
    return lib


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
        joule=p.joule, volt=p.voltage, volt2=p.voltage2,
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


def row_block_rows(nx: int, itemsize: int, phi_hx: bool) -> int:
    """y rows per block of collide_rows_kernel: 8, halved while the
    block's shared memory (csrc rows_smem_elems: 8 RHS rows, or for phi_hx
    two windows of 3 x (rows + 2) rows, each of NX values) exceeds the
    227 KB a block may use."""
    rb = ROWS_MAX
    while True:
        rows = 2 * 3 * (rb + 2) if phi_hx else rb
        if rows * nx * itemsize <= SMEM_MAX:
            return rb
        if rb == 1:
            raise ValueError(f"NX={nx} is too wide for the row-block "
                             f"collide's shared memory")
        rb //= 2


# ---------------------------------------------------------------------------
# plain versions (the CPU path; compared with the kernels on the card)
# ---------------------------------------------------------------------------

def collide_reference(cfg: Config, f, h=None, hn=None, g=None, phi=None, *,
                      hartley_x: Optional[bool] = None, phi_hx: bool = False):
    """Plain version of the collide launch: (post_f, post_h, post_hn,
    post_g, rhs); post_f holds the reflected pre-collision walls.
    hartley_x: rhs is the plain RHS times H along x.  phi_hx: `phi` is
    psi_hx, decoded with `phi_from_psi_hx` first."""
    hartley_x = resolve_hartley_x(cfg, hartley_x, phi_hx)
    if phi_hx:
        phi = phi_from_psi_hx(cfg, phi)
    state = State(f=f, h=h, hn=hn, g=g, phi=phi, t=f.new_zeros(()))
    post, macro = collide_and_reflect(cfg, state)
    rhs = (charge_rhs(cfg, macro.charge, macro.chargen)
           if cfg.physics.enable_ek else None)
    if hartley_x:
        rhs = hartley_x_local(rhs)
    return post.f, post.h, post.hn, post.g, rhs


def stream_bc_reference(cfg: Config, pf, ph=None, phn=None, pg=None):
    """Plain version of stream_bc_kernel: (f1, h1, hn1, g1)."""
    return stream_and_bcs(cfg, PostCollision(f=pf, h=ph, hn=phn, g=pg))


def fused_step_reference(cfg: Config, f, h=None, hn=None, g=None, phi=None,
                         *, hartley_x: Optional[bool] = None,
                         phi_hx: bool = False):
    """Plain version of the fused step: (f1, h1, hn1, g1, rhs)."""
    pf, ph, phn, pg, rhs = collide_reference(cfg, f, h, hn, g, phi,
                                             hartley_x=hartley_x,
                                             phi_hx=phi_hx)
    return (*stream_bc_reference(cfg, pf, ph, phn, pg), rhs)


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
        shape = g.shape if q is None else (q,) + g.shape
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_step: {name!r} has shape {tuple(t.shape)},"
                             f" wants {shape}")
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"fused_step: {name!r} is {t.dtype} on {t.device},"
                             f" wants {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_step: {name!r} is not contiguous")
    for name in tensors:
        if tensors[name] is not None and name not in want:
            raise ValueError(f"fused_step: {name!r} is not active in this config")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _empty_like_fields(cfg, like):
    """Population tensors (f, h, hn, g) of this config, uninitialized."""
    shapes = dict(_fields(cfg))
    return tuple(
        torch.empty((shapes[n],) + cfg.grid.shape, dtype=like.dtype,
                    device=like.device) if n in shapes else None
        for n in ("f", "h", "hn", "g"))


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
    lib = _load()
    ints, consts = pack_constants(cfg)
    return (lib, ints, consts, int(like.dtype == torch.float64),
            torch.cuda.current_stream(like.device).cuda_stream)


def collide(cfg: Config, f, h=None, hn=None, g=None, phi=None, post=None, *,
            hartley_x: Optional[bool] = None, phi_hx: bool = False):
    """Collide + fluid bounce-back + RHS: (post_f, post_h, post_hn, post_g,
    rhs).  The form follows `resolve_hartley_x`: the plain RHS
    (collide_kernel), rhs @ H (hartley_x) or, with `phi` holding psi_hx,
    phi decoded in the kernel (phi_hx).  CUDA tensors launch that form's
    kernel, CPU tensors run `collide_reference`.  `post` may hold a
    preallocated population set."""
    hartley_x = resolve_hartley_x(cfg, hartley_x, phi_hx)
    if f.device.type == "cpu":
        _check(cfg, dict(f=f, h=h, hn=hn, g=g, phi=phi), f.device, f.dtype)
        return collide_reference(cfg, f, h, hn, g, phi, hartley_x=hartley_x,
                                 phi_hx=phi_hx)
    lib, ints, consts, is_f64, stream = _prep(
        cfg, dict(f=f, h=h, hn=hn, g=g, phi=phi), f)
    post = post if post is not None else _empty_like_fields(cfg, f)
    rhs = (torch.empty((cfg.grid.nz - 2,) + cfg.grid.shape[1:], dtype=f.dtype,
                       device=f.device) if cfg.physics.enable_ek else None)
    name = _COLLIDE_FORMS[(hartley_x, phi_hx)]
    ins = tuple(map(_ptr, (f, h, hn, g, phi)))
    outs = (*map(_ptr, post), _ptr(rhs))
    with torch.cuda.device(f.device):
        if hartley_x:
            H = _hartley_matrix(cfg.grid.nx, f.dtype, f.device)
            rb = row_block_rows(cfg.grid.nx, f.element_size(), phi_hx)
            _launch(lib.ekpnp_collide_rows, name, is_f64, 2 if phi_hx else 1,
                    rb, ints.ctypes.data, consts.ctypes.data, *ins, _ptr(H),
                    *outs, stream)
        else:
            _launch(lib.ekpnp_collide, name, is_f64, ints.ctypes.data,
                    consts.ctypes.data, *ins, *outs, stream)
    return (*post, rhs)


def stream_bc(cfg: Config, pf, ph=None, phn=None, pg=None, out=None):
    """Pull stream + scalar wall BCs: (f1, h1, hn1, g1).  CUDA tensors
    launch stream_bc_kernel, CPU tensors run `stream_bc_reference`.  `out`
    may hold a preallocated population set (not aliasing the inputs)."""
    if pf.device.type == "cpu":
        _check(cfg, dict(f=pf, h=ph, hn=phn, g=pg), pf.device,
               pf.dtype)
        return stream_bc_reference(cfg, pf, ph, phn, pg)
    lib, ints, consts, is_f64, stream = _prep(
        cfg, dict(f=pf, h=ph, hn=phn, g=pg), pf)
    out = out if out is not None else _empty_like_fields(cfg, pf)
    with torch.cuda.device(pf.device):
        _launch(lib.ekpnp_stream_bc, "stream_bc_kernel", is_f64,
                ints.ctypes.data, consts.ctypes.data,
                *map(_ptr, (pf, ph, phn, pg)), *map(_ptr, out), stream)
    return out


def fused_step(cfg: Config, f, h=None, hn=None, g=None, phi=None,
               out=None, post=None, *, hartley_x: Optional[bool] = None,
               phi_hx: bool = False):
    """One fused step: (f, h, hn, g, phi) -> (f1, h1, hn1, g1, rhs), rhs the
    interior Poisson RHS planes z = 1..NZ-2 (None without EK): the same
    contract as the TPU kernel's `apply`.  `hartley_x` / `phi_hx` choose
    the collide form (`resolve_hartley_x`; the caller passes the resolved
    flag on to the solve as `rhs_hx`).

    CUDA tensors run the two kernels on the current stream; CPU tensors run
    the plain versions.  `post` (scratch) and `out` (f1, h1, hn1, g1) may be
    preallocated population sets that do not alias the inputs."""
    pf, ph, phn, pg, rhs = collide(cfg, f, h, hn, g, phi, post=post,
                                   hartley_x=hartley_x, phi_hx=phi_hx)
    f1, h1, hn1, g1 = stream_bc(cfg, pf, ph, phn, pg, out=out)
    return f1, h1, hn1, g1, rhs
