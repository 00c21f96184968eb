"""Transforms for the spectral Poisson solve (port of
ekpnp/parallel/fft.py), on one device or distributed over a mesh.

Complex transforms are `torch.fft` on either device: the JAX package's
DFT-as-matmul backend exists for the TPU, whose FFTs were slow, and is not
carried over.  The real DST-I (z) and Hartley (x, y) stages of the reduced
solve are matrix products (`torch.einsum`, cuBLAS on the card), their
matrices built in float64 with numpy and cached per (extent, dtype, device)
so a time loop copies none of them to the card twice.  Float32 products run
in full float32: the port's entry points switch TF32 off
(device.torch_setup).

`hartley_y` and `hartley_x_local` are the single stages the x-Hartley
route uses (ops/poisson.py rhs_hx / psi_hx): the fused step kernel does
the x stages itself on the card (kernels/fused_step.py hartley_x, phi_hx),
and these are their plain versions.

Distributed forms: given a mesh (parallel/mesh.py), `fft3`, `fft2_xy`,
`hartley2_xy` and `hartley_y` take and return lists of per-shard blocks in
the state's layout (z whole, y and x cut as the mesh cuts them; None for
another process's block).  Each 1-D
stage runs on an axis that is whole on every shard, and all-to-all
repartitions (parallel/collectives.py) move the cut between stages, in the
JAX package's stage order:

  slab ("y",):        (., y, .) --T(z), T(x)--> (y, ., .) --T(y)--> back
                      (fft3); (., y, .) --T(x)--> (., ., y) --T(y)--> back
                      (fft2_xy, hartley2_xy; hartley_y runs the y half)
  pencil ("y", "x"):  (., y, x) --T(z)--> (x, y, .) --T(x)--> (x, ., y)
                      --T(y)--> back (fft3); (., y, x) --> (., (y,x), .)
                      --T(x)--> (., ., (y,x)) --T(y)--> back (fft2_xy,
                      hartley2_xy; hartley_y the y half)

The (y, x) stages take any slab or pencil the mesh divides: a pencil
shard's NYl rows go over its x group as `tensor_split` cuts them (6/5/5 for
16 over 3), and each leg back cuts exactly the pieces its leg out joined
(`_cuts`); a piece may be empty (NYl 2 over 5 x-shards: 1/1/0/0/0), and
an empty block passes every 1-D stage unchanged.  fft3 keeps the JAX
package's divisibility checks.

`hartley_x_local` stays local: x is whole on a slab shard.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .collectives import all_to_all, even_cut

# Contraction subscripts that keep the axis order: A @ H^T along x, a
# z-batched H @ A along y, H @ A along z.
_EINSUM_3D = {0: "kz,zyx->kyx", 1: "ky,zyx->zkx", 2: "zyx,kx->zyk"}


def _contract(mat, a, axis: int):
    """Apply (n, n) `mat` along `axis` of 3-D `a`."""
    args = (a, mat) if axis == 2 else (mat, a)
    return torch.einsum(_EINSUM_3D[axis], *args)


def _check(extent: int, n: int, axis, what: str):
    if extent % n:
        raise ValueError(
            f"{what} extent {extent} must divide mesh '{axis}' size {n} for "
            f"the pencil FFT (choose NZ = 2^k + 1 / power-of-two NX, NY)")


def _local(fn, blocks, axis):
    return [None if b is None else fn(b, axis) for b in blocks]


def _cuts(blocks, mesh):
    """The piece extents of the (y, x) stages' repartitions: `ys`, a
    shard's y rows cut over its x group (a pencil; `even_cut`, so uneven
    where x does not divide them), `rows`, those of every shard in mesh
    order (the joined y), and `cols`, the x cut of the stage between.  The
    way back cuts what the way out joined."""
    b = blocks[mesh.local[0]]
    ny, nx = mesh.grid
    nyl, width = b.shape[1], b.shape[2] * nx
    ys = even_cut(nyl, nx)
    return ys, ys * ny, even_cut(width, ny * nx)


def _xy_stages(blocks, mesh, stage):
    """stage(block, axis) along x, then y, with the mesh's repartitions
    between (the structure of fft2_xy / hartley2_xy)."""
    ys, rows, cols = _cuts(blocks, mesh)
    if not mesh.pencil:
        a = _local(stage, blocks, 2)                    # x whole
        a = all_to_all(mesh, a, "y", 2, 1)              # y -> x
        a = _local(stage, a, 1)                         # y whole
        return all_to_all(mesh, a, "y", 1, 2, cat_sizes=cols)
    a = all_to_all(mesh, blocks, "x", 1, 2)             # (., (y,x), .)
    a = _local(stage, a, 2)                             # x whole
    a = all_to_all(mesh, a, ("y", "x"), 2, 1, cat_sizes=rows)
    a = _local(stage, a, 1)                             # (., ., (y,x)), y whole
    a = all_to_all(mesh, a, ("y", "x"), 1, 2, rows, cols)   # (., (y,x), .)
    return all_to_all(mesh, a, "x", 2, 1, cat_sizes=ys)     # (., y, x)


def _y_stage(blocks, mesh, stage):
    """stage(block, 1) alone, on a mesh (the y half of _xy_stages)."""
    ys, rows, cols = _cuts(blocks, mesh)
    if not mesh.pencil:
        a = all_to_all(mesh, blocks, "y", 2, 1)
        return all_to_all(mesh, _local(stage, a, 1), "y", 1, 2,
                          cat_sizes=cols)
    a = all_to_all(mesh, blocks, "x", 1, 2)
    a = all_to_all(mesh, a, ("y", "x"), 2, 1, cat_sizes=rows)
    a = all_to_all(mesh, _local(stage, a, 1), ("y", "x"), 1, 2, rows, cols)
    return all_to_all(mesh, a, "x", 2, 1, cat_sizes=ys)


def _fft1(a, axis: int, inverse: bool = False):
    if a.numel() == 0:  # an empty piece of an uneven cut: torch.fft refuses it
        return a.to(torch.promote_types(a.dtype, torch.complex64))
    return (torch.fft.ifft if inverse else torch.fft.fft)(a, dim=axis)


def fft3(a, mesh=None, inverse: bool = False):
    """3-D FFT of (NE, NY, NX) (cuFFT on the card, pocketfft on the CPU);
    distributed over `mesh` when one is given (a list of blocks)."""
    if mesh is None:
        return (torch.fft.ifftn if inverse else torch.fft.fftn)(a,
                                                               dim=(0, 1, 2))
    stage = lambda b, ax: _fft1(b, ax, inverse)
    ny, nx = mesh.grid
    ne, nyl, nxl = a[mesh.local[0]].shape
    _check(ne, ny, "y", "extended z")
    if not mesh.pencil:
        b = _local(stage, _local(stage, a, 0), 2)       # z, x whole
        b = all_to_all(mesh, b, "y", 0, 1)              # y -> z
        b = _local(stage, b, 1)                         # y whole
        return all_to_all(mesh, b, "y", 1, 0)
    _check(ne, nx, "x", "extended z")
    _check(nxl * nx, ny, "y", "x")
    b = _local(stage, a, 0)                             # z whole
    b = all_to_all(mesh, b, "x", 0, 2)                  # (x, y, .)
    b = _local(stage, b, 2)                             # x whole
    b = all_to_all(mesh, b, "y", 2, 1)                  # (x, ., y)
    b = _local(stage, b, 1)                             # y whole
    b = all_to_all(mesh, b, "y", 1, 2)                  # (x, y, .)
    return all_to_all(mesh, b, "x", 2, 0)               # (., y, x)


def fft2_xy(a, mesh=None, inverse: bool = False):
    """2-D FFT along (y, x) of (NZI, NY, NX); distributed over `mesh` when
    one is given."""
    if mesh is None:
        return (torch.fft.ifftn if inverse else torch.fft.fftn)(a, dim=(1, 2))
    return _xy_stages(a, mesh, lambda b, ax: _fft1(b, ax, inverse))


@lru_cache(maxsize=None)
def _dst1_np(n: int) -> np.ndarray:
    """B[m-1, z-1] = sin(pi m z / (n+1)), m, z = 1..n; self-inverse up to
    (n+1)/2."""
    mz = np.arange(1, n + 1)
    return np.sin(np.pi * mz[:, None] * mz[None, :] / (n + 1))


@lru_cache(maxsize=None)
def _dst1_matrix(n: int, dtype: torch.dtype, device: torch.device):
    return torch.as_tensor(_dst1_np(n)).to(device=device, dtype=dtype)


@lru_cache(maxsize=None)
def _dst1_padded_matrix(n: int, dtype: torch.dtype, device: torch.device):
    B = np.zeros((n + 2, n))
    B[1:-1] = _dst1_np(n)
    return torch.as_tensor(B).to(device=device, dtype=dtype)


def dst_z(a):
    """DST-I along axis 0 of real (NZI, NY, NX)."""
    return _contract(_dst1_matrix(a.shape[0], a.dtype, a.device), a, 0)


def dst_z_padded(a):
    """Inverse-stage DST-I along axis 0 whose output carries one zero row at
    each end: the wall planes z=0 and z=NZ-1, which the caller overwrites
    with the plate potentials."""
    return _contract(_dst1_padded_matrix(a.shape[0], a.dtype, a.device), a, 0)


@lru_cache(maxsize=None)
def _hartley_matrix(n: int, dtype: torch.dtype, device: torch.device):
    """H[k, j] = cas(2 pi j k / n) = cos + sin; real, symmetric, H @ H = n I.
    For a symbol even in the frequency index (kx^2, ky^2) Hartley-space
    filtering equals DFT filtering."""
    jk = np.outer(np.arange(n), np.arange(n)) * (2.0 * np.pi / n)
    return torch.as_tensor(np.cos(jk) + np.sin(jk)).to(device=device,
                                                         dtype=dtype)


def _apply_hartley(a, axis: int):
    return _contract(_hartley_matrix(a.shape[axis], a.dtype, a.device), a, axis)


def hartley2_xy(a, mesh=None):
    """Unnormalized real Hartley transform along (y, x) of real
    (NZI, NY, NX); self-inverse up to 1/(NY*NX).  Distributed over `mesh`
    when one is given."""
    if mesh is not None:
        return _xy_stages(a, mesh, _apply_hartley)
    for ax in (1, 2):
        a = _apply_hartley(a, ax)
    return a


def hartley_y(a, mesh=None):
    """The y stage of hartley2_xy alone, for data whose x axis is already
    in Hartley space (the fused step's hartley_x RHS, psi_hx)."""
    if mesh is not None:
        return _y_stage(a, mesh, _apply_hartley)
    return _apply_hartley(a, 1)


def hartley_x_local(a):
    """One unnormalized x-Hartley stage (`a @ H` along the last axis); the
    plain version of the fused step's x products (hartley_rows_kernel)."""
    return _apply_hartley(a, 2)
