"""Transforms for the spectral Poisson solve, single device (port of the
mesh-less parts of ekpnp/parallel/fft.py).

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
and these are their plain versions.  The multi-device (slab / pencil)
forms of the JAX package are not here.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# Contraction subscripts that keep the axis order: A @ H^T along x, a
# z-batched H @ A along y, H @ A along z.
_EINSUM_3D = {0: "kz,zyx->kyx", 1: "ky,zyx->zkx", 2: "zyx,kx->zyk"}


def _contract(mat, a, axis: int):
    """Apply (n, n) `mat` along `axis` of 3-D `a`."""
    args = (a, mat) if axis == 2 else (mat, a)
    return torch.einsum(_EINSUM_3D[axis], *args)


def fft3(a, inverse: bool = False):
    """3-D FFT of (NE, NY, NX) (cuFFT on the card, pocketfft on the CPU)."""
    return (torch.fft.ifftn if inverse else torch.fft.fftn)(a, dim=(0, 1, 2))


def fft2_xy(a, inverse: bool = False):
    """2-D FFT along (y, x) of (NZI, NY, NX)."""
    return (torch.fft.ifftn if inverse else torch.fft.fftn)(a, dim=(1, 2))


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


def hartley2_xy(a):
    """Unnormalized real Hartley transform along (y, x) of real
    (NZI, NY, NX); self-inverse up to 1/(NY*NX)."""
    for ax in (1, 2):
        a = _apply_hartley(a, ax)
    return a


def hartley_y(a):
    """The y stage of hartley2_xy alone, for data whose x axis is already
    in Hartley space (the fused step's hartley_x RHS, psi_hx)."""
    return _apply_hartley(a, 1)


def hartley_x_local(a):
    """One unnormalized x-Hartley stage (`a @ H` along the last axis); the
    plain version of the fused step's in-kernel x products."""
    return _apply_hartley(a, 2)
