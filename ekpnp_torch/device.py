"""Device and dtype resolution for the port's entry points.

Every public entry point takes `device`, default "cuda".  Without a CUDA
device it raises: the CPU is used only when the caller asks for it
(`device="cpu"`, as the tests do).  There is no silent fallback.

Matrix products stay in full float32 on the card: TF32 would cost the
Hartley/DST stages of the spectral solve about three decimal digits, so
`torch_setup` switches it off for matmuls and convolutions alike.
"""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_setup() -> None:
    """Full-precision float32 matrix products (no TF32) for the solve."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ekpnp_torch: no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    torch_setup()
    return dev


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a RunConfig dtype name ("float32" | "float64")."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} (float32 | float64)")
