"""Input encodings (counterpart of nerftex_tpu/models/encodings.py):
FourierFeatures and mip-NeRF's IntegratedPositionalEncoding.

FourierFeatures keeps the JAX package's band order
``[x, sin(xs), cos(xs)]`` with ``xs[:, k*d + j] = 2^k x[:, j]``: weights
transplanted from a JAX checkpoint depend on it.
"""

import math

import torch

MATMUL_PRECISIONS = ("float32", "bfloat16")


def check_matmul_precision(matmul_precision: str) -> str:
    if matmul_precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {MATMUL_PRECISIONS}, "
                         f"got {matmul_precision!r}")
    return matmul_precision


def round_operand(x: torch.Tensor, matmul_precision: str) -> torch.Tensor:
    """An f32 matmul operand as the dot sees it: unchanged for "float32";
    rounded to bfloat16 (to nearest even) for "bfloat16", which is what an
    f32 ``jnp.dot`` at DEFAULT precision computes with on a TPU."""
    if check_matmul_precision(matmul_precision) == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    return x


class FourierFeatures:
    """gamma(x) = [x, sin(2^k x)_k, cos(2^k x)_k]; out dim d * (2n + 1).

    The JAX package forms the 2^k x block as the matmul ``x @ lift``; with
    ``matmul_precision="bfloat16"`` x enters that product rounded to
    bfloat16, as it does on a TPU (the bench golden frame was rendered so)."""

    def __init__(self, n_freq_bands: int, matmul_precision: str = "float32") -> None:
        self.n_freq_bands = int(n_freq_bands)
        self.matmul_precision = check_matmul_precision(matmul_precision)

    def out_dim(self, in_dim: int) -> int:
        return in_dim * (2 * self.n_freq_bands + 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_freq_bands
        if n == 0:
            return x
        # Multiplying by a power of two is exact, so this broadcast equals
        # the JAX lift matmul bit for bit.
        scales = 2.0 ** torch.arange(n, dtype=x.dtype, device=x.device)
        xr = round_operand(x, self.matmul_precision)
        xs = (xr[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], n * x.shape[-1])
        return torch.cat([x, torch.sin(xs), torch.cos(xs)], -1)


class IntegratedPositionalEncoding:
    """Expected sin/cos of a diagonal Gaussian lifted through the frequency
    ladder (mip-NeRF): input [..., 6] = [mean(3), var(3)], output
    [E sin(y), E cos(y)] of width 6n over y = 2^k mean with variance
    4^k var.  Unlike FourierFeatures, the raw input is not part of it.

    The JAX package lifts the mean by the matmul ``mean @ lift`` and the
    variance by ``var @ (lift * lift)``; both operands enter rounded to
    bfloat16 with ``matmul_precision="bfloat16"``, as on a TPU.  Powers of
    2 and 4 multiply exactly, so the broadcast here is that matmul bit for
    bit."""

    def __init__(self, n_freq_bands: int, matmul_precision: str = "float32") -> None:
        self.n_freq_bands = int(n_freq_bands)
        self.matmul_precision = check_matmul_precision(matmul_precision)

    def out_dim(self, in_dim: int) -> int:
        # Defined for the 6-D (mean, var) input only.
        return 6 * self.n_freq_bands

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_freq_bands
        scales = 2.0 ** torch.arange(n, dtype=x.dtype, device=x.device)
        x = round_operand(x.reshape(-1, 6), self.matmul_precision)
        y = (x[:, None, :3] * scales[:, None]).reshape(-1, 3 * n)
        y_var = (x[:, None, 3:] * (scales * scales)[:, None]).reshape(-1, 3 * n)
        return torch.cat([expected_sin(y, y_var), expected_sin(y + 0.5 * math.pi, y_var)], -1)


def expected_sin(x: torch.Tensor, x_var: torch.Tensor) -> torch.Tensor:
    """E[sin(z)] for z ~ N(x, x_var)."""
    return torch.sin(x) * torch.exp(-0.5 * x_var)
