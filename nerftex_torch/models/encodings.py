"""Input encodings (counterpart of nerftex_tpu/models/encodings.py).

FourierFeatures keeps the JAX package's band order
``[x, sin(xs), cos(xs)]`` with ``xs[:, k*d + j] = 2^k x[:, j]``: weights
transplanted from a JAX checkpoint depend on it.
"""

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
