"""Low-level point samplers driving camera/parameter distributions.

The port's own copy of nerftex_tpu/data/sampler.py (numpy only, the same
draws from the global numpy stream): host-side, stateful enumerators with
the reference's class and constructor surface, each built around one
``_draw(idx)`` hook plus a vectorized ``batch(count)``.  Stratified jitters
the grid point within its cell.
"""

from math import ceil
from typing import Union

import numpy as np

from nerftex_torch.utils import util
from nerftex_torch.utils.util import EasyDict


class Sampler:
    """Base enumerator: d-dimensional draws, n total (-1 = unbounded)."""

    def __init__(self, d: int = 1, n: int = -1, idx: int = 0) -> None:
        self.d = d
        self.n = n
        self.idx = idx

    def _draw(self, idx: int):
        """Value for position `idx`; base class draws nothing."""
        return None

    def __call__(self):
        value = self._draw(self.idx)
        self.idx += 1
        return value

    def batch(self, count: int) -> np.ndarray:
        """Vectorized: the next `count` draws stacked [count, d]."""
        return np.stack([self() for _ in range(count)])

    def done(self) -> bool:
        return self.n >= 0 and self.idx >= self.n


class Independent(Sampler):
    """iid uniform [0,1)^d."""

    def _draw(self, idx: int) -> np.ndarray:
        return np.random.rand(self.d)

    def batch(self, count: int) -> np.ndarray:
        self.idx += count
        return np.random.rand(count, self.d)


class Constant(Sampler):
    """Always the same constant vector."""

    def __init__(self, d: int = 1, n: int = 0, c: Union[float, list] = 0.0, idx: int = 0) -> None:
        super().__init__(d, n, idx)
        self.c = np.full(d, c, float) if np.isscalar(c) else np.asarray(c, float)

    def _draw(self, idx: int) -> np.ndarray:
        return self.c

    def batch(self, count: int) -> np.ndarray:
        self.idx += count
        return np.tile(self.c, (count, 1))


class Grid(Sampler):
    """Enumerate a linearly spaced d-dim lattice covering [0,1)^d.

    Index decomposition is little-endian over axes (axis 0 varies fastest),
    matching the reference's divmod walk (sampler.py:52-55)."""

    def __init__(self, d: int = 1, n: int = -1, idx: int = 0, sample_center: bool = False) -> None:
        super().__init__(d, n, idx)
        self.cells_per_d = ceil(self.n ** (1 / self.d))
        self.cell_size = 1 / self.cells_per_d
        self.sample_center = sample_center

    def _draw(self, idx: int) -> np.ndarray:
        digits = (idx // self.cells_per_d ** np.arange(self.d)) % self.cells_per_d
        x = digits / self.cells_per_d
        return x + self.cell_size / 2 if self.sample_center else x


class Stratified(Grid):
    """Grid cells + uniform jitter inside each cell."""

    def _draw(self, idx: int) -> np.ndarray:
        return super()._draw(idx) + np.random.rand(self.d) * self.cell_size


class Concat(Sampler):
    """Concatenate the draws of two child samplers."""

    def __init__(self, sampler_config_0: EasyDict, sampler_config_1: EasyDict, n: int = -1, idx: int = 0) -> None:
        children = []
        for config in (sampler_config_0, sampler_config_1):
            config = EasyDict(config)
            config.update({"n": n, "idx": idx})
            children.append(util.instantiate(config))
        self.sampler_0, self.sampler_1 = children
        super().__init__(self.sampler_0.d + self.sampler_1.d, n, idx)

    def _draw(self, idx: int) -> np.ndarray:
        return np.concatenate([self.sampler_0(), self.sampler_1()])
