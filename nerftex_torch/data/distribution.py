"""Camera/parameter distributions (host-side numpy).

The port's own copy of nerftex_tpu/data/distribution.py, with the same
draws: Sphere restricted by (u, v) ranges (area-uniform), Hemisphere, AABB
box, Constant cycling, Range sweep and Concat, each a ``_map(u)`` of its
sampler's draw (data.sampler), which owns all state.  RenderSession draws
a config's default frame parameters from them.
"""

from typing import Union

import numpy as np

from nerftex_torch.utils import util
from nerftex_torch.utils.util import EasyDict

_DEFAULTS = {
    "independent2": {"module": "data.sampler.Independent", "d": 2},
    "independent3": {"module": "data.sampler.Independent", "d": 3},
}


class Distribution:
    def __init__(self, sampler_config: EasyDict) -> None:
        self.sampler = util.instantiate(sampler_config)

    def _map(self, u: np.ndarray) -> np.ndarray:
        return u

    def __call__(self) -> np.ndarray:
        return self._map(self.sampler())


class Sphere(Distribution):
    """Area-uniform points on the unit sphere within (u, v) sub-ranges —
    u maps linearly to z in [-1, 1], v to azimuth in [0, 2pi)."""

    def __init__(self, sampler_config: EasyDict = None, u_range: list = (0, 1.0), v_range: list = (0, 1.0)) -> None:
        super().__init__(sampler_config or EasyDict(_DEFAULTS["independent2"]))
        self._z_lo, self._z_hi = (1 - 2 * u for u in u_range)
        self._az_lo, self._az_hi = (2 * np.pi * v for v in v_range)

    def _map(self, u: np.ndarray) -> np.ndarray:
        z = self._z_lo + u[0] * (self._z_hi - self._z_lo)
        az = self._az_lo + u[1] * (self._az_hi - self._az_lo)
        ring = np.sqrt(max(1.0 - z * z, 0.0))
        return np.array([np.cos(az) * ring, np.sin(az) * ring, z])


def Hemisphere(axis=2, **kwargs):
    """Area-uniform points on the +axis hemisphere."""
    ranges = {
        0: {"v_range": [-0.25, 0.25]},
        1: {"v_range": [0, 0.5]},
        2: {"u_range": [0, 0.5]},
    }[axis]
    return Sphere(**ranges, **kwargs)


class AABB(Distribution):
    """Uniform points in the box [b_0, b_1]."""

    def __init__(self, sampler_config: EasyDict = None, b_0: Union[float, list] = 0.0, b_1: Union[float, list] = 1.0) -> None:
        super().__init__(sampler_config or EasyDict(_DEFAULTS["independent3"]))
        self._lo = np.asarray(b_0, float)
        self._hi = np.asarray(b_1, float)

    def _map(self, u: np.ndarray) -> np.ndarray:
        return self._lo + u * (self._hi - self._lo)


class Constant(Distribution):
    """Cycle through a list of constant vectors."""

    def __init__(self, constants: list = ((0,),)) -> None:
        super().__init__(EasyDict({"module": "data.sampler.Sampler", "n": len(constants)}))
        self._values = np.asarray(constants)

    def __call__(self) -> np.ndarray:
        value = self._values[self.sampler.idx % len(self._values)]
        self.sampler()
        return value


def Range(n: int = 128, b_0: Union[float, list] = 0.0, b_1: Union[float, list] = 1.0):
    """Grid sweep of [b_0, b_1] (the reference's parameter-sweep helper)."""
    return AABB(EasyDict({"module": "data.sampler.Grid", "n": n}), b_0, b_1)


class Concat(Distribution):
    """Concatenation of two distributions' draws; its nominal size is the
    larger child's (-1 if either is unbounded)."""

    def __init__(self, distribution_config_0: EasyDict, distribution_config_1: EasyDict) -> None:
        self.distribution_0 = util.instantiate(distribution_config_0)
        self.distribution_1 = util.instantiate(distribution_config_1)
        sizes = (self.distribution_0.sampler.n, self.distribution_1.sampler.n)
        size = -1 if -1 in sizes else max(sizes)
        super().__init__(EasyDict({"module": "data.sampler.Sampler", "n": size}))

    def __call__(self) -> np.ndarray:
        self.sampler()
        return np.concatenate([self.distribution_0(), self.distribution_1()])
