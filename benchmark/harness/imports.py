"""The check that no JAX code is loaded in a run.

A module counts by its top-level name, the part before the first dot,
compared whole: ``nerftex_torch`` is the port and passes, ``nerftex_tpu``
is the JAX package and does not.  ``network``, ``instancer``, ``util`` and
``data`` are the repository's shim packages, which resolve into the JAX
package.
"""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nerftex_tpu", "network", "instancer", "util",
             "data")


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
