"""The check that nothing of JAX runs in the benchmark's process.

The port's package name begins with the JAX package's (``geomloss_tpu``
and ``geomloss_tpu_torch``), so names are compared by their top-level part,
before the first dot, whole.
"""

import sys

#: Top-level module names that must not be loaded.
FORBIDDEN = ("jax", "jaxlib", "flax", "geomloss_tpu")


def forbidden_modules(names=None):
    """The loaded modules (``sys.modules`` by default) whose top-level
    name is one of :data:`FORBIDDEN`, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
