"""What a run may not load: the JAX package, JAX itself and the libraries
around it, compared by the whole top-level name of each module (the part
before the first dot), since the port's name begins with the JAX
package's."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pygradflow_tpu"})


def forbidden_loaded(modules=None):
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
