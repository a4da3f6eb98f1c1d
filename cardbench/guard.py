"""The import guard: nothing the benchmark runs may load JAX or the JAX
package.  Names are compared whole, by their top-level part: the port
``repro_torch`` is not the JAX package ``repro``."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))
