"""The check that no JAX module is loaded in the run's process.

Names are compared whole by their top-level package (the part before the
first dot): the port, `hilcodec_tpu_torch`, begins with the JAX
package's name, `hilcodec_tpu`, and is not it."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hilcodec_tpu"})


class Forbidden(RuntimeError):
    def __init__(self, found: List[str]):
        super().__init__(f"forbidden modules loaded: {', '.join(found)}")
        self.found = found


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & FORBIDDEN)
