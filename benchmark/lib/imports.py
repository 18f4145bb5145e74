"""The modules a run may not load: JAX, jaxlib, flax and the JAX package
``spsg_tpu``, compared by whole top-level name (the part before the first
dot), so that the port ``spsg_tpu_torch`` passes."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "spsg_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str], banned=FORBIDDEN) -> List[str]:
    """The names whose top-level part is one of ``banned``."""
    return sorted(n for n in names if top_level(n) in banned)


def loaded_forbidden() -> List[str]:
    return forbidden(list(sys.modules))
