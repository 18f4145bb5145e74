"""Device operations by layer: each file ``layers/<key>.json`` names a layer
(``layer``, as PERF.md's list of layers has it), a ``priority`` (lower is
tried first) and substrings of the kernel names it takes (``patterns``,
compared in lower case; ``""`` takes every name). A later kernel with a new
name is an added file."""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, List, Tuple


def load(root: str) -> List[Tuple[int, str, List[str]]]:
    out = []
    for path in sorted(glob.glob(os.path.join(root, "layers", "*.json"))):
        with open(path) as f:
            d = json.load(f)
        out.append((int(d["priority"]), d["layer"], [p.lower() for p in d["patterns"]]))
    out.sort(key=lambda t: t[0])
    return out


def classifier(root: str) -> Callable[[str], str]:
    table = load(root)

    def classify(name: str) -> str:
        k = name.lower()
        for _, layer, patterns in table:
            if any(p in k for p in patterns):
                return layer
        return "unclassified"

    return classify
