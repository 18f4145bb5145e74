"""Reference-style parameter-file reader (datagen config system,
reference datagen/src/GlobalAppState.h:11-78 X-macro reader over
zParametersScanMP.txt).

Supports the reference syntax: ``name = value;`` lines with ``//`` comments,
bools (true/false), ints, floats with an optional ``f`` suffix, and quoted
strings. Existing zParameters files drive the datagen CLI
unchanged."""

from __future__ import annotations

import re
from typing import Any, Dict

_LINE = re.compile(r"^\s*([A-Za-z_][\w]*)\s*=\s*(.+?)\s*;?\s*$")


def _parse_value(raw: str) -> Any:
    raw = raw.strip().rstrip(";").strip()
    if raw.lower() == "true":
        return True
    if raw.lower() == "false":
        return False
    if raw.startswith('"') and raw.endswith('"'):
        return raw[1:-1]
    m = re.fullmatch(r"[-+]?\d+", raw)
    if m:
        return int(raw)
    m = re.fullmatch(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?f?", raw)
    if m:
        return float(raw.rstrip("fF"))
    return raw


def load_parameter_file(path: str) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    for line in open(path):
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = _LINE.match(line)
        if m:
            params[m.group(1)] = _parse_value(m.group(2))
    return params


def scan_configs_from_params(params: Dict[str, Any]):
    """Map reference parameter names onto the datagen configs."""
    from . import fusion, scan

    fusion_cfg = fusion.FusionConfig(
        voxelsize=float(params.get("s_voxelSize", 0.02)),
        depth_min=float(params.get("s_minDepth", 0.4)),
        depth_max=float(params.get("s_maxDepth", 4.0)),
        scene_pad=int(params.get("s_scenePadding", 3)),
        height_pad=int(params.get("s_heightPad", 3)),
    )
    scan_cfg = scan.ScanConfig(
        width=int(params.get("s_renderWidth", 320)),
        height=int(params.get("s_renderHeight", 256)),
        depth_min=float(params.get("s_minDepth", 0.4)),
        depth_max=float(params.get("s_maxDepth", 4.0)),
        chance_drop_frames=float(params.get("s_chanceDropFrames", 0.8)),
    )
    return fusion_cfg, scan_cfg
