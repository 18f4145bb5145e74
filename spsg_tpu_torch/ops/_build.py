"""Build and load the package's CUDA kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The build
happens at first use (never at import), into ``ops/_build/`` (git-ignored),
and the binary is named by the hash of its source and of the headers beside it,
so a changed source or header is rebuilt and a stale binary is never picked up.
Sources include no PyTorch header, which keeps a build to seconds.

A failed build raises; callers do not fall back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("conv3x3", "conv3x3_dw", "raycast", "tsdf", "depth")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# flags of one source on top of NVCC_FLAGS: the raycaster, the TSDF integrate
# and the depth chain round a * b + c twice, as their plain PyTorch versions do
# (no fused multiply-add but an explicit __fmaf_rn)
SOURCE_FLAGS = {"raycast": ["-fmad=false"], "tsdf": ["-fmad=false"], "depth": ["-fmad=false"]}


def _flags(name: str) -> List[str]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])

_LIBS: Dict[str, ctypes.CDLL] = {}
# per source: {"seconds": float, "ptxas": str (compiler output), "path": str,
# "cached": bool}
BUILD_INFO: Dict[str, dict] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "spsg_tpu_torch: nvcc not found (looked on PATH and under $CUDA_HOME / "
        "/usr/local/cuda); the CUDA kernels cannot be built"
    )


def _out_path(src: str, tag: str, flags: Optional[List[str]] = None) -> str:
    """The binary of ``src``, named by the hash of the source, of the headers
    beside it (``*.cuh``, which sources include) and of the flags (those of
    ``tag`` unless given)."""
    h = hashlib.sha1(" ".join(_flags(tag) if flags is None else flags).encode())
    folder = os.path.dirname(os.path.abspath(src))
    headers = sorted(f for f in os.listdir(folder) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(folder, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{tag}-{h.hexdigest()[:12]}.so")


def _paths(name: str):
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    return src, _out_path(src, name)


def _start_build(name: str, src: Optional[str] = None,
                 flags: Optional[List[str]] = None) -> Optional[dict]:
    """Start nvcc for one source (``csrc/<name>.cu`` unless ``src`` is given,
    with the flags of ``name`` unless ``flags`` are); None if its binary is
    already there."""
    flags = _flags(name) if flags is None else flags
    src, out = _paths(name) if src is None else (src, _out_path(src, name, flags))
    if os.path.isfile(out):
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": "", "path": out, "cached": True})
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *flags, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return {"name": name, "proc": proc, "tmp": tmp, "out": out, "t0": time.time(), "cmd": cmd}


def _finish_build(job: dict) -> None:
    log, _ = job["proc"].communicate()
    if job["proc"].returncode != 0:
        if os.path.exists(job["tmp"]):
            os.remove(job["tmp"])
        raise RuntimeError(
            f"spsg_tpu_torch: building {job['name']}.cu failed "
            f"(exit {job['proc'].returncode}): {' '.join(job['cmd'])}\n{log}"
        )
    os.replace(job["tmp"], job["out"])  # atomic: concurrent processes race safely
    BUILD_INFO[job["name"]] = {
        "seconds": time.time() - job["t0"], "ptxas": log, "path": job["out"], "cached": False,
    }


def build_all(names=SOURCES) -> None:
    """Build every missing library, one nvcc per source, all started together."""
    jobs = [j for j in (_start_build(n) for n in names) if j is not None]
    for j in jobs:
        _finish_build(j)


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if need be. Raises on failure."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_paths(name)[1])
        _LIBS[name] = lib
    return lib


def build_source(src: str, tag: str, source: Optional[str] = None) -> str:
    """Build the CUDA source at path ``src`` (any checkout's) with the
    package's flags for ``csrc/<source>.cu`` (``tag`` unless given: its
    ``SOURCE_FLAGS``) into ``ops/_build/lib<tag>-<hash>.so``; returns that
    path. For measuring another version of a kernel beside this one."""
    flags = _flags(tag if source is None else source)
    job = _start_build(tag, src, flags)
    if job is not None:
        _finish_build(job)
    return _out_path(src, tag, flags)


_SASS_FN = re.compile(r"Function : (\S+)")


def sass_summary(name: str) -> Dict[str, object]:
    """Per kernel of the built ``csrc/<name>.cu``, the number of tensor-core
    instructions (``HMMA``) in its machine code, from ``cuobjdump -sass``;
    {"error": ...} where cuobjdump is missing or fails."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return {"error": f"{tool} not found"}
    proc = subprocess.run([tool, "-sass", _paths(name)[1]], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-300:]}
    out: Dict[str, object] = {}
    cur = None
    for line in proc.stdout.splitlines():
        m = _SASS_FN.search(line)
        if m:
            cur = m.group(1)
            out[cur] = 0
        elif cur is not None and "HMMA" in line:
            out[cur] += 1
    return out


_PTXAS_FN = re.compile(r"Function properties for (\S+)")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_summary(name: str) -> List[dict]:
    """Per kernel, what ``-Xptxas -v`` said when ``name`` was built in this
    process: registers, stack and spills (empty if the binary was cached)."""
    out: List[dict] = []
    cur: Optional[dict] = None
    for line in BUILD_INFO.get(name, {}).get("ptxas", "").splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out
