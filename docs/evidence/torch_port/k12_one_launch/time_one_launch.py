"""Times two designs that the package did not keep against the ones it did,
on one GPU at the training step's shapes: K12 (the ray set-up) as one
cooperative launch against the package's two launches (a box kernel, then a
thread-a-ray kernel started by programmatic dependent launch), and the fill
with K11 as its last phase without the fill kernel's register cap against
the package's capped kernel.

``k12_one_launch.cu.part`` (beside this file) is spliced into
``spsg_tpu_torch/ops/csrc/raycast.cu`` in place of the package's K12, and the
fill without its cap is ``depth.cu`` with the second argument of the fill
kernel's ``__launch_bounds__`` removed; both are built with the package's
flags into ``spsg_tpu_torch/ops/_build/``. Each variant is held to the plain
versions to the bit first (the set-up on chip_smoke.py's five set-up cases,
the chain on its seven frame cases), then timed in turns with the package's
(package, variant, variant, package; chip_smoke.py's time_in_turns, calls
queued behind a spin of the card) on the step's input grid and frames
(chip_smoke.py's path_batch). Prints one JSON object a line, the card's name
and power limit first.

Run from the repository root:
    python3 docs/evidence/torch_port/k12_one_launch/time_one_launch.py
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..", ".."))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from spsg_tpu_torch.ops import _build, depth as depth_ops, raycast as rc_ops  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ENTRY = "// ---------------------------------------------------------- entry\n\n"
PARTIAL_BLOCKS = 128  # kSetupReducers of the one-launch K12
UNCAPPED = ("__launch_bounds__(kThreads, S == kSlots ? 5 : 1)", "__launch_bounds__(kThreads)")


def write_source(name, text):
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def one_launch_library():
    text = open(os.path.join(_build.CSRC_DIR, "raycast.cu")).read()
    kernels, entry = open(os.path.join(HERE, "k12_one_launch.cu.part")).read().split(ENTRY)
    a = text.index("// ------------------------------------------------------------------- K12")
    b = text.index("unsigned blocks_for(long long n)")
    c = text.index("// K12. `valid` (B, Z, Y, X) bytes")
    d = text.index('}  // extern "C"')
    text = ("#include <cooperative_groups.h>\nnamespace cg = cooperative_groups;\n" + text[:a]
            + kernels + text[b:c] + entry + text[d:])
    path = _build.build_source(write_source("raycast_one_launch", text), "raycast_one_launch",
                               source="raycast")
    lib = rc_ops._bind(ctypes.CDLL(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.spsg_raycast_setup_one_launch.restype = i
    lib.spsg_raycast_setup_one_launch.argtypes = [p] * 4 + [i] + [p] * 5 + [i] * 6 + [f] * 4 + [p]
    return lib


def one_launch_setup(lib, valid, view, intr, cfg):
    B, Z, Y, X = valid.shape
    P, dev = cfg.width * cfg.height, valid.device
    partials = torch.empty(6 * B * PARTIAL_BLOCKS, dtype=torch.int32, device=dev)
    origin = torch.empty((B, 3), dtype=torch.float32, device=dev)
    direction = torch.empty((B, P, 3), dtype=torch.float32, device=dev)
    cam_z, t0, t_stop = (torch.empty((B, P), dtype=torch.float32, device=dev) for _ in range(3))
    err = lib.spsg_raycast_setup_one_launch(
        valid.data_ptr(), view.data_ptr(), intr.data_ptr(), partials.data_ptr(), partials.numel(),
        origin.data_ptr(), direction.data_ptr(), cam_z.data_ptr(), t0.data_ptr(),
        t_stop.data_ptr(), B, Z, Y, X, P, cfg.width, cfg.depth_min, cfg.depth_max,
        cfg.ray_increment, rc_ops.recip_const(cfg.ray_increment),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise SystemExit(f"one-launch K12 failed with error {err}")
    return rc_ops.MarchSetup(origin, direction, cam_z, t0, t_stop)


def uncapped_fill_library():
    """The fill without its register cap; the package's depth.cu is built once
    more as "depth_capped" so that this process sees the compiler's report of
    both."""
    text = open(os.path.join(_build.CSRC_DIR, "depth.cu")).read()
    if UNCAPPED[0] not in text:
        raise SystemExit("depth.cu: the fill kernel's register cap was not found")
    _build.build_source(write_source("depth_capped", text), "depth_capped", source="depth")
    path = _build.build_source(write_source("depth_uncapped", text.replace(*UNCAPPED)),
                               "depth_uncapped", source="depth")
    return depth_ops._bind(ctypes.CDLL(path))


def on_depth_library(fn, lib):
    def run():
        depth_ops._library()
        saved = depth_ops._libs["depth"]
        depth_ops._libs["depth"] = lib
        try:
            return fn()
        finally:
            depth_ops._libs["depth"] = saved
    return run


def fill_registers(tag):
    return [{k: d.get(k) for k in ("registers", "spill_stores", "spill_loads")}
            for d in _build.ptxas_summary(tag) if "depth_fill_kernelILi4" in d["kernel"]]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_one_launch.py: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build_all(("raycast", "depth"))
    one, uncapped = one_launch_library(), uncapped_fill_library()
    bt = cs.path_batch()
    view, intr = cs.to_dev(bt["images_view"]), cs.to_dev(bt["images_intrinsic"])
    cfg = rc_ops.RaycastConfig(width=bt["images_depth"].shape[2], height=bt["images_depth"].shape[1])
    cases = cs.setup_cases(bt, view, intr)
    bits = {name: cs.bits_differing(one_launch_setup(one, v, w, i, cfg),
                                    rc_ops.march_setup_plain(v, w, i, cfg))
            for name, (v, w, i) in cases.items()}
    if any(bits.values()):
        raise SystemExit(f"one-launch K12 differs from march_setup_plain: {bits}")
    valid = cases["input"][0]
    rec = dict(what="K12 one launch (variant) against two launches (package)",
               bits_differing=bits, stream_ops=cs.stream_ops(
                   lambda: one_launch_setup(one, valid, view, intr, cfg)),
               kernels_ms=cs.kernel_split_ms(lambda: one_launch_setup(one, valid, view, intr, cfg)),
               package_kernels_ms=cs.kernel_split_ms(lambda: rc_ops.march_setup(valid, view, intr,
                                                                                cfg)))
    cs.time_in_turns(lambda: rc_ops.march_setup(valid, view, intr, cfg),
                     lambda: one_launch_setup(one, valid, view, intr, cfg), 20, rec)
    rec["variant_ms"] = rec.pop("baseline_ms")
    print(json.dumps(rec), flush=True)

    depth = cs.to_dev(bt["images_depth"])
    bits = {}
    for name, d in cs.depth_cases(depth).items():
        filled, ok = depth_ops.fill_depth_holes_plain(d, 40)
        bits[name] = cs.bits_differing(
            on_depth_library(lambda: depth_ops.depth_to_normals(d, intr, 40), uncapped)(),
            (depth_ops.unproject_normals_plain(filled, intr), filled, ok))
    if any(bits.values()):
        raise SystemExit(f"the uncapped fill differs from the plain chain: {bits}")
    chain = (lambda: depth_ops.depth_to_normals(depth, intr, 40))
    rec = dict(what="the chain with the fill uncapped (variant) against capped (package)",
               bits_differing=bits, registers=fill_registers("depth_capped"),
               variant_registers=fill_registers("depth_uncapped"))
    cs.time_in_turns(chain, on_depth_library(chain, uncapped), 10, rec)
    rec["variant_ms"] = rec.pop("baseline_ms")
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
