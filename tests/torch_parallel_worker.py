"""Rank processes of the port's multi-process tests (tests/test_torch_parallel*.py),
and the launcher that starts them. Not a test file, and free of JAX: a rank
imports torch, numpy and spsg_tpu_torch only.

    python tests/torch_parallel_worker.py <case> <rank> <world> <port> <dir>

joins a gloo process group of ``world`` ranks on the CPU at 127.0.0.1:<port>,
reads ``<dir>/inputs.npz`` and ``<dir>/args.json``, runs ``<case>`` and writes
``<dir>/<case>_rank<rank>.npz``. Every rank uses one intra-op thread.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------- launcher
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def save_inputs(directory, arrays=None, **args) -> None:
    """``arrays`` (name -> numpy array) and the JSON ``args`` of a run."""
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, "inputs.npz"), **(arrays or {}))
    with open(os.path.join(directory, "args.json"), "w") as f:
        json.dump(args, f)


def run_ranks(case: str, directory, world: int = 2, timeout: float = 120.0):
    """Run ``case`` on ``world`` rank processes; returns each rank's results
    (a dict of numpy arrays). Raises with the ranks' output if any fails or
    they outlast ``timeout`` (every rank is killed then)."""
    directory = str(directory)
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(os.path.join(directory, f"{case}_rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r), str(world), str(port),
             directory], stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO), log))
    deadline = time.time() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = [open(os.path.join(directory, f"{case}_rank{r}.log")).read() for r in range(world)]
    if any(p.returncode != 0 for p, _ in procs):
        raise AssertionError(f"{case}: rank exit codes {[p.returncode for p, _ in procs]}\n"
                             + "\n".join(f"--- rank {r}\n{t[-4000:]}" for r, t in enumerate(logs)))
    return [dict(np.load(os.path.join(directory, f"{case}_rank{r}.npz"))) for r in range(world)]


# --------------------------------------------------------------------------- helpers
def _sub(arrays, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def _tensors(d):
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _sn_state(flat):
    out = {}
    for k, v in _tensors(flat).items():
        conv, part = k.rsplit(".", 1)
        out.setdefault(conv, {})[part] = v
    return out


def _trainer(args, arrays, mesh):
    from spsg_tpu_torch.training import TrainConfig
    from spsg_tpu_torch.training.step import Trainer

    vgg = None
    if any(k.startswith("vgg/") for k in arrays):
        from spsg_tpu_torch.models.vgg import VGGFeatures

        vgg = VGGFeatures()
        vgg.load_state_dict(_tensors(_sub(arrays, "vgg")), strict=True)
    trainer = Trainer(TrainConfig(**args["cfg"]), device="cpu", mesh=mesh, vgg=vgg)
    trainer.generator.load_state_dict(_tensors(_sub(arrays, "gen")), strict=True)
    if trainer.discriminator is not None:
        trainer.discriminator.load_state_dict(_tensors(_sub(arrays, "disc")), strict=True)
        trainer.sn_state = _sn_state(_sub(arrays, "sn"))
    return trainer


def _trainer_state(trainer, out):
    """The trainer's state after a step: both networks' state dicts, their
    gradients and the spectral state, flattened into ``out``."""
    out.update({f"gen/{k}": v.numpy() for k, v in trainer.generator.state_dict().items()})
    out.update({f"grad/{n}": p.grad.numpy() for n, p in trainer.generator.named_parameters()})
    if trainer.discriminator is not None:
        out.update({f"disc/{k}": v.numpy()
                    for k, v in trainer.discriminator.state_dict().items()})
        out.update({f"dgrad/{n}": p.grad.numpy()
                    for n, p in trainer.discriminator.named_parameters()})
        out.update({f"sn/{c}.{k}": v.numpy() for c, s in trainer.sn_state.items()
                    for k, v in s.items()})
    out["iteration"] = np.asarray(trainer.iteration)


# --------------------------------------------------------------------------- cases
def case_steps(args, arrays, mesh):
    """Runs of one Trainer.step each, in turn in this rank's process: for
    every run ``name`` of ``args["runs"]`` (its ``cfg`` and ``flags``, its
    arrays under ``name/``), a trainer from the run's weights steps on the
    rank's rows of the run's global batch; its results go under ``name/``."""
    from spsg_tpu_torch.parallel import shard_batch
    from spsg_tpu_torch.training import StepFlags

    out = {}
    for name, run in args["runs"].items():
        inputs = _sub(arrays, name)
        trainer = _trainer(run, inputs, mesh)
        batch = shard_batch(_sub(inputs, "batch"), mesh)
        batch["weight_occ"] = np.float32(batch["weight_occ"])
        metrics = trainer.step(batch, StepFlags(**run["flags"]))
        res = {f"metric/{k}": v.numpy() for k, v in metrics.items()}
        _trainer_state(trainer, res)
        out.update({f"{name}/{k}": v for k, v in res.items()})
    return out


def case_batchnorm(args, arrays, mesh):
    """A conv block (the fused conv's sums into BatchNorm) and a bare
    BatchNorm in train mode on the rank's rows: outputs, running statistics
    and the input gradients of a fixed linear loss."""
    import torch

    from spsg_tpu_torch.models.generator import BatchNorm, ConvBlock
    from spsg_tpu_torch.parallel import shard_batch

    torch.manual_seed(0)
    block = ConvBlock(3, 5)
    bn = BatchNorm(3)
    block.load_state_dict(_tensors(_sub(arrays, "block")))
    bn.load_state_dict(_tensors(_sub(arrays, "bn")))
    rows = shard_batch({k: arrays[k] for k in ("x", "gy", "gz")}, mesh)
    x = torch.from_numpy(rows["x"]).requires_grad_(True)
    y = block(x, mesh)
    z = bn(x, mesh=mesh)
    loss = (y * torch.from_numpy(rows["gy"])).sum() + (z * torch.from_numpy(rows["gz"])).sum()
    loss.backward()
    return {"y": y.detach().numpy(), "z": z.detach().numpy(), "dx": x.grad.numpy(),
            **{f"block/{k}": v.numpy() for k, v in block.state_dict().items()},
            **{f"bn/{k}": v.numpy() for k, v in bn.state_dict().items()}}


def _generator(args, arrays, **cfg_kw):
    from spsg_tpu_torch.models.generator import Generator, GeneratorConfig

    gen = Generator(GeneratorConfig(nf=args["nf"], **cfg_kw))
    gen.load_state_dict(_tensors(_sub(arrays, "gen")), strict=True)
    return gen


def case_chunked(args, arrays, mesh):
    """run_chunked_inference with mesh=: rank 0 returns the scene."""
    from spsg_tpu_torch.inference import chunked

    res = chunked.run_chunked_inference(
        _generator(args, arrays), arrays["input"], arrays["mask"], arrays["target_sdf"],
        arrays["known"], arrays["semantics"], mesh=mesh, device="cpu", **args["kw"])
    if res is None:
        return {"none": np.asarray(True)}
    return {k: np.asarray(getattr(res, k)) for k in (
        "sdf", "colors", "sem_labels", "occ", "counts", "geo_intersection", "geo_union",
        "class_intersection", "class_union", "class_weight")}


def case_whole_scene(args, arrays, mesh):
    """run_whole_scene with mesh=, once for each generator of ``args["forms"]``
    (name -> GeneratorConfig flags; its results under ``name/``, the default
    generator's, name "", without a prefix): every rank returns the whole
    scene."""
    from spsg_tpu_torch.inference import whole_scene

    out = {}
    for form, cfg_kw in args.get("forms", {"": {}}).items():
        occ, sdf, color, sem = whole_scene.run_whole_scene(
            _generator(args, arrays, **cfg_kw), arrays["input"], arrays["mask"], mesh=mesh,
            device="cpu", **args["kw"])
        res = {"occ": occ, "sdf": sdf, "color": color, "semantic": sem}
        out.update({(f"{form}/{k}" if form else k): v for k, v in res.items() if v is not None})
    return out


def case_train_cli(args, arrays, mesh):
    """The train CLI with --distributed (it joins the group itself, from the
    SPSG_* variables): the final generator's parameters and buffers."""
    from spsg_tpu_torch.cli import train

    rank = os.environ["SPSG_PROCESS_ID"]
    result = train.main(args["argv"] + ["--save", args["save"].format(rank=rank)])
    return {f"gen/{k}": v.numpy() for k, v in result.trainer.generator.state_dict().items()}


def case_scene_cli(args, arrays, mesh):
    """The whole-scene CLI with --spatial_shard (it joins the group itself)."""
    from spsg_tpu_torch.cli import test_scene

    rank = os.environ["SPSG_PROCESS_ID"]
    test_scene.main(args["argv"] + ["--output", args["output"].format(rank=rank)])
    return {}


CASES = {"steps": case_steps, "batchnorm": case_batchnorm, "chunked": case_chunked,
         "whole_scene": case_whole_scene}
# the CLIs join the process group themselves
CLI_CASES = {"train_cli": case_train_cli, "scene_cli": case_scene_cli}


def main(argv):
    case, rank, world, port, directory = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    import torch

    torch.set_num_threads(1)
    from spsg_tpu_torch.parallel import make_mesh, multihost

    with open(os.path.join(directory, "args.json")) as f:
        args = json.load(f)
    arrays = dict(np.load(os.path.join(directory, "inputs.npz")))
    if case in CLI_CASES:
        os.environ.update(SPSG_COORDINATOR=f"127.0.0.1:{port}", SPSG_NUM_PROCESSES=str(world),
                          SPSG_PROCESS_ID=str(rank))
        out = CLI_CASES[case](args, arrays, None)
    else:
        multihost.initialize(f"127.0.0.1:{port}", world, rank, device_type="cpu", timeout_s=90)
        try:
            out = CASES[case](args, arrays, make_mesh())
        finally:
            multihost.shutdown()
    np.savez(os.path.join(directory, f"{case}_rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1:])
