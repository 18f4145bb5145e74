"""Multi-process execution: one process per device on ``torch.distributed``
(PyTorch counterpart of ``spsg_tpu/parallel/multihost.py``).

Every rank runs the same program; ``initialize`` connects them through a
``tcp://`` rendezvous. Host responsibilities, as in the JAX package:

  * each rank feeds only its rows of the global batch (``local_indices``,
    ``make_global_batch``);
  * exactly one rank writes checkpoints, logs and visual dumps
    (``is_primary``);
  * the collectives are in ``parallel/mesh.py``; the step, the losses and the
    servings take the mesh as an argument.

The backend is chosen explicitly and nothing gives way to another:

  * ``device_type="cpu"``: gloo;
  * ``device_type="cuda"``: NCCL, each rank on a card of its own
    (``cuda:<local rank>``); a rank without a card of its own raises;
  * ``device_type="cuda", shared_card=True``: gloo on CUDA tensors, every rank
    on one card (``cuda:<local rank mod cards>``), for a correctness run of
    several ranks on one GPU. gloo offers only ``all_reduce`` and
    ``broadcast`` on CUDA tensors, which is all the port uses.

Launch recipe (N ranks):
  rank i:  SPSG_COORDINATOR=host0:12345 SPSG_NUM_PROCESSES=N SPSG_PROCESS_ID=i \\
           python -m spsg_tpu_torch.cli.train --distributed ...
``SPSG_LOCAL_RANK`` (default: ``SPSG_PROCESS_ID``) picks the rank's card on
its host when ranks span several hosts.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def _card(lr: int) -> torch.device:
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("spsg_tpu_torch: no CUDA device is available; pass --device cpu "
                           "(device_type='cpu') to run the ranks on the CPU")
    return torch.device(f"cuda:{lr % n}")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
    shared_card: bool = False,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join this process to the process group and return its device.

    Arguments default to the SPSG_COORDINATOR (``host:port``) /
    SPSG_NUM_PROCESSES / SPSG_PROCESS_ID environment variables; any of them
    missing raises. The backend follows the module docstring: gloo on the CPU,
    NCCL with a card for each rank, gloo on a shared card only with
    ``shared_card=True``."""
    coordinator_address = coordinator_address or os.environ.get("SPSG_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("SPSG_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("SPSG_PROCESS_ID")
    if not coordinator_address or num_processes is None or process_id is None:
        raise RuntimeError(
            "spsg_tpu_torch: a distributed run needs SPSG_COORDINATOR (host:port), "
            "SPSG_NUM_PROCESSES and SPSG_PROCESS_ID (or the arguments of "
            "parallel.multihost.initialize)")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if dist.is_initialized():
        raise RuntimeError("spsg_tpu_torch: this process is already in a process group")
    if device_type == "cpu":
        backend, device = "gloo", torch.device("cpu")
    else:
        lr = _env_int("SPSG_LOCAL_RANK")
        lr = process_id if lr is None else lr
        device = _card(lr)
        if shared_card:
            backend = "gloo"
        elif lr >= torch.cuda.device_count():
            raise RuntimeError(
                f"spsg_tpu_torch: rank {process_id} (local rank {lr}) has no card of its "
                f"own ({torch.cuda.device_count()} visible) for NCCL; ranks sharing a "
                "card need shared_card=True (--shared_card), which runs gloo")
        else:
            backend = "nccl"
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return device


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the rank that owns checkpoint / log writes (rank 0; the one
    process of a run without a group)."""
    return process_index() == 0


def build_kernels(mesh) -> None:
    """Build the CUDA kernels once: rank 0 compiles what is missing while the
    others wait, then every rank loads the binaries (``ops/_build.py`` names
    them by the hash of their sources, so the others find them built)."""
    from ..ops import _build
    from .mesh import all_true

    if mesh is None or mesh.rank == 0:
        _build.build_all()
    all_true(True, mesh)  # the barrier, through the mesh's own collective


def local_indices(n_items: int, global_batch: int, *, seed: int, epoch: int,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None) -> np.ndarray:
    """This rank's slice of the epoch's sample order.

    Every rank derives the same global permutation from ``seed + epoch`` and
    takes interleaved strides, so the union over ranks is the exact global
    epoch with no duplication; the ragged tail is dropped so every rank sees
    the same number of batches. The world size and rank come from
    ``torch.distributed`` unless given."""
    order = np.random.default_rng(seed + epoch).permutation(n_items)
    n_proc = process_count() if num_processes is None else num_processes
    idx = process_index() if process_id is None else process_id
    per_host = global_batch // n_proc
    assert global_batch % n_proc == 0, (global_batch, n_proc)
    n_batches = n_items // global_batch
    order = order[: n_batches * global_batch].reshape(n_batches, n_proc, per_host)
    return order[:, idx, :].reshape(-1)


def make_global_batch(local_batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's batch as tensors on the rank's device: arrays with a
    leading batch dim are its rows of the global batch, scalars replicate
    (every rank holds the same). The global batch is never assembled: the
    step's collectives make its reductions global. Entries that are not
    arrays (names) are left out."""
    out = {}
    for k, v in local_batch.items():
        if isinstance(v, (np.ndarray, np.generic, float, int)):
            v = torch.as_tensor(np.asarray(v))
        if isinstance(v, torch.Tensor):
            out[k] = v.to(mesh.device)
    return out
