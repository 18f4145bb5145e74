"""The process group as the port's device mesh, batch sharding, state
replication and the collectives the port runs (PyTorch counterpart of
``spsg_tpu/parallel/mesh.py``).

The JAX package runs one program over a mesh of devices and lets GSPMD insert
the collectives. Here there is one process per device on
``torch.distributed`` (``parallel/multihost.py`` starts it), and the
collectives are written out where the meaning needs them:

  * data-parallel training: each rank holds its rows of the global batch,
    parameters and optimizer state replicate, every reduction is global
    (BatchNorm's batch statistics, each loss's masked mean, the gates) and
    parameter gradients are summed across ranks;
  * chunked serving: each rank runs its share of every window batch;
  * whole-scene serving: each rank holds a Y-slab of the scene and exchanges
    halo rows with its neighbours before every conv.

Every collective here is an ``all_reduce`` or a ``broadcast``: the two that
the gloo backend offers on CUDA tensors as well as on CPU tensors, so that one
code path serves NCCL (one card a rank), gloo on the CPU (the tests) and gloo
on one shared card. A gather is an ``all_reduce`` of a zero buffer in which
each rank wrote its own slot (adding zeros is exact); a halo exchange is the
gather of each rank's edge rows.

Two autograd rules, by who consumes the reduced value:

  * :func:`global_sum` is for a value that every rank then holds and uses
    alike (a loss's numerator or denominator): forward all-reduce, backward the
    identity. Each rank's loss is then the global loss, its backward gives the
    partial derivative through its own rows, and the sum of the ranks'
    parameter gradients (:func:`sum_gradients`) is the gradient of the global
    loss, as GSPMD's is.
  * :func:`shared_sum` is for a value that feeds per-rank computations
    (BatchNorm's sums, which normalise each rank's own rows): forward
    all-reduce, backward an all-reduce of the gradient.

With no process group (or a world of one) every function here is the
identity, and no collective runs.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """One data axis over the ranks of the default ``torch.distributed``
    process group. ``rank`` and ``size`` are this process's rank and the world
    size; ``device`` is the rank's device, on which collectives run.
    ``mesh.shape["data"]`` is the world size, as on the JAX package's mesh.
    Without an initialised process group it is a world of one."""

    def __init__(self, device=None):
        if dist.is_available() and dist.is_initialized():
            self.rank = dist.get_rank()
            self.size = dist.get_world_size()
        else:
            self.rank, self.size = 0, 1
        if device is None:
            device = "cpu"
            if self.size > 1 and dist.get_backend() == "nccl":
                device = f"cuda:{torch.cuda.current_device()}"
        self.device = torch.device(device)
        self.shape = {"data": self.size}

    def __repr__(self):
        return f"Mesh(data={self.size}, rank={self.rank}, device={self.device})"


def make_mesh(device=None) -> Mesh:
    """The mesh of the current process group (``parallel/multihost.py::
    initialize`` starts one); a world of one without it. ``device`` is this
    rank's device (default: its card under NCCL, else the CPU)."""
    return Mesh(device)


def active(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` spans more than one rank (collectives run)."""
    return mesh is not None and mesh.size > 1


def check_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` if it is None or a :class:`Mesh`; raises ``TypeError`` for
    anything else (the JAX package's ``jax.sharding.Mesh`` included)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a spsg_tpu_torch.parallel.Mesh (parallel.make_mesh()), "
                        f"got {type(mesh).__name__}")
    return mesh


# --------------------------------------------------------------------------- batches
def _rows(v, mesh: Mesh):
    n = len(v) if isinstance(v, (list, tuple)) else (v.shape[0] if v.ndim >= 1 else 0)
    if n == 0 or n % mesh.size:
        return v  # replicated
    per = n // mesh.size
    return v[mesh.rank * per:(mesh.rank + 1) * per]


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a host batch: arrays (numpy or tensors) and lists
    whose leading dim divides by the world size are split into equal
    contiguous shards, rank ``r`` taking the ``r``-th; scalars and the rest
    replicate (the JAX package's rule)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor, list, tuple)):
            out[k] = _rows(v, mesh)
        else:
            out[k] = v
    return out


def _broadcast_(t: torch.Tensor, mesh: Mesh) -> None:
    buf = t.detach().to(mesh.device)
    dist.broadcast(buf, src=0)
    if buf is not t:
        with torch.no_grad():
            t.copy_(buf)


def _state_tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _state_tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _state_tensors(v)


def replicate_state(state, mesh: Optional[Mesh]):
    """Broadcast rank 0's state to every rank, in place, and return it.
    ``state`` is a module (parameters and buffers), an optimizer (its
    per-parameter state: Adam's moments and step counts) or a ``Trainer``
    (the generator and its Adam, the discriminator with its spectral state and
    its Adam). Every rank must hold the same structure, which ranks built from
    the same configuration do."""
    if not active(mesh):
        return state
    if isinstance(state, torch.nn.Module):
        with torch.no_grad():
            for t in list(state.parameters()) + list(state.buffers()):
                _broadcast_(t, mesh)
    elif isinstance(state, torch.optim.Optimizer):
        for group in state.param_groups:
            for p in group["params"]:
                for t in _state_tensors(state.state.get(p, {})):
                    _broadcast_(t, mesh)
    else:  # a Trainer
        replicate_state(state.generator, mesh)
        replicate_state(state.optimizer, mesh)
        if state.discriminator is not None:
            replicate_state(state.discriminator, mesh)
            replicate_state(state.disc_optimizer, mesh)
            for t in _state_tensors(state.sn_state):
                _broadcast_(t, mesh)
    return state


# --------------------------------------------------------------------------- collectives
def _all_reduce(x: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced over the ranks (on the rank's device,
    returned on ``x``'s device and in its type; bools and integers reduce as
    int64)."""
    dtype = x.dtype
    wire = torch.int64 if (dtype == torch.bool or not dtype.is_floating_point) else (
        torch.float32 if dtype in (torch.float16, torch.bfloat16) else dtype)
    buf = x.detach().to(device=mesh.device, dtype=wire, copy=True).contiguous()
    dist.all_reduce(buf, op=op)
    return buf.to(device=x.device, dtype=dtype)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SharedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh), None


def global_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the ranks, for a value every rank then uses alike;
    the gradient passes back to this rank's ``x`` unchanged."""
    return _GlobalSum.apply(x, mesh) if active(mesh) else x


def shared_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the ranks, for a value that feeds each rank's own
    computation (BatchNorm's sums); the gradient is summed over the ranks on
    the way back."""
    return _SharedSum.apply(x, mesh) if active(mesh) else x


def global_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean of ``x``'s elements over every rank's ``x`` (the global
    batch's mean), differentiable as :func:`global_sum`."""
    if not active(mesh):
        return x.mean()
    n = global_sum(torch.tensor(float(x.numel()), device=x.device), mesh)
    return global_sum(x.sum(), mesh) / n


def all_max(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The elementwise maximum over the ranks, without gradient."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX) if active(mesh) else x


def all_min(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The elementwise minimum over the ranks, without gradient."""
    return _all_reduce(x, mesh, dist.ReduceOp.MIN) if active(mesh) else x


def all_true(flag, mesh: Optional[Mesh]) -> bool:
    """A host decision every rank takes alike: True iff ``flag`` (a bool or a
    one-element tensor) holds on every rank. Ranks that branch on their own
    flags would wait at different collectives."""
    if not active(mesh):
        return bool(flag)
    t = torch.as_tensor(bool(flag), dtype=torch.int64).reshape(1)
    return bool(_all_reduce(t, mesh, dist.ReduceOp.MIN).item())


def gather(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along ``dim`` in rank
    order, on every rank, without gradient."""
    if not active(mesh):
        return x
    buf = torch.zeros((mesh.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[mesh.rank] = x.detach()
    buf = _all_reduce(buf, mesh)
    return torch.cat(buf.unbind(0), dim=dim)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rank, ctx.n = mesh.rank, x.shape[0]
        return gather(x, mesh, 0)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch of ``x`` (every rank's rows in rank order), for a
    loss that every rank computes alike from all rows (the style loss's Gram
    matrix of the stacked batch): the gradient of this rank's rows passes back
    to them, the other ranks' rows are constants here."""
    return _GatherRows.apply(x, mesh) if active(mesh) else x


def halo_exchange(x: torch.Tensor, halo: int, mesh: Optional[Mesh], dim: int = 2) -> torch.Tensor:
    """``x`` (this rank's slab of a volume split along ``dim`` in rank order)
    with ``halo`` rows of each neighbour's slab before and after it; the
    outer edges of the first and the last slab get zeros, the zero padding of
    the unsplit volume. Without gradient (serving)."""
    if halo == 0:
        return x
    if not active(mesh):
        shape = list(x.shape)
        shape[dim] = halo
        z = torch.zeros(shape, dtype=x.dtype, device=x.device)
        return torch.cat([z, x, z], dim=dim)
    if x.shape[dim] < halo:
        raise ValueError(f"halo_exchange: a slab of {x.shape[dim]} rows cannot give {halo}")
    edges = torch.stack([x.narrow(dim, 0, halo), x.narrow(dim, x.shape[dim] - halo, halo)])
    edges = gather(edges[None], mesh, 0)  # (ranks, 2, ...): first and last rows of each
    r, n = mesh.rank, mesh.size
    zero = torch.zeros_like(edges[0, 0])
    before = edges[r - 1, 1] if r > 0 else zero
    after = edges[r + 1, 0] if r < n - 1 else zero
    return torch.cat([before, x, after], dim=dim)


def sum_gradients(params, mesh: Optional[Mesh]) -> None:
    """Sum the parameters' ``.grad`` over the ranks, in place, with one
    all-reduce of their concatenation (every rank holds the same parameters in
    the same order)."""
    if not active(mesh):
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    flat = _all_reduce(flat, mesh)
    i = 0
    with torch.no_grad():
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
