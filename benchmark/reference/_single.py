"""The reductions of a single process: what the port's ``parallel/mesh.py``
reduces over ranks, here over the one process (the reference never shards)."""

import torch


def global_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    return x


def global_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    return x.mean()
