"""The port's process-group layer (spsg_tpu_torch/parallel/) on the CPU: the
epoch's sample order of each rank against the JAX package's
parallel/multihost.py::local_indices, the mesh and its collectives without a
process group, what initialize refuses, and BatchNorm's global statistics on
two gloo ranks (tests/torch_parallel_worker.py) against one process on the
concatenated batch."""

import jax
import numpy as np
import pytest
import torch

from spsg_tpu.parallel import multihost as jmultihost
from spsg_tpu_torch.models.generator import BatchNorm, ConvBlock
from spsg_tpu_torch.parallel import make_mesh, multihost, shard_batch
from spsg_tpu_torch.parallel import mesh as pmesh

import torch_parallel_worker as W


@pytest.mark.parametrize("world,rank,seed,epoch,n_items,global_batch", [
    (1, 0, 0, 0, 10, 2), (2, 0, 0, 3, 11, 4), (2, 1, 0, 3, 11, 4), (4, 3, 7, 1, 37, 8),
    (4, 1, 5, 9, 64, 4)])
def test_local_indices_equal_the_jax_function(monkeypatch, world, rank, seed, epoch, n_items,
                                              global_batch):
    """The same interleaved slice of the same permutation, the JAX function
    reached through monkeypatched jax.process_count / process_index; the
    ranks' slices together are the epoch's first n_items // global_batch
    global batches, each once."""
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    want = jmultihost.local_indices(n_items, global_batch, seed=seed, epoch=epoch)
    got = multihost.local_indices(n_items, global_batch, seed=seed, epoch=epoch,
                                  num_processes=world, process_id=rank)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    every = [multihost.local_indices(n_items, global_batch, seed=seed, epoch=epoch,
                                     num_processes=world, process_id=r) for r in range(world)]
    joined = np.concatenate(every)
    assert len(set(joined.tolist())) == len(joined) == (n_items // global_batch) * global_batch


def test_mesh_and_collectives_without_a_process_group():
    """Without a group the mesh is a world of one and every collective is the
    identity (the halo exchange gives the zero padding); shard_batch splits
    arrays and lists whose leading dim divides by the world size into
    contiguous shards and replicates the rest, as the JAX package's rule."""
    mesh = make_mesh()
    assert (mesh.rank, mesh.size, mesh.shape["data"], mesh.device.type) == (0, 1, 1, "cpu")
    x = torch.arange(24.0).reshape(1, 2, 3, 4, 1).requires_grad_(True)
    for f in (pmesh.global_sum, pmesh.shared_sum, pmesh.gather_rows, pmesh.all_max):
        assert f(x, mesh) is x
    assert pmesh.all_true(True, mesh) and not pmesh.all_true(False, None)
    h = pmesh.halo_exchange(x.detach(), 2, mesh, dim=2)
    assert h.shape == (1, 2, 7, 4, 1) and torch.equal(h[:, :, 2:5], x.detach())
    assert not h[:, :, :2].any() and not h[:, :, 5:].any()
    assert pmesh.global_mean(x, None).item() == x.mean().item()

    two = make_mesh()
    two.rank, two.size = 1, 2  # shard_batch reads only the rank and the size
    batch = {"input": np.arange(8).reshape(4, 2), "names": ["a", "b", "c", "d"],
             "odd": np.zeros((3, 2)), "weight_occ": np.float32(1.0),
             "t": torch.arange(6).reshape(2, 3)}
    out = shard_batch(batch, two)
    assert np.array_equal(out["input"], [[4, 5], [6, 7]]) and out["names"] == ["c", "d"]
    assert out["odd"].shape == (3, 2) and out["weight_occ"] == 1.0
    assert torch.equal(out["t"], torch.tensor([[3, 4, 5]]))
    with pytest.raises(TypeError, match="parallel.Mesh"):
        pmesh.check_mesh(object())
    # the rank's rows as tensors on the rank's device, scalars kept, names left out
    local = multihost.make_global_batch(
        {"input": np.ones((2, 3), np.float32), "name": ["a", "b"], "weight_occ": np.float32(1)},
        mesh)
    assert set(local) == {"input", "weight_occ"}
    assert local["input"].shape == (2, 3) and local["weight_occ"].item() == 1.0


def test_initialize_refuses_what_it_cannot_do(monkeypatch):
    """No SPSG_* variables, no card for a CUDA rank, an unknown device type:
    each raises, and nothing falls back to another backend or device."""
    for var in ("SPSG_COORDINATOR", "SPSG_NUM_PROCESSES", "SPSG_PROCESS_ID", "SPSG_LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="SPSG_COORDINATOR"):
        multihost.initialize()
    with pytest.raises(ValueError, match="device_type"):
        multihost.initialize("127.0.0.1:1", 2, 0, device_type="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            multihost.initialize("127.0.0.1:1", 2, 0, device_type="cuda")
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary() and multihost.process_count() == 1


def test_batchnorm_global_statistics_on_two_ranks(tmp_path):
    """A conv block (the fused conv's sums handed to BatchNorm) and a bare
    BatchNorm in train mode, each rank on its half of a batch of 4: outputs,
    running statistics and the input gradient of a fixed linear loss equal one
    process's on the whole batch within 1e-6 of each tensor's largest entry
    (measured: 1.1e-7), the running statistics identical on both ranks."""
    torch.manual_seed(0)
    block, bn = ConvBlock(3, 5), BatchNorm(3)
    with torch.no_grad():  # no BatchNorm the identity
        block.bn.weight.uniform_(0.5, 1.5)
        block.bn.bias.normal_()
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (4, 6, 5, 7, 3)).astype(np.float32)
    gy = rng.normal(size=(4, 6, 5, 7, 5)).astype(np.float32)
    gz = rng.normal(size=(4, 6, 5, 7, 3)).astype(np.float32)
    W.save_inputs(tmp_path, dict(
        x=x, gy=gy, gz=gz, **{f"block/{k}": v.numpy() for k, v in block.state_dict().items()},
        **{f"bn/{k}": v.numpy() for k, v in bn.state_dict().items()}))
    ranks = W.run_ranks("batchnorm", tmp_path)

    xt = torch.from_numpy(x).requires_grad_(True)
    y, z = block(xt), bn(xt)
    ((y * torch.from_numpy(gy)).sum() + (z * torch.from_numpy(gz)).sum()).backward()
    for name, want in (("y", y), ("z", z), ("dx", xt.grad)):
        got = np.concatenate([r[name] for r in ranks])
        want = want.detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    for prefix, module in (("block", block), ("bn", bn)):
        for k, want in module.state_dict().items():
            for r in ranks:
                np.testing.assert_allclose(r[f"{prefix}/{k}"], want.numpy(), rtol=0,
                                           atol=1e-6 * max(1.0, want.abs().max().item()),
                                           err_msg=k)
            assert np.array_equal(ranks[0][f"{prefix}/{k}"], ranks[1][f"{prefix}/{k}"]), k
    moved = ranks[0]["bn/running_mean"] != 0
    assert moved.all()
