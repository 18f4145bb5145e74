"""spsg_tpu_torch — the PyTorch/CUDA port of ``spsg_tpu`` for one NVIDIA H100.

Same sub-package layout and file names as the JAX package, so the counterpart
of a module is found by its path:

  - ``spsg_tpu_torch.data``      : voxel-grid file formats, color spaces, host data pipeline
  - ``spsg_tpu_torch.models``    : generator (two-branch 3D conv U-Net), weight bridge
  - ``spsg_tpu_torch.ops``       : hand-written CUDA kernels with their plain PyTorch
                                   versions, marching cubes (host)
  - ``spsg_tpu_torch.losses``    : 3D geometry and semantic losses
  - ``spsg_tpu_torch.training``  : configuration, generator construction, optimizer,
                                   checkpoints, the 3D-loss train step
  - ``spsg_tpu_torch.inference`` : chunked whole-scene inference with overlap stitching
  - ``spsg_tpu_torch.parallel``  : one process per card on ``torch.distributed``: the mesh,
                                   batch sharding, state replication, the collectives
  - ``spsg_tpu_torch.utils``     : mesh / image dumps
  - ``spsg_tpu_torch.cli``       : command-line entry points

The package imports ``torch`` and ``numpy`` only — never JAX and nothing of
``spsg_tpu``. Public functions keep the JAX package's layouts: dense volumes
are channel-last ``(B, Z, Y, X, C)``, conv kernels ``(kz, ky, kx, Cin, Cout)``
at the kernel wrappers. Entry points run on the GPU unless the caller asks
for the CPU. What is ported and what is still to come: ROADMAP.md.
"""

__version__ = "0.1.0"
