"""Production meshes, the reference's `launch.mesh`, as `DeviceMesh`es.

Functions, never module-level constants: importing this module touches
no process-group state.  A mesh needs a default process group whose
world covers it: one rank a device under `torchrun` (or `init_group`
with one rank in one process), or `fake_world(n)`, a fake group of `n`
ranks in one process, in which every collective is a no-op and the
tensors of this process are rank 0's shards (the dry-run's world).

Axes (the reference's DESIGN.md §4):
  pod    the communication-free chain boundary for large models (no
         collective crosses it in training)
  data   within-chain data parallelism / FSDP, or the chain axis for
         small models (16 chains a pod)
  model  tensor / expert parallelism
"""
from __future__ import annotations

import contextlib


def _mesh(device_type, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """16 × 16 = 256 devices a pod; `multi_pod` stacks 2 pods (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, names)


def make_host_mesh(device_type="cuda"):
    """Every rank of the default group on `data`, 1 on `model`: (1, 1)
    for one process on one card."""
    import torch.distributed as dist
    return _mesh(device_type, (dist.get_world_size(), 1), ("data", "model"))


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of `n` ranks (this process is rank
    0) for the block, destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
