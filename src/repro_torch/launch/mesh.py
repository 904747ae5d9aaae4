"""Production mesh construction, the port's counterpart of
``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
process group. Single pod: 16x16 = 256 ranks (data x model). Multi-pod:
2x16x16 = 512 ranks (pod x data x model); the pod axis is pure DP for
serving and the outer gradient-reduction tier for training.

Each is a ``DeviceMesh`` over the default process group, which must have as
many ranks. Without such a cluster, ``fake_world`` makes one rank of a
*fake* process group (``torch.testing._internal.distributed.fake_pg``):
every collective is accepted and moves nothing, the counterpart of the
reference's 512 placeholder host devices (``repro/launch/dryrun.py``). The
reference's jax-version shims (``compat_make_mesh``, ``compat_set_mesh``)
have no counterpart.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def production_shape(multi_pod: bool = False):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cpu"):
    """Degenerate 1-rank mesh for smoke-scale runs."""
    return init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as rank ``rank`` of a fake process group of
    ``world_size`` ranks, torn down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
