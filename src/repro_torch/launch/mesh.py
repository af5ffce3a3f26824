"""Production and debug meshes for H100s.

Counterpart of the JAX package's ``launch/mesh.py``. The model axis is one
node's NVLink domain (8 H100s of a DGX H100), where the TPU mesh's is 16
chips of ICI; the batch shards over the nodes:

    single pod: 256 GPUs as (data=32, model=8)
    multi-pod:  512 GPUs as (pod=2, data=32, model=8)

A production mesh is a *description* (``Mesh.describe``: names and sizes,
no process group), so the dry-run never starts 256 processes: it runs
rank 0's step on the meta device. ``make_debug_mesh`` builds real groups
over the ranks of an initialised process group, for tests.
"""
from __future__ import annotations

from repro_torch.sharding.utils import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh.describe(("pod", "data", "model"), (2, 32, 8))
    return Mesh.describe(("data", "model"), (32, 8))


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False) -> Mesh:
    """A small mesh with process groups over the first ranks of the world
    (collective: every rank calls it); raises past the world size."""
    if multi_pod:
        return Mesh.build(("pod", "data", "model"), (2, n_data, n_model))
    return Mesh.build(("data", "model"), (n_data, n_model))
