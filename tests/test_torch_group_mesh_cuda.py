"""``GroupMesh`` on the card: 4 gloo ranks that share it, each with its
own CUDA context and tensors, every collective copied through pinned host
buffers (that backend's transport on a card); and nccl at one rank a card.
The four distributed operators (their kernels launched on each rank's
block) against ``LocalMesh`` of the card in the parent, bit for bit
(integer-valued payloads, so the hashed reduce's float atomics add
exactly in any order).  These tests need a CUDA card
and skip without one; this file imports the port only, so it also runs
where JAX is absent.
"""
import os
import re
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import LocalMesh, spawn  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def rank_on_card(rank, world):
    """The operators on a GroupMesh of gloo ranks sharing card 0."""
    import _group_mesh_util as U
    from repro_torch.kernels.radix_partition import ops as rp
    from repro_torch.launch.mesh import GroupMesh
    torch.cuda.set_device(0)
    mesh = GroupMesh(world, "data", backend="gloo", device="cuda:0")
    U.CPU = "cuda:0"
    rp.scatter_launches.reset()
    out = U.relational(mesh)
    out["__scatter__"] = np.asarray(rp.scatter_launches.count)
    out["__staged__"] = np.asarray(mesh.staged_bytes)
    return out, None


def rank_nccl(rank, world):
    import _group_mesh_util as U
    from repro_torch.launch.mesh import GroupMesh
    mesh = GroupMesh(world, "data", backend="nccl")
    U.CPU = str(mesh.device)
    return U.relational(mesh), str(mesh.device)


@pytest.mark.cuda
def test_group_mesh_on_a_shared_card_matches_local_mesh(cuda):
    import _group_mesh_util as U
    d = tempfile.mkdtemp(prefix="group_cuda_")
    ranks = spawn(rank_on_card, 4, backend="gloo",
                  init_file=os.path.join(d, "rdv"), timeout=300)
    U.CPU = "cuda:0"
    local = U.relational(LocalMesh(4, device=cuda))
    for k in local:
        if re.search(r"__s\d$", k):
            got = ranks[0][0][k]
        else:
            got = np.concatenate([r[0][k] for r in ranks])
        np.testing.assert_array_equal(got, local[k], err_msg=k)
    assert all(int(r[0]["__scatter__"]) > 0 and int(r[0]["__staged__"]) > 0
               for r in ranks)


@pytest.mark.cuda
def test_nccl_one_rank_a_card(cuda):
    import _group_mesh_util as U
    n = torch.cuda.device_count()
    d = tempfile.mkdtemp(prefix="group_nccl_")
    ranks = spawn(rank_nccl, n, backend="nccl",
                  init_file=os.path.join(d, "rdv"), timeout=300)
    assert [dev for _, dev in ranks] == [f"cuda:{i}" for i in range(n)]
    U.CPU = "cuda:0"
    local = U.relational(LocalMesh(n, device=cuda))
    for k in local:
        if re.search(r"__s\d$", k):
            got = ranks[0][0][k]
        else:
            got = np.concatenate([r[0][k] for r in ranks])
        np.testing.assert_array_equal(got, local[k], err_msg=k)
