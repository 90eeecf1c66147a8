"""The model programs over a ``GroupMesh`` of 4 gloo ranks that share the
card, against ``LocalMesh`` runs of the same shape on the card in the
parent: the expert-parallel MoE at qwen3-moe's smoke config on (2, 2) and
(1, 4), one partition-scatter launch a rank, and the sharded training
step of qwen3-1.7b's smoke config on (2, 2), its attention forward and
backward on the kernels.  The rank bodies are ``tests/_group_model_util
.py``'s with its ``DEVICE`` set to the card.

Tolerances: the MoE bit-equal to ``LocalMesh``'s (the same kernels on
the same blocks, the float sums in rank order); the step's loss, every
gradient leaf and the parameters after the steps within STEP_TOL (f32,
the same kernels on the same blocks; held at a tolerance because the
card's GEMMs may pick another algorithm per process).  These tests need
a CUDA card and skip without one; this file imports the port only.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.sharding import opt_specs, param_specs  # noqa

STEP_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def rank_models_on_card(rank, world):
    """The MoE on (2, 2) and (1, 4) and the sharded step on (2, 2) on a
    rank sharing card 0, with its own launch counts."""
    import _group_model_util as U
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.radix_partition import ops as rp
    torch.cuda.set_device(0)
    build.library()
    U.DEVICE = "cuda:0"
    out = {}
    for tag, shape in (("22", (2, 2)), ("14", (1, 4))):
        mesh = U.group(shape)
        rp.scatter_launches.reset()
        for k, v in U.moe(mesh).items():
            out[f"moe{tag}_{k}"] = v
        out[f"moe{tag}_scatters"] = rp.scatter_launches.count
        out[f"moe{tag}_coords"] = [mesh.my_coords[a] for a in U.AXES]
    fa.launches.reset()
    fa.backward_launches.reset()
    out["step"] = U.sharded_step(U.group((2, 2)))
    out["flash"], out["flash_bwd"] = (fa.launches.count,
                                      fa.backward_launches.count)
    return out


@pytest.mark.cuda
def test_model_programs_over_ranks_on_the_card(cuda):
    import _group_model_util as U
    from repro_torch.kernels import build
    build.library()
    d = tempfile.mkdtemp(prefix="group_model_cuda_")
    ranks = spawn(rank_models_on_card, 4, backend="gloo",
                  init_file=os.path.join(d, "rdv"), timeout=300)
    U.DEVICE = "cuda:0"
    for tag, shape in (("22", (2, 2)), ("14", (1, 4))):
        want = U.moe(U.local(shape))
        b_loc = 4 // shape[0]
        for r in ranks:
            dp = r[f"moe{tag}_coords"][0]
            np.testing.assert_array_equal(
                r[f"moe{tag}_out"], want["out"][b_loc * dp:b_loc * dp + b_loc])
            np.testing.assert_array_equal(r[f"moe{tag}_aux"], want["aux"])
            assert r[f"moe{tag}_scatters"] == 1
    mesh = U.local((2, 2))
    want = U.sharded_step(mesh)
    model, _ = U.step_inputs()
    shapes = model.init_shapes()
    specs = {"param": U.spec_leaves(param_specs(model.cfg, shapes, mesh)),
             "m": U.spec_leaves(opt_specs(model.cfg, shapes, mesh)["m"])}
    specs["v"] = specs["m"]
    for r in ranks:
        got = r["step"]
        coords = dict(zip(U.AXES, r["moe22_coords"]))
        assert r["flash"] > 0 and r["flash_bwd"] > 0
        for k, v in want.items():
            kind = k.rstrip("0123456789")
            if kind in specs:
                # the rank holds its block of a parameter or a moment
                spec = specs[kind][int(k[len(kind):])]
                v = mesh.block(torch.from_numpy(v), spec, coords).numpy()
            np.testing.assert_allclose(got[k], v, rtol=0, atol=STEP_TOL,
                                       err_msg=k)

