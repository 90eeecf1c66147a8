"""AdamW with global-norm clipping (``src/repro/train/optimizer.py``).

The arithmetic is the reference's, in float32: the global-norm clip over
every gradient leaf, the bias corrections ``1 - b1**step`` in float32,
decoupled weight decay, then one cast of each updated leaf back to its
dtype.  ``state_dtype`` is float32 or bfloat16 (the moments are stored
in it; a bf16 leaf is updated in float32 and rounded to bf16 once a
step, as the reference does: there are no float32 master weights).

Unlike the reference's pure update, ``update`` writes the new values
into the parameter and moment tensors it is given, under
``torch.no_grad()``, and returns them: a full model's parameters, two
moments and their float32 temporaries then fit beside each other one
leaf at a time, and a leaf of more than ``CHUNK`` elements in blocks of
rows of its leading axis (minicpm3-4b's stacked MLP leaf alone is 1.0e9
elements, 4 GB a float32 temporary).  Each element takes the same
arithmetic either way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..tree import tree_leaves, tree_map

CHUNK = 1 << 26     # elements of a leaf updated at once (float32: 256 MB)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"

    def init(self, params) -> Dict[str, Any]:
        """Zero moments in ``state_dtype`` on each leaf's device, and the
        step, an int32 0-d tensor on the first leaf's device."""
        dt = getattr(torch, self.state_dtype)
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict[str, Any],
                                                    torch.Tensor]:
        """One step: returns (params, state, gnorm), the params and
        moments updated in place; gnorm is the float32 global norm of
        ``grads`` before clipping."""
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        return self.apply(grads, state, params, gnorm)

    @torch.no_grad()
    def apply(self, grads, state, params, gnorm) -> Tuple[
            Any, Dict[str, Any], torch.Tensor]:
        """``update`` given the global norm ``gnorm`` of the whole
        gradient, of which ``grads`` may be a part: every element takes
        the same arithmetic wherever it lies, so blocks of the leaves
        (the sharded step's, ``launch/train.py``) update as the whole
        leaves would."""
        step = state["step"] + 1
        g_leaves = tree_leaves(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        stepf = step.float()
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=stepf.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=stepf.device), stepf)
        for leaf in zip(g_leaves, tree_leaves(state["m"]),
                        tree_leaves(state["v"]), tree_leaves(params)):
            for g, m, v, p in _rows(leaf):
                gf = g.float() * scale.to(g.device)
                m32 = m.float() * b1 + gf * (1 - b1)
                v32 = v.float() * b2 + torch.square(gf) * (1 - b2)
                u = (m32 / c1.to(g.device)) / (
                    torch.sqrt(v32 / c2.to(g.device)) + self.eps)
                u = u + self.weight_decay * p.float()
                p.copy_(p.float() - self.lr * u)
                m.copy_(m32)
                v.copy_(v32)
        return params, {"m": state["m"], "v": state["v"], "step": step}, \
            gnorm


def _rows(leaf):
    """(g, m, v, p) of one leaf as one tuple or, beyond ``CHUNK``
    elements, as tuples of views of blocks of rows of its leading axis,
    each of at most ``CHUNK`` elements where a row allows it."""
    t = leaf[0]
    if t.ndim == 0 or t.numel() <= CHUNK:
        return [leaf]
    rows = max(1, CHUNK // (t.numel() // t.shape[0]))
    return zip(*(x.split(rows, 0) for x in leaf))
