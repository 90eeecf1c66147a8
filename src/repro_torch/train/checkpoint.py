"""Fault-tolerant checkpointing (``src/repro/train/checkpoint.py``).

A checkpoint is the reference's layout, so one either package writes
restores in the other: ``step_%08d/arrays.npz`` holds each leaf as a
host numpy array under its tree path (dict keys and sequence indices
joined by ``/``, stored with ``/`` -> ``__``; bf16 leaves upcast to
float32, which is exact), and ``manifest.json`` holds the step, the
sorted keys, a sha256 ``fingerprint`` over each key and the first 4096
bytes of its leaf, and ``extra``.  Writes are atomic (tmp dir, then
rename), and ``latest_step`` skips a step whose manifest is torn.

Over the ranks of a ``launch.mesh.GroupMesh`` (the elastic restore of
the reference's multi-device checkpoints), each rank holds the blocks its
coordinates own: ``save_checkpoint`` given the leaves' shardings gathers
each leaf whole and rank 0 alone writes the files, and
``restore_checkpoint`` gives each rank the blocks ``NamedSharding.blocks``
names for it, whatever mesh saved the step.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_flatten, tree_leaves_with_path, \
    tree_unflatten


def _key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array the reference saves for it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "iufb" or arr.dtype.itemsize == 0:
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {_key(path): _host(leaf)
            for path, leaf in tree_leaves_with_path(tree)}


def _mesh_of(shardings):
    for _, sh in tree_leaves_with_path(shardings):
        if sh is not None and sh.mesh.spans_processes:
            return sh.mesh
    return None


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None, shardings: Any = None
                    ) -> str:
    """Write ``tree`` as step ``step``; returns the step's directory.
    With ``shardings`` (a tree of ``NamedSharding`` mirroring ``tree``)
    over a ``GroupMesh``, every leaf is this rank's block: the blocks are
    gathered whole (``globalize``), rank 0 writes, and every rank returns
    after the step is published."""
    mesh = None if shardings is None else _mesh_of(shardings)
    if mesh is not None:
        leaves, spec = tree_flatten(tree)
        shs = [sh for _, sh in tree_leaves_with_path(shardings)]
        tree = tree_unflatten(spec, [
            sh.mesh.globalize(x, sh.spec) for x, sh in zip(leaves, shs)])
        if mesh.rank != 0:
            mesh.barrier()
            return os.path.join(ckpt_dir, f"step_{step:08d}")
        try:
            return _write(ckpt_dir, step, tree, extra)
        finally:
            mesh.barrier()
    return _write(ckpt_dir, step, tree, extra)


def _write(ckpt_dir: str, step: int, tree: Any, extra) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "__"): v for k, v in flat.items()})
        digest = hashlib.sha256()
        for k in sorted(flat):
            digest.update(k.encode())
            digest.update(flat[k].tobytes()[:4096])
        manifest = {"step": step, "keys": sorted(flat),
                    "fingerprint": digest.hexdigest(),
                    "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)       # atomic publish
        return final
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            try:
                with open(os.path.join(ckpt_dir, d, "manifest.json")) as f:
                    json.load(f)          # torn manifests are skipped
                steps.append(int(d.split("_")[1]))
            except Exception:
                continue
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, target_tree: Any,
                       shardings: Any = None):
    """Restore into the structure of ``target_tree`` (shapes must match):
    each leaf in its target leaf's dtype, on its target leaf's device, or
    with ``shardings`` (a tree of ``launch.sharding.NamedSharding``
    mirroring the target, the elastic restore) on its sharding's mesh's
    device, laid out over that mesh's logical shards: a leaf's blocks
    (``NamedSharding.blocks``) are the reference's ``addressable_shards``
    in device order.  On a ``GroupMesh`` each rank keeps only its own
    block of a leaf (``localize``), whatever mesh wrote the step.  A spec
    that does not divide its leaf raises ValueError, where the
    reference's ``device_put`` fails.  Returns (tree, manifest)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    z = np.load(os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_target = list(tree_leaves_with_path(target_tree))
    shard_flat = [None] * len(flat_target) if shardings is None else \
        [s for _, s in tree_leaves_with_path(shardings)]
    if len(shard_flat) != len(flat_target):
        raise ValueError(f"restore_checkpoint: {len(shard_flat)} shardings "
                         f"for {len(flat_target)} leaves")
    leaves = []
    for (kpath, leaf), sh in zip(flat_target, shard_flat):
        key = _key(kpath).replace("/", "__")
        arr = z[key]
        assert arr.shape == tuple(leaf.shape), (key, arr.shape, leaf.shape)
        dev = leaf.device if sh is None else sh.mesh.device
        t = torch.from_numpy(np.array(arr))
        if sh is not None:
            sh.blocks(t)             # raises if the spec does not divide
            t = sh.mesh.localize(t, sh.spec)
        leaves.append(t.to(device=dev, dtype=leaf.dtype))
    _, spec = tree_flatten(target_tree)
    return tree_unflatten(spec, leaves), manifest

