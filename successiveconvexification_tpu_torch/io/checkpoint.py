"""Checkpoint and resume of sweep states (PyTorch port).

The counterpart of the JAX package's ``io/checkpoint.py``. A state (any
tree of tensors that ``utils/tree.py`` walks: the ``ScvxState`` with its
nested IPM carry) is written as one ``.npz`` of its leaves in the order
``tree_leaves`` flattens them, plus ``_meta``, a JSON string with the step
and the config's hash. That is the file the JAX package writes when Orbax
is missing. ``restore`` refuses a checkpoint written under another config
or for a state of other shapes.

The sharded pair (``save_sharded``, ``restore_sharded``) comes with the
port's multi-device sweep.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from successiveconvexification_tpu_torch.utils.tree import tree_leaves, tree_map


def config_hash(cfg) -> str:
    """16 hex digits of the SHA-256 of the config's sorted JSON: the JAX
    package's hash of the same config."""
    return hashlib.sha256(
        json.dumps(cfg.to_dict(), sort_keys=True).encode()
    ).hexdigest()[:16]


def save(path: str, sweep_state, cfg=None, step: int = 0) -> None:
    """Write ``path``.npz: the state's leaves as ``arr_0``, ``arr_1``, ...
    and ``_meta`` (step, config hash)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {"step": step}
    if cfg is not None:
        meta["config_hash"] = config_hash(cfg)
    leaves = [t.detach().cpu().numpy() for t in tree_leaves(sweep_state)]
    np.savez(path + ".npz", *leaves, _meta=json.dumps(meta))


def restore(path: str, like, cfg=None):
    """Read a state written by ``save``. ``like`` gives the tree, shapes,
    dtypes and device (e.g. a fresh state of the same batch and K); each
    leaf lands on ``like``'s device in its dtype. Raises ``ValueError`` if
    the checkpoint was written under another config than ``cfg`` or its
    leaves do not match ``like``'s count and shapes."""
    with np.load(path + ".npz", allow_pickle=False) as data:
        meta = json.loads(str(data["_meta"]))
        if cfg is not None and meta.get("config_hash") not in (
                None, config_hash(cfg)):
            raise ValueError(
                "checkpoint was written with a different config "
                f"({meta.get('config_hash')} != {config_hash(cfg)})")
        like_leaves = tree_leaves(like)
        n_saved = sum(1 for k in data.files if k.startswith("arr_"))
        if n_saved != len(like_leaves):
            raise ValueError(f"checkpoint holds {n_saved} leaves, the state "
                             f"{len(like_leaves)}")
        arrs = [data[f"arr_{i}"] for i in range(n_saved)]
    for i, (a, t) in enumerate(zip(arrs, like_leaves)):
        if a.shape != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {i} has shape {a.shape}, the "
                             f"state {tuple(t.shape)}")
    it = iter(arrs)
    return tree_map(lambda t: torch.as_tensor(next(it)).to(
        device=t.device, dtype=t.dtype), like)
