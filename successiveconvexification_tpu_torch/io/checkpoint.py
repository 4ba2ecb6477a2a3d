"""Checkpoint and resume of sweep states (PyTorch port).

The counterpart of the JAX package's ``io/checkpoint.py``. A state (any
tree of tensors that ``utils/tree.py`` walks: the ``ScvxState`` with its
nested IPM carry) is written as one ``.npz`` of its leaves in the order
``tree_leaves`` flattens them, plus ``_meta``, a JSON string with the step
and the config's hash. That is the file the JAX package writes when Orbax
is missing. ``restore`` refuses a checkpoint written under another config
or for a state of other shapes.

A sweep split over ranks (``parallel/mesh.py``) is checkpointed shard-wise,
in the JAX package's sharded format: ``save_sharded`` writes
``{path}.shard{rank}.npz`` with this rank's tiles only, each under the key
``leaf{i}|{start}_{stop}|...`` (one ``start_stop`` a dimension, empty where
the tile spans the dimension), plus ``_meta``; it writes a ``.tmp`` file,
flushes and syncs it, and renames it into place, so a process killed while
writing leaves the previous commit whole. ``restore_sharded`` rebuilds each
rank's tiles from whatever saved tiles cover them: a checkpoint of another
rank count whose tiles cover the same global shapes restores too (the
recovery ensemble may be smaller than the one that crashed). It refuses
a tile that no file covers, another config, and shard files of different
steps: zero-filling or mixing steps would make up a state the sweep was
never in.
"""

from __future__ import annotations

import glob
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


def _index_key(leaf_i: int, index) -> str:
    """The JAX package's key of a tile: ``leaf{i}|start_stop|...``."""
    parts = []
    for sl in index:
        start = "" if sl.start is None else int(sl.start)
        stop = "" if sl.stop is None else int(sl.stop)
        parts.append(f"{start}_{stop}")
    return f"leaf{leaf_i}|" + "|".join(parts)


def _parse_key(key: str):
    """(leaf index, tuple of slices) of a tile key."""
    head, *parts = key.split("|")
    sls = []
    for part in parts:
        s_, e_ = part.split("_")
        sls.append(slice(int(s_) if s_ else None, int(e_) if e_ else None))
    return int(head[len("leaf"):]), tuple(sls)


def _tile(shape: tuple, mesh):
    """(global shape, index) of this rank's tile of a local leaf: the
    leading axis is the scenario axis, split in contiguous tiles; a leaf
    without one, or a single process's, is one whole tile."""
    if not shape:
        return (), ()
    if mesh is None or mesh.world == 1:
        return shape, (slice(None),) * len(shape)
    glob_shape = (shape[0] * mesh.world,) + tuple(shape[1:])
    return glob_shape, ((mesh.scenario_slice(glob_shape[0]),)
                        + (slice(None),) * (len(shape) - 1))


def save_sharded(path: str, sweep_state, mesh=None, cfg=None,
                 step: int = 0) -> None:
    """Write this rank's lanes of ``sweep_state`` (its local state under
    ``mesh``; default: a single process) to ``{path}.shard{rank}.npz``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blobs = {}
    for leaf_i, t in enumerate(tree_leaves(sweep_state)):
        a = t.detach().cpu().numpy()
        # a leaf without a batch axis: JAX's key of a host array
        index = _tile(a.shape, mesh)[1] or (slice(None),)
        blobs[_index_key(leaf_i, index)] = a
    meta = {"step": step}
    if cfg is not None:
        meta["config_hash"] = config_hash(cfg)
    final = f"{path}.shard{0 if mesh is None else mesh.rank}.npz"
    tmp = f"{final}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, _meta=json.dumps(meta), **blobs)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)


def _shard_files(path: str) -> list:
    files = sorted(glob.glob(f"{path}.shard*.npz"))
    if not files:
        raise FileNotFoundError(f"no shard files under {path}.shard*.npz")
    return files


def remove_shards(path: str, first: int) -> None:
    """Remove the shard files of ranks ``first`` and above."""
    for f in glob.glob(f"{path}.shard*.npz"):
        rank = f[len(f"{path}.shard"):-len(".npz")]
        if rank.isdigit() and int(rank) >= first:
            os.remove(f)


def _agreed_meta(metas: list, cfg=None) -> dict:
    """The one ``_meta`` of a set of shard files; raises ``ValueError``
    if they were written under another config or at different steps."""
    if cfg is not None:
        for meta in metas:
            if meta.get("config_hash") not in (None, config_hash(cfg)):
                raise ValueError(
                    "checkpoint was written with a different config "
                    f"({meta.get('config_hash')} != {config_hash(cfg)})")
    steps = sorted({meta.get("step", 0) for meta in metas})
    if len(steps) > 1:
        raise ValueError(
            f"checkpoint shard files do not cover one step: steps {steps} "
            "(restore refused: a state mixed from two steps was never the "
            "sweep's)")
    return metas[0] if metas else {"step": 0}


def sharded_step(path: str, cfg=None) -> int:
    """The step of the shard files under ``path`` (refusals as
    ``restore_sharded``'s)."""
    metas = []
    for f in _shard_files(path):
        with np.load(f, allow_pickle=False) as z:
            if "_meta" in z.files:
                metas.append(json.loads(str(z["_meta"])))
    return int(_agreed_meta(metas, cfg).get("step", 0))


def restore_sharded(path: str, like, mesh=None, cfg=None):
    """This rank's state from every shard file under ``path``. ``like`` is
    the rank's local state (tree, shapes, dtypes and device) under ``mesh``
    (default: a single process); each leaf's tile is rebuilt from the saved
    tiles that cover it, whatever rank count wrote them. ``.tmp`` files of
    an interrupted write are ignored. Raises ``ValueError`` when the tiles
    do not cover a leaf, a tile does not fit the global shape, or the files
    disagree on the step or the config."""
    data: dict = {}
    metas = []
    for f in _shard_files(path):
        with np.load(f, allow_pickle=False) as z:
            for k in z.files:
                if k == "_meta":
                    metas.append(json.loads(str(z[k])))
                elif k not in data:
                    data[k] = z[k]
    _agreed_meta(metas, cfg)
    tiles: dict = {}
    for k, v in data.items():
        leaf_i, sls = _parse_key(k)
        tiles.setdefault(leaf_i, []).append((sls, v))
    like_leaves = tree_leaves(like)
    if set(tiles) - set(range(len(like_leaves))):
        raise ValueError(f"checkpoint holds leaves {sorted(tiles)}, the "
                         f"state {len(like_leaves)}")
    out = []
    for leaf_i, t in enumerate(like_leaves):
        glob_shape, index = _tile(tuple(t.shape), mesh)
        full = np.zeros(glob_shape, dtype=torch.empty(0, dtype=t.dtype)
                        .numpy().dtype)
        covered = np.zeros(glob_shape, dtype=bool)
        for sls, v in tiles.get(leaf_i, []):
            sls = sls if glob_shape else ()
            if full[sls].shape != v.shape:     # never broadcast a tile
                raise ValueError(f"checkpoint leaf {leaf_i}: a tile of shape "
                                 f"{v.shape} does not fit the global shape "
                                 f"{glob_shape}")
            full[sls] = v
            covered[sls] = True
        if not covered[index].all():
            raise ValueError(
                f"checkpoint shard files do not cover leaf {leaf_i} index "
                f"{index}: a shard file is missing or was written partially "
                "(restore refused: zero-filling would make up state)")
        out.append(torch.as_tensor(np.ascontiguousarray(full[index])))
    it = iter(out)
    return tree_map(lambda t: next(it).to(device=t.device, dtype=t.dtype), like)
