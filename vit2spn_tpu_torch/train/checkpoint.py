"""Checkpoint save/restore (port of `vit2spn_tpu/train/checkpoint.py`).

The same file format as the JAX package, so checkpoints move between the two
packages in both directions: one .npz with the tree's leaves flattened under
"/"-joined paths (dict keys, NamedTuple field names, sequence indices — the
JAX package's `_path_key` names) plus a `__metadata__` JSON blob.

`restore` takes a template tree (`like=`) and returns the same structure
with the stored values as tensors of the template's dtype and device; keys
must match exactly, as the JAX package's `restore(strict=True)`. The
port's trainer state (train/ssp.py::SSPTrainState) holds the parameters,
Adam's state under optax.adam's leaf names (`opt_state/0/count`,
`opt_state/0/mu/0/...`, `opt_state/0/nu/1/...`) and the step count, so a
training checkpoint restores strictly in either package, moments included.
Keys that start with a prefix in `ignore` are neither read nor counted as
extra: serving reads params and step alone with `ignore=("opt_state/",)`,
which also takes a params-only file.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Iterable, Optional

import numpy as np
import torch


def _children(tree):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if hasattr(tree, "_fields"):  # NamedTuple
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> dict:
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            return {prefix: tree.detach().cpu().numpy()}
        return {prefix: np.asarray(tree)}
    flat = {}
    for k, v in kids:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def save(path: str, tree, metadata: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = _flatten(tree)
    payload["__metadata__"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8
    )
    # atomic write: tmp file + rename, so an interrupted save never corrupts
    # an existing checkpoint
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def metadata(path: str) -> dict:
    with np.load(path) as raw:
        if "__metadata__" in raw:
            return json.loads(raw["__metadata__"].tobytes().decode())
    return {}


def compatible(path: str, like) -> Optional[str]:
    """None when `restore(path, like)` would succeed (the same leaf keys,
    the same element counts: restore reshapes, so shapes are checked by
    size as restore checks them); else a readable reason. Never raises for
    a well-formed npz; reads only the file's shapes and `like`'s."""
    with np.load(path) as raw:
        stored = {k: raw[k].shape for k in raw.files if k != "__metadata__"}
    used = set()
    for key, leaf in _flatten_shapes(like).items():
        if key not in stored:
            return f"checkpoint lacks leaf {key!r}"
        want = tuple(np.shape(leaf))
        if int(np.prod(stored[key])) != int(np.prod(want)):
            return (f"leaf {key!r}: stored shape {stored[key]} is incompatible "
                    f"with expected {want}")
        used.add(key)
    extra = sorted(set(stored) - used)
    if extra:
        return f"checkpoint has extra leaves {extra[:5]}"
    return None


def _flatten_shapes(tree, prefix: str = "") -> dict:
    """{leaf key: leaf} in the order of `_flatten`, without copying."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for k, v in kids:
        flat.update(_flatten_shapes(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _rebuild(like, stored: dict, prefix: str, used: set, missing: list):
    kids = _children(like)
    if kids is None:
        if prefix not in stored:
            missing.append(prefix)
            return like
        used.add(prefix)
        arr = np.asarray(stored[prefix])
        if arr.size != int(np.prod(np.shape(like))):
            raise ValueError(f"leaf {prefix!r}: stored shape {arr.shape} is "
                             f"incompatible with expected {tuple(np.shape(like))}")
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(
                dtype=like.dtype, device=like.device).reshape(like.shape)
        return arr.astype(np.asarray(like).dtype).reshape(np.shape(like))
    vals = {k: _rebuild(v, stored, f"{prefix}/{k}" if prefix else k, used,
                        missing) for k, v in kids}
    if isinstance(like, dict):
        return {k: vals[str(k)] for k in like}
    if hasattr(like, "_fields"):
        return type(like)(**vals)
    return type(like)(vals[str(i)] for i in range(len(like)))


def restore(path: str, like, ignore: Iterable[str] = ()):
    """Load leaves into the structure of `like`, strictly: a leaf missing
    from the file, or a stored key the template lacks, raises KeyError.
    Stored keys that start with a prefix in `ignore` are skipped."""
    ignore = tuple(ignore)
    with np.load(path) as raw:
        stored = {k: raw[k] for k in raw.files
                  if k != "__metadata__" and not k.startswith(ignore)}
    used: set = set()
    missing: list = []
    out = _rebuild(like, stored, "", used, missing)
    extra = set(stored) - used
    if missing or extra:
        raise KeyError(f"checkpoint mismatch: missing={missing[:5]} "
                       f"extra={sorted(extra)[:5]}")
    return out


def exists(path: str) -> bool:
    return os.path.exists(path)
