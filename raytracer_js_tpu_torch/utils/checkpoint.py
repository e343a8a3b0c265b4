"""Checkpoint / resume (port of ``raytracer_js_tpu.utils.checkpoint``).

A snapshot of a nested structure of tensors — a fit's params and its
optimizer's ``state_dict`` — is one ``.npz`` file holding the arrays and a
JSON sidecar holding the structure (dicts with their int or str keys,
lists, tuples, Python scalars), the step and user metadata. A killed fit
resumes from it bit for bit.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from ..config import resolve_device

PathLike = Union[str, pathlib.Path]


def _encode(obj: Any, leaves: list):
    """The structure of ``obj`` as JSON, its tensors and arrays appended to
    ``leaves``."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return {"t": len(leaves) - 1}
    if isinstance(obj, np.ndarray):
        leaves.append(obj)
        return {"a": len(leaves) - 1}
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, (int, str)):
                raise TypeError(f"checkpoint dict keys are int or str, got "
                                f"{type(k).__name__}")
        return {"d": [[k, _encode(v, leaves)] for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        tag = "l" if isinstance(obj, list) else "u"
        return {tag: [_encode(v, leaves) for v in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"v": obj}
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _decode(node: dict, arrays, like_leaves, device):
    tag, val = next(iter(node.items()))
    if tag in ("t", "a"):
        arr = arrays[f"leaf_{val}"]
        if like_leaves is not None:
            ref = like_leaves[val]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {val}: checkpoint shape {arr.shape} "
                                 f"!= expected {tuple(ref.shape)}")
            if isinstance(ref, torch.Tensor):
                return torch.as_tensor(arr, dtype=ref.dtype,
                                       device=ref.device)
            return arr.astype(ref.dtype)
        if tag == "a":
            return arr
        return torch.as_tensor(arr, device=device)
    if tag == "d":
        return {k: _decode(v, arrays, like_leaves, device) for k, v in val}
    if tag in ("l", "u"):
        out = [_decode(v, arrays, like_leaves, device) for v in val]
        return out if tag == "l" else tuple(out)
    return val


def _shape_of(node: dict):
    """The structure without leaf contents, for comparing two trees."""
    tag, val = next(iter(node.items()))
    if tag == "d":
        return ("d", tuple((k, _shape_of(v)) for k, v in val))
    if tag in ("l", "u"):
        return (tag, tuple(_shape_of(v) for v in val))
    return (tag, val if tag in ("t", "a") else None)


def save(path: PathLike, tree: Any, step: int = 0,
         meta: Optional[dict] = None) -> pathlib.Path:
    """Write a snapshot -> ``<path>.npz`` plus ``<path>.json``; each file is
    written under a temporary name and renamed, the arrays last."""
    path = pathlib.Path(path).with_suffix(".npz")
    leaves: list = []
    skeleton = _encode(tree, leaves)
    side = path.with_suffix(".json")
    tmp = side.with_suffix(".json.tmp")
    tmp.write_text(json.dumps({"step": int(step), "n_leaves": len(leaves),
                               "tree": skeleton, "user": meta or {}}))
    tmp.replace(side)
    tmp = path.with_suffix(".npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i}": (a.detach().cpu().numpy()
                                     if isinstance(a, torch.Tensor) else a)
                       for i, a in enumerate(leaves)})
    tmp.replace(path)
    return path


def restore(path: PathLike, like: Any = None,
            device=None) -> Tuple[Any, int, dict]:
    """Load a snapshot -> (tree, step, meta).

    With ``like``, the stored structure must equal ``like``'s (else
    ``ValueError``) and each leaf takes the shape, dtype and device of
    ``like``'s leaf; without it, tensors come back with their stored dtype
    on ``device`` (default the card, ``config.resolve_device``).
    """
    path = pathlib.Path(path).with_suffix(".npz")
    info = json.loads(path.with_suffix(".json").read_text())
    like_leaves = None
    if like is None:
        device = resolve_device(device)
    else:
        like_leaves = []
        like_skel = _encode(like, like_leaves)
        if _shape_of(like_skel) != _shape_of(info["tree"]):
            raise ValueError(f"checkpoint has {info['n_leaves']} leaves in "
                             f"another structure than expected "
                             f"({len(like_leaves)} leaves)")
    with np.load(path) as z:
        tree = _decode(info["tree"], z, like_leaves, device)
    return tree, int(info["step"]), info.get("user", {})


def latest(directory: PathLike,
           prefix: str = "ckpt_") -> Optional[pathlib.Path]:
    """Newest ``<prefix><step>.npz`` in a directory, by step number."""
    best, best_step = None, -1
    for p in pathlib.Path(directory).glob(f"{prefix}*.npz"):
        try:
            step = int(p.stem[len(prefix):])
        except ValueError:
            continue
        if step > best_step:
            best, best_step = p, step
    return best
