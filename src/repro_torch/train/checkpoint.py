"""Checkpoint save / restore with an atomic rename and keep-k rotation:
counterpart of ``repro.train.checkpoint``, file for file.

  * ``save`` writes ``proc<k>_step_<N>.npz.tmp``, then ``os.replace``s it,
    so a host dying mid-write never corrupts the latest checkpoint;
  * the arrays are named by their key paths, ``p/<path>`` for the params
    and ``o/<path>`` for the optimizer state, a path the dict keys and
    sequence indices from the root joined by ``/``, in sorted-key order
    (``jax.tree_util``'s); the JSON ``__manifest__`` holds the step and the
    caller's extras;
  * keep-k: older steps are deleted only after the new save is in place.

So a checkpoint written by either package restores in the other. bfloat16
leaves are written as numpy writes the reference's (ml_dtypes) bfloat16
arrays, 2-byte void words (``<V2``), and read back bit for bit by the
template's dtype; no ml_dtypes is needed.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import tree

_SEP = "/"
_V2 = np.dtype("V2")


def _process_index() -> int:
    dist = torch.distributed
    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)


def _flatten(t) -> Dict[str, Any]:
    return dict(tree.named_leaves(t, sep=_SEP))


def _to_numpy(x) -> np.ndarray:
    x = torch.as_tensor(x).detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_V2)
    return x.numpy()


def _from_numpy(a: np.ndarray, like) -> torch.Tensor:
    """The array as a tensor of the template leaf's dtype (bfloat16 from
    its 2-byte words), shape and device (the CPU for a ``meta`` leaf)."""
    want = like.dtype
    if want == torch.bfloat16:
        if a.dtype.itemsize != 2 or a.dtype.kind not in "Vfiu":
            raise ValueError(f"checkpoint: a bfloat16 leaf stored as "
                             f"{a.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
        if t.dtype != want:
            raise ValueError(f"checkpoint: leaf stored as {a.dtype}, the "
                             f"template's is {want}")
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint: leaf of shape {tuple(t.shape)}, the "
                         f"template's is {tuple(like.shape)}")
    return t if like.device.type == "meta" else t.to(like.device)


def _unflatten(template, flat: Dict[str, Any]):
    names = list(_flatten(template))
    return tree.unflatten(template, [
        _from_numpy(flat[k], like)
        for k, like in zip(names, tree.leaves(template))])


def save(ckpt_dir: str, step: int, params, opt_state=None, *,
         extra: Optional[dict] = None, keep: int = 3,
         process_index: Optional[int] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    proc = _process_index() if process_index is None else process_index
    arrays = {f"p{_SEP}{k}": _to_numpy(v)
              for k, v in _flatten(params).items()}
    if opt_state is not None:
        arrays.update({f"o{_SEP}{k}": _to_numpy(v)
                       for k, v in _flatten(opt_state).items()})
    manifest = json.dumps({"step": int(step), "extra": extra or {}})
    fname = os.path.join(ckpt_dir, f"proc{proc}_step_{step:09d}.npz")
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __manifest__=manifest, **arrays)
    os.replace(tmp, fname)                      # atomic: never half-written
    _rotate(ckpt_dir, proc, keep)
    return fname


def _rotate(ckpt_dir: str, proc: int, keep: int):
    pat = re.compile(rf"proc{proc}_step_(\d+)\.npz$")
    found = sorted(
        (int(m.group(1)), f) for f in os.listdir(ckpt_dir)
        if (m := pat.match(f)))
    for _, f in found[:-keep] if keep > 0 else []:
        os.remove(os.path.join(ckpt_dir, f))


def latest_step(ckpt_dir: str, process_index: Optional[int] = None
                ) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    proc = _process_index() if process_index is None else process_index
    pat = re.compile(rf"proc{proc}_step_(\d+)\.npz$")
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := pat.match(f))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, params_template, opt_template=None, *,
            step: Optional[int] = None,
            process_index: Optional[int] = None
            ) -> Tuple[int, Any, Any, dict]:
    """Returns (step, params, opt_state, extra). The templates (trees of
    tensors, ``meta`` ones too) give the structure, dtypes, shapes and
    devices: each leaf lands on its template leaf's device (the CPU for a
    ``meta`` leaf)."""
    proc = _process_index() if process_index is None else process_index
    if step is None:
        step = latest_step(ckpt_dir, process_index=proc)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    fname = os.path.join(ckpt_dir, f"proc{proc}_step_{step:09d}.npz")
    with np.load(fname, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        flat = {k: z[k] for k in z.files if k != "__manifest__"}
    p_flat = {k[len(f"p{_SEP}"):]: v for k, v in flat.items()
              if k.startswith(f"p{_SEP}")}
    params = _unflatten(params_template, p_flat)
    opt_state = None
    if opt_template is not None:
        o_flat = {k[len(f"o{_SEP}"):]: v for k, v in flat.items()
                  if k.startswith(f"o{_SEP}")}
        opt_state = _unflatten(opt_template, o_flat)
    return manifest["step"], params, opt_state, manifest.get("extra", {})
