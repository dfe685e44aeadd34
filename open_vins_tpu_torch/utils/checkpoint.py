"""Filter-state checkpoint / resume.

Counterpart of `open_vins_tpu/utils/checkpoint.py`.  The filter (VioState,
the feature table, anything else a caller keeps) is a pytree of tensors:
every record of the port registers itself as one, in field order, as the
JAX package's NamedTuples flatten.  A checkpoint is one flat npz whose keys
are the leaves' places, `state.{i}`, `table.{i}` and `extra.{k}`, the same
keys in the same leaf order as the JAX package writes, so a checkpoint of
either package loads into the other.  Restoring mid-sequence resumes the
estimator exactly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree

from open_vins_tpu_torch import resolve_device


def _numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix, out):
    leaves, treedef = pytree.tree_flatten(tree)
    for i, leaf in enumerate(leaves):
        out[f"{prefix}.{i}"] = _numpy(leaf)
    return treedef


def save(path, state, table=None, extra=None):
    """Write a checkpoint npz.  `extra` is an optional dict of arrays."""
    out = {}
    defs = {"state": _flatten(state, "state", out)}
    if table is not None:
        defs["table"] = _flatten(table, "table", out)
    if extra:
        for k, v in extra.items():
            out[f"extra.{k}"] = _numpy(v)
    np.savez(path, **out)
    return defs


def load(path, state_template, table_template=None, device=None):
    """Restore (state, table, extra) shaped like the given templates, with
    their tensors on `device` (None = CUDA; pass the template's device,
    `state_template.cov.device`, to restore where it lies).  Each leaf keeps
    the dtype it was saved with; a leaf whose shape differs from its
    template's raises."""
    dev = resolve_device(device)
    with np.load(path) as data:
        def restore(template, prefix):
            leaves, treedef = pytree.tree_flatten(template)
            new = []
            for i, leaf in enumerate(leaves):
                a = data[f"{prefix}.{i}"]
                if tuple(a.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"checkpoint leaf {prefix}.{i} has shape "
                        f"{a.shape}, the template {tuple(leaf.shape)}")
                new.append(torch.as_tensor(np.array(a), device=dev))
            return pytree.tree_unflatten(new, treedef)

        state = restore(state_template, "state")
        table = (restore(table_template, "table")
                 if table_template is not None else None)
        extra = {k[len("extra."):]: data[k] for k in data.files
                 if k.startswith("extra.")}
    return state, table, extra
