"""Checkpoint/resume: reference-compatible param pickles + sampler state.

Counterpart of ``gpcsd_tpu.io.checkpoint``, in two tiers:

1. **Parameter dicts**: the reference persists fitted hyperparameters as
   pickled dicts (``gpcsd1d.py:84-102``).  The model classes of this
   package and of the JAX package emit that schema, so a pickle written by
   either package's model loads into the other's.

2. **Sampler state**: a tree of NamedTuples, dicts, lists, tuples, tensors,
   numpy arrays and plain scalars goes to one ``.npz`` (the tensors and
   arrays) plus a pickled structure file (the containers, the NamedTuple
   classes by reference, and the scalars).  Tensors come back as tensors on
   the device the caller names, arrays as arrays.  The JAX package's orbax
   route has no counterpart.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .. import config


def save_params(model, path):
    """Pickle a model's parameter dict in the reference schema."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(model.extract_model_params(), f)


def load_params(model, path):
    """Restore parameters from a (reference-compatible) pickle."""
    with open(path, "rb") as f:
        model.restore_model_params(pickle.load(f))
    return model


# ---------------------------------------------------------------------------
# sampler state
# ---------------------------------------------------------------------------


def _flatten(tree, leaves):
    """The structure of ``tree`` with every tensor and array replaced by its
    index into ``leaves`` (which is appended to)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree.detach().cpu().numpy())
        return ("tensor", len(leaves) - 1)
    if isinstance(tree, np.ndarray):
        leaves.append(tree)
        return ("array", len(leaves) - 1)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ("namedtuple", type(tree), [_flatten(t, leaves) for t in tree])
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_flatten(t, leaves) for t in tree])
    if isinstance(tree, dict):
        return ("dict", {k: _flatten(v, leaves) for k, v in tree.items()})
    if tree is None or isinstance(tree, (bool, int, float, str, np.generic)):
        return ("value", tree)
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _unflatten(node, leaves, device):
    kind = node[0]
    if kind == "tensor":
        return torch.from_numpy(leaves[node[1]]).to(device)
    if kind == "array":
        return leaves[node[1]]
    if kind == "value":
        return node[1]
    if kind == "namedtuple":
        return node[1](*(_unflatten(n, leaves, device) for n in node[2]))
    if kind == "dict":
        return {k: _unflatten(n, leaves, device) for k, n in node[1].items()}
    seq = [_unflatten(n, leaves, device) for n in node[1]]
    return tuple(seq) if kind == "tuple" else seq


def save_sampler_state(state, path):
    """Checkpoint a sampler-state tree to ``path + ".npz"`` and
    ``path + ".structure.pkl"``.

    Atomic: a stop in the middle of a save must never leave a truncated
    ``.npz`` or a structure that does not match it.  Both files go to
    temporaries and are ``os.replace()``d; the ``.npz`` lands last because
    its existence is what gates a resume.
    """
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    leaves = []
    structure = _flatten(state, leaves)
    tmp_structure = path + ".structure.pkl.tmp"
    tmp_npz = path + ".npz.tmp"
    with open(tmp_structure, "wb") as f:
        pickle.dump(structure, f)
    with open(tmp_npz, "wb") as f:
        np.savez(f, **{str(i): leaf for i, leaf in enumerate(leaves)})
    os.replace(tmp_structure, path + ".structure.pkl")
    os.replace(tmp_npz, path + ".npz")


def sampler_state_exists(path) -> bool:
    """Whether :func:`save_sampler_state` has completed a save at ``path``."""
    return os.path.exists(os.path.abspath(path) + ".npz")


def load_sampler_state(path, device=config.DEFAULT_DEVICE):
    """Restore a tree saved by :func:`save_sampler_state`; its tensors are
    placed on ``device``."""
    device = config.get_device(device)
    path = os.path.abspath(path)
    with open(path + ".structure.pkl", "rb") as f:
        structure = pickle.load(f)
    with np.load(path + ".npz") as data:
        leaves = [data[str(i)] for i in range(len(data.files))]
    return _unflatten(structure, leaves, device)
