"""Parameter bridge between the JAX package's params tree and the port.

The JAX package keeps its parameters as a nested tree of dicts and lists of
arrays (``midi_vae_tpu/models/vae.py::MidiVAE.init_params``). The port holds
the same tree as modules under the same key paths: a dict of arrays becomes an
``nn.ParameterDict``, a dict of subtrees an ``nn.ModuleDict``, a list an
``nn.ModuleList``. So ``params["decoder"]["notes"]["cells"][0]["u"]`` names
the same array in both packages, and ``state_dict()`` keys are the key paths
joined with ``.``. On disk (``params.npz``) the paths are joined with ``/``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {"a/0/w": array}."""
    out: dict[str, np.ndarray] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple)):
            out.update(flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def unflatten(flat: dict[str, Any]):
    """Inverse of ``flatten``: a level whose keys are all digits is a list."""
    root: dict = {}
    for path, value in flat.items():
        node = root
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_params(path: str, tree) -> None:
    """Write the tree as an ``.npz`` with ``/``-joined keys."""
    np.savez(path, **flatten(tree))


def load_params(path: str):
    with np.load(path) as data:
        return unflatten({k: data[k] for k in data.files})


def to_module(tree, trainable: bool = False) -> nn.Module:
    """Numpy tree -> module tree of contiguous float32 parameters. Serving
    keeps ``trainable=False`` (no gradients); the trainer asks for
    ``trainable=True``."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([to_module(v, trainable) for v in tree])
    leaves = {k: v for k, v in tree.items() if not isinstance(v, (dict, list, tuple))}
    if leaves and len(leaves) != len(tree):
        raise ValueError(f"mixed array/subtree node: {sorted(tree)}")
    if leaves:
        return nn.ParameterDict({
            # a copy: the trainer updates parameters in place, and the
            # caller's arrays may be shared or read-only
            k: nn.Parameter(torch.from_numpy(np.array(v, dtype=np.float32, order="C")),
                            requires_grad=trainable)
            for k, v in leaves.items()
        })
    return nn.ModuleDict({k: to_module(v, trainable) for k, v in tree.items()})


def to_tree(module: nn.Module):
    """Module tree -> numpy tree under the same key paths."""
    return unflatten({
        k.replace(".", "/"): v.detach().cpu().numpy() for k, v in module.state_dict().items()
    })
