"""Run directories and training checkpoints of the port.

A run directory holds ``config.json`` + ``params.npz``: what the transfer
CLI serves. ``load_config`` is a copy of ``midi_vae_tpu/training/
checkpoint.py::load_config`` (that package's ``__init__`` imports jax). The
parameters are one ``.npz`` whose keys are the JAX params tree's key paths
joined with ``/`` (``bridge.save_params``); ``tools/jax_run_to_torch.py``
converts a JAX run directory into one.

A training run adds one ``epoch_N/`` per checkpoint (counterpart of the JAX
package's orbax checkpoints, ``save_checkpoint``/``restore_checkpoint``/
``latest_epoch``): ``params.npz``, ``opt_state.npz`` (the optimizer's count
and moments under ``<slot>/<parameter name>``), ``rng.npy`` (the
``torch.Generator`` state) and ``state.json`` (the epoch and the generator's
device). Resume is exact: the same params, moments and generator state.

A judge directory (``save_classifier``/``load_classifier``) holds one
sub-directory per kind (``pitch/``, ``velocity/``, ``instrument/``), each
with ``spec.json`` (the ``ClassifierSpec`` fields, as the JAX package writes
them) and ``params.npz``; ``tools/jax_run_to_torch.py --classifiers``
converts the JAX package's judge directories into it.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from .. import bridge
from ..config import Config
from ..models.classifier import ClassifierSpec, StyleClassifier

PARAMS_FILE = "params.npz"
OPT_FILE = "opt_state.npz"
SPEC_FILE = "spec.json"
RNG_FILE = "rng.npy"
STATE_FILE = "state.json"


def load_config(run_dir: str) -> Config:
    path = os.path.join(run_dir, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no config.json under {run_dir!r} -- is this a run directory?"
        )
    return Config.load(path)


def save_run(run_dir: str, cfg: Config, params) -> None:
    """Write ``config.json`` and ``params.npz`` (params: the numpy tree)."""
    os.makedirs(run_dir, exist_ok=True)
    cfg.save(os.path.join(run_dir, "config.json"))
    bridge.save_params(os.path.join(run_dir, PARAMS_FILE), params)


def load_params(run_dir: str):
    """The numpy params tree of a port run directory."""
    path = os.path.join(run_dir, PARAMS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no {PARAMS_FILE} under {run_dir!r}; convert a JAX run with "
            "tools/jax_run_to_torch.py"
        )
    return bridge.load_params(path)


def load_run_params(run_dir: str, epoch: int | None = None):
    """The params a serving CLI takes from a run: ``epoch_<epoch>/``'s
    (``restore_checkpoint``) when ``epoch`` is given, else the run's
    top-level ``params.npz`` (the latest checkpoint's after training, or a
    converted or seeded run's)."""
    if epoch is None:
        return load_params(run_dir)
    return restore_checkpoint(run_dir, epoch)["params"]


def save_checkpoint(run_dir: str, epoch: int, params, opt_state: dict, rng: torch.Generator,
                    cfg: Config | None) -> str:
    """Write ``run_dir/epoch_<epoch>/`` (params: the numpy tree; opt_state:
    a flat dict of arrays) and ``config.json`` beside it. Returns its path."""
    path = os.path.join(run_dir, f"epoch_{epoch}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    bridge.save_params(os.path.join(tmp, PARAMS_FILE), params)
    np.savez(os.path.join(tmp, OPT_FILE), **opt_state)
    np.save(os.path.join(tmp, RNG_FILE), rng.get_state().numpy())
    with open(os.path.join(tmp, STATE_FILE), "w") as f:
        json.dump({"epoch": int(epoch), "rng_device": rng.device.type}, f)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)  # a checkpoint on disk is always complete
    if cfg is not None:
        cfg.save(os.path.join(run_dir, "config.json"))
    return path


def latest_epoch(run_dir: str) -> int | None:
    if not os.path.isdir(run_dir):
        return None
    epochs = []
    for name in os.listdir(run_dir):
        if name.startswith("epoch_"):
            try:
                epochs.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(epochs) if epochs else None


def restore_checkpoint(run_dir: str, epoch: int | None = None) -> dict:
    """{params (numpy tree), opt_state (dict of arrays), rng_state (uint8
    tensor), rng_device, epoch}; epoch=None means the latest."""
    if epoch is None:
        epoch = latest_epoch(run_dir)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {run_dir}")
    path = os.path.join(run_dir, f"epoch_{epoch}")
    with open(os.path.join(path, STATE_FILE)) as f:
        state = json.load(f)
    with np.load(os.path.join(path, OPT_FILE)) as d:
        opt_state = {k: d[k] for k in d.files}
    return {
        "params": bridge.load_params(os.path.join(path, PARAMS_FILE)),
        "opt_state": opt_state,
        "rng_state": torch.from_numpy(np.load(os.path.join(path, RNG_FILE))),
        "rng_device": state["rng_device"],
        "epoch": int(state["epoch"]),
    }


def save_classifier(kind_dir: str, spec, params) -> None:
    """Write one judge: ``spec.json`` (``spec``: a ``ClassifierSpec``, or the
    JAX package's, whose fields are the same) and ``params.npz`` (the numpy
    tree)."""
    os.makedirs(kind_dir, exist_ok=True)
    with open(os.path.join(kind_dir, SPEC_FILE), "w") as f:
        json.dump(dict(spec.__dict__), f, indent=2)
    bridge.save_params(os.path.join(kind_dir, PARAMS_FILE), params)


def load_spec(kind_dir: str) -> ClassifierSpec:
    """The ``ClassifierSpec`` of one judge directory."""
    path = os.path.join(kind_dir, SPEC_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {SPEC_FILE} under {kind_dir!r} -- is this a judge directory?")
    with open(path) as f:
        return ClassifierSpec(**json.load(f))


def load_classifier(kind_dir: str):
    """The ``StyleClassifier`` of one judge directory, on the CPU."""
    return StyleClassifier(load_spec(kind_dir),
                           bridge.load_params(os.path.join(kind_dir, PARAMS_FILE)))
