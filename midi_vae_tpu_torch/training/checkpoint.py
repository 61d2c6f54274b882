"""Run directories of the port: ``config.json`` + ``params.npz``.

``load_config`` is a copy of ``midi_vae_tpu/training/checkpoint.py::
load_config`` (that package's ``__init__`` imports jax). The parameters are
one ``.npz`` whose keys are the JAX params tree's key paths joined with
``/`` (``bridge.save_params``); ``tools/jax_run_to_torch.py`` converts a JAX
run directory into one.
"""

from __future__ import annotations

import os

from midi_vae_tpu.config import Config

from .. import bridge

PARAMS_FILE = "params.npz"


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
