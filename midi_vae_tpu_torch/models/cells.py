"""RNN cell parameters and step functions (GRU / LSTM / SimpleRNN).

Counterpart of ``midi_vae_tpu/models/cells.py``. The numpy initializers repeat
``_np_rng``/``split_keys``/``glorot_uniform``/``orthogonal`` exactly, so the
same key gives bit-equal parameters in both packages. The step functions are
plain tensor code; the GRU is the classic reset-before cell, ``(r*h) @ U_h``
(``torch.nn.GRU`` and cuDNN compute a reset-after cell and are not used).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

Params = dict[str, Any]


def _np_rng(key) -> np.random.Generator:
    """Numpy generator seeded from a raw uint32 pair (the data of a jax
    PRNG key: ``jax.random.PRNGKey(s)`` is ``[0, s]``)."""
    return np.random.default_rng(np.asarray(key).astype(np.uint32).tolist())


def split_keys(key, n: int = 2) -> np.ndarray:
    """(n, 2) uint32 child keys."""
    return _np_rng(key).integers(0, 2**32, size=(n, 2), dtype=np.uint32)


def glorot_uniform(key, shape, dtype=np.float32):
    fan_in, fan_out = shape[0], shape[1]
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return np.asarray(_np_rng(key).uniform(-limit, limit, size=shape), dtype)


def orthogonal(key, shape, dtype=np.float32):
    """Orthogonal init (rows or columns orthonormal), Keras-style."""
    rows, cols = shape
    big, small = max(rows, cols), min(rows, cols)
    a = _np_rng(key).normal(size=(big, small))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if rows < cols:
        q = q.T
    return np.asarray(q[:rows, :cols], dtype)


def dense_init(key, in_dim: int, out_dim: int) -> Params:
    return {"w": glorot_uniform(key, (in_dim, out_dim)), "b": np.zeros((out_dim,), np.float32)}


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


_ACTIVATIONS = {
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "linear": lambda x: x,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "softplus": torch.nn.functional.softplus,
    "elu": torch.nn.functional.elu,
}


def activation_fn(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


def _hard_sigmoid(x):
    """Keras-2.0.x hard_sigmoid: clip(0.2x + 0.5, 0, 1)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


_GATE_ACTIVATIONS = {"sigmoid": torch.sigmoid, "hard_sigmoid": _hard_sigmoid}


def gate_activation_fn(name: str):
    try:
        return _GATE_ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown gate activation {name!r}") from None


# Each cell provides init(key, in_dim, hidden) -> numpy params, num_states,
# x_proj(params, x) and step(params, xp, states, act, gate_act).


class GRUCell:
    num_states = 1

    @staticmethod
    def init(key, in_dim: int, hidden: int) -> Params:
        k1, k2 = split_keys(key)
        return {
            "w": glorot_uniform(k1, (in_dim, 3 * hidden)),
            "u": orthogonal(k2, (hidden, 3 * hidden)),
            "b": np.zeros((3 * hidden,), np.float32),
        }

    @staticmethod
    def x_proj(p: Params, x: torch.Tensor) -> torch.Tensor:
        return x @ p["w"] + p["b"]

    @staticmethod
    def step(p: Params, xp, states, act, gate_act=torch.sigmoid):
        (h,) = states
        hidden = h.shape[-1]
        u = p["u"]
        hu_zr = h @ u[:, : 2 * hidden]
        xz, xr, xh = torch.split(xp, hidden, dim=-1)
        z = gate_act(xz + hu_zr[:, :hidden])
        r = gate_act(xr + hu_zr[:, hidden:])
        hh = act(xh + (r * h) @ u[:, 2 * hidden :])
        new_h = z * h + (1.0 - z) * hh
        return new_h, (new_h,)


class LSTMCell:
    num_states = 2

    @staticmethod
    def init(key, in_dim: int, hidden: int) -> Params:
        k1, k2 = split_keys(key)
        b = np.zeros((4 * hidden,), np.float32)
        b[hidden : 2 * hidden] = 1.0  # Keras unit_forget_bias
        return {
            "w": glorot_uniform(k1, (in_dim, 4 * hidden)),
            "u": orthogonal(k2, (hidden, 4 * hidden)),
            "b": b,
        }

    @staticmethod
    def x_proj(p: Params, x: torch.Tensor) -> torch.Tensor:
        return x @ p["w"] + p["b"]

    @staticmethod
    def step(p: Params, xp, states, act, gate_act=torch.sigmoid):
        h, c = states
        i, f, g, o = torch.chunk(xp + h @ p["u"], 4, dim=-1)
        new_c = gate_act(f) * c + gate_act(i) * act(g)
        new_h = gate_act(o) * act(new_c)
        return new_h, (new_h, new_c)


class SimpleRNNCell:
    num_states = 1

    @staticmethod
    def init(key, in_dim: int, hidden: int) -> Params:
        k1, k2 = split_keys(key)
        return {
            "w": glorot_uniform(k1, (in_dim, hidden)),
            "u": orthogonal(k2, (hidden, hidden)),
            "b": np.zeros((hidden,), np.float32),
        }

    @staticmethod
    def x_proj(p: Params, x: torch.Tensor) -> torch.Tensor:
        return x @ p["w"] + p["b"]

    @staticmethod
    def step(p: Params, xp, states, act, gate_act=torch.sigmoid):
        (h,) = states
        new_h = act(xp + h @ p["u"])
        return new_h, (new_h,)


_CELLS = {"GRU": GRUCell, "LSTM": LSTMCell, "SimpleRNN": SimpleRNNCell}


def get_cell(cell_type: str):
    try:
        return _CELLS[cell_type]
    except KeyError:
        raise ValueError(f"unknown cell_type {cell_type!r}") from None


def zero_states(cell, batch: int, hidden: int, like: torch.Tensor) -> tuple:
    return tuple(like.new_zeros((batch, hidden)) for _ in range(cell.num_states))
