"""The trainer's optimizers: optax's stock Adam and RMSprop, and the
Keras-2.0.8-exact variants of ``midi_vae_tpu/training/keras_optim.py``.

The JAX package takes ``optax.adam`` / ``optax.rmsprop`` for 'adam' /
'rmsprop' and writes the two Keras rules out as optax transformations. There
is no optax here, so all four rules are written out in plain torch ops (the
multi-tensor ``torch._foreach_*`` ops, one launch per op over all
parameters), each as a small optimizer over a fixed list of parameters whose
state is a flat dict of tensors that a checkpoint stores and restores
exactly:

* ``adam`` (optax.adam): m = b1 m + (1-b1) g, v = b2 v + (1-b2) g^2,
  p -= lr * m_hat / (sqrt(v_hat) + eps) with the bias corrections of step t.
  ``torch.optim.Adam`` computes the same m_hat / (sqrt(v_hat) + eps).
* ``rmsprop`` (optax.rmsprop, eps inside the square root):
  nu = rho nu + (1-rho) g^2, p -= lr * g / sqrt(nu + eps).
* ``adam_keras``: lr_t = lr sqrt(1-b2^t) / (1-b1^t), p -= lr_t m / (sqrt(v) + eps).
* ``rmsprop_keras``: p -= lr g / (sqrt(a) + eps), eps outside the root.

Defaults mirror optax and Keras 2.0.8 (b1 0.9, b2 0.999, rho 0.9, eps 1e-8,
decay 0).
"""

from __future__ import annotations

import numpy as np
import torch


class Optimizer:
    """Updates ``params`` in place from a list of grads in the same order.
    ``names`` key the state for checkpoints."""

    slots: tuple[str, ...] = ()

    def __init__(self, params: list[torch.Tensor], names: list[str], learning_rate: float):
        self.params = list(params)
        self.names = list(names)
        self.lr = learning_rate
        self.count = 0  # completed steps
        self.state = {s: [torch.zeros_like(p) for p in self.params] for s in self.slots}

    @torch.no_grad()
    def step(self, grads) -> None:
        self._update(list(grads))
        self.count += 1

    def _update(self, grads) -> None:
        raise NotImplementedError

    def state_dict(self) -> dict[str, np.ndarray]:
        out = {"count": np.asarray(self.count, np.int64)}
        for slot, tensors in self.state.items():
            for name, t in zip(self.names, tensors):
                out[f"{slot}/{name}"] = t.detach().cpu().numpy()
        return out

    def load_state_dict(self, d) -> None:
        self.count = int(d["count"])
        for slot, tensors in self.state.items():
            for name, t in zip(self.names, tensors):
                t.copy_(torch.from_numpy(np.asarray(d[f"{slot}/{name}"])))


class Adam(Optimizer):
    slots = ("m", "v")

    def __init__(self, params, names, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, names, learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _update(self, grads):
        m, v = self.state["m"], self.state["v"]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - self.b2)
        t = self.count + 1
        denom = torch._foreach_div(v, 1.0 - self.b2**t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m, 1.0 - self.b1**t)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(self.params, upd, alpha=-self.lr)


class RMSprop(Optimizer):
    slots = ("nu",)

    def __init__(self, params, names, learning_rate, decay=0.9, eps=1e-8):
        super().__init__(params, names, learning_rate)
        self.decay, self.eps = decay, eps

    def _update(self, grads):
        nu = self.state["nu"]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.decay)
        denom = torch._foreach_add(nu, self.eps)
        torch._foreach_sqrt_(denom)
        upd = torch._foreach_div(grads, denom)
        torch._foreach_add_(self.params, upd, alpha=-self.lr)


class KerasAdam(Adam):
    """Keras 2.0.8 Adam: p -= lr_t * m_t / (sqrt(v_t) + eps)."""

    def __init__(self, params, names, learning_rate, b1=0.9, b2=0.999, eps=1e-8, decay=0.0):
        super().__init__(params, names, learning_rate, b1, b2, eps)
        self.decay = decay

    def _update(self, grads):
        m, v = self.state["m"], self.state["v"]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - self.b2)
        lr = self.lr / (1.0 + self.decay * self.count)
        t = self.count + 1
        lr_t = lr * np.sqrt(1.0 - self.b2**t) / (1.0 - self.b1**t)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m, denom)
        torch._foreach_add_(self.params, upd, alpha=-lr_t)


class KerasRMSprop(Optimizer):
    """Keras 2.0.8 RMSprop: p -= lr * g / (sqrt(a_t) + eps)."""

    slots = ("a",)

    def __init__(self, params, names, learning_rate, rho=0.9, eps=1e-8, decay=0.0):
        super().__init__(params, names, learning_rate)
        self.rho, self.eps, self.decay = rho, eps, decay

    def _update(self, grads):
        a = self.state["a"]
        torch._foreach_mul_(a, self.rho)
        torch._foreach_addcmul_(a, grads, grads, value=1.0 - self.rho)
        lr = self.lr / (1.0 + self.decay * self.count)
        denom = torch._foreach_sqrt(a)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(grads, denom)
        torch._foreach_add_(self.params, upd, alpha=-lr)


OPTIMIZERS = {"adam": Adam, "rmsprop": RMSprop, "adam_keras": KerasAdam,
              "rmsprop_keras": KerasRMSprop}
