"""Style classifiers (the judges): one RNN-classifier module, three input kinds.

Counterpart of ``midi_vae_tpu/models/classifier.py``: ``ClassifierSpec``
(with ``for_kind`` and ``preprocess_inputs``), the stacked-RNN
``StyleClassifier`` (2 x RNN(256) -> dense softmax over the classes),
``classifier_loss`` (masked crossentropy and accuracy),
``ensemble_prediction``, ``make_judge`` and ``classifier_inputs_for_kind``.
``init_params`` consumes keys as the JAX package does, so a seed gives
bit-equal parameters.

``ClassifierSpec.for_kind`` copies the VAE's ``cell_type``. Serving
(``predict``) encodes through kernel A (GRU judges) or L (LSTM judges); the
training path (``logits(x, train=True)``, as the JAX package's
``logits(inference=False)``) takes the differentiable layers on the route
``ops/_layout.py`` picks from the judge's width: A + C + W or F + G + W for
GRU judges, L + N + W or Q + R + W for LSTM judges (``encode_sequence``: the
wrappers run their plain versions on CPU tensors). The judges are trained by
``training/classifier_trainer.py`` (``cli/classify.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from .. import bridge
from ..config import Config
from ..data.batching import bucket_pow2
from ..ops import _layout
from .cells import dense_apply, dense_init, get_cell, split_keys
from .rnn import encode_sequence

Params = dict[str, Any]

CLASSIFIER_KINDS = ("pitch", "velocity", "instrument")


@dataclass(frozen=True)
class ClassifierSpec:
    kind: str
    input_dim: int
    num_classes: int
    lstm_size: int = 256
    num_layers: int = 2
    cell_type: str = "GRU"
    gate_activation: str = "sigmoid"
    learning_rate: float = 2e-5
    batch_size: int = 512
    # velocity-kind preprocessing (velocity_classifier.py:58-71,138-144)
    only_train_note_starts: bool = False
    scale_velocity_between_0_and_1: bool = False
    velocity_threshold: float = 0.5

    # per-kind learning rates of the reference: pitch/velocity 2e-5,
    # instrument 1e-5
    DEFAULT_LEARNING_RATES = {"pitch": 2e-5, "velocity": 2e-5, "instrument": 1e-5}

    @classmethod
    def for_kind(cls, kind: str, cfg: Config, **overrides) -> "ClassifierSpec":
        dims = {"pitch": cfg.input_dim, "velocity": 1, "instrument": cfg.instrument_dim}
        if kind not in dims:
            raise ValueError(f"unknown classifier kind {kind!r}")
        base = dict(
            kind=kind,
            input_dim=dims[kind],
            num_classes=cfg.num_classes,
            cell_type=cfg.cell_type,
            gate_activation=cfg.gate_activation,
            learning_rate=cls.DEFAULT_LEARNING_RATES[kind],
            velocity_threshold=cfg.velocity_threshold,
        )
        base.update(overrides)
        return cls(**base)

    def preprocess_inputs(self, x):
        """Kind-specific input transforms (velocity_classifier.py:138-144)."""
        if self.kind != "velocity":
            return x
        x = np.copy(np.asarray(x))
        if self.scale_velocity_between_0_and_1:
            nz = np.nonzero(x)
            x[nz] = (x[nz] - self.velocity_threshold) / (1.0 - self.velocity_threshold)
        if self.only_train_note_starts:
            x[np.nonzero(x)] = 1
        return x


class StyleClassifier(nn.Module):
    """Stacked-RNN sequence classifier; ``params=None`` initializes from
    ``[0, seed]``; ``trainable=True`` gives the parameters gradients."""

    def __init__(self, spec: ClassifierSpec, params: Params | None = None, seed: int = 0,
                 trainable: bool = False):
        super().__init__()
        self.spec = spec
        self.cell = get_cell(spec.cell_type)
        if params is None:
            params = self.init_params(np.array([0, seed], np.uint32))
        self.params = bridge.to_module(params, trainable=trainable)

    def kernels_enabled(self) -> bool:
        """Whether the layers go through the kernel wrappers (the JAX
        ``StyleClassifier._pallas_enabled``; its cells are tanh)."""
        return self.spec.cell_type in ("GRU", "LSTM") and self.spec.gate_activation == "sigmoid"

    def init_params(self, key) -> Params:
        spec = self.spec
        keys = split_keys(key, spec.num_layers + 1)
        layers = []
        d = spec.input_dim
        for i in range(spec.num_layers):
            layers.append(self.cell.init(keys[i], d, spec.lstm_size))
            d = spec.lstm_size
        return {"rnn": layers, "out": dense_init(keys[-1], spec.lstm_size, spec.num_classes)}

    def train_route(self, device: torch.device) -> str:
        """``"narrow"`` or ``"wide"``: the training layers' builds at the
        judge's width (``ops/_layout.py``); no decode heads, and the first
        layer's dx is not wanted."""
        spec = self.spec
        layers = [(spec.input_dim, False)] + [(spec.lstm_size, True)] * (spec.num_layers - 1)
        return _layout.train_route(spec.lstm_size, layers, [], on_card=device.type == "cuda",
                                   cell_type=spec.cell_type)

    def logits(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, T, input_dim) -> (B, num_classes), on the inference path or,
        with ``train``, on the training path."""
        kernels = self.kernels_enabled()
        wide = kernels and train and self.train_route(x.device) == "wide"
        h = encode_sequence(self.params["rnn"], x, self.spec.cell_type, "tanh",
                            kernels=kernels, gate_activation=self.spec.gate_activation,
                            train=train, wide=wide)
        return dense_apply(self.params["out"], h)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Softmax class probabilities -- the Keras ``model.predict``."""
        return torch.softmax(self.logits(x), dim=-1)


def classifier_loss(model: StyleClassifier, x: torch.Tensor, c_onehot: torch.Tensor,
                    mask: torch.Tensor | None = None):
    """Categorical crossentropy + accuracy (pitch_classifier.py:102-103), on
    the training path; ``mask`` (B,) keeps padding rows out of both means.
    Returns (loss, {"loss", "acc"})."""
    return masked_crossentropy(model.logits(x, train=True), c_onehot, mask)


def masked_crossentropy(logits: torch.Tensor, c_onehot: torch.Tensor,
                        mask: torch.Tensor | None = None):
    """``classifier_loss`` from logits (B, num_classes) already computed."""
    xent = -(c_onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    correct = (logits.argmax(-1) == c_onehot.argmax(-1)).float()
    if mask is not None:
        denom = torch.clamp(mask.sum(), min=1e-8)
        loss, acc = (xent * mask).sum() / denom, (correct * mask).sum() / denom
    else:
        loss, acc = xent.mean(), correct.mean()
    return loss, {"loss": loss, "acc": acc}


# ---------------------------------------------------------------------------
# Ensemble judge (vae_evaluation.py:110-117)
# ---------------------------------------------------------------------------

DEFAULT_ENSEMBLE_WEIGHT = 0.999 - 0.5  # subtract 0.5: a random judge weighs 0


def ensemble_prediction(pitch_probs, instrument_probs, velocity_probs,
                        weights: tuple[float, float, float] = (
                            DEFAULT_ENSEMBLE_WEIGHT, DEFAULT_ENSEMBLE_WEIGHT,
                            DEFAULT_ENSEMBLE_WEIGHT)):
    wp, wi, wv = weights
    return (pitch_probs * wp + instrument_probs * wi + velocity_probs * wv) / (wp + wi + wv)


def make_judge(model: StyleClassifier):
    """A numpy-in, probs-out predict callable on the model's device: inputs
    preprocessed per the classifier spec, padded to ``bucket_pow2`` rows (the
    JAX package's static shapes), trimmed on return."""
    spec = model.spec
    device = next(model.parameters()).device

    def predict(x):
        x = np.asarray(spec.preprocess_inputs(x), np.float32)
        n = x.shape[0]
        xp = np.zeros((bucket_pow2(n), *x.shape[1:]), np.float32)
        xp[:n] = x
        with torch.inference_mode():
            return model.predict(torch.from_numpy(xp).to(device)).cpu().numpy()[:n]

    return predict


def classifier_inputs_for_kind(kind: str, X, V, I):
    """The classifier input arrays from window tensors. For 'instrument' the
    reference feeds ONE instrument matrix per song
    (instrument_classifier.py:231-237); callers pass per-window tiles and may
    deduplicate per song themselves."""
    if kind == "pitch":
        return X
    if kind == "velocity":
        return V
    if kind == "instrument":
        return I
    raise ValueError(f"unknown classifier kind {kind!r}")
