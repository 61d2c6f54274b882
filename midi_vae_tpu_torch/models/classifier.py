"""Style classifiers (the judges): one RNN-classifier module, three input kinds.

Counterpart of ``midi_vae_tpu/models/classifier.py`` on its inference path:
``ClassifierSpec`` (with ``for_kind`` and ``preprocess_inputs``), the
stacked-RNN ``StyleClassifier`` (2 x RNN(256) -> dense softmax over the
classes), ``ensemble_prediction``, ``make_judge`` and
``classifier_inputs_for_kind``. ``init_params`` consumes keys as the JAX
package does, so a seed gives bit-equal parameters.

``ClassifierSpec.for_kind`` copies the VAE's ``cell_type``, so the judges of
an LSTM run encode through kernel L and those of a GRU run through kernel A
(``encode_sequence``: the wrappers run their plain versions on CPU tensors).
Training the judges (``classifier_loss``, ``training/classifier_trainer.py``
of the JAX package) is not ported yet.
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
    ``[0, seed]``."""

    def __init__(self, spec: ClassifierSpec, params: Params | None = None, seed: int = 0):
        super().__init__()
        self.spec = spec
        self.cell = get_cell(spec.cell_type)
        if params is None:
            params = self.init_params(np.array([0, seed], np.uint32))
        self.params = bridge.to_module(params)

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

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, input_dim) -> (B, num_classes), on the inference path."""
        h = encode_sequence(self.params["rnn"], x, self.spec.cell_type, "tanh",
                            kernels=self.kernels_enabled(),
                            gate_activation=self.spec.gate_activation)
        return dense_apply(self.params["out"], h)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Softmax class probabilities -- the Keras ``model.predict``."""
        return torch.softmax(self.logits(x), dim=-1)


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
