"""Training the style judges: host-driven epochs of Adam steps and a
confusion-matrix evaluation, on one device.

Counterpart of ``midi_vae_tpu/training/classifier_trainer.py``:
``classifier_arrays`` (:31), ``ClassifierState`` (:47), ``ClassifierTrainer``
with ``train_step`` (:68), ``run_epoch`` (:102), ``evaluate`` (:199: the
per-window (per-song for the instrument kind) predictions accumulated into a
confusion matrix, accuracy = trace / sum, pitch_classifier.py:116-149),
``fit`` (:239: the test_step / save_step cadence, ``history.json``, the
confusion plots), ``save`` / ``restore`` (:328-351) and ``load_classifier``
(:354). The optimizer is ``optax.adam(spec.learning_rate)``'s rule
(``keras_optim.Adam``). The JAX package runs a chunk of epochs as one
device-resident program (:135-197); the port runs each epoch host-driven, as
``training/trainer.py`` does, over the same padded batch grid and masks
(``padded_batch_order``: a shuffled window order cut into batches of
``spec.batch_size``, pad rows masked out of the loss). The evaluation batch
runs the serving forward once and takes both the loss and the class
probabilities from it (the JAX package runs the training forward for the
loss and ``predict`` for the probabilities: the same math).

Randomness: ``ClassifierState.rng`` is a ``torch.Generator`` on the training
device; each shuffled epoch draws its numpy seed from it. Its state is
checkpointed, so a resumed run continues the same stream. A judge directory
holds ``spec.json`` and ``params.npz`` (what ``checkpoint.load_classifier``
and ``cli.transfer --classifiers`` read) beside one ``epoch_N/`` checkpoint
per save.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import bridge
from ..data.batching import FlatSplit
from ..models.classifier import ClassifierSpec, StyleClassifier, classifier_loss, masked_crossentropy
from . import checkpoint as ckpt
from .keras_optim import Adam
from .trainer import aggregate_metrics, pad_batch_to, padded_batch_order


def classifier_arrays(flat: FlatSplit, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """(inputs, labels) for one classifier kind from a FlatSplit.
    'instrument' keeps one sample per song (instrument_classifier.py:231-237)."""
    if kind == "pitch":
        return flat.X, flat.labels
    if kind == "velocity":
        return flat.V, flat.labels
    if kind == "instrument":
        first = flat.first_in_song
        return flat.I[first], flat.labels[first]
    raise ValueError(f"unknown classifier kind {kind!r}")


@dataclass
class ClassifierState:
    """The judge (its parameters train in place), the optimizer and its
    state, the generator of the shuffle seeds, and the epoch to run next."""

    model: StyleClassifier
    opt_state: Adam
    rng: torch.Generator
    epoch: int = 0


class ClassifierTrainer:
    """The train and eval steps and the epoch loop of one judge on one device
    ('cuda' launches the kernels and raises without a card; 'cpu' runs their
    plain versions)."""

    def __init__(self, spec: ClassifierSpec, device: str | torch.device = "cuda"):
        self.spec = spec
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")

    # ------------------------------------------------------------------
    def new_state(self, params, epoch: int = 0, seed: int = 0) -> ClassifierState:
        """A state from a numpy params tree, with fresh optimizer state and
        the generator seeded with ``seed``."""
        model = StyleClassifier(self.spec, params, trainable=True).to(self.device)
        named = list(model.params.named_parameters())
        opt = Adam([p for _, p in named], [k.replace(".", "/") for k, _ in named],
                   self.spec.learning_rate)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(seed)
        return ClassifierState(model=model, opt_state=opt, rng=rng, epoch=epoch)

    def init_state(self, seed: int = 0) -> ClassifierState:
        """Parameters from the numpy init with key [0, seed] (the port's
        StyleClassifier default), fresh optimizer state, the generator
        seeded."""
        params = StyleClassifier(self.spec).init_params(np.array([0, seed], np.uint32))
        return self.new_state(params, seed=seed)

    def _tensors(self, *arrays):
        return [torch.as_tensor(a, device=self.device) for a in arrays]

    def train_step(self, state: ClassifierState, x: torch.Tensor, c: torch.Tensor,
                   mask: torch.Tensor | None = None) -> dict:
        """One Adam step on a device batch; returns its metrics (0-d tensors,
        not synced)."""
        loss, metrics = classifier_loss(state.model, x, c, mask)
        state.opt_state.step(torch.autograd.grad(loss, state.opt_state.params))
        return {k: v.detach() for k, v in metrics.items()}

    def eval_step(self, model: StyleClassifier, x: torch.Tensor, c: torch.Tensor,
                  mask: torch.Tensor | None = None) -> tuple[dict, torch.Tensor]:
        """(metrics, class probabilities) of a device batch, from one serving
        forward."""
        with torch.no_grad():
            logits = model.logits(x)
            _, metrics = masked_crossentropy(logits, c, mask)
            return metrics, torch.softmax(logits, dim=-1)

    # ------------------------------------------------------------------
    def epoch_grid(self, state: ClassifierState, n: int, shuffle: bool = True):
        """The epoch's (n_batches, batch_size) window grid and masks: the
        order shuffled with a numpy seed drawn from ``state.rng``."""
        order = np.arange(n)
        if shuffle:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=state.rng,
                                     device=self.device).item())
            np.random.RandomState(seed).shuffle(order)
        return padded_batch_order(order, self.spec.batch_size)

    def run_epoch(self, state: ClassifierState, inputs: np.ndarray, labels: np.ndarray,
                  shuffle: bool = True, preprocessed: bool = False) -> dict:
        """One epoch of train steps; the metrics' means over its real rows."""
        if not preprocessed:
            inputs = self.spec.preprocess_inputs(inputs)
        onehot = np.eye(self.spec.num_classes, dtype=np.float32)[labels]
        grid, masks = self.epoch_grid(state, inputs.shape[0], shuffle)
        pending = []
        for idx, m in zip(grid, masks):
            safe = np.maximum(idx, 0)  # pad rows gather row 0, masked out
            x, c, mask = self._tensors(np.asarray(inputs[safe], np.float32), onehot[safe], m)
            pending.append((self.train_step(state, x, c, mask), float(m.sum())))
        return aggregate_metrics(pending).means()

    def evaluate(self, state: ClassifierState, inputs: np.ndarray, labels: np.ndarray,
                 preprocessed: bool = False) -> dict:
        """Loss + accuracy + confusion[true, predicted]. ``preprocessed``
        skips spec.preprocess_inputs (fit preprocesses the test split once)."""
        if not preprocessed:
            inputs = self.spec.preprocess_inputs(inputs)
        n, bs = inputs.shape[0], self.spec.batch_size
        num_classes = self.spec.num_classes
        onehot = np.eye(num_classes, dtype=np.float32)[labels]
        confusion = np.zeros((num_classes, num_classes))
        pending = []
        for start in range(0, n, bs):
            idx = np.arange(start, min(start + bs, n))
            batch, mask = pad_batch_to({"x": np.asarray(inputs[idx], np.float32),
                                        "c": onehot[idx]}, bs)
            metrics, probs = self.eval_step(state.model, *self._tensors(batch["x"], batch["c"],
                                                                        mask))
            pred = probs[: len(idx)].argmax(-1).cpu().numpy()
            for t, p in zip(labels[idx], pred):
                confusion[t, p] += 1
            pending.append((metrics, float(mask.sum())))
        out = aggregate_metrics(pending).means()
        total = confusion.sum()
        out["accuracy"] = float(np.trace(confusion) / total) if total else 0.0
        out["confusion"] = confusion
        return out

    # ------------------------------------------------------------------
    def fit(self, state: ClassifierState, train_inputs: np.ndarray, train_labels: np.ndarray,
            test_inputs: np.ndarray | None = None, test_labels: np.ndarray | None = None,
            epochs: int = 10, output_dir: str | None = None, test_step: int = 1,
            save_step: int = 10, log_fn=print, class_names: list[str] | None = None) -> dict:
        """Epochs from ``state.epoch`` to ``epochs`` with the test and save
        cadence; returns the history {epoch: [...], train: [...], test:
        [...]}, also written to ``history.json``."""
        history: dict[str, list] = {"train": [], "test": [], "epoch": []}
        last_saved_epoch = -1
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
        x_train = self.spec.preprocess_inputs(train_inputs)
        x_test = (self.spec.preprocess_inputs(test_inputs)
                  if test_inputs is not None and len(test_inputs) else None)
        e = state.epoch
        while e < epochs:
            t0 = time.time()
            m = self.run_epoch(state, x_train, train_labels, preprocessed=True)
            log_fn(f"[{self.spec.kind}] epoch {e}: loss={m.get('loss', 0):.4f} "
                   f"acc={m.get('acc', 0):.4f} ({time.time() - t0:.1f}s)")
            history["epoch"].append(e)
            history["train"].append(m)
            state.epoch = e + 1
            if x_test is not None and e % test_step == 0:
                tm = self.evaluate(state, x_test, test_labels, preprocessed=True)
                confusion = tm.pop("confusion")
                history["test"].append({"epoch": e, **tm})
                log_fn(f"  test acc={tm['accuracy']:.4f} loss={tm.get('loss', 0):.4f}")
                if output_dir and e % save_step == 0:
                    try:
                        from ..utils.plotting import plot_confusion_matrix

                        plot_confusion_matrix(
                            confusion,
                            class_names or [str(i) for i in range(self.spec.num_classes)],
                            tm["accuracy"], os.path.join(output_dir, f"confusion_{e}.png"))
                    except Exception as err:  # plotting must never kill training
                        log_fn(f"confusion plot failed: {err}")
            if output_dir and e % save_step == 0:
                self.save(output_dir, state)
                last_saved_epoch = state.epoch
                self._write_history(output_dir, history)
            e += 1
        if output_dir:
            if last_saved_epoch != state.epoch:  # avoid a duplicate final save
                self.save(output_dir, state)
            self._write_history(output_dir, history)
        return history

    @staticmethod
    def _write_history(output_dir: str, history: dict) -> None:
        with open(os.path.join(output_dir, "history.json"), "w") as f:
            json.dump(history, f)

    # ------------------------------------------------------------------
    def save(self, output_dir: str, state: ClassifierState) -> None:
        """``epoch_<epoch - 1>/`` (params, Adam state, generator) plus the
        judge's ``spec.json`` and ``params.npz``."""
        params = bridge.to_tree(state.model.params)
        ckpt.save_checkpoint(output_dir, state.epoch - 1, params, state.opt_state.state_dict(),
                             state.rng, None)
        ckpt.save_classifier(output_dir, self.spec, params)

    def restore(self, output_dir: str, epoch: int | None = None) -> ClassifierState:
        """The state saved at ``epoch`` (default: the latest), to continue
        with the epoch after it."""
        saved = ckpt.restore_checkpoint(output_dir, epoch)
        if saved["rng_device"] != self.device.type:
            raise ValueError(f"checkpoint generator is on {saved['rng_device']}, the trainer on "
                             f"{self.device.type}: an exact resume needs the same device type")
        state = self.new_state(saved["params"], epoch=saved["epoch"] + 1)
        state.opt_state.load_state_dict(saved["opt_state"])
        state.rng.set_state(saved["rng_state"])
        return state


def load_classifier(output_dir: str, epoch: int | None = None) -> StyleClassifier:
    """A trained judge from its directory, on the CPU: the checkpoint of
    ``epoch`` (default: the latest)."""
    saved = ckpt.restore_checkpoint(output_dir, epoch)
    return StyleClassifier(ckpt.load_spec(output_dir), saved["params"])
