"""The VAE training loop on one device, with the batches gathered on the host.

Counterpart of ``midi_vae_tpu/training/trainer.py``: ``make_optimizer``
(:41), ``_slice_batch`` (:90), ``padded_batch_order`` (:117), ``TrainState``
(:134), ``EpochMetrics`` (:148), the train, eval and encode steps
(:188-218), ``init_state`` (:790), ``compute_history`` (:814),
``evaluate`` (:927), ``fit`` (:960) and ``restore`` (:1344). ``fit`` runs
the epochs of the JAX package's one-process default, ``_fit_device``
(:1084), with the data on the host:
- each epoch's batch order is ``epoch_order``, a pure numpy function of
  (cfg.seed, epoch) (``_epoch_orders``, :617-639), in the padded batch grid;
- with ``history_from_train_z`` (the default) the history latents come from
  a per-window z cache that each train step fills with its batch's z_mean
  (``_device_epoch_fn``, :464-491; row N is the dustbin of padding rows),
  zero at epoch 0 and seeded by one encode pass when a run resumes past it
  (``_get_z_cache``, :585-615); without it an encode pass at each epoch's
  start gives them (:467-469);
- evaluation encodes its split with the current parameters
  (``_device_eval_fn``, :641-665);
- the test and save cadence, epoch 0 with H = 0, and the preemption-safe
  stop of ``_fit_device``.
The device-resident data, the HBM layout picker and async saves are not
ported yet.

Randomness: ``TrainState.rng`` is a ``torch.Generator`` on the training
device; each train step draws its reparameterization noise from it. Its
state is checkpointed, so a resumed run continues the same stream.
"""

from __future__ import annotations

import json
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .. import bridge
from ..config import Config
from ..data.batching import FlatSplit
from ..models.vae import MidiVAE, loss_and_metrics
from . import checkpoint as ckpt
from .keras_optim import OPTIMIZERS, Optimizer

BATCH_KEYS = ("X", "Y", "I", "V", "D", "C", "S")


def pad_batch_to(batch: dict, size: int) -> tuple[dict, np.ndarray]:
    """Pad a (possibly short) batch dict to ``size`` rows; returns the padded
    batch and a float mask (size,) with 1 on real rows. A copy of
    ``midi_vae_tpu/parallel/mesh.py::pad_batch_to`` (:111-126; that module
    imports jax): keeps the batch shape fixed across an epoch's last partial
    batch, whose padding rows the loss masks out."""
    n = next(iter(batch.values())).shape[0]
    mask = np.zeros((size,), np.float32)
    mask[:n] = 1.0
    if n == size:
        return dict(batch), mask
    out = {}
    for k, v in batch.items():
        pad = np.zeros((size - n, *v.shape[1:]), dtype=v.dtype)
        out[k] = np.concatenate([np.asarray(v), pad], axis=0)
    return out, mask


def padded_batch_order(order, bs: int) -> tuple[np.ndarray, np.ndarray]:
    """A window-index order padded to an (n_batches, bs) grid, -1 = pad, and
    its float mask (1 on real rows). A copy of
    ``midi_vae_tpu/training/trainer.py::padded_batch_order`` (:117-130), the
    batch grid of the JAX package's device-resident epochs: pad rows gather
    row 0 and are masked out of every loss and metric."""
    order = np.asarray(order)
    n = int(order.shape[0])
    n_batches = max(1, (n + bs - 1) // bs)
    padded = np.full((n_batches * bs,), -1, np.int32)
    padded[:n] = order
    grid = padded.reshape(n_batches, bs)
    return grid, (grid >= 0).astype(np.float32)


def epoch_order(cfg: Config, num_windows: int, epoch: int, shuffle: bool = True):
    """Epoch ``epoch``'s batch grid and mask (``padded_batch_order``): the
    windows in order, or shuffled by ``RandomState(base + epoch)`` with base
    (cfg.seed * 1_000_003 + 0x5EED) mod 2**31, whatever the chunking or
    resume (``_epoch_orders``, :617-639)."""
    order = np.arange(num_windows)
    if shuffle:
        base = (cfg.seed * 1_000_003 + 0x5EED) % (2**31)
        np.random.RandomState((base + epoch) % (2**31)).shuffle(order)
    return padded_batch_order(order, cfg.batch_size)


def history_from(z: np.ndarray, flat: FlatSplit) -> np.ndarray:
    """H[i] = z[i-1] within each song, zero at each song's first window
    (the reference's per-song roll, :470-471)."""
    H = np.zeros_like(z)
    H[1:] = z[:-1]
    H[flat.first_in_song] = 0.0
    return H


def make_optimizer(cfg: Config, model: MidiVAE) -> Optimizer:
    """'adam'/'rmsprop' follow optax's stock rules; the '_keras' variants
    the Keras-2.0.8 update rules (see keras_optim)."""
    name = cfg.optimizer.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    named = list(model.params.named_parameters())
    return OPTIMIZERS[name]([p for _, p in named], [k.replace(".", "/") for k, _ in named],
                            cfg.learning_rate)


def _slice_batch(flat: FlatSplit, idx: np.ndarray, cfg: Config, H: np.ndarray | None) -> dict:
    batch = {k: getattr(flat, k)[idx] for k in BATCH_KEYS}
    if cfg.history:
        batch["H"] = H[idx] if H is not None else np.zeros((len(idx), cfg.latent_dim), np.float32)
    if cfg.decoder_additional_input:
        parts = []
        if cfg.decoder_input_composer:
            parts.append(batch["C"])
        if cfg.append_signature_vector_to_latent:
            parts.append(batch["S"])
        batch["A"] = np.concatenate(parts, axis=-1)
    if cfg.meta_next_notes:
        # next-window targets; the last window of each song predicts silence
        nxt = np.minimum(idx + 1, flat.num_windows - 1)
        same_song = (flat.song_id[nxt] == flat.song_id[idx]) & (nxt != idx)
        N = flat.Y[nxt].copy()
        N[~same_song] = 0
        if cfg.include_silent_note:
            N[~same_song, :, -1] = 1
        batch["N"] = N
    return batch


@dataclass
class TrainState:
    """The model (its parameters train in place), the optimizer and its
    state, the generator of the noise, the epoch to run next, and the z
    cache: (N + 1, latent_dim) on the trainer's device, derived and not
    checkpointed (None until ``fit`` builds it for its split)."""

    model: MidiVAE
    opt_state: Optimizer
    rng: torch.Generator
    epoch: int = 0
    z_cache: torch.Tensor | None = None


@dataclass
class EpochMetrics:
    sums: dict = field(default_factory=dict)
    weight: float = 0.0

    def update(self, metrics: dict, weight: float) -> None:
        for k, v in metrics.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v) * weight
        self.weight += weight

    def means(self) -> dict:
        if self.weight == 0:
            return {}
        return {k: v / self.weight for k, v in self.sums.items()}


def aggregate_metrics(pending: list[tuple[dict, float]]) -> EpochMetrics:
    """Per-batch metric tensors -> EpochMetrics, with one device sync."""
    agg = EpochMetrics()
    if not pending:
        return agg
    keys = list(pending[0][0])
    host = torch.stack([torch.stack([m[k].float() for k in keys]) for m, _ in pending]).cpu()
    for row, (_m, w) in zip(host.tolist(), pending):
        agg.update(dict(zip(keys, row)), weight=w)
    return agg


class VAETrainer:
    """The train, eval and encode steps and the epoch loop of one config on
    one device ('cuda' launches the kernels and raises without a card;
    'cpu' runs their plain versions)."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
        self._stop_requested = False

    # ------------------------------------------------------------------
    def to_device(self, batch: dict) -> dict:
        """numpy batch -> tensors on the trainer's device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def value_and_grad(self, state: TrainState, batch: dict, noise: torch.Tensor | None = None,
                       return_z: bool = False):
        """(loss, metrics, grads) of one batch; grads in the optimizer's
        parameter order (zeros for parameters the loss does not reach). With
        ``return_z`` the metrics hold the batch's z_mean, detached, under
        "_z"."""
        loss, metrics = loss_and_metrics(state.model, batch, noise=noise, return_z=return_z)
        params = state.opt_state.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        return loss, {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(self, state: TrainState, batch: dict, noise: torch.Tensor | None = None,
                   rows: torch.Tensor | None = None) -> dict:
        """One optimizer step on a device batch; returns its metrics (0-d
        tensors, not synced). The noise is epsilon_std * N(0, 1) drawn from
        state.rng, as ``sample_z`` draws it, unless given. ``rows`` (B,),
        the batch's window indices on the device with padding rows sent to
        the dustbin row N, writes the batch's z_mean into ``state.z_cache``
        (an ``index_copy_`` on the device, no host sync)."""
        cfg = self.cfg
        if noise is None and cfg.epsilon_std != 0.0:
            noise = cfg.epsilon_std * torch.randn(
                (batch["X"].shape[0], cfg.latent_dim), generator=state.rng, device=self.device)
        cache = rows is not None and state.z_cache is not None
        _loss, metrics, grads = self.value_and_grad(state, batch, noise, return_z=cache)
        if cache:
            state.z_cache.index_copy_(0, rows, metrics.pop("_z").to(state.z_cache.dtype))
        state.opt_state.step(grads)
        return metrics

    def eval_step(self, model: MidiVAE, batch: dict) -> dict:
        """Metrics with the deterministic latent (epsilon_std -> 0)."""
        with torch.no_grad():
            _, metrics = loss_and_metrics(model, batch)
        return metrics

    def encode_step(self, model: MidiVAE, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return model.encode(batch)

    # ------------------------------------------------------------------
    def new_state(self, params, epoch: int = 0, seed: int = 0) -> TrainState:
        """A state from a numpy params tree, with fresh optimizer state and
        the generator seeded with ``seed``."""
        model = MidiVAE(self.cfg, params, trainable=True).to(self.device)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(seed)
        return TrainState(model=model, opt_state=make_optimizer(self.cfg, model), rng=rng,
                          epoch=epoch)

    def init_state(self, seed: int | None = None) -> TrainState:
        """Parameters from the numpy init with key [0, seed] (the port's
        MidiVAE default), fresh optimizer state, the generator seeded."""
        seed = self.cfg.seed if seed is None else seed
        params = MidiVAE(self.cfg).init_params(np.array([0, seed], np.uint32))
        return self.new_state(params, seed=seed)

    def restore(self, run_dir: str, epoch: int | None = None) -> TrainState:
        """The state saved at ``epoch`` (default: the latest), to continue
        with the epoch after it."""
        saved = ckpt.restore_checkpoint(run_dir, epoch)
        if saved["rng_device"] != self.device.type:
            raise ValueError(f"checkpoint generator is on {saved['rng_device']}, the trainer on "
                             f"{self.device.type}: an exact resume needs the same device type")
        state = self.new_state(saved["params"], epoch=saved["epoch"] + 1)
        state.opt_state.load_state_dict(saved["opt_state"])
        state.rng.set_state(saved["rng_state"])
        return state

    def save(self, state: TrainState, run_dir: str, epoch: int) -> None:
        """``epoch_<epoch>/`` plus the top-level ``params.npz`` and
        ``config.json`` that ``cli/transfer.py --model`` serves."""
        params = bridge.to_tree(state.model.params)
        ckpt.save_checkpoint(run_dir, epoch, params, state.opt_state.state_dict(), state.rng, None)
        ckpt.save_run(run_dir, self.cfg, params)

    # ------------------------------------------------------------------
    def uses_z_cache(self) -> bool:
        """History latents from the train steps' z cache instead of an
        encode pass at each epoch's start (``_uses_z_cache``, :398-402)."""
        return self.cfg.history and self.cfg.history_from_train_z

    def encode_all(self, model: MidiVAE, flat: FlatSplit) -> np.ndarray:
        """One batched encoder pass in window order -> z (N, latent_dim)
        (``_encode_all_z``, :563-583)."""
        cfg = self.cfg
        n = flat.num_windows
        zs = np.zeros((n, cfg.latent_dim), np.float32)
        bs = cfg.batch_size
        for start in range(0, n, bs):
            idx = np.arange(start, min(start + bs, n))
            batch, _mask = pad_batch_to({k: getattr(flat, k)[idx] for k in ("X", "I", "V", "D")}, bs)
            zs[idx] = self.encode_step(model, self.to_device(batch))[: len(idx)].cpu().numpy()
        return zs

    def compute_history(self, model: MidiVAE, flat: FlatSplit) -> np.ndarray:
        """One batched encoder pass -> H[i] = z[i-1] within each song."""
        return history_from(self.encode_all(model, flat), flat)

    def z_cache_for(self, state: TrainState, flat: FlatSplit) -> torch.Tensor:
        """``state.z_cache`` for ``flat``: kept when it has its N + 1 rows,
        else zero when the state is at epoch 0 and, past it (a resume),
        seeded by one encode pass with the state's parameters
        (``_get_z_cache``, :585-615)."""
        n = flat.num_windows
        if state.z_cache is not None and state.z_cache.shape[0] == n + 1:
            return state.z_cache
        cache = torch.zeros((n + 1, self.cfg.latent_dim), device=self.device)
        if state.epoch > 0:
            cache[:n] = torch.as_tensor(self.encode_all(state.model, flat), device=self.device)
        return cache

    def run_epoch(self, state: TrainState, flat: FlatSplit, epoch: int, shuffle: bool = True,
                  H: np.ndarray | None = None) -> EpochMetrics:
        """Epoch ``epoch``'s optimizer steps over ``epoch_order``'s grid,
        each writing its z_mean into ``state.z_cache`` when there is one."""
        cfg = self.cfg
        n = flat.num_windows
        if not n:
            return EpochMetrics()
        grid, masks = epoch_order(cfg, n, epoch, shuffle)
        pending = []
        for idx, mask in zip(grid, masks):
            batch, _ = pad_batch_to(_slice_batch(flat, idx[idx >= 0], cfg, H), cfg.batch_size)
            batch["M"] = mask
            rows = torch.as_tensor(np.where(idx >= 0, idx, n).astype(np.int64), device=self.device)
            pending.append((self.train_step(state, self.to_device(batch), rows=rows),
                            float(mask.sum())))
        return aggregate_metrics(pending)

    def evaluate(self, state: TrainState, flat: FlatSplit,
                 H: np.ndarray | None = None) -> EpochMetrics:
        cfg = self.cfg
        if cfg.history and H is None and flat.num_windows:
            H = self.compute_history(state.model, flat)
        bs = cfg.batch_size
        pending = []
        for start in range(0, flat.num_windows, bs):
            idx = np.arange(start, min(start + bs, flat.num_windows))
            batch, mask = pad_batch_to(_slice_batch(flat, idx, cfg, H), bs)
            batch["M"] = mask
            pending.append((self.eval_step(state.model, self.to_device(batch)), float(mask.sum())))
        return aggregate_metrics(pending)

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, train: FlatSplit, test: FlatSplit | None = None,
            epochs: int | None = None, output_dir: str | None = None,
            log_fn: Callable[[str], None] = print, plot: bool = True) -> dict:
        """The training loop with the test and save cadence. Returns the
        metric history {epoch: [...], train: [...], test: [...]}.
        SIGTERM/SIGINT stop it at the next epoch boundary with a checkpoint
        of the last completed epoch."""
        cfg = self.cfg
        epochs = cfg.epochs if epochs is None else epochs
        start_epoch = state.epoch
        self._stop_requested = False
        prev_handlers = {}

        def _request_stop(signum, frame):
            self._stop_requested = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _request_stop)
            except (ValueError, OSError):
                pass  # not the main thread
        history: dict[str, list] = {"train": [], "test": [], "epoch": []}
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            cfg.save(os.path.join(output_dir, "config.json"))
            hist_path = os.path.join(output_dir, "history.json")
            if state.epoch > 0 and os.path.exists(hist_path):
                # resuming: keep the record of the epochs before the resume
                try:
                    with open(hist_path) as f:
                        prev = json.load(f)
                    keep = [i for i, ep in enumerate(prev.get("epoch", [])) if ep < state.epoch]
                    history["epoch"] = [prev["epoch"][i] for i in keep]
                    history["train"] = [prev["train"][i] for i in keep]
                    history["test"] = [t for t in prev.get("test", [])
                                       if t.get("epoch", -1) < state.epoch]
                except (ValueError, KeyError, IndexError):
                    pass  # unreadable history: start fresh
        try:
            self._fit_epochs(state, train, test, epochs, output_dir, log_fn, history)
        finally:
            for sig, handler in prev_handlers.items():
                try:
                    signal.signal(sig, handler)
                except (ValueError, OSError):
                    pass
        if self._stop_requested:
            final = state.epoch - 1
            if output_dir and final >= start_epoch:
                log_fn(f"stop signal received: checkpointed epoch {final}, exiting (resume to continue)")
            else:
                log_fn("stop signal received: no checkpoint written, exiting")
        if output_dir:
            with open(os.path.join(output_dir, "history.json"), "w") as f:
                json.dump(history, f)
            if plot:
                try:
                    from ..utils.plotting import plot_training_history

                    plot_training_history(history, os.path.join(output_dir, "plot.png"))
                except Exception as err:  # plotting must never kill training
                    log_fn(f"plotting failed: {err}")
        return history

    def _fit_epochs(self, state, train, test, epochs, output_dir, log_fn, history) -> None:
        cfg = self.cfg
        start_epoch = state.epoch
        last_saved_epoch = -1
        e = state.epoch
        if self.uses_z_cache() and e < epochs and train.num_windows:
            state.z_cache = self.z_cache_for(state, train)
        while e < epochs and not self._stop_requested:
            t0 = time.time()
            H = None
            if cfg.history and e > 0 and train.num_windows:
                # one sync an epoch for the cache's rows; the JAX package
                # reads them on the device (:464-472)
                H = (history_from(state.z_cache[: train.num_windows].cpu().numpy(), train)
                     if self.uses_z_cache() else self.compute_history(state.model, train))
            train_metrics = self.run_epoch(state, train, e, shuffle=cfg.shuffle_train_set,
                                           H=H).means()
            dt = time.time() - t0
            steps = train.num_windows * cfg.output_length
            log_fn(f"epoch {e}: loss={train_metrics.get('loss', float('nan')):.4f} "
                   f"notes_acc={train_metrics.get('notes_acc', float('nan')):.4f} "
                   f"kl={train_metrics.get('kl_loss', float('nan')):.4f} "
                   f"({steps / max(dt, 1e-9):.0f} note-steps/s)")
            state.epoch = e + 1
            history["epoch"].append(e)
            history["train"].append(train_metrics)
            if test is not None and test.num_windows and e % cfg.test_step == 0:
                test_metrics = self.evaluate(state, test).means()
                history["test"].append({"epoch": e, **test_metrics})
                log_fn(f"  test: loss={test_metrics.get('loss', float('nan')):.4f} "
                       f"notes_acc={test_metrics.get('notes_acc', float('nan')):.4f}")
            if output_dir and e % cfg.save_step == 0:
                self.save(state, output_dir, e)
                last_saved_epoch = e
                with open(os.path.join(output_dir, "history.json"), "w") as f:
                    json.dump(history, f)
            e += 1
        if output_dir:
            # the final (or stop-time) checkpoint, unless already saved or
            # nothing was trained
            final = state.epoch - 1
            if last_saved_epoch != final and final >= start_epoch:
                self.save(state, output_dir, final)
