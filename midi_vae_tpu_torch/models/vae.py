"""The MIDI-VAE model, inference path: encoder, latent, multi-head decoder.

Counterpart of ``midi_vae_tpu/models/vae.py``: ``init_params`` consumes keys
in the same order (so a seed gives bit-equal parameters), ``encode_stats``,
``sample_z``, ``encode``, ``decode`` (the ``inference=True`` branch) and
``composer_logits``. The model owns its parameters as a module tree under the
JAX key paths (``bridge.to_module``).

The kernel switch ``kernels_enabled`` mirrors ``MidiVAE._pallas_enabled``:
GRU cells with sigmoid gates take kernel A (encoder layers) and kernel B
(decode heads); the wrappers run their plain versions on CPU tensors. Configs
the JAX package runs as plain scans (``gate_activation='hard_sigmoid'``,
``cell_type='SimpleRNN'``, ``use_pallas='off'``) keep the plain path on any
device. Paths whose kernels are not ported yet raise on CUDA.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from midi_vae_tpu.config import Config

from .. import bridge
from ..ops.gru_decode import OUT_ACTIVATIONS, gru_decode
from ..ops.gru_layer import CELL_ACTIVATIONS
from .cells import activation_fn, dense_apply, dense_init, get_cell, glorot_uniform, split_keys
from .rnn import decode_autoregressive, encode_sequence, init_decoder_states

Params = dict[str, Any]


class MidiVAE(nn.Module):
    """Holds the config and the parameters; ``params=None`` initializes them
    from ``[0, cfg.seed]``."""

    def __init__(self, cfg: Config, params: Params | None = None):
        super().__init__()
        self.cfg = cfg
        self.cell = get_cell(cfg.cell_type)
        if params is None:
            params = self.init_params(np.array([0, cfg.seed], np.uint32))
        self.params = bridge.to_module(params)

    def kernels_enabled(self, device: torch.device) -> bool:
        """Whether the encoder layers and decode heads go through the kernel
        wrappers (which run their plain versions on CPU tensors)."""
        cfg = self.cfg
        if cfg.cell_type not in ("GRU", "LSTM") or cfg.use_pallas == "off":
            return False
        if cfg.gate_activation != "sigmoid":
            return False  # the kernels implement exact-sigmoid gates only
        cuda = device.type == "cuda"
        if cfg.cell_type == "LSTM":
            if cuda:
                raise NotImplementedError("LSTM kernels not yet ported")
            return False
        if cfg.lstm_activation not in CELL_ACTIVATIONS:
            if cuda:
                raise NotImplementedError(
                    f"GRU kernels with lstm_activation={cfg.lstm_activation!r} not yet ported"
                )
            return False
        return True

    # ------------------------------------------------------------------
    # Parameter initialization (plain numpy, same key order as the JAX package)
    # ------------------------------------------------------------------
    def init_params(self, key) -> Params:
        cfg = self.cfg
        cell = self.cell
        keys = iter(split_keys(key, 256))

        def rnn_stack(n_layers: int, in_dim: int, bidirectional: bool) -> list:
            layers = []
            d = in_dim
            for i in range(n_layers):
                if bidirectional and i != n_layers - 1:
                    layers.append({
                        "fwd": cell.init(next(keys), d, cfg.lstm_size),
                        "bwd": cell.init(next(keys), d, cfg.lstm_size),
                    })
                    d = 2 * cfg.lstm_size
                else:
                    layers.append(cell.init(next(keys), d, cfg.lstm_size))
                    d = cfg.lstm_size
            return layers

        enc: Params = {}
        enc_in = cfg.embedding_dim if cfg.use_embedding else cfg.input_dim
        if cfg.use_embedding:
            enc["embedding"] = {"w": glorot_uniform(next(keys), (cfg.input_dim, cfg.embedding_dim))}
        enc["notes_rnn"] = rnn_stack(cfg.num_layers_encoder, enc_in, cfg.bidirectional)
        n_meta = 0
        if cfg.meta_instrument:
            enc["inst_rnn"] = rnn_stack(1, cfg.meta_instrument_dim, False)
            n_meta += 1
        if cfg.meta_velocity:
            enc["vel_rnn"] = rnn_stack(1, 1, False)
            n_meta += 1
        if cfg.meta_held_notes:
            enc["held_rnn"] = rnn_stack(1, 2, False)
            n_meta += 1
        if n_meta:
            enc["fusion"] = dense_init(next(keys), cfg.lstm_size * (1 + n_meta), cfg.lstm_size)
        if cfg.extra_layer:
            enc["extra"] = dense_init(next(keys), cfg.lstm_size, cfg.lstm_size)
        half = cfg.lstm_size // 2 if cfg.split_lstm_vector else cfg.lstm_size
        other_half = cfg.lstm_size - cfg.lstm_size // 2 if cfg.split_lstm_vector else cfg.lstm_size
        enc["z_mean"] = dense_init(next(keys), half, cfg.latent_dim)
        enc["z_log_var"] = dense_init(next(keys), other_half, cfg.latent_dim)

        new_dim = cfg.latent_dim
        if cfg.history:
            new_dim += cfg.latent_dim
        if cfg.decoder_additional_input:
            new_dim += cfg.decoder_additional_input_dim

        def head(n_layers: int, head_dim: int) -> Params:
            cells = []
            d = head_dim
            for _ in range(n_layers):
                cells.append(cell.init(next(keys), d, cfg.lstm_size))
                d = cfg.lstm_size
            init_dense = [
                dense_init(next(keys), new_dim, cfg.lstm_size)
                for _ in range(n_layers * cell.num_states)
            ]
            return {"cells": cells, "out": dense_init(next(keys), cfg.lstm_size, head_dim),
                    "init": init_dense}

        dec: Params = {"notes": head(cfg.num_layers_decoder, cfg.output_dim)}
        if cfg.meta_instrument:
            dec["instrument"] = head(1, cfg.meta_instrument_dim)
        if cfg.meta_velocity:
            dec["velocity"] = head(1, 1)
        if cfg.meta_held_notes:
            dec["held"] = head(1, 2)
        if cfg.meta_next_notes:
            dec["next"] = head(cfg.num_layers_decoder, cfg.output_dim)

        params: Params = {"encoder": enc, "decoder": dec}
        if cfg.composer_decoder_at_notes_output:
            params["composer_at_notes"] = {
                "rnn": rnn_stack(1, cfg.output_dim, False),
                "out": dense_init(next(keys), cfg.lstm_size, cfg.num_composers),
            }
        if cfg.composer_decoder_at_instrument_output:
            params["composer_at_instrument"] = {
                "rnn": rnn_stack(1, cfg.meta_instrument_dim, False),
                "out": dense_init(next(keys), cfg.lstm_size, cfg.num_composers),
            }
        return params

    # ------------------------------------------------------------------
    # Encoder
    # ------------------------------------------------------------------
    def encode_stats(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """X/I/V/D -> (z_mean, z_log_var)."""
        cfg = self.cfg
        enc = self.params["encoder"]
        x = batch["X"]
        kernels = self.kernels_enabled(x.device)
        if cfg.use_embedding:
            x = x @ enc["embedding"]["w"]
        parts = [encode_sequence(enc["notes_rnn"], x, cfg.cell_type, cfg.lstm_activation,
                                 cfg.bidirectional, kernels, cfg.gate_activation)]
        for flag, name, key in ((cfg.meta_instrument, "inst_rnn", "I"),
                                (cfg.meta_velocity, "vel_rnn", "V"),
                                (cfg.meta_held_notes, "held_rnn", "D")):
            if flag:
                parts.append(encode_sequence(enc[name], batch[key], cfg.cell_type,
                                             cfg.lstm_activation, False, kernels,
                                             cfg.gate_activation))
        h = parts[0]
        if len(parts) > 1:
            act = activation_fn(cfg.activation_before_splitting)
            h = act(dense_apply(enc["fusion"], torch.cat(parts, dim=-1)))
        if cfg.extra_layer:
            act = activation_fn(cfg.activation_before_splitting)
            h = act(dense_apply(enc["extra"], h))
        if cfg.split_lstm_vector:
            half = cfg.lstm_size // 2
            h1, h2 = h[:, :half], h[:, half:]
        else:
            h1 = h2 = h
        return dense_apply(enc["z_mean"], h1), dense_apply(enc["z_log_var"], h2)

    def sample_z(self, z_mean, z_log_var, generator: torch.Generator | None,
                 epsilon_std: float) -> torch.Tensor:
        """z = mu + exp(logvar/2) * eps, eps ~ N(0, epsilon_std^2);
        epsilon_std=0 or generator=None => z_mean."""
        if generator is None or epsilon_std == 0.0:
            return z_mean
        eps = epsilon_std * torch.randn(z_mean.shape, generator=generator,
                                        device=z_mean.device, dtype=z_mean.dtype)
        return z_mean + torch.exp(z_log_var / 2.0) * eps

    def encode(self, batch: dict, generator: torch.Generator | None = None,
               epsilon_std: float = 0.0) -> torch.Tensor:
        z_mean, z_log_var = self.encode_stats(batch)
        return self.sample_z(z_mean, z_log_var, generator, epsilon_std)

    # ------------------------------------------------------------------
    # Decoder (inference: every head decodes autoregressively)
    # ------------------------------------------------------------------
    def decode(self, z: torch.Tensor, history: torch.Tensor | None = None,
               additional: torch.Tensor | None = None) -> dict[str, tuple]:
        """z (+ history / additional) -> per-head (probs, logits), (B, T, D)."""
        cfg = self.cfg
        dec = self.params["decoder"]
        B = z.shape[0]
        parts = [z]
        if cfg.history:
            parts.append(history if history is not None else z.new_zeros((B, cfg.latent_dim)))
        if cfg.decoder_additional_input:
            parts.append(additional if additional is not None
                         else z.new_zeros((B, cfg.decoder_additional_input_dim)))
        new_encoded = torch.cat(parts, dim=-1) if len(parts) > 1 else z
        kernels = self.kernels_enabled(z.device)

        def run_head(name: str, head_dim: int, length: int, out_activation: str):
            h = dec[name]
            states = init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                         cfg.lstm_state_activation)
            start = z.new_zeros((B, head_dim))
            if kernels:
                if len(h["cells"]) in (1, 2) and out_activation in OUT_ACTIVATIONS:
                    probs, logits = gru_decode(list(h["cells"]), h["out"], [s[0] for s in states],
                                               start, length, cfg.lstm_activation, out_activation)
                    return probs.transpose(0, 1), logits.transpose(0, 1)
                if z.device.type == "cuda":
                    raise NotImplementedError(
                        f"per-step GRU kernels (head {name!r}: {len(h['cells'])} layers, "
                        f"{out_activation!r} output) not yet ported"
                    )
            return decode_autoregressive(list(h["cells"]), h["out"], states, start, length,
                                         cfg.cell_type, cfg.lstm_activation, out_activation,
                                         cfg.gate_activation)

        outputs = {"notes": run_head("notes", cfg.output_dim, cfg.output_length, cfg.activation)}
        if cfg.meta_velocity:
            outputs["velocity"] = run_head("velocity", 1, cfg.meta_velocity_length,
                                           cfg.meta_velocity_activation)
        if cfg.meta_held_notes:
            outputs["held"] = run_head("held", 2, cfg.meta_held_notes_length,
                                       cfg.meta_held_notes_activation)
        if cfg.meta_next_notes:
            outputs["next"] = run_head("next", cfg.output_dim, cfg.meta_next_notes_output_length,
                                       cfg.activation)
        if cfg.meta_instrument:
            outputs["instrument"] = run_head("instrument", cfg.meta_instrument_dim,
                                             cfg.meta_instrument_length,
                                             cfg.meta_instrument_activation)
        return outputs

    def composer_logits(self, z: torch.Tensor) -> torch.Tensor:
        """The composer probe's logits are z[:, :num_composers]."""
        return z[:, : self.cfg.num_composers]
