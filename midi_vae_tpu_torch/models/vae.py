"""The MIDI-VAE model: encoder, latent, multi-head decoder, and the loss.

Counterpart of ``midi_vae_tpu/models/vae.py``: ``init_params`` consumes keys
in the same order (so a seed gives bit-equal parameters), ``encode_stats``,
``sample_z``, ``encode``, ``decode`` (both branches), ``apply``, the latent
probes, and the loss (``kl_divergence``, ``loss_and_metrics``). The model
owns its parameters as a module tree under the JAX key paths
(``bridge.to_module``); ``trainable=True`` gives them gradients.

The kernel switch ``kernels_enabled`` mirrors ``MidiVAE._pallas_enabled``:
cells with sigmoid gates take, when serving, kernel A (GRU) or kernel L
(LSTM, tanh cells: ``_lstm_x_use_pallas``) per encoder layer and kernel B
(GRU) or kernel M (LSTM) per 1- or 2-layer decode head with a softmax,
sigmoid or linear output; a head those do not take (3 layers, or another
output activation) runs kernel T (GRU) or S (LSTM) per cell and step, as the
JAX package runs its ``fused_step`` there. The wrappers run their plain
versions on CPU tensors. Configs the JAX package runs as plain scans
(``gate_activation='hard_sigmoid'``, ``cell_type='SimpleRNN'``,
``use_pallas='off'``) keep the plain path on any device.

The training path (``inference=False``) decides each part on its own, as the
JAX package does (``train_kernels``): the per-step cells T, T xp, S and S xp
take any of tanh, sigmoid and relu; the whole-layer and whole-head training
kernels take tanh cells only, along the route ``ops/_layout.py`` picks from
the card's limits (``train_route``). Encoder layers: with
``fused_train_encoder`` (the default) the whole-layer kernels (GRU
``gru_layer_train_x``, A + C + W, or on the wide route ``gru_layer_train``
over xp = x @ W + b, F + G + W; LSTM ``lstm_layer_train_x``, L + N + W, or
``lstm_layer_train``, Q + R + W) or, for other cell activations, the plain
scan; without it xp in one matmul and T xp or S xp per step, or in bfloat16
(``compute_dtype``, the JAX package's ``whole_scan``) one call of the
whole-scan kernel X (GRU) or Y (LSTM) per layer over it. GRU decode
heads: with ``fused_train_decoder`` the notes head and its T-length side
heads in one multi-head call (narrow route, where ``_mh_vmem_ok`` admits it
at the step's batch; ``decode_residual_bf16`` stores its h sequences in
bfloat16, and raises on the card where the TPU would run that call off the
narrow route, ``_multihead``), every other 1- or 2-layer head
with a softmax, sigmoid or linear output through ``gru_decode_train`` (D +
E, or their wide builds), the plain scan where those kernels do not take the
head (3 layers, other cell activations: ``_dec_mode``), and T per cell and
step for other output activations; ``merge_decoder_scans`` runs the T-length
heads in one loop (``decode_heads_merged``) through T, and
``fused_train_decoder=False`` every head through T. LSTM heads run S per
cell and step (the JAX package has no LSTM whole-head training kernel),
merged or not. Teacher-forced heads take the plain scan. In bfloat16 the
kernels run their bf16 builds (A, C, D, E and W on the narrow route; X, G,
the wide D and E, and W on the wide route; L, N and W or Q, R and W for the
LSTM; T and S, X and Y), the multi-head call is declined and heads narrower
than 8 are decoded in float32 (``gru_decode_train``), as on the TPU; the
encode pass and serving stay float32. As the TPU's rows round differently
in bf16, each encoder layer and GRU decode head there takes the rows the
JAX package runs at the batch it is called with (``ops/_layout.py``:
``bf16_layer_mode``, ``bf16_head_mode``, ``head_builds``), not the route of
the step: the LSTM's L + N or Q + R, the GRU's A + C or X + G (dU from the
float32 or the rounded gate grads), D + E or their wide builds (rows 7 and
8 at H = 512 on the wide builds with row 8's rounding).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from .. import bridge
from ..config import Config
from ..ops import _layout, gru_step, lstm_step
from ..ops.gru_decode import (
    OUT_ACTIVATIONS,
    gru_decode,
    gru_decode_multihead_train,
    gru_decode_train,
)
from ..ops.gru_layer import CELL_ACTIVATIONS
from ..ops.lstm_decode import lstm_decode
from .cells import activation_fn, dense_apply, dense_init, get_cell, glorot_uniform, split_keys
from .rnn import decode_autoregressive, decode_heads_merged, encode_sequence, init_decoder_states

Params = dict[str, Any]


def _side_heads(cfg: Config) -> list[tuple[str, int, str]]:
    """(name, width, output activation) of the T-length side heads that ride
    in the notes head's multi-head call (``_decode_multihead_train``)."""
    return [(n, d, a) for flag, n, d, length, a in (
        (cfg.meta_velocity, "velocity", 1, cfg.meta_velocity_length,
         cfg.meta_velocity_activation),
        (cfg.meta_held_notes, "held", 2, cfg.meta_held_notes_length,
         cfg.meta_held_notes_activation),
    ) if flag and length == cfg.output_length and a in OUT_ACTIVATIONS]


def _multihead(cfg: Config, route: str | None, B: int, on_card: bool = False) -> bool:
    """Whether the training decode of a batch of B runs the multi-head call
    when the notes head is not teacher-forced: GRU, tanh,
    ``fused_train_decoder``, not merged, a 2-layer notes head with a
    softmax, sigmoid or linear output and a T-length side head, float32
    (bf16 training falls back to the per-head kernels on the TPU), the VMEM
    check ``_mh_vmem_ok`` at B (``models/vae.py:560-572``, ``_mh_use_pallas``
    fused_train.py:3454-3471), on the narrow route (where D's and E's 8-row
    builds launch; ``_mh_vmem_ok`` fails at H = 512 for every B). Off the
    narrow route (H = 416 to 480 at B <= 32) the per-head wide builds
    compute the same function in float32, but not with
    ``decode_residual_bf16``, whose sequences the TPU stores rounded: there
    the call runs rows 5 and 6 through D's and E's bf16-residual builds, on
    their chains (D's decode chain takes every multiple of 32; E's chain a
    multiple of 64, so H = 448 runs), and ``on_card`` raises
    NotImplementedError where one of them does not launch (H = 416, 480: E's
    chain; the CPU runs their plain versions)."""
    side = _side_heads(cfg)
    if not (cfg.cell_type == "GRU" and cfg.lstm_activation == "tanh" and cfg.fused_train_decoder
            and not cfg.merge_decoder_scans and cfg.num_layers_decoder == 2
            and cfg.activation in OUT_ACTIVATIONS and bool(side)
            and cfg.compute_dtype != "bfloat16"
            and _layout.mh_vmem_ok(B, cfg.output_dim, [d for _, d, _ in side], cfg.lstm_size)):
        return False
    if route == "narrow" or not cfg.decode_residual_bf16:
        return route == "narrow"
    if on_card:
        H = cfg.lstm_size
        heads = [(cfg.output_dim, 2)] + [(d, 1) for _, d, _ in side]
        whys = [why for d, n in heads for why in (_layout.dec_train_limit("D_resid", H, d, n),
                                                  _layout.gru_bptt_limit("E_resid", H, d, n))
                if why is not None]
        if whys:
            raise NotImplementedError(
                f"the JAX package runs this decode through rows 5 and 6 with bf16 residuals "
                f"(decode_residual_bf16) at B={B}, H={H}; their port builds (D_resid, E_resid) "
                f"do not launch on the {route} route: {whys[0]} (ROADMAP Queue 2 item 4)")
    return True


def _cast_tree(tree, dtype):
    """Nested dicts/lists of tensors cast to ``dtype`` (differentiably)."""
    if isinstance(tree, (list, tuple, torch.nn.ModuleList)):
        return [_cast_tree(v, dtype) for v in tree]
    if isinstance(tree, (dict, torch.nn.ModuleDict, torch.nn.ParameterDict)):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


class MidiVAE(nn.Module):
    """Holds the config and the parameters; ``params=None`` initializes them
    from ``[0, cfg.seed]``."""

    def __init__(self, cfg: Config, params: Params | None = None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.cell = get_cell(cfg.cell_type)
        if params is None:
            params = self.init_params(np.array([0, cfg.seed], np.uint32))
        self.params = bridge.to_module(params, trainable=trainable)

    def kernels_enabled(self, device: torch.device) -> bool:
        """Whether the encoder layers and decode heads go through the kernel
        wrappers (which run their plain versions on CPU tensors)."""
        cfg = self.cfg
        if cfg.cell_type not in ("GRU", "LSTM") or cfg.use_pallas == "off":
            return False
        if cfg.gate_activation != "sigmoid":
            return False  # the kernels implement exact-sigmoid gates only
        if cfg.lstm_activation not in CELL_ACTIVATIONS:
            if device.type == "cuda":
                raise NotImplementedError(
                    f"{cfg.cell_type} kernels with lstm_activation={cfg.lstm_activation!r} "
                    "not yet ported")
            return False
        return True

    def serving_head_kernel(self, name: str, n_layers: int, out_activation: str,
                            device: torch.device) -> bool:
        """Whether a serving decode head goes through its decode kernel (B
        for GRU, M for LSTM: 1- or 2-layer heads with a softmax, sigmoid or
        linear output). A head they do not take runs kernel T (GRU) or S
        (LSTM) step by step (``decode_step``), as the JAX package runs its
        ``fused_step`` there (``models/vae.py:522-534``)."""
        if not self.kernels_enabled(device):
            return False
        return n_layers in (1, 2) and out_activation in OUT_ACTIVATIONS

    def decode_step(self, kernels: bool):
        """The per-step cell of ``decode_autoregressive`` and
        ``decode_heads_merged`` when ``kernels`` (the JAX package's
        ``fused_step``): kernel T for GRU heads, S for LSTM heads; else None
        (the plain cells)."""
        if not kernels:
            return None
        ops = lstm_step if self.cfg.cell_type == "LSTM" else gru_step
        return ops.make_decoder_step(self.cfg.lstm_activation)

    def train_kernels(self, device: torch.device) -> tuple[bool, bool]:
        """(steps, layers) of the training path; each part of the step then
        decides on its own, as the JAX package does. ``steps``: the per-step
        cells T, T xp, S and S xp run where the JAX package runs its
        ``fused_step`` and per-step encoder cells (tanh, sigmoid or relu).
        ``layers``: the whole-layer and whole-head training kernels (A to G,
        L, N, Q, R) take the part; they hard-code tanh's derivative, and the
        JAX package sends other cell activations to the plain scans
        (``_x_use_pallas`` fused_train.py:2269, ``_dec_mode`` :981,
        ``_mh_use_pallas`` :3456, ``_lstm_x_use_pallas`` :2546)."""
        if not self.kernels_enabled(device):
            return False, False
        return True, self.cfg.lstm_activation == "tanh"

    def train_kernels_enabled(self, device: torch.device) -> bool:
        """Whether the flags send any part of the training step through a
        kernel: the whole-layer and whole-head kernels (tanh cells), the
        LSTM heads' S, or the per-step cells that ``merge_decoder_scans`` and
        ``fused_train_*=False`` select (``train_kernels``)."""
        steps, layers = self.train_kernels(device)
        cfg = self.cfg
        return steps and (layers or cfg.cell_type == "LSTM" or cfg.merge_decoder_scans
                          or not cfg.fused_train_encoder or not cfg.fused_train_decoder)

    def train_route(self, device: torch.device) -> str:
        """``"narrow"`` or ``"wide"``: which kernel builds the training step
        takes at this width (``ops/_layout.py``); on the card a width no
        build launches raises LaunchLimitError. In bf16 the parts are
        dispatched one by one (``config_route``: its label, ``"per-part"``
        where they differ)."""
        return _layout.config_route(self.cfg, on_card=device.type == "cuda")

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
    def encode_stats(self, batch: dict, inference: bool = True,
                     params=None) -> tuple[torch.Tensor, torch.Tensor]:
        """X/I/V/D -> (z_mean, z_log_var). ``inference=False`` is the
        training path (the JAX default; the port defaults to serving)."""
        cfg = self.cfg
        enc = (self.params if params is None else params)["encoder"]
        x = batch["X"]
        train = not inference
        per_step = wide = whole_scan = False
        if inference:
            kernels = self.kernels_enabled(x.device)
        else:
            # fused_train_encoder: the whole-layer kernels (tanh cells) or
            # the plain scan; without it T xp or S xp per step, or in bf16
            # the whole-scan kernels X and Y (rnn.py:139-200, vae.py:255-260)
            steps, layers = self.train_kernels(x.device)
            whole_scan = (steps and not cfg.fused_train_encoder
                          and cfg.compute_dtype == "bfloat16")
            per_step = steps and not cfg.fused_train_encoder and not whole_scan
            kernels = per_step or whole_scan or layers
            wide = (layers and not per_step and not whole_scan
                    and self.train_route(x.device) == "wide")
        if cfg.use_embedding:
            x = x @ enc["embedding"]["w"]
        parts = [encode_sequence(enc["notes_rnn"], x, cfg.cell_type, cfg.lstm_activation,
                                 cfg.bidirectional, kernels, cfg.gate_activation, train, wide,
                                 per_step, whole_scan)]
        for flag, name, key in ((cfg.meta_instrument, "inst_rnn", "I"),
                                (cfg.meta_velocity, "vel_rnn", "V"),
                                (cfg.meta_held_notes, "held_rnn", "D")):
            if flag:
                parts.append(encode_sequence(enc[name], batch[key], cfg.cell_type,
                                             cfg.lstm_activation, False, kernels,
                                             cfg.gate_activation, train, wide, per_step,
                                             whole_scan))
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
               additional: torch.Tensor | None = None,
               ground_truth: torch.Tensor | None = None,
               next_ground_truth: torch.Tensor | None = None,
               inference: bool = True, params=None) -> dict[str, tuple]:
        """z (+ history / additional) -> per-head (probs, logits), (B, T, D).
        ``inference=False`` is the training path (``_decode_train``)."""
        cfg = self.cfg
        dec = (self.params if params is None else params)["decoder"]
        B = z.shape[0]
        parts = [z]
        if cfg.history:
            parts.append(history if history is not None else z.new_zeros((B, cfg.latent_dim)))
        if cfg.decoder_additional_input:
            parts.append(additional if additional is not None
                         else z.new_zeros((B, cfg.decoder_additional_input_dim)))
        new_encoded = torch.cat(parts, dim=-1) if len(parts) > 1 else z
        if not inference:
            return self._decode_train(dec, new_encoded, z, ground_truth, next_ground_truth)

        def run_head(name: str, head_dim: int, length: int, out_activation: str):
            h = dec[name]
            states = init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                         cfg.lstm_state_activation)
            start = z.new_zeros((B, head_dim))
            if self.serving_head_kernel(name, len(h["cells"]), out_activation, z.device):
                if cfg.cell_type == "LSTM":
                    probs, logits = lstm_decode(list(h["cells"]), h["out"], states, start,
                                                length, cfg.lstm_activation, out_activation)
                else:
                    probs, logits = gru_decode(list(h["cells"]), h["out"], [s[0] for s in states],
                                               start, length, cfg.lstm_activation, out_activation)
                return probs.transpose(0, 1), logits.transpose(0, 1)
            return decode_autoregressive(list(h["cells"]), h["out"], states, start, length,
                                         cfg.cell_type, cfg.lstm_activation, out_activation,
                                         cfg.gate_activation,
                                         step=self.decode_step(self.kernels_enabled(z.device)))

        return {name: run_head(name, dim, length, act)
                for name, dim, length, act in self.serving_heads()}

    def serving_heads(self) -> list[tuple[str, int, int, str]]:
        """The heads ``decode`` runs at inference, in order: (name, width,
        steps, output activation)."""
        cfg = self.cfg
        heads = [("notes", cfg.output_dim, cfg.output_length, cfg.activation)]
        if cfg.meta_velocity:
            heads.append(("velocity", 1, cfg.meta_velocity_length, cfg.meta_velocity_activation))
        if cfg.meta_held_notes:
            heads.append(("held", 2, cfg.meta_held_notes_length, cfg.meta_held_notes_activation))
        if cfg.meta_next_notes:
            heads.append(("next", cfg.output_dim, cfg.meta_next_notes_output_length,
                          cfg.activation))
        if cfg.meta_instrument:
            heads.append(("instrument", cfg.meta_instrument_dim, cfg.meta_instrument_length,
                          cfg.meta_instrument_activation))
        return heads

    def _decode_train(self, dec, new_encoded, z, ground_truth, next_ground_truth) -> dict:
        """The training decode (``MidiVAE.decode(inference=False)``,
        ``models/vae.py:442-630``): the multi-head call (``_multihead``) for
        the notes head and its T-length side heads; with
        ``merge_decoder_scans`` the T-length heads in one loop
        (``decode_heads_merged``) through the per-step cell; every other head
        through ``run_head`` (see the module note). Teacher-forced heads take
        the plain scan."""
        cfg = self.cfg
        B = z.shape[0]
        steps, layers = self.train_kernels(z.device)
        lstm = cfg.cell_type == "LSTM"
        route = self.train_route(z.device) if layers and not lstm else None
        step = self.decode_step(steps)
        merge = cfg.merge_decoder_scans
        # a teacher-forced notes head scans over known inputs and stays out
        # of the multi-head call and the merged loop (models/vae.py:558-583)
        notes_tf = cfg.teacher_force and ground_truth is not None

        def spec(name: str, head_dim: int, out_activation: str | None = None) -> dict:
            h = dec[name]
            states = init_decoder_states(h["init"], new_encoded, cfg.cell_type,
                                         cfg.lstm_state_activation)
            return {"cells": list(h["cells"]), "out": h["out"], "init_states": states,
                    "init": [s[0] for s in states],
                    "start": z.new_zeros((B, head_dim)), "out_activation": out_activation}

        def run_head(name, head_dim, length, out_activation, gt=None):
            s = spec(name, head_dim)
            args = (s["cells"], s["out"], s["init_states"], s["start"], length, cfg.cell_type,
                    cfg.lstm_activation, out_activation, cfg.gate_activation)
            if gt is not None:  # the teacher-forced scan runs the plain cells
                return decode_autoregressive(*args, gt)
            if steps and not lstm and cfg.fused_train_decoder and out_activation in OUT_ACTIVATIONS:
                # gru_decode_train (models/vae.py:504-521): D + E, or the plain
                # scan where _dec_mode says "scan" (3 layers, non-tanh cells)
                if layers and len(s["cells"]) in (1, 2):
                    builds = ("D_wide", "E_wide") if route == "wide" else ("D", "E")
                    if z.dtype == torch.bfloat16:
                        n = len(s["cells"])
                        mode = _layout.bf16_head_mode(B, head_dim, cfg.lstm_size, n,
                                                      z.device.type == "cuda")
                        if mode == "scan":
                            return decode_autoregressive(*args)
                        builds = _layout.head_builds(mode, head_dim, cfg.lstm_size, n)
                    probs, logits = gru_decode_train(s["cells"], s["out"], s["init"], s["start"],
                                                     length, cfg.lstm_activation, out_activation,
                                                     builds)
                    return probs.transpose(0, 1), logits.transpose(0, 1)
                return decode_autoregressive(*args)
            return decode_autoregressive(*args, step=step)

        outputs: dict = {}
        if layers and not notes_tf and _multihead(cfg, route, B, z.device.type == "cuda"):
            side = _side_heads(cfg)
            results = gru_decode_multihead_train(
                spec("notes", cfg.output_dim), [spec(n, d) for n, d, _ in side],
                cfg.output_length, cfg.lstm_activation,
                (cfg.activation, *(a for _, _, a in side)),
                torch.bfloat16 if cfg.decode_residual_bf16 else None)
            for name, (probs, logits) in zip(["notes"] + [n for n, _, _ in side], results):
                outputs[name] = (probs.transpose(0, 1), logits.transpose(0, 1))
        merged: dict = {}
        if "notes" not in outputs:
            if merge and not notes_tf:
                merged["notes"] = spec("notes", cfg.output_dim, cfg.activation)
            else:
                outputs["notes"] = run_head("notes", cfg.output_dim, cfg.output_length,
                                            cfg.activation, ground_truth if notes_tf else None)
        for flag, name, d, length, a in (
                (cfg.meta_velocity, "velocity", 1, cfg.meta_velocity_length,
                 cfg.meta_velocity_activation),
                (cfg.meta_held_notes, "held", 2, cfg.meta_held_notes_length,
                 cfg.meta_held_notes_activation)):
            if flag and name not in outputs:
                if merge:
                    merged[name] = spec(name, d, a)
                else:
                    outputs[name] = run_head(name, d, length, a)
        if cfg.meta_next_notes:
            next_tf = cfg.meta_next_notes_teacher_force and next_ground_truth is not None
            if merge and not next_tf:
                merged["next"] = spec("next", cfg.output_dim, cfg.activation)
            else:
                outputs["next"] = run_head("next", cfg.output_dim,
                                           cfg.meta_next_notes_output_length, cfg.activation,
                                           next_ground_truth if next_tf else None)
        if merged:
            outputs.update(decode_heads_merged(merged, cfg.output_length, cfg.cell_type,
                                               cfg.lstm_activation, step, cfg.gate_activation))
        if cfg.meta_instrument:
            outputs["instrument"] = run_head("instrument", cfg.meta_instrument_dim,
                                             cfg.meta_instrument_length,
                                             cfg.meta_instrument_activation)
        return outputs

    # ------------------------------------------------------------------
    # Latent probes
    # ------------------------------------------------------------------
    def composer_logits(self, z: torch.Tensor) -> torch.Tensor:
        """The composer probe's logits are z[:, :num_composers]."""
        return z[:, : self.cfg.num_composers]

    def signature_prediction(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        offset = cfg.num_composers if cfg.include_composer_decoder else 0
        return activation_fn(cfg.signature_activation)(z[:, offset : offset + cfg.signature_dim])

    def _composer_from(self, params, key: str, seq: torch.Tensor) -> torch.Tensor:
        """The adversarial composer decoders: a plain GRU scan over a head's
        output (the JAX package runs no kernel there either)."""
        p = params[key]
        h = encode_sequence(p["rnn"], seq, self.cfg.cell_type, self.cfg.lstm_activation,
                            gate_activation=self.cfg.gate_activation)
        return dense_apply(p["out"], h)

    # ------------------------------------------------------------------
    # Full autoencoder forward (training)
    # ------------------------------------------------------------------
    def apply(self, batch: dict, generator: torch.Generator | None = None,
              epsilon_std: float = 0.0, noise: torch.Tensor | None = None) -> dict:
        """Encode, sample, decode every head and the probes, on the training
        path. ``noise``: pre-scaled reparameterization noise (epsilon_std *
        N(0, 1), (B, latent_dim)), z = z_mean + exp(z_log_var / 2) * noise;
        without it ``sample_z`` draws from ``generator``. With
        ``compute_dtype='bfloat16'`` the forward runs in bf16, params and
        batch cast as the JAX package casts them (``models/vae.py:689-697``)."""
        cfg = self.cfg
        params = self.params
        if cfg.compute_dtype == "bfloat16":
            params = _cast_tree(self.params, torch.bfloat16)
            batch = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
                     for k, v in batch.items()}
            if noise is not None:
                noise = noise.to(torch.bfloat16)
        z_mean, z_log_var = self.encode_stats(batch, inference=False, params=params)
        if noise is not None:
            z = z_mean + torch.exp(z_log_var / 2.0) * noise
        else:
            z = self.sample_z(z_mean, z_log_var, generator, epsilon_std)
        outputs = self.decode(
            z, history=batch.get("H"), additional=batch.get("A"),
            ground_truth=batch.get("Y") if cfg.teacher_force else None,
            next_ground_truth=batch.get("N") if cfg.meta_next_notes_teacher_force else None,
            inference=False, params=params)
        result = {"z_mean": z_mean, "z_log_var": z_log_var, "z": z, "heads": outputs}
        if cfg.include_composer_decoder:
            result["composer_logits"] = self.composer_logits(z)
        if cfg.signature_decoder:
            result["signature"] = self.signature_prediction(z)
        if cfg.composer_decoder_at_notes_output:
            result["composer_at_notes_logits"] = self._composer_from(
                params, "composer_at_notes", outputs["notes"][0])
        if cfg.composer_decoder_at_instrument_output:
            result["composer_at_instrument_logits"] = self._composer_from(
                params, "composer_at_instrument", outputs["instrument"][0])
        return result


# ---------------------------------------------------------------------------
# Loss: the single fused objective (midi_vae_tpu/models/vae.py:827-1005)
# ---------------------------------------------------------------------------

def _xent_from_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element categorical crossentropy -sum(y * log_softmax(logits))."""
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(-1)


def kl_divergence(z_mean, z_log_var, prior_mean: float, prior_std: float) -> torch.Tensor:
    """Per-sample KL(N(mu, sigma) || N(prior)), summed over latent dims."""
    prior_log_var = 2.0 * float(np.log(prior_std))
    prior_var = prior_std * prior_std
    return -0.5 * (1.0 + z_log_var - prior_log_var
                   - ((z_mean - prior_mean) ** 2 + torch.exp(z_log_var)) / prior_var).sum(-1)


def loss_and_metrics(model: MidiVAE, batch: dict, generator: torch.Generator | None = None,
                     epsilon_std: float = 0.0, noise: torch.Tensor | None = None,
                     return_z: bool = False) -> tuple[torch.Tensor, dict]:
    """Total loss = sum(weight_i * head_loss_i) + beta * KL, with the metrics
    dict of per-head losses and accuracies (0-d tensors). ``batch["M"]``
    (B,) masks padding rows out of every mean; ``noise`` as in ``apply``."""
    cfg = model.cfg
    out = model.apply(batch, generator, epsilon_std, noise)
    if cfg.compute_dtype == "bfloat16":
        def up(tree):
            if isinstance(tree, dict):
                return {k: up(v) for k, v in tree.items()}
            if isinstance(tree, (tuple, list)):
                return type(tree)(up(v) for v in tree)
            return tree.float()
        out = up(out)
    metrics: dict[str, torch.Tensor] = {}
    M = batch.get("M")

    def bmean(x: torch.Tensor) -> torch.Tensor:
        """Mean over all elements, restricted to valid batch rows."""
        if M is None:
            return x.mean()
        m = M.reshape(M.shape[0], *([1] * (x.dim() - 1)))
        per_sample = 1.0
        for d in x.shape[1:]:
            per_sample *= d
        denom = torch.clamp((M.sum() * per_sample), min=1e-8)
        return (x * m).sum() / denom

    def acc(probs, target):
        return bmean((probs.argmax(-1) == target.argmax(-1)).float())

    probs, logits = out["heads"]["notes"]
    Y = batch["Y"]
    if cfg.vae_loss in ("mse", "mean_squared_error"):
        xent = ((probs - Y) ** 2).mean(-1)
    else:
        xent = _xent_from_logits(logits, Y)
    if cfg.include_silent_note and cfg.silent_weight != 1.0:
        w = torch.where(Y[..., -1] == 1, torch.full_like(xent, cfg.silent_weight),
                        torch.ones_like(xent))
        nonzero = bmean((w != 0).float())
        notes_loss = bmean(xent * w) / torch.clamp(nonzero, min=1e-8)
    else:
        notes_loss = bmean(xent)
    metrics["notes_loss"] = notes_loss
    metrics["notes_acc"] = acc(probs, Y)
    total = 1.0 * notes_loss

    def categorical_head(head: str, key: str, name: str, weight: float):
        p, lg = out["heads"][head]
        loss = bmean(_xent_from_logits(lg, batch[key]))
        metrics[f"{name}_loss"] = loss
        metrics[f"{name}_acc"] = acc(p, batch[key])
        return weight * loss

    if cfg.meta_instrument:
        total = total + categorical_head("instrument", "I", "meta_instrument",
                                         cfg.meta_instrument_weight)
    if cfg.meta_velocity:
        probs_v, _ = out["heads"]["velocity"]
        V = batch["V"]
        loss_v = bmean((probs_v - V) ** 2)
        metrics["meta_velocity_loss"] = loss_v
        # Keras-2.0.8 binary_accuracy on a regression head: y_true is NOT
        # rounded, so a continuous velocity only scores at exactly 0 or 1
        metrics["meta_velocity_acc"] = bmean((torch.round(probs_v) == V).float())
        total = total + cfg.meta_velocity_weight * loss_v
    if cfg.meta_held_notes:
        total = total + categorical_head("held", "D", "meta_held_notes", cfg.meta_held_notes_weight)
    if cfg.meta_next_notes:
        total = total + categorical_head("next", "N", "meta_next_notes", cfg.meta_next_notes_weight)

    if cfg.include_composer_decoder:
        C = batch["C"]
        loss_c = bmean(_xent_from_logits(out["composer_logits"], C))
        metrics["composer_loss"] = loss_c
        metrics["composer_acc"] = acc(out["composer_logits"], C)
        total = total + cfg.composer_weight * loss_c
    if cfg.signature_decoder:
        loss_s = bmean((out["signature"] - batch["S"]) ** 2)
        metrics["signature_loss"] = loss_s
        total = total + cfg.signature_weight * loss_s
    if cfg.composer_decoder_at_notes_output:
        loss_cn = bmean(_xent_from_logits(out["composer_at_notes_logits"], batch["C"]))
        metrics["composer_at_notes_loss"] = loss_cn
        total = total + cfg.composer_decoder_at_notes_weight * loss_cn
    if cfg.composer_decoder_at_instrument_output:
        loss_ci = bmean(_xent_from_logits(out["composer_at_instrument_logits"], batch["C"]))
        metrics["composer_at_instrument_loss"] = loss_ci
        total = total + cfg.composer_decoder_at_instrument_weight * loss_ci

    log_var = out["z_log_var"]
    if cfg.epsilon_factor > 0:
        log_var = log_var + cfg.epsilon_factor
    kl = bmean(kl_divergence(out["z_mean"], log_var, cfg.prior_mean, cfg.prior_std))
    metrics["kl_loss"] = kl
    total = total + cfg.beta * kl
    metrics["loss"] = total
    if return_z:
        metrics["_z"] = out["z_mean"]
    return total, metrics

