"""Sequence RNN encoders and the autoregressive readout decode.

Counterpart of ``midi_vae_tpu/models/rnn.py``: ``encode_sequence``/
``_scan_layer`` run each layer as one call of kernel A (``ops.gru_layer``)
or, for LSTM cells, kernel L (``ops.lstm_layer``) when the model's kernel
switch is on, or on the training path as the differentiable
``gru_layer_train_x`` (kernels A, C and W) or ``lstm_layer_train_x``
(kernels L, N and W) or, on the wide route (``ops/_layout.py``), xp = x @ W
+ b in torch.matmul and ``gru_layer_train`` (kernels F, G and W; in
bfloat16 X, G and W) or
``lstm_layer_train`` (kernels Q, R and W) over it, or with ``per_step``
(``fused_train_encoder=False``) xp in one matmul and the per-step cell over
it (kernel T xp or S xp), or with ``whole_scan`` (the same in bfloat16) xp
in one matmul and the whole-scan layer over it (kernel X or Y), else the
plain per-step cell scan;
``init_decoder_states`` is plain dense + activation;
``decode_autoregressive`` is the readout loop that feeds each step's
activated output back as the next input, each cell through ``step`` when
given (kernel T or S, the JAX package's ``fused_step``) or the plain cell,
or with ``ground_truth`` the plain teacher-forced scan (heads that the
decode kernels take never reach it on the kernel path);
``decode_heads_merged`` runs several heads in one loop, each cell through
``step`` too.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops import _layout
from ..ops.encoder_scan import gru_encoder_scan, lstm_encoder_scan
from ..ops.gru_layer import gru_layer, gru_layer_train, gru_layer_train_x
from ..ops.gru_step import gru_recurrent_step
from ..ops.lstm_layer import lstm_layer, lstm_layer_train, lstm_layer_train_x
from ..ops.lstm_step import lstm_recurrent_step
from .cells import activation_fn, dense_apply, gate_activation_fn, get_cell, zero_states

Params = dict[str, Any]


def encode_sequence(layer_params, xs: torch.Tensor, cell_type: str, activation: str = "tanh",
                    bidirectional: bool = False, kernels: bool = False,
                    gate_activation: str = "sigmoid", train: bool = False,
                    wide: bool = False, per_step: bool = False,
                    whole_scan: bool = False) -> torch.Tensor:
    """Run a stacked RNN over (B, T, D); return the last layer's final h (B, H).

    All layers but the last return sequences; ``bidirectional`` wraps the
    non-final layers in forward + backward passes with concat merge.
    ``train`` (with ``kernels``) takes the differentiable training layer,
    over a precomputed x-projection when ``wide``; ``per_step`` (with
    ``kernels``) the per-step cell over it; ``whole_scan`` (with
    ``kernels``) the whole-scan layer over it."""
    cell = get_cell(cell_type)
    h = xs
    n_layers = len(layer_params)
    opts = (kernels, gate_activation, train, wide, per_step, whole_scan)
    for i, p in enumerate(layer_params):
        is_last = i == n_layers - 1
        if bidirectional and not is_last:
            fwd = _scan_layer(cell, p["fwd"], h, activation, True, *opts)
            bwd = _scan_layer(cell, p["bwd"], h.flip(1), activation, True, *opts).flip(1)
            h = torch.cat([fwd, bwd], dim=-1)
        else:
            h = _scan_layer(cell, p, h, activation, not is_last, *opts)
    return h


def _scan_layer(cell, p: Params, xs: torch.Tensor, activation: str, return_sequences: bool,
                kernels: bool = False, gate_activation: str = "sigmoid", train: bool = False,
                wide: bool = False, per_step: bool = False, whole_scan: bool = False):
    """One RNN layer over (B, T, D): one kernel-A call when ``kernels`` (GRU
    cells with sigmoid gates), the training layer (kernels A, C, W) when
    ``train`` too, or with ``wide`` xp = x @ W + b and kernels F, G, W (X,
    G, W in bfloat16: the JAX package's ``_gru_layer_fallback_x``,
    ``fused_train.py:2282-2288``, over ``_fwd_kernel`` and ``_bwd_kernel``);
    for LSTM cells with tanh one kernel-L call (``lstm_layer_infer_x``), the
    training layer (kernels L, N, W) or with ``wide`` kernels Q, R, W
    (``_lstm_layer_fallback_x``, :2559-2565); other LSTM cell activations
    take the plain scan on any device (``_lstm_x_use_pallas``,
    ``_lstm_mode``); with ``per_step`` xp = x @ W + b in one matmul and
    kernel T xp (GRU) or S xp (LSTM) per step over it, any cell activation
    (``rnn.py:184-200``); with ``whole_scan`` the same xp and one call of
    kernel X (GRU) or Y (LSTM) over it, any cell activation
    (``rnn.py:163-182``); else the plain cell scan. A bf16 training layer
    (kernels and ``train``, bf16 ``xs``) takes the rows the JAX package runs
    at its own (B, D, H) (``ops/_layout.py::bf16_layer_mode``: the in-kernel
    projection, or xp = x @ W + b in bf16 and the in-place or the wide pair,
    which differ in the rounding dU is summed from), whatever ``wide`` says;
    on the card rows without a port build that launches raise
    NotImplementedError."""
    B, T, _ = xs.shape
    hidden = p["u"].shape[0]
    init = zero_states(cell, B, hidden, xs)
    if kernels and whole_scan:
        # xp in the compute dtype, as cell.x_proj gives it outside Pallas
        xp = (xs.transpose(0, 1).reshape(T * B, -1) @ p["w"] + p["b"]).reshape(T, B, -1)
        if cell.num_states == 2:
            out = lstm_encoder_scan(xp, init[0], init[1], p["u"], activation, return_sequences)
        else:
            out = gru_encoder_scan(xp, init[0], p["u"], activation, return_sequences)
        return out.transpose(0, 1) if return_sequences else out
    if kernels and per_step:
        xp = (xs.transpose(0, 1).reshape(T * B, -1) @ p["w"] + p["b"]).reshape(T, B, -1)
        states, outs = init, []
        for t in range(T):
            if cell.num_states == 2:
                states = lstm_recurrent_step(xp[t], *states, p["u"], activation)
            else:
                states = (gru_recurrent_step(xp[t], *states, p["u"], activation),)
            if return_sequences:
                outs.append(states[0])
        return torch.stack(outs, dim=1) if return_sequences else states[0]
    mode = "inplace" if wide else "x"  # float32: one function on every row
    if kernels and train and xs.dtype == torch.bfloat16:
        mode = _layout.bf16_layer_mode("LSTM" if cell.num_states == 2 else "GRU", B,
                                       xs.shape[-1], hidden, xs.device.type == "cuda",
                                       xs.requires_grad)
    if kernels and train and mode != "scan" and (cell.num_states == 1 or activation == "tanh"):
        x = xs.transpose(0, 1).contiguous()
        if mode != "x":
            xp = (x.reshape(T * B, -1) @ p["w"] + p["b"]).reshape(T, B, -1)
            if cell.num_states == 2:
                out = lstm_layer_train(xp, init[0], init[1], p["u"], return_sequences, mode)
            else:
                out = gru_layer_train(xp, init[0], p["u"], return_sequences, mode)
        elif cell.num_states == 2:
            out = lstm_layer_train_x(x, init[0], init[1], p["w"], p["b"], p["u"],
                                     return_sequences)
        else:
            out = gru_layer_train_x(x, init[0], p["w"], p["b"], p["u"], return_sequences)
        return out.transpose(0, 1) if return_sequences else out
    if kernels and not train and cell.num_states == 2 and activation == "tanh":
        out = lstm_layer(xs.transpose(0, 1).contiguous(), init[0], init[1], p["w"], p["b"], p["u"],
                         activation, return_sequences)
        return out.transpose(0, 1) if return_sequences else out
    if kernels and not train and cell.num_states == 1:
        out = gru_layer(xs.transpose(0, 1).contiguous(), init[0], p["w"], p["b"], p["u"],
                        activation, return_sequences)
        return out.transpose(0, 1) if return_sequences else out

    act = activation_fn(activation)
    gact = gate_activation_fn(gate_activation)
    xp = cell.x_proj(p, xs.reshape(B * T, -1)).reshape(B, T, -1)
    states = init
    outs = []
    for t in range(T):
        out, states = cell.step(p, xp[:, t], states, act, gact)
        if return_sequences:
            outs.append(out)
    return torch.stack(outs, dim=1) if return_sequences else states[0]


def init_decoder_states(init_dense, new_encoded: torch.Tensor, cell_type: str,
                        state_activation: str) -> tuple[tuple, ...]:
    """Per-layer initial states = act(Dense([z, history, ...])); ``init_dense``
    is flat, num_layers * num_states dense params, layer-major."""
    cell = get_cell(cell_type)
    act = activation_fn(state_activation)
    n_layers = len(init_dense) // cell.num_states
    it = iter(init_dense)
    return tuple(
        tuple(act(dense_apply(next(it), new_encoded)) for _ in range(cell.num_states))
        for _ in range(n_layers)
    )


def decode_autoregressive(cell_params, out_dense: Params, initial_states, start: torch.Tensor,
                          output_length: int, cell_type: str, lstm_activation: str = "tanh",
                          out_activation: str = "softmax", gate_activation: str = "sigmoid",
                          ground_truth: torch.Tensor | None = None, step=None):
    """Readout loop: output_t feeds back as input_{t+1} (one head of
    ``decode_heads_merged``); with ``ground_truth`` (B, T, out_dim), step
    t > 0 consumes ground_truth[t-1] instead (teacher forcing, always the
    plain cells: the JAX teacher-forced scan ignores ``fused_step``,
    ``rnn.py:276-297``). ``step(params, x, states) -> (out, states)``
    replaces the plain cell of the fed-back loop (``fused_step``,
    ``rnn.py:299-312``).

    Returns (probs, logits), both (B, T, out_dim)."""
    if ground_truth is None:
        head = {"cells": cell_params, "out": out_dense, "init_states": initial_states,
                "start": start, "out_activation": out_activation}
        return decode_heads_merged({"head": head}, output_length, cell_type, lstm_activation,
                                   step, gate_activation)["head"]
    cell = get_cell(cell_type)
    act = activation_fn(lstm_activation)
    gact = gate_activation_fn(gate_activation)
    states = list(initial_states)
    logits = []
    for t in range(output_length):
        out = start if t == 0 else ground_truth[:, t - 1]
        for i, p in enumerate(cell_params):
            out, states[i] = cell.step(p, cell.x_proj(p, out), states[i], act, gact)
        logits.append(dense_apply(out_dense, out))
    logits = torch.stack(logits, dim=1)
    return activation_fn(out_activation)(logits), logits


def decode_heads_merged(heads: dict, output_length: int, cell_type: str,
                        lstm_activation: str = "tanh", step=None,
                        gate_activation: str = "sigmoid") -> dict:
    """Several readout decoders in one loop (``rnn.py:320-377``): the carry
    holds every head's states and previous output, each step runs every
    head's cells (through ``step`` when given, the JAX package's
    ``fused_step``) and readout in turn. The heads share no state, so each
    head's result is that of decoding it alone (``decode_autoregressive``
    is the one-head case).

    heads: name -> dict(cells, out, init_states, start, out_activation), all
    over ``output_length`` steps. Returns name -> (probs, logits), each (B,
    T, dim)."""
    cell = get_cell(cell_type)
    act = activation_fn(lstm_activation)
    gact = gate_activation_fn(gate_activation)
    if step is None:
        def step(p, x, s):
            return cell.step(p, cell.x_proj(p, x), s, act, gact)
    out_acts = {n: activation_fn(h["out_activation"]) for n, h in heads.items()}
    carry = {n: (list(h["init_states"]), h["start"]) for n, h in heads.items()}
    seqs = {n: ([], []) for n in heads}
    for _ in range(output_length):
        for n, h in heads.items():
            states, out = carry[n]
            for i, p in enumerate(h["cells"]):
                out, states[i] = step(p, out, states[i])
            lg = dense_apply(h["out"], out)
            out = out_acts[n](lg)
            carry[n] = (states, out)
            seqs[n][0].append(out)
            seqs[n][1].append(lg)
    return {n: (torch.stack(p, dim=1), torch.stack(lg, dim=1)) for n, (p, lg) in seqs.items()}
