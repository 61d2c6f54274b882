"""Batched encode / decode / style transfer on a model (the serving path).

Counterpart of ``midi_vae_tpu/evaluation/generation.py:28-343``:
``additional_rows``, ``decode_argmax_graph``, ``transfer_argmax_graph``,
``GenerationContext``, ``split_song_back_to_samples`` and
``vote_for_programs``. Batches are padded to the
``bucket_pow2`` sizes the JAX package uses; the parameters move to the
device once, when the context is made. All IO is numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import use_exact_f32
from ..config import Config
from ..data.batching import bucket_pow2, held_to_categorical, prepare_velocity
from ..data.tensorize import instrument_matrix_to_programs
from ..models.vae import MidiVAE
from . import sampling


def additional_rows(cfg: Config, C: int | None, S: np.ndarray | None, n: int) -> np.ndarray | None:
    """Decoder additional input rows, [C one-hot, S] per the configured flags.
    None when the config has no additional input."""
    if not cfg.decoder_additional_input:
        return None
    parts = []
    if cfg.decoder_input_composer:
        onehot = np.zeros((n, cfg.num_classes), np.float32)
        if C is not None:
            onehot[:, C] = 1.0
        parts.append(onehot)
    if cfg.append_signature_vector_to_latent:
        sig = np.zeros((n, cfg.signature_vector_length), np.float32)
        if S is not None:
            S = np.atleast_2d(np.asarray(S, np.float32))
            sig[: min(n, len(S))] = S[:n]
        parts.append(sig)
    return np.concatenate(parts, axis=-1)


def decode_argmax_graph(model: MidiVAE, cfg: Config):
    """fn(z, H, A) -> per-head argmax dict (argmax on the device)."""

    def decode_argmax_fn(z, H, A):
        outs = model.decode(z, history=H, additional=A if cfg.decoder_additional_input else None)
        res = {"notes_idx": outs["notes"][0].argmax(dim=-1)}
        if "instrument" in outs:
            res["inst_idx"] = outs["instrument"][0].argmax(dim=-1)
        if "velocity" in outs:
            res["vel"] = outs["velocity"][0][..., 0]
        if "held" in outs:
            res["held_idx"] = outs["held"][0].argmax(dim=-1)
        if "next" in outs:
            res["next_idx"] = outs["next"][0].argmax(dim=-1)
        return res

    return decode_argmax_fn


def transfer_argmax_graph(model: MidiVAE, cfg: Config, eps: float):
    """fn(batch, perm, A, generator) -> (argmax dict, switched z):
    encode -> latent swap (``perm``, a permutation of the latent indices)
    -> history roll -> decode -> argmax. ``A`` is the decoder additional
    input of the target class; ``eps`` the encode sampling epsilon."""
    decode_argmax = decode_argmax_graph(model, cfg)

    def transfer_argmax_fn(batch, perm, A, generator):
        z = model.encode(batch, generator, eps)
        switched = z[:, perm]
        H = torch.zeros_like(switched)
        H[1:] = switched[:-1]
        return decode_argmax(switched, H, A), switched

    return transfer_argmax_fn


class GenerationContext:
    """Encode / decode / style transfer with a model on one device."""

    def __init__(self, cfg: Config, model: MidiVAE, device: torch.device | str):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        use_exact_f32()
        self.model = model.to(self.device).eval()
        # do_not_sample_in_evaluation: eval encodes use epsilon_std = 0
        self._eval_eps = 0.0 if cfg.do_not_sample_in_evaluation else cfg.epsilon_std
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._decode_argmax = decode_argmax_graph(self.model, cfg)
        self._transfer_argmax = transfer_argmax_graph(self.model, cfg, self._eval_eps)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr, np.float32)).to(self.device)

    def _decode_padded(self, fn, z, history, additional) -> dict[str, np.ndarray]:
        cfg = self.cfg
        z = np.atleast_2d(np.asarray(z, np.float32))
        n = z.shape[0]
        b = bucket_pow2(n)
        zp = np.zeros((b, cfg.latent_dim), np.float32)
        zp[:n] = z
        Hp = np.zeros((b, cfg.latent_dim), np.float32)
        if history is not None:
            Hp[:n] = np.atleast_2d(history)[:n]
        Ap = np.zeros((b, max(1, cfg.decoder_additional_input_dim)), np.float32)
        if additional is not None:
            Ap[:n] = np.atleast_2d(additional)[:n]
        with torch.inference_mode():
            outs = fn(self._put(zp), self._put(Hp), self._put(Ap))
            return {k: v.cpu().numpy()[:n] for k, v in outs.items()}

    def decode_batch(self, z, history=None, additional=None) -> dict[str, np.ndarray]:
        """Decode (B, latent) -> head probability arrays."""

        def probs_fn(z, H, A):
            outs = self.model.decode(z, H, A if self.cfg.decoder_additional_input else None)
            return {k: probs for k, (probs, _logits) in outs.items()}

        return self._decode_padded(probs_fn, z, history, additional)

    def _padded_encoder_batch(self, X, I, V, D) -> tuple[dict, int]:
        """Windows of one song -> bucket-padded device batch + real count."""
        cfg = self.cfg
        n = X.shape[0]
        b = bucket_pow2(n)
        D_cat = held_to_categorical(np.atleast_2d(D))
        V3 = prepare_velocity(np.atleast_2d(V), D_cat, cfg)
        batch = {
            "X": np.zeros((b, cfg.input_length, cfg.input_dim), np.float32),
            "I": np.zeros((b, cfg.max_voices, cfg.instrument_dim), np.float32),
            "V": np.zeros((b, cfg.output_length, 1), np.float32),
            "D": np.zeros((b, cfg.output_length, 2), np.float32),
        }
        batch["X"][:n] = X
        batch["I"][:n] = np.tile(I[None], (n, 1, 1))
        batch["V"][:n] = V3
        batch["D"][:n] = D_cat
        return {k: self._put(v) for k, v in batch.items()}, n

    def encode_song(self, X, I, V, D) -> np.ndarray:
        """Windows of one song -> latents (n, latent)."""
        batch, n = self._padded_encoder_batch(X, I, V, D)
        with torch.inference_mode():
            z = self.model.encode(batch, self._generator, self._eval_eps)
            return z.cpu().numpy()[:n]

    def additional_for(self, C: int | None, S: np.ndarray | None, n: int) -> np.ndarray | None:
        return additional_rows(self.cfg, C, S, n)

    def transfer_argmax(self, batch, perm, A):
        """One encode -> swap -> history roll -> decode -> argmax on the
        device: (argmax dict, switched z), both on the device."""
        with torch.inference_mode():
            return self._transfer_argmax(batch, perm, A, self._generator)

    def style_transfer_song(self, X, I, V, D, C: int, C_switch: int, S=None):
        """The style-transfer round trip: returns the processed rolls
        (Y, I, V, D, N) and the switched latents (n, latent)."""
        cfg = self.cfg
        batch, n = self._padded_encoder_batch(X, I, V, D)
        perm = np.arange(cfg.latent_dim)
        perm[[C, C_switch]] = perm[[C_switch, C]]
        # the additional input carries the TARGET class (+ signature)
        Ap = np.zeros((batch["X"].shape[0], max(1, cfg.decoder_additional_input_dim)), np.float32)
        A = self.additional_for(C_switch, S, n)
        if A is not None:
            Ap[:n] = A
        idx, switched = self.transfer_argmax(
            batch, torch.as_tensor(perm, device=self.device), self._put(Ap)
        )
        idx = {k: v.cpu().numpy()[:n] for k, v in idx.items()}
        return sampling.process_argmax_outputs(idx, self.cfg), switched.cpu().numpy()[:n]

    def decode_and_process(self, z, history=None, additional=None, sample_method: str = "argmax",
                           independent_windows: bool = False):
        """Decode + argmax on the device, then post-process to rolls."""
        if sample_method != "argmax":
            raise NotImplementedError(f"sample_method {sample_method!r} not yet ported")
        idx = self._decode_padded(self._decode_argmax, z, history, additional)
        return sampling.process_argmax_outputs(idx, self.cfg, independent_windows=independent_windows)


def split_song_back_to_samples(X: np.ndarray, length: int) -> list[np.ndarray]:
    """A song's rows (n * length, ...) -> its n windows of ``length`` rows."""
    return np.split(X, int(X.shape[0] / length))


def vote_for_programs(I_pred: np.ndarray, cfg: Config) -> list[int]:
    """Majority vote of predicted instruments per voice over all windows."""
    votes = [dict() for _ in range(cfg.max_voices)]
    for matrix in I_pred:
        programs = instrument_matrix_to_programs(matrix, cfg.instrument_attach_method)
        for voice, program in enumerate(programs[: cfg.max_voices]):
            votes[voice][program] = votes[voice].get(program, 0) + 1
    result = []
    for voice in range(cfg.max_voices):
        best, best_count = 0, 0
        for program, count in votes[voice].items():
            if count > best_count:
                best, best_count = program, count
        result.append(best)
    return result
