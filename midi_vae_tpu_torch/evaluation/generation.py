"""Batched encode / decode / style transfer on a model, and the song
generators: interpolations, medleys, random songs, long songs.

Counterpart of ``midi_vae_tpu/evaluation/generation.py``: where the
reference calls ``decoder.predict`` once per latent vector, everything here
decodes batches of latents in one call, padded to the ``bucket_pow2`` sizes
the JAX package uses. The parameters move to the device once, when the
context is made. All IO is numpy. The JAX context's ``mesh`` has no
counterpart: the port serves on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import use_exact_f32
from ..config import Config
from ..data.batching import bucket_pow2, held_to_categorical, prepare_velocity
from ..data.tensorize import instrument_matrix_to_programs
from ..models.vae import MidiVAE
from ..utils import music
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
                           rng=None, independent_windows: bool = False):
        """Decode, then post-process to rolls (Y, I, V, D, N). ``argmax``
        takes the argmax on the device and fetches indices; ``choice`` fetches
        the heads' probabilities and draws from them on the host with
        ``rng`` (a ``np.random.RandomState``; None: numpy's global one).
        ``independent_windows`` post-processes each window on its own (the
        velocity override chain then resets at every window boundary, as in
        the reference's per-window ``decoder.predict`` calls)."""
        if sample_method == "argmax":
            idx = self._decode_padded(self._decode_argmax, z, history, additional)
            return sampling.process_argmax_outputs(idx, self.cfg, independent_windows=independent_windows)
        outs = self.decode_batch(z, history, additional)
        return sampling.process_decoder_outputs(outs, sample_method, self.cfg, rng,
                                                independent_windows=independent_windows)


# ---------------------------------------------------------------------------
# Latent-space helpers (vae_evaluation.py:577-662)
# ---------------------------------------------------------------------------

def linear_interpolation(p0: np.ndarray, p1: np.ndarray, t: float) -> np.ndarray:
    return p0 * (1.0 - t) + p1 * t


def slerp(p0: np.ndarray, p1: np.ndarray, t: float) -> np.ndarray:
    omega = np.arccos(np.clip(np.dot(p0 / np.linalg.norm(p0), p1 / np.linalg.norm(p1)), -1.0, 1.0))
    so = np.sin(omega)
    if so == 0:
        return linear_interpolation(p0, p1, t)
    return np.sin((1.0 - t) * omega) / so * p0 + np.sin(t * omega) / so * p1


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


def prepare_for_drawing(Y: np.ndarray, cfg: Config, V: np.ndarray | None = None) -> np.ndarray:
    """Grey-scale notes by velocity for plots (vae_evaluation.py:619-642)."""
    newY = np.copy(Y)
    mv = cfg.max_voices
    if V is not None:
        thr = cfg.velocity_threshold
        for step in range(V.shape[0]):
            if V[step] > thr:
                newY[step, :] *= (V[step] - thr) * cfg.max_velocity
            else:
                if step > mv:
                    prev = np.argmax(newY[step - mv])
                    cur = np.argmax(newY[step])
                    if cur != prev:
                        newY[step, :] = 0
                    else:
                        newY[step, :] = newY[step - mv, :]
                else:
                    newY[step, :] = 0
        poly = music.monophonic_to_khot_pianoroll(newY, mv, set_all_nonzero_to_1=False)
    else:
        poly = music.monophonic_to_khot_pianoroll(newY, mv)
    return np.transpose(poly)


def restructure_song_to_fit_more_instruments(Y: np.ndarray, I_list, V: np.ndarray, D: np.ndarray,
                                             cfg: Config):
    """Give every window its own instrument set by widening the voice axis
    (vae_evaluation.py:645-662)."""
    T = cfg.output_length
    mv = cfg.max_voices
    num_samples = len(I_list)
    Y_final = np.zeros((num_samples * T * num_samples, Y.shape[1]), Y.dtype)
    V_final = np.zeros((num_samples * T * num_samples,))
    D_final = np.zeros((num_samples * T * num_samples,))
    final_programs: list[int] = []
    for sample, I in enumerate(I_list):
        final_programs.extend(instrument_matrix_to_programs(I, cfg.instrument_attach_method))
        for step in range(T // mv):
            for voice in range(mv):
                src = sample * T + step * mv + voice
                dst = sample * T * num_samples + step * num_samples * mv + sample * mv + voice
                Y_final[dst, :] = Y[src, :]
                V_final[dst] = V[src]
                D_final[dst] = D[src]
    return Y_final, final_programs, V_final, D_final


# ---------------------------------------------------------------------------
# Song generators
# ---------------------------------------------------------------------------

def generate_random_song(ctx: GenerationContext, z_std: float, rng: np.random.RandomState,
                         sample_method: str = "choice", style_class: int | None = None,
                         z: np.ndarray | None = None):
    """One random-latent song; optional composer-knob forcing
    (vae_evaluation.py:1771-1814): z[0:k] = -1, z[C] = 1. Pass ``z`` to
    reuse one latent across classes (the reference flips the knob on a
    shared random code, so per-class outputs differ only by the knob)."""
    cfg = ctx.cfg
    if z is None:
        z = rng.normal(0.0, z_std, size=(1, cfg.latent_dim)).astype(np.float32)
    z = np.copy(np.atleast_2d(z)).astype(np.float32)
    if style_class is not None:
        z[0, : cfg.num_classes] = -1
        z[0, style_class] = 1
    return ctx.decode_and_process(
        z, additional=ctx.additional_for(style_class if style_class is not None else 0, None, len(z)),
        sample_method=sample_method, rng=rng,
    )


def generate_interpolation_song(ctx: GenerationContext, z_a: np.ndarray, z_b: np.ndarray,
                                steps: int, sample_method: str = "argmax", rng=None):
    """Walk z_a -> z_b in ``steps + 1`` windows, history chained
    (vae_evaluation.py:841-887). Returns (Y, I_list, V, D)."""
    zs = np.stack([linear_interpolation(z_a, z_b, i / float(steps)) for i in range(steps + 1)])
    history = np.zeros_like(zs)
    history[1:] = zs[:-1]
    # the reference decodes one window per predict call: window-independent
    # post-processing
    Y, I, V, D, _ = ctx.decode_and_process(zs, history=history, sample_method=sample_method,
                                           rng=rng, independent_windows=True)
    return Y, I, V, D


def generate_medley(ctx: GenerationContext, songs: list[dict], interpolation_length: int,
                    samples_per_song: int, sample_method: str = "argmax",
                    rng: np.random.RandomState | None = None):
    """Chosen-song interpolation medley (vae_evaluation.py:705-837).

    ``songs``: list of {X, I, V, D} window dicts. For each consecutive pair,
    bridge with ``interpolation_length`` interpolated windows, then decode
    ``samples_per_song`` real windows. Returns (Y, I_list, V, D, info).
    """
    rng = rng or np.random.RandomState()
    Y_out, I_out, V_out, D_out = [], [], [], []
    info: dict[str, object] = {}
    previous_medley_z = None
    previous_rep = np.zeros((1, ctx.cfg.latent_dim), np.float32)

    for idx, song in enumerate(songs):
        X, I, V, D = song["X"], song["I"], song["V"], song["D"]
        n = X.shape[0]
        take = min(samples_per_song, n)
        start = 0 if n <= take else int(rng.randint(0, n - take))
        R = ctx.encode_song(X[start: start + take], I, V[start: start + take], D[start: start + take])
        info[f"programs_{idx}"] = instrument_matrix_to_programs(I, ctx.cfg.instrument_attach_method)

        if previous_medley_z is not None:
            for i in range(interpolation_length):
                z = linear_interpolation(previous_medley_z, R[0], i / float(interpolation_length))[None]
                Y, Ip, Vp, Dp, _ = ctx.decode_and_process(z, history=previous_rep,
                                                          sample_method=sample_method, rng=rng)
                Y_out.append(Y)
                I_out.extend(Ip)
                V_out.append(Vp)
                D_out.append(Dp)
                # the reference records the decoded bridge instruments per
                # interpolation step (vae_evaluation.py:810)
                info[f"programs_{idx}_interpolation_{i}"] = instrument_matrix_to_programs(
                    Ip[0], ctx.cfg.instrument_attach_method)
                previous_rep = z
        for i in range(R.shape[0]):
            z = R[i][None]
            Y, Ip, Vp, Dp, _ = ctx.decode_and_process(z, history=previous_rep,
                                                      sample_method=sample_method, rng=rng)
            Y_out.append(Y)
            I_out.extend(Ip)
            V_out.append(Vp)
            D_out.append(Dp)
            previous_rep = z
        previous_medley_z = R[-1]

    return (np.concatenate(Y_out, axis=0), np.asarray(I_out), np.concatenate(V_out),
            np.concatenate(D_out), info)


def generate_long_song(ctx: GenerationContext, all_z: np.ndarray, z_std: float, length: int,
                       rng: np.random.RandomState, sample_method: str = "choice"):
    """Decode -> re-encode -> blend with the nearest cached train z, chained
    (vae_evaluation.py:1821-1896).

    The nearest-z scan is the reference's (vae_evaluation.py:1847-1856): the
    running minimum starts at index 0's distance whether or not 0 was
    already picked, so when no unpicked z beats dist(all_z[0], R) the walk
    picks index 0 again."""
    cfg = ctx.cfg
    R = rng.normal(0.0, z_std, size=(1, cfg.latent_dim))
    previous_rep = np.zeros((1, cfg.latent_dim), np.float32)
    picked: set[int] = set()
    Y_out, I_out, V_out, D_out = [], [], [], []

    for _ in range(length):
        dists = np.linalg.norm(all_z - R, axis=1)
        lowest = dists[0]
        best = 0
        for i in range(len(all_z)):
            if dists[i] < lowest and i not in picked:
                lowest = dists[i]
                best = i
        picked.add(best)
        e = z_std
        R = (R + all_z[best] * e) / (1 + e)

        Y, I, V, D, _ = ctx.decode_and_process(R, history=previous_rep,
                                               sample_method=sample_method, rng=rng)
        Y_out.append(Y)
        I_out.extend(I)
        V_out.append(V)
        D_out.append(D)

        # feed the output back through the encoder
        X = sampling.add_silent_column(Y, cfg)[None]
        previous_rep = R
        R = ctx.encode_song(X, I[0], V[None], D[None])

    return np.concatenate(Y_out, axis=0), np.asarray(I_out), np.concatenate(V_out), np.concatenate(D_out)
