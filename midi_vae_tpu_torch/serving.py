"""Serving bundles: exported, weights-baked inference programs.

Counterpart of ``midi_vae_tpu/serving.py``. A deployed MIDI-VAE needs three
programs:

  * ``encode``          windows -> latents (the deterministic eval-mode
                        z = z_mean);
  * ``decode_argmax``   latents (+ history, additional input) -> argmax'd
                        head outputs (note indices, instrument indices,
                        velocities, held flags);
  * ``style_transfer``  windows + latent permutation -> encode -> z swap ->
                        history roll -> decode -> argmax in one program
                        (``GenerationContext.transfer_argmax``).

Each is ``torch.export.export(..., strict=False)`` of a small module over
the port's own graphs (``model.encode``, ``decode_argmax_graph``,
``transfer_argmax_graph``), traced under ``torch.no_grad()`` with the
weights it reads (the encoder's, the decoder's or both) as the module's
parameters, and saved with ``torch.export.save`` as ``{program}@{B}.pt2``,
one per batch bucket. The programs call the kernels
through their registered operators (``ops/_custom.py``: ``mvt::gru_layer``,
``mvt::gru_decode``, ``mvt::lstm_layer``, ``mvt::lstm_decode``);
``export_classifier_judges`` seals the three style judges the same way
(``judge_{kind}@{B}.pt2``), so the transfer-and-judge pipeline runs from the
bundle alone. The directory also holds the run's ``config.json`` and a
``manifest.json`` with the JAX package's keys (``torch_version`` in place of
``jax_version``; ``platforms`` ``["cuda"]`` or ``["cpu"]``).

A bundle holds no model class and loading it builds none: the loader
imports the operators (which build their kernels at first use on the card,
as the Pallas kernels ride inside a JAX bundle's programs), loads the
programs, and serves any row count up to the largest bucket by padding to
the smallest adequate one. The programs of a bundle share one set of
weights on load, so that the decode kernels' packed weight slices
(``ops/gru_decode.py::packed``) are packed once per head and plan, not once
per program. The loader runs the programs under ``torch.no_grad()`` (an
inference tensor has no version counter, and the packing cache would miss
on it) with the port's float32 flags (``use_exact_f32``). A program traced
on ``cuda`` holds its weights on the card: it loads only on a card, and a
JAX bundle (``*.jaxexport``) is refused. Heads that neither B nor M decodes
run kernel T or S step by step, and those are not registered operators yet:
``export_serving_bundle`` refuses such a config (``unregistered_kernels``).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from . import use_exact_f32
from .config import Config

_PROGRAMS = ("encode", "decode_argmax", "style_transfer")
_MANIFEST = "manifest.json"
# bumped when the on-disk layout or program signatures change incompatibly
BUNDLE_FORMAT = 1
# where the kernels that no operator serves yet are queued
_QUEUE = "ROADMAP.md, Queue 1 item 10"


def _encoder_shapes(cfg: Config, B: int) -> dict[str, tuple]:
    shapes = {"X": (B, cfg.input_length, cfg.input_dim)}
    if cfg.meta_instrument:
        shapes["I"] = (B, cfg.max_voices, cfg.instrument_dim)
    if cfg.meta_velocity:
        shapes["V"] = (B, cfg.meta_velocity_length, 1)
    if cfg.meta_held_notes:
        shapes["D"] = (B, cfg.meta_held_notes_length, 2)
    return shapes


def _buckets(batch_size: int | Sequence[int]) -> list[int]:
    buckets = sorted({int(b) for b in ([batch_size] if isinstance(batch_size, int)
                                       else batch_size)})
    if not buckets or buckets[0] < 1:
        raise ValueError(f"bad batch buckets {buckets}")
    return buckets


def _device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"serving bundles run on cpu or cuda, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return dev


def unregistered_kernels(model, device: str | torch.device) -> list[str]:
    """The kernels ``model``'s serving graphs reach on ``device`` that no
    ``mvt::`` operator serves: kernel T (GRU) or S (LSTM), the per-step cell
    of each decode head that B or M does not take
    (``MidiVAE.serving_head_kernel``: heads of three or more layers, or an
    output activation other than softmax, sigmoid and linear). The encoder
    serves through A or L (or the plain scan where the kernels are off,
    ``models/rnn.py::_scan_layer``), never through the training path's X,
    Y, T xp or S xp."""
    device = torch.device(device)
    if not model.kernels_enabled(device):
        return []
    step = "S" if model.cfg.cell_type == "LSTM" else "T"
    found = []
    for name, _, _, out_activation in model.serving_heads():
        n_layers = len(model.params["decoder"][name]["cells"])
        if not model.serving_head_kernel(name, n_layers, out_activation, device):
            found.append(f"kernel {step} on the {name} head ({n_layers} layers, "
                         f"{out_activation} output)")
    return found


class _Program(nn.Module):
    """A serving program over ``model``: it registers only the parameter
    subtrees its graph reads (``parts`` of ``model.params``), so the program
    holds those weights and no others; the model itself stays unregistered."""

    def __init__(self, model, parts):
        super().__init__()
        for part in parts:
            self.add_module(part, model.params[part])
        self._model = (model,)


class _Encode(_Program):
    def __init__(self, model):
        super().__init__(model, ["encoder"])

    def forward(self, batch):
        return self._model[0].encode(batch, None, 0.0)


class _DecodeArgmax(_Program):
    def __init__(self, model, cfg):
        super().__init__(model, ["decoder"])
        from .evaluation.generation import decode_argmax_graph

        self._fn = decode_argmax_graph(model, cfg)

    def forward(self, z, H, A):
        return self._fn(z, H, A)


class _StyleTransfer(_Program):
    def __init__(self, model, cfg):
        super().__init__(model, ["encoder", "decoder"])
        from .evaluation.generation import transfer_argmax_graph

        self._fn = transfer_argmax_graph(model, cfg, 0.0)

    def forward(self, batch, perm, A):
        return self._fn(batch, perm, A, None)


class _Judge(nn.Module):
    def __init__(self, classifier):
        super().__init__()
        self.model = classifier

    def forward(self, x):
        return self.model.predict(x)


def _export(module: nn.Module, args: tuple, path: str) -> tuple[int, float]:
    """Export ``module`` on ``args`` to ``path``: (bytes, seconds)."""
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
    program.example_inputs = None  # zeros of the bucket's shapes: a batch of bytes, no use
    torch.export.save(program, path)
    return os.path.getsize(path), time.perf_counter() - t0


def export_serving_bundle(
    cfg: Config,
    params,
    out_dir: str,
    batch_size: int | Sequence[int] = 256,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Export the three serving programs for ``cfg`` and ``params`` (the
    numpy tree of a run, ``checkpoint.load_run_params``) on ``device``.

    ``batch_size``: one bucket or a list of buckets, each with its own
    program triple (shapes are static; the loader picks the smallest
    adequate bucket per call). Raises NotImplementedError for a config whose
    serving path reaches a kernel no operator serves
    (``unregistered_kernels``). Returns the manifest dict."""
    from .models.vae import MidiVAE

    dev = _device(device)
    use_exact_f32()
    model = MidiVAE(cfg, params).to(dev).eval()
    missing = unregistered_kernels(model, dev)
    if missing:
        raise NotImplementedError(
            "this config's serving path reaches kernels that are not registered operators "
            f"yet: {'; '.join(missing)} ({_QUEUE} registers them). Serve it live: "
            "python -m midi_vae_tpu_torch.cli.transfer --model RUN")
    buckets = _buckets(batch_size)
    a_dim = max(1, cfg.decoder_additional_input_dim)
    programs = {"encode": _Encode(model), "decode_argmax": _DecodeArgmax(model, cfg),
                "style_transfer": _StyleTransfer(model, cfg)}

    os.makedirs(out_dir, exist_ok=True)
    sizes: dict[str, int] = {}
    seconds: dict[str, float] = {}
    for B in buckets:
        batch = {k: torch.zeros(s, device=dev) for k, s in _encoder_shapes(cfg, B).items()}
        z = torch.zeros(B, cfg.latent_dim, device=dev)
        A = torch.zeros(B, a_dim, device=dev)
        perm = torch.arange(cfg.latent_dim, device=dev)
        args = {"encode": (batch,), "decode_argmax": (z, torch.zeros_like(z), A),
                "style_transfer": (batch, perm, A)}
        for name, module in programs.items():
            fname = f"{name}@{B}.pt2"
            sizes[fname], seconds[fname] = _export(module, args[name],
                                                   os.path.join(out_dir, fname))

    cfg.save(os.path.join(out_dir, "config.json"))
    manifest = {
        "bundle_format": BUNDLE_FORMAT,
        "programs": list(_PROGRAMS),
        "batch_sizes": buckets,
        "encoder_input_dims": {k: list(s[1:]) for k, s in _encoder_shapes(cfg, 1).items()},
        "latent_dim": cfg.latent_dim,
        "additional_dim": a_dim,
        "platforms": [dev.type],
        "deterministic_encode": True,
        "torch_version": torch.__version__,
        "blob_bytes": sizes,
        "export_seconds": seconds,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def export_classifier_judges(
    classifiers: dict,
    bundle_dir: str,
    batch_size: int | Sequence[int] = 256,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Seal style judges into an EXISTING serving bundle.

    ``classifiers``: kind -> ``StyleClassifier`` for any subset of
    {'pitch', 'velocity', 'instrument'} (``checkpoint.load_classifier``).
    Each judge's softmax ``predict`` is exported per batch bucket with its
    weights baked in (``judge_<kind>@<B>.pt2``: kernel A for GRU judges, L
    for LSTM judges); its ``ClassifierSpec`` goes into the manifest, so the
    loader replays the host-side input preprocessing (velocity transforms)
    without a model class. Sequence judges are sealed at the decoded window
    length (``cfg.output_length``), the transfer-and-judge use the bundle
    serves; the loader rejects other trailing dims. ``device`` must be the
    bundle's platform. Returns the updated manifest."""
    manifest_path = os.path.join(bundle_dir, _MANIFEST)
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(f"{bundle_dir!r} has no manifest -- export the VAE bundle "
                                "first (export_serving_bundle)")
    with open(manifest_path) as f:
        manifest = json.load(f)
    dev = _device(device)
    if manifest["platforms"] != [dev.type]:
        raise ValueError(f"the bundle's programs run on {manifest['platforms']}; seal its "
                         f"judges there too, not on {dev.type!r}")
    use_exact_f32()
    cfg = Config.load(os.path.join(bundle_dir, "config.json"))
    buckets = _buckets(batch_size)
    judges: dict[str, Any] = {}
    for kind, classifier in classifiers.items():
        spec = classifier.spec
        row_dims = {"pitch": (cfg.output_length, spec.input_dim),
                    "velocity": (cfg.output_length, 1),
                    "instrument": (cfg.max_voices, spec.input_dim)}
        if kind not in row_dims:
            raise ValueError(f"unknown judge kind {kind!r}")
        module = _Judge(classifier.to(dev).eval())
        sizes, seconds = {}, {}
        for B in buckets:
            fname = f"judge_{kind}@{B}.pt2"
            x = torch.zeros(B, *row_dims[kind], device=dev)
            sizes[fname], seconds[fname] = _export(module, (x,), os.path.join(bundle_dir, fname))
        judges[kind] = {"row_dims": list(row_dims[kind]), "spec": dataclasses.asdict(spec),
                        "blob_bytes": sizes, "export_seconds": seconds}
    manifest["judges"] = judges
    manifest["judge_batch_sizes"] = buckets
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _share_weights(programs) -> None:
    """Point every program's parameters and buffers at one tensor per name
    (the first program's), where the tensors are equal: the programs of a
    bundle were exported from one model, so they serve from one set of
    weights and the packing cache keys one entry per head and plan."""
    shared: dict[str, torch.Tensor] = {}
    for module in programs:
        for kind in ("_parameters", "_buffers"):
            for prefix, sub in module.named_modules():
                slots = getattr(sub, kind)
                for leaf, t in slots.items():
                    name = f"{prefix}.{leaf}" if prefix else leaf
                    seen = shared.setdefault(name, t)
                    if (seen is not t and seen.shape == t.shape and seen.dtype == t.dtype
                            and torch.equal(seen, t)):
                        slots[leaf] = seen


class ServingBundle:
    """A loaded bundle: exported programs, numpy in and out.

    ``encode(batch)``, ``decode_argmax(z, H, A)`` and ``style_transfer(batch,
    perm, A)`` accept any row count up to the largest exported bucket:
    inputs are zero-padded to the smallest adequate bucket and outputs
    trimmed back. ``device`` must be the platform the bundle was exported
    on (default ``cuda``)."""

    def __init__(self, bundle_dir: str, device: str | torch.device = "cuda"):
        manifest_path = os.path.join(bundle_dir, _MANIFEST)
        if not os.path.exists(manifest_path):
            raise FileNotFoundError(
                f"{bundle_dir!r} has no manifest.json -- is this a serving bundle "
                "(python -m midi_vae_tpu_torch.tools.export_serving --out)?")
        with open(manifest_path) as f:
            self.manifest = json.load(f)
        if "jax_version" in self.manifest or glob.glob(os.path.join(bundle_dir, "*.jaxexport")):
            raise RuntimeError(
                f"{bundle_dir!r} is a JAX package bundle (midi_vae_tpu.serving, jax.export "
                "programs); the port serves its own format: export the run with python -m "
                "midi_vae_tpu_torch.tools.export_serving")
        fmt = int(self.manifest.get("bundle_format", 1))
        if fmt > BUNDLE_FORMAT:
            raise RuntimeError(
                f"bundle {bundle_dir!r} has format {fmt}, newer than this framework supports "
                f"({BUNDLE_FORMAT}); upgrade the package or re-export the bundle")
        platforms = [p.lower() for p in self.manifest.get("platforms") or []]
        dev = torch.device(device)
        if dev.type not in platforms:
            raise RuntimeError(
                f"bundle {bundle_dir!r} was exported for platform(s) {platforms}; it was asked "
                f"to load on {dev.type!r}. Re-export with --device {dev.type} (python -m "
                "midi_vae_tpu_torch.tools.export_serving) or load it on a matching host")
        self.device = _device(dev)
        use_exact_f32()
        from .ops import _custom  # noqa: F401  the mvt:: operators the programs call

        self.bundle_dir = bundle_dir
        self.cfg = Config.load(os.path.join(bundle_dir, "config.json"))
        self.batch_sizes = [int(b) for b in self.manifest["batch_sizes"]]
        self._judge_meta = self.manifest.get("judges", {})
        self.judge_batch_sizes = [int(b) for b in self.manifest.get("judge_batch_sizes", [])]
        names = [(n, B) for n in self.manifest["programs"] for B in self.batch_sizes]
        names += [(f"judge_{k}", B) for k in self._judge_meta for B in self.judge_batch_sizes]
        self._fns = {(n, B): torch.export.load(os.path.join(bundle_dir, f"{n}@{B}.pt2")).module()
                     for n, B in names}
        _share_weights([fn for (n, _), fn in self._fns.items() if not n.startswith("judge_")])

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    def bucket_for(self, n: int) -> int:
        for B in self.batch_sizes:
            if n <= B:
                return B
        raise ValueError(f"{n} rows exceed the bundle's largest bucket {self.max_batch}")

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(self.device)

    def call(self, name: str, B: int, *args):
        """Program ``name`` at bucket ``B`` on device tensors: its outputs,
        on the device."""
        with torch.no_grad():
            return self._fns[(name, B)](*args)

    def _pad_rows(self, a, B: int, dtype=np.float32):
        a = np.asarray(a, dtype)
        p = np.zeros((B,) + a.shape[1:], dtype)
        p[: a.shape[0]] = a
        return p

    def pad_batch(self, batch: dict, B: int | None = None) -> tuple[dict, int]:
        """Zero-pad a partial encoder batch to a bucket; returns (padded
        batch, real row count)."""
        n = int(np.asarray(batch["X"]).shape[0])
        B = self.bucket_for(n) if B is None else B
        out = {}
        for k, dims in self.manifest["encoder_input_dims"].items():
            a = np.asarray(batch[k], np.float32)
            if list(a.shape[1:]) != list(dims):
                raise ValueError(f"{k}: expected trailing dims {dims}, got {list(a.shape[1:])}")
            out[k] = self._pad_rows(a, B)
        return out, n

    def _device_batch(self, padded: dict) -> dict:
        return {k: self._put(v) for k, v in padded.items()}

    def encode(self, batch: dict) -> np.ndarray:
        n = int(np.asarray(batch["X"]).shape[0])
        if n > self.max_batch:
            # encode is row-independent: chunk over the largest bucket
            return np.concatenate([
                self.encode({k: np.asarray(v)[i: i + self.max_batch] for k, v in batch.items()})
                for i in range(0, n, self.max_batch)], axis=0)
        padded, n = self.pad_batch(batch)
        B = padded["X"].shape[0]
        return self.call("encode", B, self._device_batch(padded)).cpu().numpy()[:n]

    def decode_argmax(self, z, H=None, A=None) -> dict[str, np.ndarray]:
        z = np.atleast_2d(np.asarray(z, np.float32))
        n = z.shape[0]
        if n > self.max_batch:
            # row-independent given explicit H and A: chunk like encode
            def rows(a, i):
                return None if a is None else np.atleast_2d(a)[i: i + self.max_batch]

            chunks = [self.decode_argmax(z[i: i + self.max_batch], rows(H, i), rows(A, i))
                      for i in range(0, n, self.max_batch)]
            return {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}
        B = self.bucket_for(n)
        Hp = (np.zeros((B, self.manifest["latent_dim"]), np.float32) if H is None
              else self._pad_rows(np.atleast_2d(H), B))
        Ap = (np.zeros((B, self.manifest["additional_dim"]), np.float32) if A is None
              else self._pad_rows(np.atleast_2d(A), B))
        out = self.call("decode_argmax", B, self._put(self._pad_rows(z, B)), self._put(Hp),
                        self._put(Ap))
        return {k: v.cpu().numpy()[:n] for k, v in out.items()}

    def style_transfer(self, batch: dict, perm, A=None):
        padded, n = self.pad_batch(batch)
        B = padded["X"].shape[0]
        Ap = (np.zeros((B, self.manifest["additional_dim"]), np.float32) if A is None
              else self._pad_rows(np.atleast_2d(A), B))
        perm = torch.as_tensor(np.asarray(perm, np.int64), device=self.device)
        outs, switched = self.call("style_transfer", B, self._device_batch(padded), perm,
                                   self._put(Ap))
        return {k: v.cpu().numpy()[:n] for k, v in outs.items()}, switched.cpu().numpy()[:n]

    # -- song-level entry points (GenerationContext's surface) ------------
    # The transfer CLI drives a live GenerationContext or a loaded bundle
    # through the same methods; a bundle decodes argmax only.

    def _song_batch(self, X, I, V, D) -> dict:
        from .data.batching import held_to_categorical, prepare_velocity

        cfg = self.cfg
        n = X.shape[0]
        D_cat = held_to_categorical(np.atleast_2d(D))
        V3 = prepare_velocity(np.atleast_2d(V), D_cat, cfg)
        batch = {"X": np.asarray(X, np.float32)}
        if cfg.meta_instrument:
            batch["I"] = np.tile(np.asarray(I, np.float32)[None], (n, 1, 1))
        if cfg.meta_velocity:
            batch["V"] = np.asarray(V3, np.float32)
        if cfg.meta_held_notes:
            batch["D"] = np.asarray(D_cat, np.float32)
        return batch

    def additional_for(self, C, S, n):
        from .evaluation.generation import additional_rows

        return additional_rows(self.cfg, C, S, n)

    def encode_song(self, X, I, V, D) -> np.ndarray:
        """Windows of one song -> deterministic latents (n, latent)."""
        return self.encode(self._song_batch(X, I, V, D))

    def style_transfer_song(self, X, I, V, D, C: int, C_switch: int, S=None):
        """Style transfer from the bundle alone: encode -> z[C] <-> z[C_switch]
        swap -> history roll -> argmax decode, the contract of
        ``GenerationContext.style_transfer_song``. Songs up to the largest
        bucket take the one-program path; longer songs compose the same
        pipeline from the ``encode`` and ``decode_argmax`` programs (the
        history roll on the host between them), so a bundle serves any song
        length."""
        from .evaluation import sampling

        cfg = self.cfg
        batch = self._song_batch(X, I, V, D)
        n = batch["X"].shape[0]
        perm = np.arange(cfg.latent_dim)
        perm[[C, C_switch]] = perm[[C_switch, C]]
        A = self.additional_for(C_switch, S, n)
        if n <= self.max_batch:
            idx, switched = self.style_transfer(batch, perm, A)
        else:
            switched = self.encode(batch)[:, perm]
            H = np.zeros_like(switched)
            H[1:] = switched[:-1]
            idx = self.decode_argmax(switched, H, A)
        return sampling.process_argmax_outputs(idx, cfg), switched

    # -- sealed classifier judges ------------------------------------------

    @property
    def judges(self) -> dict:
        """kind -> numpy predict callable over the sealed judge programs,
        the surface ``models.classifier.make_judge`` builds from live models.
        Empty when the bundle was exported without judges."""
        from .models.classifier import ClassifierSpec

        out = {}
        for kind, meta in self._judge_meta.items():
            spec = ClassifierSpec(**meta["spec"])

            def predict(x, _kind=kind, _spec=spec, _dims=meta["row_dims"]):
                x = np.asarray(_spec.preprocess_inputs(x), np.float32)
                if list(x.shape[1:]) != list(_dims):
                    raise ValueError(f"judge_{_kind}: expected trailing dims {_dims}, "
                                     f"got {list(x.shape[1:])}")
                if x.shape[0] == 0:  # make_judge's surface: empty in, (0, k) out
                    return np.zeros((0, _spec.num_classes), np.float32)
                top = self.judge_batch_sizes[-1]
                chunks = []
                for i in range(0, x.shape[0], top):  # rows are independent
                    part = x[i: i + top]
                    n = part.shape[0]
                    B = next(b for b in self.judge_batch_sizes if n <= b)
                    probs = self.call(f"judge_{_kind}", B, self._put(self._pad_rows(part, B)))
                    chunks.append(probs.cpu().numpy()[:n])
                return np.concatenate(chunks, axis=0)

            out[kind] = predict
        return out

    def ensemble_prediction(self, pitch_x, instrument_x, velocity_x):
        """The three-judge ensemble over the sealed programs: the weighted
        mean of the judges' softmax probabilities (weights 0.999 - 0.5)."""
        from .models.classifier import ensemble_prediction

        judges = self.judges
        missing = {"pitch", "instrument", "velocity"} - set(judges)
        if missing:
            raise RuntimeError(f"bundle lacks sealed judges {sorted(missing)}; re-export with "
                               "python -m midi_vae_tpu_torch.tools.export_serving --classifiers")
        return np.asarray(ensemble_prediction(judges["pitch"](pitch_x),
                                              judges["instrument"](instrument_x),
                                              judges["velocity"](velocity_x)))

    def decode_and_process(self, z, history=None, additional=None, sample_method: str = "argmax",
                           rng=None, independent_windows: bool = False):
        if sample_method != "argmax":
            raise ValueError("serving bundles export argmax decoding only; "
                             f"got sample_method={sample_method!r}")
        from .evaluation import sampling

        idx = self.decode_argmax(z, history, additional)
        return sampling.process_argmax_outputs(idx, self.cfg,
                                               independent_windows=independent_windows)


def load_serving_bundle(bundle_dir: str, device: str | torch.device = "cuda") -> ServingBundle:
    return ServingBundle(bundle_dir, device)
