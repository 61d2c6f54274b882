"""A copy of ``midi_vae_tpu/config.py`` for the port, which imports nothing of
the JAX package. Keep the two field-equal: ``tests/test_torch_isolation.py``
holds every field and derived property of both against each other.

Typed configuration for the TPU-native MIDI-VAE framework.

This replaces the reference's global-constants module (``settings.py`` in
brunnergino/MIDI-VAE, see the reference's settings.py:1-416) with a frozen
dataclass: every semantic field of the reference survives with the same
default, derived quantities (``input_dim``, ``num_composers``, the
``x max_voices`` sequence lengths of settings.py:140-144, ...) are computed in
``__post_init__`` instead of at import time, and there are **no import side
effects** (the reference mkdir's a pickle folder on import,
settings.py:58-61).

Configs serialize to/from JSON, replacing both ``settings.py`` and the
``params.txt`` dumps of the reference (vae_training.py:578-654).
"""

from __future__ import annotations

import ast
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

# General-MIDI instrument tables (settings.py:252-416). Public-domain data.
INSTRUMENT_CATEGORY_NAMES = [
    "piano", "chromatic percussion", "organs", "guitar", "bass", "strings",
    "ensemble", "brass", "reed", "pipe", "synth lead", "synth pad",
    "synth effects", "ethnic", "percussive", "sound effects",
]

_INSTRUMENT_DIMS = {
    "1hot-category": 16,
    "khot-category": 4,
    "1hot-instrument": 128,
    "khot-instrument": 7,
}

VALID_CELL_TYPES = ("GRU", "LSTM", "SimpleRNN")


@dataclass(frozen=True)
class Config:
    """One config object for data import, model, training and generation.

    Field semantics follow the reference's settings.py; fields whose value is
    *derived* in the reference (e.g. ``input_dim = new_num_notes +
    composer_length + silent_dim + instrument_dim``, settings.py:207) are
    exposed as read-only properties here.
    """

    # ---------------- data import (settings.py:26-101) ----------------
    classes: tuple[str, ...] = ("style1", "style2")
    include_unknown: bool = False
    only_unknown: bool = False
    test_fraction: float = 0.1
    split_seed: int = 42                      # import_midi.py:451 random_state
    high_crop: int = 84                       # exclusive top pitch (C6)
    low_crop: int = 24                        # inclusive bottom pitch (C1)
    num_notes: int = 128
    smallest_note: int = 16                   # 16 => 16th notes; multiple of 4
    max_voices_per_track: int = 1             # MAXIMAL_NUMBER_OF_VOICES_PER_TRACK
    max_velocity: float = 127.0
    max_songs: int = 100_000
    equal_mini_songs: bool = False
    attach_instruments: bool = False
    include_only_monophonic_instruments: bool = False
    max_voices: int = 4
    instrument_attach_method: str = "1hot-category"
    song_completion: bool = False
    velocity_threshold: float = 0.5           # played-note velocity floor
    smaller_training_set_factor: float = 1.0
    save_preprocessed_midi: bool = False

    # ---------------- generation (settings.py:17-32) ----------------
    temperature: float = 1.0
    sample_method: str = "choice"             # 'choice' | 'argmax'
    cutoff_sample_threshold: float = 0.0
    number_of_tries: int = 1
    override_sampled_pitches_based_on_velocity_info: bool = True
    do_not_sample_in_evaluation: bool = True

    # ---------------- VAE architecture (settings.py:104-233) ----------------
    bars_input_length: int = 16               # pre-unroll steps; x max_voices
    bars_output_length: int = 16
    lstm_size: int = 256
    latent_dim: int = 256
    cell_type: str = "GRU"
    num_layers_encoder: int = 2
    num_layers_decoder: int = 2
    bidirectional: bool = False
    use_embedding: bool = False
    embedding_dim: int = 0
    split_lstm_vector: bool = True
    extra_layer: bool = True
    history: bool = True
    include_silent_note: bool = True
    include_composer_feature: bool = False
    include_composer_decoder: bool = True
    composer_weight: float = 0.1
    teacher_force: bool = False
    activation: str = "softmax"
    lstm_activation: str = "tanh"
    # RNN gate (recurrent) activation. 'sigmoid' (default) is the modern
    # exact choice the Pallas kernels implement; 'hard_sigmoid' reproduces
    # the Keras-2.0.8 default the reference trained with
    # (clip(0.2x+0.5,0,1)) -- it forces the plain-scan cell path
    # (models/vae.py:_pallas_enabled) and exists for bit-faithful
    # differential parity against the executing reference
    # (tools/ref_parity_check.py check_model).
    gate_activation: str = "sigmoid"
    lstm_state_activation: str = "tanh"
    activation_before_splitting: str = "tanh"
    vae_loss: str = "categorical_crossentropy"

    # latent / priors
    beta: float = 0.1
    epsilon_std: float = 0.01
    epsilon_factor: float = 0.0
    prior_mean: float = 0.0
    prior_std: float = 1.0

    # meta heads (settings.py:179-231)
    meta_instrument: bool = True
    meta_instrument_activation: str = "softmax"
    meta_instrument_weight: float = 0.1
    meta_velocity: bool = True
    meta_velocity_activation: str = "sigmoid"
    meta_velocity_weight: float = 1.0
    meta_held_notes: bool = False
    meta_held_notes_activation: str = "softmax"
    meta_held_notes_weight: float = 0.1
    meta_next_notes: bool = False
    meta_next_notes_weight: float = 0.1
    meta_next_notes_teacher_force: bool = False
    combine_velocity_and_held_notes: bool = False

    # latent probes
    signature_decoder: bool = False
    signature_vector_length: int = 15
    signature_activation: str = "tanh"
    signature_weight: float = 1.0
    composer_decoder_at_notes_output: bool = False
    composer_decoder_at_notes_weight: float = 1.0
    composer_decoder_at_notes_activation: str = "softmax"
    composer_decoder_at_instrument_output: bool = False
    composer_decoder_at_instrument_weight: float = 1.0
    composer_decoder_at_instrument_activation: str = "softmax"

    # decoder conditioning
    decoder_input_composer: bool = False
    append_signature_vector_to_latent: bool = False

    # ---------------- training (settings.py:108-241) ----------------
    batch_size: int = 256
    learning_rate: float = 2e-4
    optimizer: str = "adam"                   # 'adam' | 'rmsprop' | Keras-2.0.8-exact '{adam,rmsprop}_keras'
    epochs: int = 2000
    test_step: int = 1
    save_step: int = 10
    shuffle_train_set: bool = True
    silent_weight: float = 1.0
    seed: int = 0

    # parallelism (no reference counterpart -- SURVEY.md §2.3)
    mesh_data_axis: int = -1                  # -1 => all devices on 'data'
    mesh_model_axis: int = 1
    compute_dtype: str = "float32"            # 'float32' | 'bfloat16'
    use_pallas: str = "auto"                  # 'auto' | 'on' | 'off'
    # one scan for all T-length decoder heads; measured slightly slower than
    # separate scans when the Pallas fused steps are on, so default off
    merge_decoder_scans: bool = False
    # whole-layer train kernels (fused fwd + fused scan-transpose bwd,
    # ops/fused_train) for the ENCODER layers / the DECODER
    # heads; independently A/B-able against the per-step kernel paths.
    # Interleaved medians on v5e (B=256, f32): encoder kernels 2.53 -> 3.27M
    # note-steps/s/chip; decoder kernels a further ~12% on the notes head
    # (3.99 vs 4.51 ms/grad). ALL heads take the whole-head kernels,
    # including the narrow ones (velocity D=1, held D=2) -- device-side
    # tracing shows the kernel pair beats the 64-iteration device loop the
    # per-step path compiles to. Both f32 and bf16 take these kernels
    # (weight/bias grads are emitted f32 from the kernel and cast back to
    # the compute dtype outside).
    fused_train_encoder: bool = True
    fused_train_decoder: bool = True
    # device-resident epochs: source of the history latent H (previous
    # window's z, vae_training.py:787-798). True (default): reuse the z
    # computed inside each training step -- a per-window cache carried
    # across epochs, so the per-epoch whole-split encoder pass disappears
    # (~10% of device-epoch step time). H is then <= 1 epoch stale, the
    # same staleness class as the epoch-start encode pass (False) and the
    # reference's per-song predict; epoch 0 trains with H = 0 either way.
    history_from_train_z: bool = True
    # store the multi-head decode kernels' hidden-sequence RESIDUALS
    # (h1seq/h2seq/hkseq -- read only by the backward kernel) in bfloat16,
    # halving ~151 MB/step of the largest HBM streams. The forward is
    # BIT-EQUAL either way (the autoregressive carry stays at compute
    # dtype in VMEM scratch); only the backward's gate recomputation
    # reads rounded h values (~1e-3 rel gradient deviation). MEASURED
    # PERF-NEUTRAL on v5e -- device-op tracing shows identical kernel
    # times (576.3 vs 573.9 us/step mh-bwd; the step is serial-latency
    # bound at ~35% of HBM bandwidth, tools/bench_residual_dtype.py +
    # profile_step) -- so the default keeps exact-f32 gradients. The
    # option stays for bandwidth-bound regimes (e.g. wider models).
    decode_residual_bf16: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        # normalize classes: a plain "A,B" string would otherwise be silently
        # iterated into single CHARACTERS by tuple() (13 one-letter classes
        # from --set classes=style1,style2); split on commas instead
        if isinstance(self.classes, str):
            object.__setattr__(
                self, "classes",
                tuple(c for c in (p.strip() for p in self.classes.split(",")) if c),
            )
        else:
            object.__setattr__(self, "classes", tuple(self.classes))
        if not self.classes:
            raise ValueError("classes must not be empty")
        if not 0 <= self.low_crop < self.high_crop <= self.num_notes:
            raise ValueError(
                f"need 0 <= low_crop < high_crop <= num_notes, got "
                f"low_crop={self.low_crop} high_crop={self.high_crop} "
                f"num_notes={self.num_notes}"
            )
        if self.instrument_attach_method not in _INSTRUMENT_DIMS:
            raise ValueError(
                f"unknown instrument_attach_method {self.instrument_attach_method!r}"
            )
        if self.cell_type not in VALID_CELL_TYPES:
            raise ValueError(f"unknown cell_type {self.cell_type!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32/bfloat16, got {self.compute_dtype!r}"
            )
        if self.use_pallas not in ("auto", "on", "off"):
            raise ValueError(f"use_pallas must be auto/on/off, got {self.use_pallas!r}")
        if self.gate_activation not in ("sigmoid", "hard_sigmoid"):
            raise ValueError(
                "gate_activation must be sigmoid/hard_sigmoid, "
                f"got {self.gate_activation!r}"
            )
        if self.vae_loss not in ("categorical_crossentropy", "mse", "mean_squared_error"):
            # the notes-head loss selector (vae_definition.py:338); the
            # reference forwards it verbatim to Keras compile, where only
            # these names make sense for a softmax sequence head
            raise ValueError(
                "vae_loss must be categorical_crossentropy or mse, "
                f"got {self.vae_loss!r}"
            )
        if self.composer_decoder_at_notes_activation != "softmax" or (
            self.composer_decoder_at_instrument_activation != "softmax"
        ):
            # the adversarial probes are trained with categorical
            # crossentropy (vae_definition.py:418,430); a non-softmax
            # activation would silently change the loss semantics, and the
            # reference never ships one (settings.py:197,200)
            raise ValueError(
                "composer_decoder_at_*_activation supports only 'softmax'"
            )
        if self.smallest_note % 4 != 0:
            raise ValueError("smallest_note must be a multiple of 4")
        if self.num_layers_encoder <= 0 or self.num_layers_decoder <= 0:
            raise ValueError("need at least one encoder and decoder layer")
        if self.lstm_size <= 0 or self.latent_dim <= 0:
            raise ValueError("lstm_size and latent_dim must be positive")
        if self.beta <= 0:
            raise ValueError("beta must be > 0 (vae_definition.py:183)")
        if self.use_embedding and not self.include_silent_note:
            raise ValueError("use_embedding requires include_silent_note")
        if self.use_embedding and self.embedding_dim <= 0:
            raise ValueError("use_embedding requires embedding_dim > 0")
        if self.meta_instrument and self.meta_instrument_weight <= 0:
            raise ValueError("meta_instrument_weight must be > 0")
        if self.meta_velocity and self.meta_velocity_weight <= 0:
            raise ValueError("meta_velocity_weight must be > 0")
        if self.meta_held_notes and self.meta_held_notes_weight <= 0:
            raise ValueError("meta_held_notes_weight must be > 0")
        if self.meta_next_notes and self.meta_next_notes_weight <= 0:
            raise ValueError("meta_next_notes_weight must be > 0")
        if self.signature_decoder and self.signature_weight <= 0:
            raise ValueError("signature_weight must be > 0")
        if self.composer_decoder_at_instrument_output and not self.meta_instrument:
            raise ValueError(
                "composer_decoder_at_instrument_output requires meta_instrument"
            )
        if self.signature_decoder:
            offset = self.num_composers if self.include_composer_decoder else 0
            if offset + self.signature_vector_length > self.latent_dim:
                raise ValueError(
                    "latent_dim too small for the signature probe slice "
                    f"({offset}+{self.signature_vector_length} > {self.latent_dim})"
                )
        if self.combine_velocity_and_held_notes and self.meta_held_notes:
            raise ValueError(
                "combine_velocity_and_held_notes forces meta_held_notes off "
                "(settings.py:222-224)"
            )
        if self.include_composer_feature:
            # a retired reference flag: it widens input_dim
            # (settings.py:128-129, :207) but nothing ever appends the
            # composer one-hot to the note vectors in either codebase, so
            # enabling it would only feed zero columns to the encoder.
            raise ValueError(
                "include_composer_feature is a dead reference flag (it widens "
                "input_dim but no code path appends the composer one-hot; "
                "settings.py:128-129). Use include_composer_decoder (the "
                "latent probe) or decoder_input_composer instead."
            )

    # ---------------- derived quantities ----------------
    @property
    def num_classes(self) -> int:
        return len(self.classes) + (1 if self.include_unknown else 0)

    @property
    def new_num_notes(self) -> int:
        return self.high_crop - self.low_crop

    @property
    def silent_dim(self) -> int:
        return 1 if self.include_silent_note else 0

    @property
    def composer_length(self) -> int:
        return self.num_classes if self.include_composer_feature else 0

    @property
    def num_composers(self) -> int:
        # settings.py:202-205
        if (
            self.include_composer_decoder
            or self.composer_decoder_at_notes_output
            or self.composer_decoder_at_instrument_output
        ):
            return self.num_classes
        return 0

    @property
    def instrument_dim(self) -> int:
        """Width of one instrument feature vector."""
        return _INSTRUMENT_DIMS[self.instrument_attach_method]

    @property
    def attached_instrument_dim(self) -> int:
        """Instrument width appended to note vectors (0 unless attach_instruments)."""
        return self.instrument_dim if self.attach_instruments else 0

    @property
    def input_dim(self) -> int:
        # settings.py:207
        return (
            self.new_num_notes
            + self.composer_length
            + self.silent_dim
            + self.attached_instrument_dim
        )

    @property
    def output_dim(self) -> int:
        # settings.py:208
        return self.new_num_notes + self.silent_dim + self.attached_instrument_dim

    @property
    def input_length(self) -> int:
        """Unrolled encoder sequence length (settings.py:140-144)."""
        if self.song_completion:
            return self.bars_input_length
        return self.bars_input_length * self.max_voices

    @property
    def output_length(self) -> int:
        """Unrolled decoder sequence length (settings.py:140)."""
        return self.bars_output_length * self.max_voices

    @property
    def meta_instrument_dim(self) -> int:
        return self.instrument_dim

    @property
    def meta_instrument_length(self) -> int:
        return self.max_voices

    @property
    def meta_velocity_length(self) -> int:
        return self.output_length

    @property
    def meta_held_notes_length(self) -> int:
        return self.output_length

    @property
    def meta_next_notes_output_length(self) -> int:
        return self.output_length

    @property
    def signature_dim(self) -> int:
        return self.signature_vector_length

    @property
    def decoder_additional_input(self) -> bool:
        return self.decoder_input_composer or self.append_signature_vector_to_latent

    @property
    def decoder_additional_input_dim(self) -> int:
        dim = 0
        if self.decoder_input_composer:
            dim += self.num_classes
        if self.append_signature_vector_to_latent:
            dim += self.signature_vector_length
        return dim

    @property
    def has_meta_heads(self) -> bool:
        return (
            self.meta_instrument
            or self.meta_velocity
            or self.meta_held_notes
            or self.meta_next_notes
        )

    # ---------------- serialization ----------------
    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["classes"] = list(self.classes)
        return d

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            # a typo'd field would otherwise be silently dropped and the
            # default used -- warn, but stay loadable across revisions
            print(f"warning: unknown config fields ignored: {unknown}")
        kwargs = {k: v for k, v in d.items() if k in known}
        if "classes" in kwargs and not isinstance(kwargs["classes"], str):
            # leave strings for __post_init__'s comma-split normalization
            # (tuple('a,b') would char-split into 3 one-letter classes)
            kwargs["classes"] = tuple(kwargs["classes"])
        return cls(**kwargs)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)


def parse_overrides(pairs: list[str]) -> dict[str, Any]:
    """Parse repeated ``--set KEY=VALUE`` flags into Config kwargs.

    Values are Python literals where possible (``lstm_size=512``,
    ``compute_dtype='bfloat16'``), bare strings otherwise
    (``compute_dtype=bfloat16`` works too). Keys are validated against
    the Config fields so a typo fails with the field name instead of a
    ``Config.__init__`` traceback. The single shared implementation
    behind every CLI and tool that accepts ``--set``."""
    valid = {f.name for f in dataclasses.fields(Config)}
    out: dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        if k not in valid:
            raise SystemExit(
                f"--set: unknown Config field {k!r} (see MIGRATION.md "
                "for the settings.py -> Config field map)"
            )
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def small_test_config(**overrides: Any) -> Config:
    """A tiny config for unit tests: fast to build and jit."""
    base = dict(
        bars_input_length=4,
        bars_output_length=4,
        lstm_size=16,
        latent_dim=16,
        batch_size=4,
        max_voices=2,
    )
    base.update(overrides)
    return Config(**base)
