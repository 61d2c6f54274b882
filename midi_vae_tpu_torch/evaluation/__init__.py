"""Generation, post-processing of decoder outputs, and the evaluation harness.

The submodules load on first use: a serving bundle's loader imports
``generation`` and ``sampling`` and no model class (``harness`` imports
the VAE's)."""

import importlib

_SUBMODULES = ("generation", "harness", "probes", "sampling", "stats", "sweep")
_NAMES = {"GenerationContext": "generation", "EvalSections": "harness", "Evaluator": "harness"}


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _NAMES:
        return getattr(importlib.import_module(f".{_NAMES[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
