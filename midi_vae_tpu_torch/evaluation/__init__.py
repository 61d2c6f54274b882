"""Generation, post-processing of decoder outputs, and the evaluation harness."""

from . import generation, harness, probes, sampling, stats, sweep
from .generation import GenerationContext
from .harness import EvalSections, Evaluator
