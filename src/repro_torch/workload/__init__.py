"""Experiment-grade workload generation for the solve service.

``repro_torch.workload.generator`` turns a declarative sweep spec — the
vnep-approx experiment shape: random G(n,p) grids × repetitions × a
named-instance mix × knob distributions — into open-loop arrival traces
that ``benchmarks/serve_load.py`` replays against the serving stack,
with duplicate/isomorphic-duplicate dials to exercise the result cache
(DESIGN.md §16).
"""
from .generator import (Arrival, SpecError, SweepSpec, generate,
                        quick_spec, read_trace, write_trace)

__all__ = ["Arrival", "SpecError", "SweepSpec", "generate", "quick_spec",
           "read_trace", "write_trace"]
