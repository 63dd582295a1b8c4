"""Carry the reference's parameters across to the port.

A stencil has no weights: its parameters are the spec and the plan, plus
the grid it advances.  Each function takes what the reference hands out
as plain Python / numpy values, so the port never imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import StencilPlan, plan_from_dict
from repro_torch.core.stencils import StencilSpec


def spec_from_reference(d: dict) -> StencilSpec:
    """``d`` is ``dataclasses.asdict(spec)`` of a reference ``StencilSpec``."""
    taps = tuple((tuple(int(o) for o in off), float(c)) for off, c in d["taps"])
    return StencilSpec(str(d["name"]), int(d["ndim"]), int(d["r"]),
                       str(d["kind"]), taps)


def plan_from_reference(d: dict) -> StencilPlan:
    """``d`` is the reference's ``autotune.plan_to_dict(plan)``."""
    return plan_from_dict(d)


def grid_from_reference(a: np.ndarray, device) -> torch.Tensor:
    """A grid from the reference (``np.asarray`` of its array) on
    ``device``; the tensor owns a copy of the data."""
    return torch.tensor(np.asarray(a), device=device)
