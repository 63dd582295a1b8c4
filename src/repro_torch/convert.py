"""Carry the reference's parameters across to the port.

A stencil has no weights: its parameters are the spec and the plan, plus
the grid it advances.  An LM's are its parameter tree.  Each function
takes what the reference hands out as plain Python / numpy values, so the
port never imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.api import StencilPlan, plan_from_dict
from repro_torch.core.stencils import StencilSpec
from repro_torch.models import transformer


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


def tensors_from_reference(tree, device) -> dict:
    """A nested dict of numpy arrays as the same nest of tensors on
    ``device`` (each owning a copy)."""
    if isinstance(tree, dict):
        return {k: tensors_from_reference(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def lm_params_from_reference(tree: dict, cfg: ArchConfig, device) -> dict:
    """``tree`` is ``jax.tree.map(np.asarray, params)`` of the reference's
    ``transformer.init_params``: layers stacked on a leading ``n_layers``
    axis, as the port keeps them, so the structure carries over as is (the
    hybrid's weight-shared ``shared`` block is one block, not stacked)."""
    transformer.check_family(cfg)
    if ("shared" in tree) != (cfg.family == "hybrid"):
        raise ValueError(f"{cfg.name}: a {cfg.family} tree "
                         f"{'needs' if cfg.family == 'hybrid' else 'has no'} a 'shared' block")
    params = tensors_from_reference(tree, device)
    stacked = {t.shape[0] for t in transformer.tree_leaves(params["layers"])}
    if stacked != {cfg.n_layers}:
        raise ValueError(f"{cfg.name}: layer tensors lead with {sorted(stacked)}, "
                         f"want {cfg.n_layers} stacked layers")
    return params
