"""PyTorch / CUDA port of the stencil vectorization system.

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch and hand-written CUDA kernels for Hopper (sm_90a).
It imports neither ``jax`` nor ``repro``.

    from repro_torch.core.api import StencilPlan, StencilProblem
    p = StencilProblem("2d5p", (8192, 8192))            # device="cuda"
    plan = StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2)
    y = p.run(p.init(0), steps=16, plan=plan)
"""
