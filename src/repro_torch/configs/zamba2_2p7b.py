"""zamba2-2.7b — hybrid: Mamba2 backbone + SHARED attention blocks.

[arXiv:2411.15242; hf]  54 Mamba2 layers d_model=2560, ssm_state=64; one
weight-shared attention+MLP block applied every 6 SSM layers (32H kv=32,
d_ff=10240) — the parameter-sharing trick that defines the Zamba family.
Sub-quadratic backbone ⇒ runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32_000,
    act="geglu",
    norm="rmsnorm",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=128,
    shared_attn_every=6,
)
