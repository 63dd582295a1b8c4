"""nemotron-4-15b — dense, squared-ReLU MLP, GQA.

[arXiv:2402.16819]  32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, LayerNorm, squared-ReLU (no gating)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=256_000,
    act="sq_relu",
    norm="layernorm",
)
