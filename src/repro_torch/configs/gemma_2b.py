"""gemma-2b — dense, GeGLU, MQA (kv=1), head_dim=256, huge vocab.

[arXiv:2403.08295; hf]  18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000, tied embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256_000,
    act="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
