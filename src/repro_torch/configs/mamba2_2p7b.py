"""mamba2-2.7b — pure SSM (SSD, state-space duality).

[arXiv:2405.21060]  64L d_model=2560 (attention-free), ssm_state=128,
head_dim=64, expand=2 ⇒ d_inner=5120, 80 SSD heads.  vocab=50280.
O(1) decode state ⇒ runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50_280,
    norm="rmsnorm",
    tie_embeddings=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=128,
)
