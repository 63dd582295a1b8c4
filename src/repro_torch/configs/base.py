"""Architecture and shape configuration: the port's copy of the
reference's ``configs/base.py``.

One ``ArchConfig`` per architecture lives in ``configs/<id>.py``; the four
LM shape points are global ``ShapeConfig``s.  ``smoke()`` derives a reduced
same-family config for CPU tests.  Only the architectures whose family the
port runs (ssm, dense, hybrid) have a file here; ``get_arch`` on any other
assigned id (the MoE, audio and VLM configs) raises ``NotImplementedError``
naming ROADMAP A11.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"          # swiglu | geglu | sq_relu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window attention (tokens)
    mrope_sections: Optional[tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0            # per-expert hidden dim
    n_shared_experts: int = 0
    moe_group_size: int = 512    # dispatch group (GShard-style capacity)
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # --- hybrid (Zamba2): one *shared* attn+MLP block every N ssm layers ---
    shared_attn_every: int = 0
    # --- modality frontend (stub): token | frames | patches ---
    frontend: str = "token"

    # ----- derived -----
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attends(self) -> bool:
        return self.family != "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM state / sliding
        window ⇒ O(1)/O(W) decode state)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm"):
            attn = d * self.n_heads * self.head_dim \
                + 2 * d * self.n_kv_heads * self.head_dim \
                + self.n_heads * self.head_dim * d
            if self.family == "moe":
                n_mats = 3  # gated
                ff = self.n_experts * n_mats * d * self.moe_d_ff \
                    + self.n_shared_experts * n_mats * d * self.moe_d_ff \
                    + d * self.n_experts  # router
            else:
                n_mats = 3 if self.act in ("swiglu", "geglu") else 2
                ff = n_mats * d * f
            per_layer = attn + ff + 2 * d
        elif self.family == "ssm":
            di, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, \
                self.ssm_nheads
            per_layer = d * (2 * di + 2 * g * n + h) + di * d \
                + self.ssm_conv * (di + 2 * g * n) + 2 * h + di + d
        elif self.family == "hybrid":
            di, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, \
                self.ssm_nheads
            per_layer = d * (2 * di + 2 * g * n + h) + di * d \
                + self.ssm_conv * (di + 2 * g * n) + 2 * h + di + d
            # plus ONE shared attn+mlp block (counted once, outside layers)
        total = emb + self.n_layers * per_layer + d
        if self.family == "hybrid":
            attn = self.d_model * self.n_heads * self.head_dim * 2 \
                + 2 * self.d_model * self.n_kv_heads * self.head_dim
            mlp = 3 * self.d_model * self.d_ff
            total += attn + mlp + 2 * self.d_model
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k + shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * (
            self.n_experts * 3 * d * self.moe_d_ff)
        active = self.n_layers * (self.top_k + self.n_shared_experts) \
            * 3 * d * self.moe_d_ff
        return dense + active

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        kv_ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        heads = 4
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if not self.shared_attn_every
                         else 2 * self.shared_attn_every),
            d_model=64,
            n_heads=heads,
            n_kv_heads=max(1, heads // kv_ratio),
            head_dim=16,
            d_ff=128,
            vocab=256,
            window=min(self.window, 32) if self.window else None,
            n_experts=min(self.n_experts, 4) or 0,
            top_k=min(self.top_k, 2) or 0,
            moe_d_ff=32 if self.n_experts else 0,
            moe_group_size=16,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=8,
            mrope_sections=(2, 3, 3) if self.mrope_sections else None,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "moonshot_v1_16b_a3b", "mixtral_8x22b", "zamba2_2p7b", "mamba2_2p7b",
    "gemma_2b", "nemotron_4_15b", "deepseek_coder_33b", "starcoder2_7b",
    "musicgen_large", "qwen2_vl_2b",
]


def get_arch(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "p")
    if key not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; have {ARCH_IDS}")
    try:
        mod = importlib.import_module(f"repro_torch.configs.{key}")
    except ModuleNotFoundError:
        raise NotImplementedError(
            f"{name!r} is not ported yet: the port runs the ssm, dense and hybrid "
            "families; MoE and the audio and VLM frontends are ROADMAP A11") from None
    return mod.CONFIG
