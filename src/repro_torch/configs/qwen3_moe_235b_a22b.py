"""qwen3-moe-235b-a22b [moe]; port of
``repro/configs/qwen3_moe_235b_a22b.py``: 94L d_model=4096 64H (GQA kv=4)
d_ff=1536/expert vocab=151936, MoE 128 experts top-8, qk_norm."""

from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B (235B-A22B scaling per assignment)",
    num_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,           # per-expert ffn width
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    activation="silu",
    mlp_gated=True,
    num_experts=128,
    top_k=8,
    moe_dff=1536,
    attention_window=4096,
)


def smoke_config():
    return smoke_reduce(CONFIG)
