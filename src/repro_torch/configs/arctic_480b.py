"""arctic-480b [moe]; port of ``repro/configs/arctic_480b.py``: 35L
d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2
plus a dense residual MLP in parallel (dense-MoE hybrid)."""

from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    arch_id="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    activation="silu",
    mlp_gated=True,
    num_experts=128,
    top_k=2,
    moe_dff=4864,
    dense_residual=True,
    attention_window=4096,
)


def smoke_config():
    return smoke_reduce(CONFIG)
