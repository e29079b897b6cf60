"""mistral-large-123b [dense]; port of
``repro/configs/mistral_large_123b.py``: 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768."""

from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    arch_id="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    activation="silu",
    mlp_gated=True,
    attention_window=4096,
)


def smoke_config():
    return smoke_reduce(CONFIG)
