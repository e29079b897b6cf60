"""qwen3-4b [dense]; port of ``repro/configs/qwen3_4b.py``:
36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, qk_norm."""

from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    arch_id="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (4B sibling per assignment)",
    num_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    activation="silu",
    mlp_gated=True,
    attention_window=4096,
)


def smoke_config():
    return smoke_reduce(CONFIG)
