"""starcoder2-3b [dense]; port of ``repro/configs/starcoder2_3b.py``:
30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152, GQA + RoPE,
ungated GELU MLP, LayerNorm."""

from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    arch_id="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173 (StarCoder2)",
    num_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=999_999.0,
    activation="gelu",
    norm_type="layernorm",
    mlp_gated=False,
    attention_window=4096,
)


def smoke_config():
    return smoke_reduce(CONFIG)
