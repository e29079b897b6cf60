"""granite-3-8b [dense]; port of ``repro/configs/granite_3_8b.py``:
40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155."""

from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    arch_id="granite-3-8b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base (8B sibling per assignment)",
    num_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10_000.0,
    activation="silu",
    mlp_gated=True,
    attention_window=4096,
)


def smoke_config():
    return smoke_reduce(CONFIG)
