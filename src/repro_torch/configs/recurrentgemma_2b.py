"""recurrentgemma-2b [hybrid]; port of
``repro/configs/recurrentgemma_2b.py``: 26L d_model=2560 10H (MQA, kv=1,
head_dim 256) d_ff=7680 vocab=256000; RG-LRU recurrent blocks and
local-attention blocks at 2:1 (rec, rec, attn), window 2048, each
followed by a GeGLU MLP."""

from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
    num_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    activation="gelu",
    mlp_gated=True,          # GeGLU
    lru_width=2560,
    conv_width=4,
    local_window=2048,
)


def smoke_config():
    return smoke_reduce(CONFIG)
