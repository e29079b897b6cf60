"""rwkv6-3b [ssm]; port of ``repro/configs/rwkv6_3b.py``: 32L d_model=2560
(attention-free, data-dependent decay time-mix) d_ff=8960 vocab=65536.

The channel-mix K->V projection pair is the quantized MLP pair; the
time-mix recurrence stays in float32 library ops."""

from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    source="arXiv:2404.05892 (RWKV-6 Finch)",
    num_layers=32,
    d_model=2560,
    n_heads=40,              # time-mix heads = d_model / rwkv_head_dim
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    activation="relu2",      # channel-mix uses squared ReLU
    mlp_gated=False,
    rwkv_head_dim=64,
)


def smoke_config():
    return smoke_reduce(CONFIG, n_heads=4, n_kv_heads=4, head_dim=64)
