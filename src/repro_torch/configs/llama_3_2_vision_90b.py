"""llama-3.2-vision-90b [vlm]; port of
``repro/configs/llama_3_2_vision_90b.py``: 100L d_model=8192 64H (GQA
kv=8) d_ff=28672 vocab=128256, a gated cross-attention image layer every
5th layer (80 self + 20 cross).  The ViT and its projector are a stub:
the batch carries precomputed patch embeddings (B, 1601, d)."""

from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B scaling per assignment)",
    num_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    activation="silu",
    mlp_gated=True,
    cross_attn_every=5,
    vision_tokens=1601,
    attention_window=4096,   # sliding-window decode variant for long_500k
)


def smoke_config():
    return smoke_reduce(CONFIG)
