"""whisper-large-v3 [audio]; port of ``repro/configs/whisper_large_v3.py``:
an encoder-decoder, 32L encoder + 32L decoder, d_model=1280 20H d_ff=5120
vocab=51866.  The conv/mel front end is a stub: the batch carries
precomputed frame embeddings (B, 1500, d).  The decoder's positions end
at 448 (``max_target_positions``)."""

from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    source="arXiv:2212.04356 (Whisper), large-v3 card",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    max_target_positions=448,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    activation="gelu",
    norm_type="layernorm",
    use_rope=False,
    mlp_gated=False,
    causal=True,
)


def smoke_config():
    return smoke_reduce(CONFIG)
