"""Model and quantization configs; port of ``repro/configs/base.py``.

The dataclasses keep every field of the reference so a port config and a
JAX config of the same architecture compare field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "mlp"            # "none" | "mlp" (MLP/FFN pairs quantized)
    scheme: str = "tp-aware"     # "naive-actorder" | "exllama" | "tp-aware"
    group_size: int = 128
    act_order: bool = True
    attn_tp_aware: bool = False
    # Row-TP shards of the down projection must be quant-group aligned:
    # the group size is chosen to tile d_ff / tp_groups.
    tp_groups: int = 16
    # Runtime half of the plan, read by ``ExecutionPolicy.from_config``:
    # "auto" picks the CUDA kernel for ordered layouts on the card.
    backend: str = "auto"
    compute_dtype: str = "float32"
    collective: str = "psum"
    kv_page_size: Optional[int] = None
    kv_bits: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str
    source: str

    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_type: str = "rms"       # "rms" | "layernorm"
    use_rope: bool = True
    norm_eps: float = 1e-5
    attention_window: Optional[int] = None
    causal: bool = True

    activation: str = "silu"
    mlp_gated: bool = True

    num_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25

    lru_width: Optional[int] = None
    conv_width: int = 4
    local_window: int = 2048

    rwkv_head_dim: int = 64

    encoder_layers: int = 0
    encoder_seq: int = 1500
    max_target_positions: int = 0

    cross_attn_every: int = 0
    vision_tokens: int = 1601

    quant: QuantConfig = QuantConfig()
    dtype: str = "bfloat16"

    # Deployment head padding to the model-axis size (see ``head_grid``).
    attn_tp_pad: Optional[int] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def padded_vocab(self) -> int:
        """Vocab rounded up to ``attn_tp_pad``; padded logit columns are
        masked to -1e30 in ``lm_head``."""
        if not self.attn_tp_pad or self.vocab_size % self.attn_tp_pad == 0:
            return self.vocab_size
        tp = self.attn_tp_pad
        return (self.vocab_size + tp - 1) // tp * tp

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_quant(self, **kw) -> "ModelConfig":
        return dataclasses.replace(
            self, quant=dataclasses.replace(self.quant, **kw))

    def _counts(self) -> tuple[int, int, int]:
        """Per-layer attention and MLP params, and the experts' per expert
        (with the router's ``d * E`` apart)."""
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.family == "ssm":
            attn = d * d * 4  # r,k,v,o time-mix projections
        mlp = d * self.d_ff * (3 if self.mlp_gated else 2)
        if self.num_experts and not self.dense_residual:
            mlp = 0
        expert = d * self.moe_dff * (3 if self.mlp_gated else 2)
        return attn, mlp, expert

    def param_count(self) -> int:
        """Approximate total parameter count N (for MODEL_FLOPS = 6ND), as
        the reference counts it."""
        attn, mlp, expert = self._counts()
        moe = (self.num_experts * expert + self.d_model * self.num_experts
               if self.num_experts else 0)
        emb = self.vocab_size * self.d_model * 2
        enc = self.encoder_layers * (attn + mlp)
        return self.num_layers * (attn + mlp + moe) + emb + enc

    def active_param_count(self) -> int:
        """Active params per token (MoE: the ``top_k`` experts only)."""
        attn, mlp, expert = self._counts()
        moe = (self.top_k * expert + self.d_model * self.num_experts
               if self.num_experts else 0)
        emb = self.vocab_size * self.d_model  # the lm head's product
        return self.num_layers * (attn + mlp + moe) + emb


def smoke_reduce(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    from repro_torch.core.quantization import choose_group_size

    kw = dict(
        num_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, top_k=min(cfg.top_k, 2), moe_dff=128)
    if cfg.lru_width:
        kw.update(lru_width=256, local_window=64)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=32, max_target_positions=128)
    if cfg.cross_attn_every:
        kw.update(cross_attn_every=2, vision_tokens=16)
    if cfg.attention_window:
        kw.update(attention_window=64)
    kw.update(overrides)
    new = cfg.with_(**kw)
    gs = choose_group_size(min(new.d_ff if not new.num_experts else new.moe_dff,
                               new.d_model, 128), 64)
    return new.with_quant(group_size=gs)
