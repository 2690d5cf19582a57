"""GPT model hyperparameter config.

Field names match the ``Model`` block of the repo's GPT YAML configs and
``paddlefleetx_tpu/models/gpt/config.py``, so one YAML file drives both
packages.  The port keeps the architecture fields; the training-only
knobs of the JAX config (recompute, fused LayerNorm, flash attention
schedules, sequence parallelism) are not read by the serving path and
are ignored by :meth:`GPTConfig.from_config`, as the JAX serving forward
ignores them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_attention_heads: int = 16
    ffn_hidden_size: Optional[int] = None  # defaults to 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    # compute dtype for activations and stored weights (LayerNorm params
    # stay float32)
    dtype: str = "bfloat16"
    # MoE is not ported yet: > 1 raises
    num_experts: int = 0

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            object.__setattr__(self, "ffn_hidden_size", 4 * self.hidden_size)
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("num_attention_heads must divide hidden_size")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {self.dtype!r}; valid: float32, bfloat16")
        if self.num_experts > 1:
            raise NotImplementedError(
                "MoE GPT is not ported yet (a later slice of the port)"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_config(model_cfg) -> "GPTConfig":
        """Build from a YAML ``Model`` section (unknown keys ignored)."""
        fields = {f.name for f in dataclasses.fields(GPTConfig)}
        kwargs = {k: v for k, v in dict(model_cfg).items() if k in fields}
        return GPTConfig(**kwargs)


# Reference model sizes (projects/gpt/docs, configs/gpt/*.yaml)
PRESETS = {
    "gpt-345M": dict(hidden_size=1024, num_layers=24, num_attention_heads=16),
    "gpt-1.3B": dict(hidden_size=2048, num_layers=24, num_attention_heads=16),
    "gpt-6.7B": dict(hidden_size=4096, num_layers=32, num_attention_heads=32),
    "gpt-13B": dict(hidden_size=5120, num_layers=40, num_attention_heads=40),
    "gpt-175B": dict(hidden_size=12288, num_layers=96, num_attention_heads=96),
}
