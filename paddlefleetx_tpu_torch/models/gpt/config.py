"""GPT model hyperparameter config.

Field names match the ``Model`` block of the repo's GPT YAML configs and
``paddlefleetx_tpu/models/gpt/config.py:16-106``, so one YAML file drives
both packages.  The training knobs (recompute, fused LayerNorm, chunked
CE, attention implementation, flash blocks and backward schedule, scan
unroll, sequence parallelism) carry the JAX validation, copied.  The
serving path reads none of them, so any valid YAML serves; the features
the port does not have yet are refused on the training path
(``models/gpt/model.loss_fn``, ``core/engine.Engine``), never here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

RECOMPUTE_NAMES = ("qkv", "attn_out", "attn_lse", "mlp_hidden")


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
    # recompute: "full" | "selective" | "full_attn" | "core_attn"
    # (models/gpt/model._layer_remat maps each to torch.utils.checkpoint)
    use_recompute: bool = False
    recompute_granularity: str = "full"
    # comma-separated names kept live under "selective" (qkv | attn_out |
    # attn_lse | mlp_hidden); empty = the default qkv, attn_out, attn_lse
    recompute_names: str = ""
    # training LayerNorms through the fused kernels K1/K2 (ops/fused_layernorm);
    # serving keeps the plain LayerNorm
    use_fused_ln: bool = False
    # chunked softmax-CE: not ported yet, refused in training
    use_chunked_ce: bool = False
    ce_chunk_size: int = 4096
    # attention: "xla" (plain PyTorch) | "flash" (ops/flash_attention.py);
    # "ring" is refused in training (no context parallelism yet)
    attn_impl: str = "xla"
    # flash tile size (0 = auto: PFX_FLASH_BLOCK env, else the ladder of
    # ops/flash_attention._block_sizes)
    flash_block: int = 0
    # flash backward schedule: "" = auto (PFX_FLASH_BWD, else "split");
    # "fused" = one kernel for dq, dk and dv
    flash_bwd: str = ""
    # validated as in the JAX config (>= 1, divides num_layers); eager
    # PyTorch runs the layers as a Python loop, so it has no effect here
    scan_unroll: int = 1
    # Megatron sequence parallelism: refused in training (one device)
    sequence_parallel: bool = False
    # compute dtype for activations (serving stores weights in it; the
    # training model keeps float32 masters and casts per use).  LayerNorm
    # params stay float32 either way.
    dtype: str = "bfloat16"
    # MoE is not ported yet: > 1 raises
    num_experts: int = 0

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            object.__setattr__(self, "ffn_hidden_size", 4 * self.hidden_size)
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("num_attention_heads must divide hidden_size")
        if self.recompute_granularity not in ("full", "selective", "full_attn", "core_attn"):
            raise ValueError(f"bad recompute_granularity {self.recompute_granularity}")
        raw = self.recompute_names
        parts = raw if isinstance(raw, (list, tuple)) else str(raw).split(",")
        names = tuple(str(n).strip() for n in parts if str(n).strip())
        bad = set(names) - set(RECOMPUTE_NAMES)
        if bad:
            raise ValueError(
                f"bad recompute_names {sorted(bad)}; "
                "valid: qkv, attn_out, attn_lse, mlp_hidden"
            )
        if names and self.recompute_granularity != "selective":
            raise ValueError(
                "recompute_names only applies to recompute_granularity='selective'"
            )
        if self.scan_unroll < 1 or self.num_layers % self.scan_unroll:
            raise ValueError(
                f"scan_unroll {self.scan_unroll} must be >=1 and divide "
                f"num_layers {self.num_layers}"
            )
        if self.flash_bwd not in ("", "split", "fused"):
            raise ValueError(
                f"flash_bwd {self.flash_bwd!r}; valid: '' (auto), split, fused"
            )
        object.__setattr__(self, "recompute_names", ",".join(names))
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {self.dtype!r}; valid: float32, bfloat16")
        if self.num_experts > 1:
            raise NotImplementedError(
                "MoE GPT is not ported yet (a later slice of the port)"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def recompute_name_tuple(self) -> Tuple[str, ...]:
        """Normalized selective-recompute save-set; empty = the default."""
        return tuple(n for n in self.recompute_names.split(",") if n)

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
