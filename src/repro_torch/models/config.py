"""ModelConfig — the single description every subsystem consumes.

The partner of ``repro/models/config.py``, copied field for field so the
architecture configs copy over verbatim; ``param_dtype_`` and
``compute_dtype_`` return torch dtypes.  One instance per architecture
lives in ``repro_torch/configs/<id>.py``; ``reduced()`` derives the
CPU-test variant (same family, tiny dims).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    """One architecture: widths, attention flavour, numerics."""

    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None      # None → d_model // n_heads

    # attention flavour
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0            # stablelm: partial rotary
    qk_norm: bool = False            # qwen3 / stablelm
    attn_softcap: float | None = None    # gemma2
    final_softcap: float | None = None   # gemma2
    sliding_window: int | None = None
    window_pattern: str = "none"     # none | all | alternate (gemma2)
    post_block_norm: bool = False    # gemma2 sandwich norms

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    # SSM / hybrid
    layer_kind: str = "attn"         # attn | mamba1 | mamba2 (homogeneous stack)
    ssm_state: int = 0
    d_inner: int = 0                 # 0 → 2 * d_model
    conv_kernel: int = 4
    mamba_head_dim: int = 64         # mamba2 heads = d_inner / mamba_head_dim
    shared_attn_every: int = 0       # zamba2: shared attn block period (0 = off)

    # io / numerics
    input_mode: str = "tokens"       # tokens | embeddings (vlm/audio stub)
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    norm_offset: float = 0.0         # gemma: weights applied as (1 + w)
    activation: str = "silu"
    embed_scale: bool = False        # gemma: × sqrt(d_model)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True

    # accounting knobs of the JAX package (remat above too): its dry-run
    # unrolls the layer scan and widens attention chunks, and
    # ``matmul_reduce`` sets the tensor-parallel partial-sum dtype.  The
    # port runs eagerly on one device and reads none of them; they stay so
    # that configs copy over verbatim.
    unroll_layers: bool = False
    attn_chunk: int = 1024
    matmul_reduce: str = "float32"

    notes: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner_(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def param_dtype_(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def compute_dtype_(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_free(self) -> bool:
        return self.layer_kind in ("mamba1", "mamba2") and \
            self.shared_attn_every == 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape: SSM/hybrid, or SWA on every
        attention layer (bounded KV window)."""
        return self.layer_kind != "attn" or self.window_pattern in (
            "all", "alternate") and (self.sliding_window or 0) > 0

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, h = self.d_model, self.head_dim_
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.layer_kind == "attn":
            attn = d * h * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * h * d
            if self.is_moe:
                ff = self.n_experts * 3 * d * self.expert_d_ff \
                    + self.n_shared_experts * 3 * d * self.shared_expert_d_ff \
                    + d * self.n_experts  # router
                if self.n_shared_experts:
                    ff += d  # shared-expert gate
            else:
                ff = 3 * d * self.d_ff
            per_layer = attn + ff + 2 * d
        elif self.layer_kind == "mamba1":
            di, n = self.d_inner_, self.ssm_state
            per_layer = (d * 2 * di            # in_proj
                         + di * self.conv_kernel
                         + di * (2 * n + di // 16)  # x_proj(Δ,B,C) low-rank dt
                         + di // 16 * di       # dt_proj
                         + di * n + di         # A, D
                         + di * d + d)         # out_proj + norm
        elif self.layer_kind == "mamba2":
            di, n = self.d_inner_, self.ssm_state
            nh = di // self.mamba_head_dim
            per_layer = (d * (2 * di + 2 * n + nh)  # in_proj (x,z,B,C,dt)
                         + (di + 2 * n) * self.conv_kernel
                         + nh * 2               # A, D per head
                         + di * d + d + di)     # out_proj, norms
        total = emb + self.n_layers * per_layer
        if self.shared_attn_every > 0:
            h_ = self.head_dim_
            total += (d * h_ * (self.n_heads + 2 * self.n_kv_heads)
                      + self.n_heads * h_ * d + 3 * d * self.d_ff + 2 * d)
        return total

    def n_active_params(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6·N_active·D)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        routed_all = self.n_experts * 3 * d * self.expert_d_ff
        routed_active = self.top_k * 3 * d * self.expert_d_ff
        return self.n_params() - self.n_layers * (routed_all - routed_active)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape: which step it lowers and its dims."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """The runnable cells for an arch: long_500k only for sub-quadratic
    architectures (DESIGN.md §5); everything else runs all four."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out
