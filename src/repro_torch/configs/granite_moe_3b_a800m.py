"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8) per-expert ff512
vocab 49155, MoE 40 experts top-8.

Many small experts (d_ff 512: the MXInt weight block of 256 divides it),
tied embeddings over an odd vocab, full attention, bf16.
[hf:ibm-granite/granite-3.0-3b-a800m-base config.json]  SMOKE is the
reference's reduced config for tests.
"""
import torch

from repro_torch.models.model_api import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="granite_moe_3b_a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    unit=("attn",),
    rope_theta=10000.0,
    ffn_kind="moe",
    moe=MoEConfig(num_experts=40, top_k=8, capacity_factor=1.25),
    tie_embeddings=True,
    dtype=torch.bfloat16,
    remat="block",
)

SMOKE = ModelConfig(
    name="granite_moe_smoke",
    family="moe",
    n_layers=2,
    d_model=48,
    n_heads=6,
    n_kv_heads=2,
    d_ff=32,
    vocab=512,
    unit=("attn",),
    ffn_kind="moe",
    moe=MoEConfig(num_experts=8, top_k=4),
    tie_embeddings=True,
    dtype=torch.float32,
)

LONG_500K_SUPPORTED = False
SKIP_REASON = ("full-attention MoE decoder: dense 512k KV at batch 1 "
               "fails the sub-quadratic requirement (DESIGN.md §6)")
