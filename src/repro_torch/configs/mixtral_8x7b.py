"""mixtral-8x7b [moe]: 32L d4096 32H (GQA kv=8) ff14336 vocab 32000,
MoE 8 experts top-2, sliding-window attention (W=4096).

RoPE theta 1e6, RMSNorm, untied embeddings, bf16; the window makes the
KV cache a ring of at most 4096 slots.  [arXiv:2401.04088; hf:
mistralai/Mixtral-8x7B-v0.1 config.json]  SMOKE is the reference's
reduced config for tests.
"""
import torch

from repro_torch.models.model_api import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="mixtral_8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    unit=("attn",),
    window=4096,
    rope_theta=1000000.0,
    ffn_kind="moe",
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    dtype=torch.bfloat16,
    remat="block",
)

SMOKE = ModelConfig(
    name="mixtral_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=512,
    unit=("attn",),
    window=16,
    ffn_kind="moe",
    moe=MoEConfig(num_experts=4, top_k=2),
    dtype=torch.float32,
)

LONG_500K_SUPPORTED = True   # SWA ring cache: O(window) per layer
