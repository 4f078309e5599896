"""llama3-8b [dense]: 32L d4096 32H (GQA kv=8) ff14336 vocab 128256.

RoPE theta 500k, SwiGLU, RMSNorm, untied embeddings, bf16.
[arXiv:2407.21783]  SMOKE is the reference's reduced config for tests.
"""
import torch

from repro_torch.models.model_api import ModelConfig

FULL = ModelConfig(
    name="llama3_8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    unit=("attn",),
    rope_theta=500000.0,
    ffn_kind="swiglu",
    dtype=torch.bfloat16,
    remat="block",
)

SMOKE = ModelConfig(
    name="llama3_8b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    unit=("attn",),
    rope_theta=500000.0,
    ffn_kind="swiglu",
    dtype=torch.float32,
)

LONG_500K_SUPPORTED = False
SKIP_REASON = ("pure full-attention decoder: a dense 512k-KV cache per "
               "layer at batch 1 is quadratic-cost prefill and out of the "
               "sub-quadratic requirement (DESIGN.md §6)")
