"""phi4-mini-3.8b [dense]: 32L d3072 24H (GQA kv=8) ff8192 vocab 200064.

RoPE + SwiGLU + GQA (3 query heads per KV head), RMSNorm, tied
embeddings (one table for the row gather and the unembedding), bf16.
Real Phi-4-mini rotates part of each head (partial rotary embedding); the
reference applies full RoPE, and so does the port.  [Phi-4-Mini Technical
Report, arXiv:2503.01743; hf:microsoft/Phi-4-mini-instruct config.json]
SMOKE is the reference's reduced config for tests.
"""
import torch

from repro_torch.models.model_api import ModelConfig

FULL = ModelConfig(
    name="phi4_mini_3_8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    unit=("attn",),
    rope_theta=10000.0,
    ffn_kind="swiglu",
    tie_embeddings=True,
    dtype=torch.bfloat16,
    remat="block",
)

SMOKE = ModelConfig(
    name="phi4_mini_smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=6,
    n_kv_heads=2,
    d_ff=96,
    vocab=512,
    unit=("attn",),
    ffn_kind="swiglu",
    tie_embeddings=True,
    dtype=torch.float32,
)

LONG_500K_SUPPORTED = False
SKIP_REASON = ("pure full-attention decoder: dense 512k KV at batch 1 "
               "fails the sub-quadratic requirement (DESIGN.md §6)")
