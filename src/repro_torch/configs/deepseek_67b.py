"""deepseek-67b [dense]: 95L d8192 64H (GQA kv=8) ff22016 vocab 102400.

Llama-style: RoPE theta 1e4, SwiGLU, RMSNorm, untied embeddings, bf16;
the deepest model of the repo.  [arXiv:2401.02954; hf:
deepseek-ai/deepseek-llm-67b-base config.json]  SMOKE is the reference's
reduced config for tests (an odd depth, one KV head).
"""
import torch

from repro_torch.models.model_api import ModelConfig

FULL = ModelConfig(
    name="deepseek_67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    unit=("attn",),
    n_units=95,
    rope_theta=10000.0,
    ffn_kind="swiglu",
    dtype=torch.bfloat16,
    remat="block",
)

SMOKE = ModelConfig(
    name="deepseek_67b_smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=1,
    d_ff=160,
    vocab=512,
    unit=("attn",),
    n_units=3,
    ffn_kind="swiglu",
    dtype=torch.float32,
)

LONG_500K_SUPPORTED = False
SKIP_REASON = ("pure full-attention decoder (95L): dense 512k KV at batch 1 "
               "fails the sub-quadratic requirement (DESIGN.md §6)")
