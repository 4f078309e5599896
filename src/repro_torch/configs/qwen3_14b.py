"""qwen3-14b [dense]: 40L d5120 40H (GQA kv=8) hd128 ff17408 vocab 151936.

qk-norm (per-head RMSNorm on Q and K after the projections, before RoPE),
GQA (5 query heads per KV head), SwiGLU, RMSNorm, RoPE theta 1e6, untied
embeddings, bf16.  [Qwen3 Technical Report, arXiv:2505.09388, Table 1;
hf:Qwen/Qwen3-14B config.json]  SMOKE is the reference's reduced config
for tests.
"""
import torch

from repro_torch.models.model_api import ModelConfig

FULL = ModelConfig(
    name="qwen3_14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    head_dim=128,
    unit=("attn",),
    qk_norm=True,
    rope_theta=1000000.0,
    ffn_kind="swiglu",
    dtype=torch.bfloat16,
    remat="block",
)

SMOKE = ModelConfig(
    name="qwen3_14b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    head_dim=16,
    unit=("attn",),
    qk_norm=True,
    ffn_kind="swiglu",
    dtype=torch.float32,
)

LONG_500K_SUPPORTED = False
SKIP_REASON = ("pure full-attention decoder: dense 512k KV at batch 1 "
               "fails the sub-quadratic requirement (DESIGN.md §6)")
