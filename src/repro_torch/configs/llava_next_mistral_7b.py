"""llava-next-mistral-7b [vlm]: Mistral-7B backbone, 32L d4096 32H (GQA
kv=8) ff14336 vocab 32000, RoPE theta 1e6, SwiGLU, bf16.

The modality frontend is a stub, as in the reference: the batch carries
precomputed CLIP-style patch embeddings (anyres tiling of a 672x672
image: 5 tiles x 576 patches = 2880 vision tokens of dim 1024), which
the ``vision_proj`` linear maps into the first 2880 token positions.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]  SMOKE is the reference's reduced
config for tests.
"""
import torch

from repro_torch.models.model_api import ModelConfig

VISION_TOKENS = 2880   # 5 anyres tiles x (24 x 24) patches

FULL = ModelConfig(
    name="llava_next_mistral_7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    unit=("attn",),
    rope_theta=1000000.0,
    ffn_kind="swiglu",
    vision_tokens=VISION_TOKENS,
    vision_dim=1024,
    dtype=torch.bfloat16,
    remat="block",
)

SMOKE = ModelConfig(
    name="llava_smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    unit=("attn",),
    ffn_kind="swiglu",
    vision_tokens=8,
    vision_dim=32,
    dtype=torch.float32,
)

LONG_500K_SUPPORTED = False
SKIP_REASON = ("full-attention VLM backbone: dense 512k KV at batch 1 "
               "fails the sub-quadratic requirement (DESIGN.md §6)")
