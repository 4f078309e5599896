"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) ff7680 vocab 256000.

RG-LRU + local attention at 1:2 attention:recurrent ratio: the repeating
unit is (rec, rec, attn) x 8 with a (rec, rec) tail = 26 layers.  Local
attention window 2048 (head dim 256); GeGLU MLPs; tied embeddings, bf16.
[arXiv:2402.19427; hf]  SMOKE is the reference's reduced config for
tests.
"""
import torch

from repro_torch.models.model_api import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma_2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    unit=("rec", "rec", "attn"),
    n_units=8,
    tail=("rec", "rec"),
    local_attn_window=2048,
    lru_width=2560,
    conv_width=4,
    rope_theta=10000.0,
    ffn_kind="geglu",
    tie_embeddings=True,
    dtype=torch.bfloat16,
    remat="block",
)

SMOKE = ModelConfig(
    name="recurrentgemma_smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=2,
    n_kv_heads=1,
    d_ff=128,
    vocab=512,
    unit=("rec", "rec", "attn"),
    n_units=1,
    tail=("rec", "rec"),
    local_attn_window=16,
    lru_width=64,
    ffn_kind="geglu",
    tie_embeddings=True,
    dtype=torch.float32,
)

LONG_500K_SUPPORTED = True   # RG-LRU state + windowed local attention
