"""xlstm-350m [ssm]: 24L d1024 4H ff- vocab 50304, mLSTM + sLSTM blocks.

xLSTM[7:1] layout: unit = 7 mLSTM + 1 sLSTM, repeated 3x.  mLSTM runs in
its chunkwise-parallel form (prefill, scoring) and as an O(1)
matrix-memory update (decode); sLSTM is a sequential scalar-memory loop.
Attention-free; no FFN (the blocks carry their own projections); tied
embeddings, bf16.  [arXiv:2405.04517]  SMOKE is the reference's reduced
config for tests.
"""
import torch

from repro_torch.models.model_api import ModelConfig

FULL = ModelConfig(
    name="xlstm_350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    unit=("mlstm",) * 7 + ("slstm",),
    n_units=3,
    ffn_kind="none",
    tie_embeddings=True,
    dtype=torch.bfloat16,
    remat="block",
)

SMOKE = ModelConfig(
    name="xlstm_smoke",
    family="ssm",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=512,
    unit=("mlstm",) * 3 + ("slstm",),
    n_units=2,
    ffn_kind="none",
    tie_embeddings=True,
    dtype=torch.float32,
)

LONG_500K_SUPPORTED = True   # O(1) recurrent state for both block kinds
