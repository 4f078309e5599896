"""seamless-m4t-medium [audio]: encoder-decoder, 12 + 12 layers, d1024
16H ff4096 vocab 256206, GELU FFNs, bf16: a multimodal speech/text
translation backbone.

The speech frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings (b, S, 1024) for the encoder.  The text
decoder is cached and drives the decode steps; the training loss is
frames -> tokens.  [arXiv:2308.11596; hf]  SMOKE is the reference's
reduced config for tests.
"""
import torch

from repro_torch.models.model_api import ModelConfig

FULL = ModelConfig(
    name="seamless_m4t_medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    is_encoder_decoder=True,
    n_encoder_layers=12,
    audio_frames=True,
    unit=("attn",),
    ffn_kind="gelu",
    dtype=torch.bfloat16,
    remat="block",
)

SMOKE = ModelConfig(
    name="seamless_smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    is_encoder_decoder=True,
    n_encoder_layers=2,
    audio_frames=True,
    unit=("attn",),
    ffn_kind="gelu",
    dtype=torch.float32,
)

LONG_500K_SUPPORTED = False
SKIP_REASON = ("encoder-decoder with full attention: 512k cross+self dense "
               "KV at batch 1 fails the sub-quadratic requirement "
               "(DESIGN.md §6)")
