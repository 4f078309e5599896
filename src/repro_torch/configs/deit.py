"""DeiT Tiny / Small / Base, the paper's evaluation models (§IV).

DeiT-Tiny:  12L d192  3H  ff768
DeiT-Small: 12L d384  6H  ff1536
DeiT-Base:  12L d768 12H  ff3072
All: 224x224 images, patch 16 (197 tokens), 1000 classes, GELU MLP,
pre-LayerNorm.  [Touvron et al.; timm]
"""
import torch

from repro_torch.models.model_api import ModelConfig


def _deit(name, d, heads, ff):
    return ModelConfig(name=name, family="vit", n_layers=12, d_model=d,
                       n_heads=heads, n_kv_heads=heads, d_ff=ff,
                       image_size=224, patch_size=16, n_classes=1000,
                       dtype=torch.float32, norm_eps=1e-6)


DEIT_TINY = _deit("deit_tiny", 192, 3, 768)
DEIT_SMALL = _deit("deit_small", 384, 6, 1536)
DEIT_BASE = _deit("deit_base", 768, 12, 3072)

# a reduced DeiT for tests
DEIT_MICRO = ModelConfig(name="deit_micro", family="vit", n_layers=4,
                         d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                         image_size=32, patch_size=8, n_classes=10,
                         dtype=torch.float32)

BY_NAME = {
    "deit_tiny": DEIT_TINY,
    "deit_small": DEIT_SMALL,
    "deit_base": DEIT_BASE,
    "deit_micro": DEIT_MICRO,
}
