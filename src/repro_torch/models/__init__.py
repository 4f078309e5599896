"""Model zoo of the port: the ViT/DeiT family, the decoder LMs (dense,
mixture-of-experts, recurrent, VLM) and the encoder-decoder."""
from repro_torch.models.model_api import ModelConfig
from repro_torch.models.transformer import DecoderLM, EncDecLM
from repro_torch.models.vit import ViT


def build_model(cfg: ModelConfig):
    """The model class a config names: ``ViT`` for the vit family,
    ``EncDecLM`` for an encoder-decoder, else ``DecoderLM``."""
    if cfg.family == "vit":
        return ViT(cfg)
    if cfg.is_encoder_decoder:
        return EncDecLM(cfg)
    return DecoderLM(cfg)
