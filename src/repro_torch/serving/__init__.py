"""Serving: packed-MXInt weights, the ViT engine and its scheduler."""
