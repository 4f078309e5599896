"""Model zoo of the port: the ViT/DeiT family so far."""
