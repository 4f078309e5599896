"""Tensor and data parallelism of the packed planes on
``torch.distributed``."""
