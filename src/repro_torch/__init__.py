"""PyTorch/CUDA port of the MXInt ViT datapath for NVIDIA Hopper (sm_90a).

The package mirrors ``repro``'s module layout so that each module has an
obvious counterpart there.  It imports ``torch`` and numpy only.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper runs its plain PyTorch version instead of the
CUDA kernel.

This slice covers the paper's deployment: a DeiT classifier served fully
MXInt-quantized (``QuantConfig(mode="kernel", quantize_nonlinear=True)``)
on packed weight planes through ``ViTServingEngine`` and
``ClassifyScheduler``.
"""
