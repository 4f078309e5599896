"""PyTorch/CUDA port of the MXInt ViT datapath for NVIDIA Hopper (sm_90a).

The package mirrors ``repro``'s module layout so that each module has an
obvious counterpart there.  It imports ``torch`` and numpy only.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper runs its plain PyTorch version instead of the
CUDA kernel.

It covers the DeiT classifier and the dense decoder LM, served through
``ViTServingEngine`` / ``ClassifyScheduler`` and ``ServingEngine`` /
``BatchScheduler``, in the five execution modes of ``QuantConfig``: the
paper's deployment ``mode="kernel"`` on packed weight planes, the float
baseline "off", quantize-dequantize "fake", the bit-accurate MXInt oracle
"sim" and the dequantize-then-float "packed", with per-layer-group
overrides (``QuantOverride``).

It trains them too: ``optim`` (AdamW, schedules) and ``train``
(``TrainState``, ``make_train_step`` by ``torch.autograd`` with
microbatches, ``CheckpointManager``, ``TrainLoop`` with resume,
heartbeats and straggler flags) over the synthetic streams of
``data.pipeline``, in "off", "fake" (straight-through QDQ) and "sim";
kernel mode and packed planes carry no gradient and are refused.
"""
