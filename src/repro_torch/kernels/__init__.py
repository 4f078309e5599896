"""The five MXInt kernels of the DeiT path, their plain PyTorch versions,
and the shape plumbing around them (``ops``).

Each kernel module holds the public op, its plain version and a
``launches`` counter that the op increments once per CUDA launch.  The
CUDA sources live in ``csrc/`` and are built by ``_build`` at first use.
"""
