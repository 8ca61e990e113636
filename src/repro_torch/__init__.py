"""repro_torch — the PyTorch/CUDA port of the FlashMLA-ETAP reproduction.

A second package beside ``repro`` (the JAX reference).  It mirrors the
reference's module layout so each module's counterpart is easy to find, and
it imports neither ``jax`` nor anything of ``repro``.  Entry points default
to ``device="cuda"``; the CPU tests pass ``device="cpu"``.  A tensor's device
picks the path: CUDA tensors run the hand-written Hopper kernels under
``kernels/csrc``, CPU tensors run each kernel's plain PyTorch version.
"""
