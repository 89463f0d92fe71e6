"""Kernels of the port: hand-written CUDA for the card (``csrc/``, built by
``_build``), their plain PyTorch versions (``ref``), and ``ops``, which
sends a CPU tensor to the plain version and a CUDA tensor to the kernel."""
