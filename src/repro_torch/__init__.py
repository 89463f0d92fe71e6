"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module layout and imports nothing of it (nor of JAX).  The first slice
serves dense decoders end to end: ``serve.api.LLM`` -> ``serve.engine``
(continuous batching over a two-tier paged KV pool whose page placement
``core.GuidanceRuntime`` decides) -> ``models`` -> ``kernels`` (a
hand-written CUDA paged-attention kernel).  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
