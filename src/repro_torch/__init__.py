"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module layout and imports nothing of it (nor of JAX).  It serves dense
and MoE decoders end to end: ``serve.api.LLM`` -> ``serve.engine``
(continuous batching over a two-tier paged KV pool whose page placement
``core.GuidanceRuntime`` decides) -> ``models`` -> ``kernels``
(hand-written CUDA paged attention and grouped-expert SwiGLU).  It trains
dense decoders: ``launch.train`` -> ``train.Trainer`` (parameter and
moment groups placed between HBM and pinned host by the same runtime,
``core.placement``) -> ``models`` (``Model.loss``) -> the hand-written
CUDA flash attention forward and backward.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
