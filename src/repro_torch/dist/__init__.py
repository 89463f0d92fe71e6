"""Distribution substrate of the port (``repro/dist``): the logical-axis
sharding rules and the ambient mesh (``sharding``), the int8 gradient round
trip with error feedback (``compress``), and the collectives (the MoE
layer's ragged all-to-all, the ring matmuls, the overlapped MLP and the
collective counter; ``collectives``).  It exports what the JAX package's
``repro.dist`` exports apart from ``constrain``: the port has no compiler
to partition its dense layers by annotations (ROADMAP.md A20)."""

from .collectives import (allgather_matmul_reference, count_collectives,
                          make_overlapped_mlp, matmul_reducescatter_reference,
                          ragged_all_to_all, ragged_all_to_all_reference,
                          ring_allgather_matmul, ring_matmul_reducescatter)
from .compress import (BLOCK, ErrorFeedback, QuantizedTensor,
                       compress_with_feedback, dequantize, quantize,
                       quantize_roundtrip)
from .sharding import (DECODE_RULES, DEFAULT_RULES, FSDP_RULES,
                       MOMENTS_RULES, SP_DECODE_RULES, AbstractMesh,
                       PartitionSpec, abstract_mesh, active_mesh,
                       active_rules, batch_data_axes, batch_pspec,
                       logical_to_pspec, to_placements, use_mesh, use_rules)

__all__ = ["BLOCK", "DECODE_RULES", "DEFAULT_RULES", "ErrorFeedback",
           "FSDP_RULES", "MOMENTS_RULES", "SP_DECODE_RULES", "AbstractMesh",
           "PartitionSpec", "QuantizedTensor", "abstract_mesh",
           "active_mesh", "active_rules", "allgather_matmul_reference",
           "batch_data_axes", "batch_pspec", "compress_with_feedback",
           "count_collectives", "dequantize", "logical_to_pspec",
           "make_overlapped_mlp", "matmul_reducescatter_reference",
           "quantize", "quantize_roundtrip", "ragged_all_to_all",
           "ragged_all_to_all_reference", "ring_allgather_matmul",
           "ring_matmul_reducescatter", "to_placements", "use_mesh",
           "use_rules"]
