"""Distribution substrate of the port (``repro/dist``): the logical-axis
sharding rules, the ambient mesh and ``constrain`` (``sharding``), the int8
gradient round trip with error feedback (``compress``), and the
collectives (the tensor-parallel regions, the data-parallel reduction, the
MoE layer's ragged all-to-all, the ring matmuls, the overlapped MLP and
the collective counter; ``collectives``).  It exports what the JAX
package's ``repro.dist`` exports.  The port's ``constrain`` checks a local
block's layout instead of asking a compiler to partition: the model
computes on local blocks and issues its collectives itself."""

from .collectives import (allgather_matmul_reference, copy_to_group,
                          count_collectives, make_overlapped_mlp,
                          matmul_reducescatter_reference, ragged_all_to_all,
                          ragged_all_to_all_reference, reduce_from_group,
                          ring_allgather_matmul, ring_matmul_reducescatter,
                          sum_over_data)
from .compress import (BLOCK, ErrorFeedback, QuantizedTensor,
                       compress_with_feedback, dequantize, quantize,
                       quantize_roundtrip)
from .sharding import (DECODE_RULES, DEFAULT_RULES, FSDP_RULES,
                       MOMENTS_RULES, SP_DECODE_RULES, AbstractMesh,
                       PartitionSpec, abstract_mesh, active_mesh,
                       active_rules, batch_data_axes, batch_pspec, constrain,
                       data_groups, logical_to_pspec, model_group,
                       to_placements, use_mesh, use_rules)

__all__ = ["BLOCK", "DECODE_RULES", "DEFAULT_RULES", "ErrorFeedback",
           "FSDP_RULES", "MOMENTS_RULES", "SP_DECODE_RULES", "AbstractMesh",
           "PartitionSpec", "QuantizedTensor", "abstract_mesh",
           "active_mesh", "active_rules", "allgather_matmul_reference",
           "batch_data_axes", "batch_pspec", "compress_with_feedback",
           "constrain", "copy_to_group", "count_collectives",
           "data_groups", "dequantize", "logical_to_pspec",
           "make_overlapped_mlp", "matmul_reducescatter_reference",
           "model_group", "quantize", "quantize_roundtrip",
           "ragged_all_to_all", "ragged_all_to_all_reference",
           "reduce_from_group", "ring_allgather_matmul",
           "ring_matmul_reducescatter", "sum_over_data", "to_placements",
           "use_mesh", "use_rules"]
