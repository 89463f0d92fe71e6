"""Distribution substrate of the port: the int8 gradient round trip with
error feedback (``compress``) and the ragged all-to-all of the MoE layer's
expert-parallel dispatch (``collectives``).  The sharding rules, the ring
matmuls and the overlapped MLP are not ported yet (ROADMAP.md queue A item
11)."""

from .collectives import ragged_all_to_all, ragged_all_to_all_reference
from .compress import (BLOCK, ErrorFeedback, QuantizedTensor,
                       compress_with_feedback, dequantize, quantize,
                       quantize_roundtrip)

__all__ = ["BLOCK", "ErrorFeedback", "QuantizedTensor",
           "compress_with_feedback", "dequantize", "quantize",
           "quantize_roundtrip", "ragged_all_to_all",
           "ragged_all_to_all_reference"]
