"""Distribution substrate of the port.  So far only what the train step
uses: the int8 gradient round trip (``compress``).  Sharding, collectives
and error feedback come with distribution (ROADMAP.md queue A item 11)."""

from .compress import BLOCK, QuantizedTensor, dequantize, quantize, quantize_roundtrip

__all__ = ["BLOCK", "QuantizedTensor", "dequantize", "quantize",
           "quantize_roundtrip"]
