"""Core of the paper's contribution: progressive quantization, bit
division/concatenation, and the progressive model container."""
from repro_torch.core.bitplanes import PAPER_DEFAULT, PlaneSchedule, concat, split
from repro_torch.core.plane_store import PlaneStore, TensorSlot
from repro_torch.core.policy import DivisionPolicy, UniformPolicy
from repro_torch.core.progressive import ProgressiveModel, ReceiverState, divide
from repro_torch.core.quantize import (QuantizedTensor, container_dtype, dequantize,
                                       quantize)

__all__ = [
    "QuantizedTensor", "quantize", "dequantize", "container_dtype",
    "PlaneSchedule", "PAPER_DEFAULT", "split", "concat",
    "DivisionPolicy", "UniformPolicy", "PlaneStore", "TensorSlot",
    "ProgressiveModel", "ReceiverState", "divide",
]
