"""Core of the paper's contribution: progressive quantization, bit
division/concatenation, and the progressive model container."""
from repro_torch.core.bitplanes import PAPER_DEFAULT, PlaneSchedule, concat, split
from repro_torch.core.plane_store import PlaneStore, TensorSlot
from repro_torch.core.policy import (DivisionPolicy, ExpertPopularityPolicy,
                                     LayerPriorityPolicy, UniformPolicy,
                                     embeddings_first_score, schedule_from_stages)
from repro_torch.core.progressive import (ProgressiveModel, ReceiverState, divide,
                                          transmit_reconstruct)
from repro_torch.core.quantize import (QuantizedTensor, container_dtype, dequantize,
                                       quantization_error_bound, quantize, truncate)

__all__ = [
    "QuantizedTensor", "quantize", "dequantize", "truncate", "quantization_error_bound",
    "container_dtype", "PlaneSchedule", "PAPER_DEFAULT", "split", "concat",
    "DivisionPolicy", "UniformPolicy", "LayerPriorityPolicy", "ExpertPopularityPolicy",
    "embeddings_first_score", "schedule_from_stages", "PlaneStore", "TensorSlot",
    "ProgressiveModel", "ReceiverState", "divide", "transmit_reconstruct",
]
