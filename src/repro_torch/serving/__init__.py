from repro_torch.serving.engine import (GenerationResult, PoolRequest, PoolStepStats,
                                        PrecisionManagedEngine, ProgressiveServer,
                                        SlotPoolEngine, WireStoreReceiver, resident_report)
from repro_torch.serving.quantized import QuantizedLinearState, from_progressive
from repro_torch.serving.speculative import (SpecConfig, SpeculativeEngine,
                                             SpeculativeResult, SpeculativeSlotPool)

__all__ = ["GenerationResult", "PoolRequest", "PoolStepStats", "PrecisionManagedEngine",
           "ProgressiveServer", "QuantizedLinearState", "SlotPoolEngine", "SpecConfig",
           "SpeculativeEngine", "SpeculativeResult", "SpeculativeSlotPool",
           "WireStoreReceiver", "from_progressive", "resident_report"]
