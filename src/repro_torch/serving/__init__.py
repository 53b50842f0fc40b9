from repro_torch.serving.engine import (GenerationResult, PoolRequest, PoolStepStats,
                                        PrecisionManagedEngine, ProgressiveServer,
                                        SlotPoolEngine, WireStoreReceiver, resident_report)

__all__ = ["GenerationResult", "PoolRequest", "PoolStepStats", "PrecisionManagedEngine",
           "ProgressiveServer", "SlotPoolEngine", "WireStoreReceiver", "resident_report"]
