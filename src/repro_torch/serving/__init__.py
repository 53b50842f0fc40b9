from repro_torch.serving.engine import (GenerationResult, PrecisionManagedEngine,
                                        ProgressiveServer, resident_report)

__all__ = ["GenerationResult", "PrecisionManagedEngine", "ProgressiveServer",
           "resident_report"]
