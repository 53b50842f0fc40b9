from repro_torch.models.common import ArchConfig
from repro_torch.models.model import Model, build_model

__all__ = ["ArchConfig", "Model", "build_model"]
