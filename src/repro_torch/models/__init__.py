from repro_torch.models.registry import build
from repro_torch.models.transformer import Model

__all__ = ["build", "Model"]
