from repro_torch.models.layers import RunConfig
from repro_torch.models.model_zoo import Model, build

__all__ = ["RunConfig", "Model", "build"]
