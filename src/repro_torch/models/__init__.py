from repro_torch.models.api import ModelAPI, get_model
from repro_torch.models.guard import GuardSpec, fence, full_guard

__all__ = ["ModelAPI", "get_model", "GuardSpec", "fence", "full_guard"]
