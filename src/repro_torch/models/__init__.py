from repro_torch.models.api import ModelAPI, get_model

__all__ = ["ModelAPI", "get_model"]
