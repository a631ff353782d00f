from repro_torch.data.pipeline import DataConfig, FileTokens, SyntheticLM, \
    make_source

__all__ = ["DataConfig", "FileTokens", "SyntheticLM", "make_source"]
