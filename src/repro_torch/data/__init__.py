from .pipeline import DataConfig, SyntheticTokenPipeline

__all__ = ["DataConfig", "SyntheticTokenPipeline"]
