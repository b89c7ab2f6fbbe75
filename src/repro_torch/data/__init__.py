from repro_torch.data.pipeline import DataConfig, LMPipeline

__all__ = ["DataConfig", "LMPipeline"]
