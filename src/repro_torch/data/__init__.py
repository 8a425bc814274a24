"""The synthetic data pipeline, counterpart of ``repro/data``."""

from repro_torch.data.pipeline import SyntheticLMData, make_pipeline

__all__ = ["SyntheticLMData", "make_pipeline"]
