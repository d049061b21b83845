from .pipeline import ByteCorpus, TokenPipeline

__all__ = ["ByteCorpus", "TokenPipeline"]
