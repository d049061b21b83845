from .engine import Request, ServingEngine, ServingInstance

__all__ = ["Request", "ServingInstance", "ServingEngine"]
