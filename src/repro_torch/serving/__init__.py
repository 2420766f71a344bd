"""Continuous-batching LM serving over a slot pool (``ServeEngine``)."""

from .engine import EngineConfig, Request, ServeEngine

__all__ = ["EngineConfig", "Request", "ServeEngine"]
