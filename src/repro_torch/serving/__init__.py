"""Serving layer of the port: requests, metrics and the single-device
engine.  ``Engine`` is imported lazily so request/metrics stay cheap."""
from repro_torch.serving.request import Request, ServeRequest, State


def __getattr__(name):
    if name == "Engine":
        from repro_torch.serving.engine import Engine
        return Engine
    raise AttributeError(name)


__all__ = ["Engine", "Request", "ServeRequest", "State"]
