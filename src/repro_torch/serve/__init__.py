from .engine import Engine, Request, ServeConfig

__all__ = ["Engine", "Request", "ServeConfig"]
