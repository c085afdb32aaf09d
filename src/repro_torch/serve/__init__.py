"""Serving layer of the port: the batched decode engine (counterpart of
``repro.serve``'s :class:`ServeEngine` and :class:`Request`).  The strategy
service waits for ROADMAP queue item 2."""
from .engine import Request, ServeEngine

__all__ = ["ServeEngine", "Request"]
