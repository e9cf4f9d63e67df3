"""Serving of the port: the static batched engine and the continuous-
batching slot scheduler over the paged KV pool (the reference's
`repro/serve/__init__.py` names)."""
from .engine import Engine  # noqa: F401
from .scheduler import Request, SlotScheduler  # noqa: F401

__all__ = ["Engine", "Request", "SlotScheduler"]
