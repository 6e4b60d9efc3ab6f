"""Slot-batched streaming codec serving (engine + asyncio TCP server)."""

from .engine import SlotEngine
from .server import CodecServer, serve_forever

__all__ = ["SlotEngine", "CodecServer", "serve_forever"]
