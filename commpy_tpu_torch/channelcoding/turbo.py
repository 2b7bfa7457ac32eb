"""Reference-compatible turbo module (commpy.channelcoding.turbo API)."""
from ..ops.turbo import map_decode, turbo_decode, turbo_encode

__all__ = ["turbo_encode", "map_decode", "turbo_decode"]
