"""Frontends over the port's Renderer (``cpuvox_tpu/frontend``)."""
from .interactive import InteractiveSession  # noqa: F401
