"""Runtime analysis of the port: the serving engine's and the router's
invariant sanitizer (``sanitizer.py``, behind ``PT_FLAGS_sanitize``)."""

from .sanitizer import SAFE_READS, EngineSanitizer, SanitizerError

__all__ = ["EngineSanitizer", "SAFE_READS", "SanitizerError"]
