"""paddle error taxonomy + enforce helpers.

Parity: ``paddle/common/errors.h`` + the PADDLE_ENFORCE_* macro family
(paddle/common/enforce.h) — typed error categories so callers can catch
classes of failure, and enforce helpers that produce uniform, actionable
messages at user-facing raise sites.

Counterpart of ``paddle_tpu/errors.py``, class for class: each category
multiple-inherits the closest Python builtin (InvalidArgumentError is-a
ValueError, UnimplementedError is-a NotImplementedError, ...), so
adopting the taxonomy never breaks callers already catching builtins.
"""

from __future__ import annotations

__all__ = [
    "Error", "InvalidArgumentError", "NotFoundError", "OutOfRangeError",
    "AlreadyExistsError", "ResourceExhaustedError",
    "PreconditionNotMetError", "PermissionDeniedError",
    "ExecutionTimeoutError", "UnimplementedError", "UnavailableError",
    "FatalError", "ExternalError",
    "enforce", "enforce_eq", "enforce_gt", "enforce_ge", "enforce_in",
    "enforce_shape_match",
]


class Error(Exception):
    """Base of the paddle error taxonomy (errors.h `ErrorType`)."""

    code = "UNKNOWN"


class InvalidArgumentError(Error, ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(Error, FileNotFoundError):
    code = "NOT_FOUND"


class OutOfRangeError(Error, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(Error):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(Error, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(Error, RuntimeError):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(Error, PermissionError):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(Error, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(Error, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(Error, RuntimeError):
    code = "UNAVAILABLE"


class FatalError(Error, RuntimeError):
    code = "FATAL"


class ExternalError(Error, RuntimeError):
    code = "EXTERNAL"


def _fmt(msg, cls):
    return f"({cls.code}) {msg}"


def enforce(cond, msg, error_cls=InvalidArgumentError):
    """PADDLE_ENFORCE: raise ``error_cls`` with a coded message unless
    ``cond``. ``cond`` is a host value: a condition on a card tensor
    would wait for the card to read it."""
    if not cond:
        raise error_cls(_fmt(msg, error_cls))


def enforce_eq(a, b, what="value", error_cls=InvalidArgumentError):
    if a != b:
        raise error_cls(_fmt(
            f"{what} mismatch: expected {b!r}, got {a!r}", error_cls))


def enforce_gt(a, b, what="value", error_cls=InvalidArgumentError):
    if not a > b:
        raise error_cls(_fmt(
            f"{what} must be > {b!r}, got {a!r}", error_cls))


def enforce_ge(a, b, what="value", error_cls=InvalidArgumentError):
    if not a >= b:
        raise error_cls(_fmt(
            f"{what} must be >= {b!r}, got {a!r}", error_cls))


def enforce_in(value, allowed, what="value",
               error_cls=InvalidArgumentError):
    if value not in allowed:
        raise error_cls(_fmt(
            f"{what} must be one of {list(allowed)!r}, got {value!r}",
            error_cls))


def enforce_shape_match(shape, expected, what="tensor",
                        error_cls=InvalidArgumentError):
    """Compare shapes; ``None`` entries in ``expected`` are wildcards."""
    shape, expected = tuple(shape), tuple(expected)
    ok = len(shape) == len(expected) and all(
        e is None or s == e for s, e in zip(shape, expected))
    if not ok:
        raise error_cls(_fmt(
            f"{what} shape mismatch: expected {expected}, got {shape}",
            error_cls))
