"""paddle_tpu_torch.utils (counterpart of ``paddle_tpu/utils``; parity:
``paddle.utils``): dlpack interop, ``deprecated``, ``try_import``,
``run_check`` and ``unique_name``."""

import contextlib as _contextlib

from . import dlpack  # noqa: F401

__all__ = ["dlpack", "deprecated", "try_import", "run_check", "unique_name"]


def deprecated(update_to="", since="", reason="", level=1):
    """Parity: paddle.utils.deprecated: level 0 suppresses the message,
    1 warns (the default), 2 raises RuntimeError."""
    import functools
    import warnings

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            msg = f"{fn.__name__} is deprecated"
            if since:
                msg += f" since {since}"
            if update_to:
                msg += f"; use {update_to} instead"
            if reason:
                msg += f" ({reason})"
            if level >= 2:
                raise RuntimeError(msg)
            if level == 1:
                warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return inner

    return wrap


def try_import(module_name, err_msg=None):
    """Parity: paddle.utils.try_import."""
    import importlib

    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            err_msg or f"{module_name} is required but not installed"
        ) from e


def run_check():
    """Parity: paddle.utils.run_check: one small computation on the
    current device (the card unless ``set_device("cpu")``; raises without
    one), reporting what it ran on."""
    import torch

    from ..core.device import current_device

    dev = current_device()
    out = (torch.eye(8, device=dev) @ torch.eye(8, device=dev)).sum()
    assert float(out) == 8.0
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"paddle_tpu_torch is installed and working on {n} "
          f"{dev.type} device(s): {name}")


class _UniqueName:
    """Parity: paddle.utils.unique_name (generate/guard/switch)."""

    def __init__(self):
        self._counters = {}

    def generate(self, key):
        n = self._counters.get(key, 0)
        self._counters[key] = n + 1
        return f"{key}_{n}"

    def switch(self, new_generator=None):
        old = dict(self._counters)
        self._counters = {} if new_generator is None else new_generator
        return old

    @_contextlib.contextmanager
    def guard(self, new_generator=None):
        old = self.switch({} if new_generator is None else new_generator)
        try:
            yield
        finally:
            self._counters = old


unique_name = _UniqueName()
