"""``paddle.hub`` (counterpart of ``paddle_tpu/hub.py``): ``list``,
``help`` and ``load`` over a local repository (a directory with a
``hubconf.py``), upstream's ``source='local'`` mode; other sources
raise, as in JAX: the port reaches no network.
"""

from __future__ import annotations

import importlib.util
import os

_ENTRY_PREFIX = "_"  # hubconf entries are public callables
_cache = {}


def _load_hubconf(repo_dir: str, force_reload: bool = False):
    """Executed once per repo_dir (hubconf module-level side effects —
    weight loads, registries — must not repeat for list+load
    sequences); force_reload re-executes."""
    key = os.path.abspath(repo_dir)
    if not force_reload and key in _cache:
        return _cache[key]
    path = os.path.join(repo_dir, "hubconf.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no hubconf.py under {repo_dir!r}")
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _cache[key] = mod
    return mod


def _require_local(source):
    if source not in ("local",):
        raise NotImplementedError(
            "paddle_tpu_torch.hub reaches no network: clone the repo and "
            "use source='local' with its path, upstream's local mode")


def list(repo_dir, source="local", force_reload=False):  # noqa: A001
    _require_local(source)
    mod = _load_hubconf(repo_dir, force_reload)
    return [n for n in dir(mod)
            if callable(getattr(mod, n)) and not n.startswith(_ENTRY_PREFIX)]


def help(repo_dir, model, source="local", force_reload=False):  # noqa: A001
    _require_local(source)
    return getattr(_load_hubconf(repo_dir, force_reload), model).__doc__


def load(repo_dir, model, *args, source="local", force_reload=False,
         **kwargs):
    _require_local(source)
    return getattr(_load_hubconf(repo_dir, force_reload),
                   model)(*args, **kwargs)
