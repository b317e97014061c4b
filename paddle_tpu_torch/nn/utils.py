"""paddle_tpu_torch.nn.utils (counterpart of ``paddle_tpu/nn/utils.py``;
parity: python/paddle/nn/utils/): ``weight_norm``, ``remove_weight_norm``,
``spectral_norm``, ``clip_grad_norm_``, ``clip_grad_value_``,
``parameters_to_vector``, ``vector_to_parameters``.

``weight_norm`` and ``spectral_norm`` replace the layer's ``weight``
parameter with new parameters and recompute a plain ``weight`` tensor
attribute in a forward pre-hook (``Layer``'s, torch's own), from the
parameters as they are at the call: eagerly, and under
``functional_call`` with swapped values, the gradient reaches the new
parameters.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.parameter import Parameter
from ..core.random import make_generator


def _norm_except_dim(v, dim):
    """L2 norm over every axis but ``dim`` (kept); ``dim`` None: over all."""
    if dim is None:
        return torch.sqrt(torch.sum(torch.square(v)))
    dim = dim % v.dim()
    axes = tuple(i for i in range(v.dim()) if i != dim)
    if not axes:
        return torch.sqrt(torch.square(v))
    return torch.sqrt(torch.sum(torch.square(v), dim=axes, keepdim=True))


def _base_name(param, name):
    return param.name if isinstance(param, Parameter) else name


def weight_norm(layer: nn.Module, name: str = "weight", dim: int = 0):
    """w = g * v / ||v||, with ``{name}_g`` and ``{name}_v`` parameters."""
    if name not in layer._parameters:
        raise ValueError(f"weight_norm: no parameter {name!r}")
    w = layer._parameters.pop(name)
    base = _base_name(w, name)
    with torch.no_grad():
        g0 = _norm_except_dim(w, dim)
    layer.register_parameter(f"{name}_g", Parameter(g0, name=f"{base}_g"))
    layer.register_parameter(f"{name}_v", Parameter(w, name=f"{base}_v"))

    def recompute(lyr, inputs):
        g = lyr._parameters[f"{name}_g"]
        v = lyr._parameters[f"{name}_v"]
        object.__setattr__(lyr, name, v * (g / _norm_except_dim(v, dim)))

    handle = layer.register_forward_pre_hook(recompute)
    layer.__dict__.setdefault("_weight_norm_hooks", {})[name] = (handle, dim)
    recompute(layer, ())
    return layer


def remove_weight_norm(layer: nn.Module, name: str = "weight"):
    """Fold g * v / ||v|| back into one parameter."""
    hooks = layer.__dict__.get("_weight_norm_hooks", {})
    if name not in hooks:
        raise ValueError(f"remove_weight_norm: {name!r} not weight-normed")
    handle, dim = hooks.pop(name)
    handle.remove()
    g = layer._parameters.pop(f"{name}_g")
    v = layer._parameters.pop(f"{name}_v")
    with torch.no_grad():
        w = v * (g / _norm_except_dim(v, dim))
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, Parameter(w, name=v.name[:-2]))
    return layer


def _to_matrix(w, dim):
    if dim != 0:
        w = torch.movedim(w, dim, 0)
    return w.reshape(w.shape[0], -1)


def spectral_norm(layer: nn.Module, name: str = "weight",
                  n_power_iterations: int = 1, eps: float = 1e-12,
                  dim: int = 0):
    """w / sigma_max(w), sigma by power iteration from the ``{name}_u``
    buffer (no gradient through the iteration, as in the reference); the
    buffer advances at every call. ``u`` starts from a float32 normal
    draw of a generator seeded 0 on the weight's device (JAX: its
    ``PRNGKey(0)``: other numbers, so tests carry the buffer across)."""
    if name not in layer._parameters:
        raise ValueError(f"spectral_norm: no parameter {name!r}")
    w = layer._parameters.pop(name)
    layer.register_parameter(
        f"{name}_orig", Parameter(w, name=f"{_base_name(w, name)}_orig"))
    u0 = torch.empty((_to_matrix(w, dim).shape[0],), dtype=torch.float32,
                     device=w.device)
    u0.normal_(generator=make_generator(0, w.device))
    layer.register_buffer(f"{name}_u", u0 / torch.linalg.norm(u0))

    def recompute(lyr, inputs):
        wv = lyr._parameters[f"{name}_orig"]
        mat = _to_matrix(wv, dim)
        u = lyr._buffers[f"{name}_u"]
        with torch.no_grad():
            for _ in range(max(1, n_power_iterations)):
                v = mat.T @ u
                v = v / torch.clamp_min(torch.linalg.norm(v), eps)
                u = mat @ v
                u = u / torch.clamp_min(torch.linalg.norm(u), eps)
        sigma = u @ (mat @ v)
        object.__setattr__(lyr, name, wv / sigma)
        lyr._buffers[f"{name}_u"] = u

    handle = layer.register_forward_pre_hook(recompute)
    layer.__dict__.setdefault("_spectral_norm_hooks", {})[name] = (
        handle, dim)
    recompute(layer, ())
    return layer


# ---------------------------------------------------------------------------
# gradient and parameter-vector utilities
# ---------------------------------------------------------------------------
def clip_grad_norm_(parameters, max_norm, norm_type=2.0):
    """Scale the ``.grad`` of ``parameters`` in place so their global
    ``norm_type`` norm is at most ``max_norm``; returns the norm before
    clipping (a tensor: no host sync)."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.max(torch.stack([p.grad.abs().max() for p in params]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(torch.abs(p.grad) ** norm_type) for p in params]
        )) ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp_min(total, 1e-6), max=1.0)
    for p in params:
        p.grad.mul_(scale)
    return total


def clip_grad_value_(parameters, clip_value):
    for p in parameters:
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)


def parameters_to_vector(parameters):
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters):
    i = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[i:i + n].reshape(p.shape))
            i += n
