"""Fused channels-last GroupNorm (+SiLU) with its backward (counterpart
of ``paddle_tpu/kernels/group_norm.py``).

Two Hopper kernels (``csrc/group_norm.cu``) carry it, each beside its
plain PyTorch version in this module:

- row 12, the forward (``_gn_fwd_kernel`` through ``_gn_fwd_pallas``):
  two-pass float32 moments per (sample, group), then normalise, affine
  and the optional SiLU; y in x's dtype, mean and rstd ``[n, g]``;
- row 13, the backward (``_gn_bwd_kernel`` through ``_gn_bwd_pallas``):
  x-hat recomputed from the saved statistics, the SiLU chain, dx in x's
  dtype and per-sample dgamma/dbeta partials ``[n, c]``, summed over n
  by the caller.

``_FusedGroupNorm`` (a ``torch.autograd.Function``) saves ``(x3, gamma,
beta, mean, rstd)`` as ``_fused_fwd`` does. gamma and beta enter the
kernels as float32 (bf16 parameters are cast) and their gradients leave
in the parameters' dtype.

Dispatch: a CPU tensor takes the plain versions; a CUDA tensor launches
the kernels or raises. The kernels take any NHWC shape with ``c % g ==
0`` (``_launch_plan`` refuses only groups of more than about 9,000
channels, whose partial sums overflow shared memory); the JAX TPU VMEM
budget (``supports_fused``, copied here) only
decides, for CPU tensors, whether ``nn.functional.group_norm`` takes
this path or the reference, as in JAX. Each wrapper adds one to
``LAUNCHES[name]`` per launch.

``_launch_plan`` chooses each launch's geometry here, where the CPU
tests reach it: the slab of whole groups a cluster takes, the cluster's
CTAs along the rows, the CTA's threads, the vector width and whether a
CTA's tile stays in shared memory. On the card it asks the kernels'
library how many clusters of each candidate the card holds at once, and
the library sizes the candidate's shared memory as the launch does
(``_card_clusters``: a plan whose size differs from the kernel's raises),
and reads the card's SM count; the CPU tests use
``_card.clusters_model`` and the H100's 132. The kernels validate the
plan and refuse one they do not take.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _ops
from ._card import SMEM_LIMIT, SMS, clusters_model, held_clusters, sm_count

# kernel launches in this process: row 12 (forward), row 13 (backward)
LAUNCHES = {"group_norm_fwd": 0, "group_norm_bwd": 0}

# the JAX kernel's VMEM gate (paddle_tpu/kernels/group_norm.py:61-87)
VMEM_BUDGET_BYTES = 8 * 1024 * 1024
_F32_SLABS = 5

_F32 = torch.float32
_TAG = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _pick_c_block(hw: int, c: int, cg: int):
    """The JAX kernel's channel slab for the VMEM budget, or None when
    one group's slab exceeds it."""
    if hw * cg * 4 * _F32_SLABS > VMEM_BUDGET_BYTES:
        return None
    blk = cg
    while (blk * 2 <= c and c % (blk * 2) == 0
           and hw * blk * 2 * 4 * _F32_SLABS <= VMEM_BUDGET_BYTES):
        blk *= 2
    return blk


def supports_fused(shape, num_groups: int) -> bool:
    """The JAX gate: True when its TPU kernel takes this NHWC shape within
    its VMEM budget. The port's kernels have no such limit."""
    if len(shape) != 4:
        return False
    n, h, w, c = shape
    if c % num_groups:
        return False
    return _pick_c_block(h * w, c, c // num_groups) is not None


def use_fused(x, num_groups: int) -> bool:
    """The dispatch rule of a 4-D NHWC GroupNorm with the
    ``fused_group_norm`` flag on: every tensor off the CPU goes to the
    kernels (the wrapper raises for a device other than the card), a CPU
    tensor where the JAX gate ``supports_fused`` holds; a ``meta`` tensor
    takes the plain version, which computes shapes only (a shape-only
    pass such as ``hapi.summary`` reaches no kernel)."""
    if x.device.type == "meta":
        return False
    return x.device.type != "cpu" or supports_fused(x.shape, num_groups)


# the launch plan's limits on the H100 (csrc/group_norm.cu checks them)
SMEM_BUDGET = 113 * 1024   # a resident tile's CTA: two CTAs an SM
WAVE_THREADS_PER_SM = 256  # a wave's threads: more add no speed (PERF.md)
MAX_RANKS = 8              # CTAs of a cluster: the portable size
THREAD_CAPS = (256, 128)   # threads of a CTA, at most
MIN_ROW_BYTES = 64         # a slab's row: two 32-byte sectors at least
MIN_ROWS = 8               # rows of a CTA when the rows are split


class LaunchPlan(NamedTuple):
    slab: int       # channels of a cluster: whole groups and vectors
    ranks: int      # CTAs of the cluster, each ceil(hw / ranks) rows
    vec: int        # elements a thread moves at a time (16 bytes at most)
    resident: bool  # the CTA's tile (x, and dy backward) in shared memory
    threads: int    # threads of a CTA
    smem: int       # dynamic shared memory bytes of a CTA


def _plan_for(n, hw, c, g, itemsize, backward, align, ranks, cap):
    """The geometry of a launch with clusters of ``ranks`` CTAs of at most
    ``cap`` threads: the widest vector that c and the pointers allow; the
    narrowest slab of whole groups and whole vectors whose rows are at
    least ``MIN_ROW_BYTES``; threads along the slab's vectors times rows
    of threads; resident when the tiles fit ``SMEM_BUDGET``. Mirrors the
    shared-memory layout of ``csrc/group_norm.cu: make_geo``, to which
    ``_card_clusters`` holds every plan on the card."""
    cg = c // g
    vec = 16 // itemsize
    while vec > 1 and (c % vec or align % (vec * itemsize)):
        vec //= 2
    step = math.lcm(vec, cg)
    slab = step
    while slab * itemsize < MIN_ROW_BYTES and slab < c:
        slab += step
        while c % slab:
            slab += step
    cols = min(slab // vec, cap)
    per = -(-hw // ranks)
    threads = -(-cols * max(1, min(cap // cols, per)) // 32) * 32
    tile = -(-per * slab * itemsize // 16) * 16
    arrays = (2 if slab // vec <= cols else 4) if backward else 1
    side = 4 * (arrays * (threads // cols) * slab + 2 * slab
                + (6 if backward else 4) * (slab // cg))
    with_tiles = (2 if backward else 1) * tile + side
    resident = with_tiles <= SMEM_BUDGET
    return LaunchPlan(slab, ranks, vec, resident, threads,
                      with_tiles if resident else side)


def _launch_plan(n: int, hw: int, c: int, g: int, itemsize: int,
                 backward: bool = False, align: int = 16,
                 clusters=None, sms: int = SMS) -> LaunchPlan:
    """The geometry of one kernel launch over ``[n, hw, c]`` in elements
    of ``itemsize`` bytes, whose data pointers are all ``align``-byte
    aligned, on a card of ``sms`` SMs. Among clusters of 1, 2, 4 or 8 CTAs
    (each at least ``MIN_ROWS`` rows) of at most 256 or 128 threads
    (``_plan_for``): a resident one if any; then the fewest waves of the
    grid's n x slabs clusters, given how many the card holds at once
    (``clusters(plan, backward)``, by default ``_card.clusters_model``; a
    plan over ``SMEM_LIMIT`` holds none); then the most threads, up to
    ``WAVE_THREADS_PER_SM`` an SM; then the most ranks."""
    if g < 1 or c % g:
        raise ValueError(f"channels {c} not divisible by groups {g}")

    def fit(p):
        if p.smem > SMEM_LIMIT:
            return 0
        if clusters:
            return clusters(p, backward)
        return clusters_model(p.threads, p.smem, p.ranks, sms)

    def score(p):
        grid = n * (c // p.slab)
        held = fit(p)
        waves = -(-grid // held) if held > 0 else grid + 1
        work = min(grid * p.ranks * p.threads, sms * WAVE_THREADS_PER_SM)
        return (not p.resident, waves, -work, -p.ranks)

    plans = [_plan_for(n, hw, c, g, itemsize, backward, align, ranks, cap)
             for ranks in (1, 2, 4, 8) if ranks == 1 or hw >= ranks * MIN_ROWS
             for cap in THREAD_CAPS]
    plan = min(plans, key=score)
    if plan.smem > SMEM_LIMIT:
        raise ValueError(f"group norm: a slab of {plan.slab} channels needs "
                         f"{plan.smem} bytes of shared memory (at most "
                         f"{SMEM_LIMIT})")
    return plan


def _alignment(*tensors) -> int:
    """The largest power of two, at most 16, dividing every data pointer."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


def _check_act(act):
    if act not in (None, "silu"):
        raise ValueError(f"fused_group_norm: unknown activation {act!r}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _per_channel(stat_g, cg):
    """[n, g] -> [n, 1, c]: each group's value on its channels."""
    return stat_g.repeat_interleave(cg, dim=1)[:, None, :]


def _group_sum(per_channel, g):
    """[n, c] -> [n, g]: the sum over each group's channels."""
    n, c = per_channel.shape
    return per_channel.reshape(n, g, c // g).sum(dim=-1)


def group_norm_fwd_plain(x3, gamma, beta, num_groups: int, eps: float,
                         act=None):
    """Plain version of row 12 on ``x3 [n, hw, c]`` as the JAX kernel
    computes it: per-channel sums over hw, then over the group's
    channels, two passes. Returns y (x's dtype), mean and rstd [n, g]
    float32."""
    _check_act(act)
    n, hw, c = x3.shape
    g = num_groups
    cg = c // g
    inv_n = 1.0 / (hw * cg)
    x = x3.to(_F32)
    mean = _group_sum(x.sum(dim=1), g) * inv_n
    dv = x - _per_channel(mean, cg)
    var = _group_sum((dv * dv).sum(dim=1), g) * inv_n
    rstd = torch.rsqrt(var + eps)
    y = dv * _per_channel(rstd, cg) * gamma.to(_F32) + beta.to(_F32)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x3.dtype), mean, rstd


def group_norm_bwd_plain(x3, dy3, gamma, beta, mean, rstd, num_groups: int,
                         act=None):
    """Plain version of row 13: dx (x's dtype) and the per-sample dgamma,
    dbeta partials [n, c] float32."""
    _check_act(act)
    n, hw, c = x3.shape
    g = num_groups
    cg = c // g
    inv_n = 1.0 / (hw * cg)
    gamma, beta = gamma.to(_F32), beta.to(_F32)
    rstd_c = _per_channel(rstd, cg)
    xhat = (x3.to(_F32) - _per_channel(mean, cg)) * rstd_c
    dz = dy3.to(_F32)
    if act == "silu":
        z = xhat * gamma + beta
        sig = torch.sigmoid(z)
        dz = dz * (sig * (1.0 + z * (1.0 - sig)))
    dgamma = (dz * xhat).sum(dim=1)
    dbeta = dz.sum(dim=1)
    dxhat = dz * gamma
    m1 = _group_sum(dxhat.sum(dim=1), g) * inv_n
    m2 = _group_sum((dxhat * xhat).sum(dim=1), g) * inv_n
    dx = rstd_c * (dxhat - _per_channel(m1, cg)
                   - xhat * _per_channel(m2, cg))
    return dx.to(x3.dtype), dgamma, dbeta


def group_norm_reference(x, gamma=None, beta=None, num_groups: int = 1,
                         epsilon: float = 1e-5, activation=None):
    """Plain NHWC GroupNorm(+activation) of any rank, the JAX reference:
    statistics, affine and activation in float32, y in x's dtype, no
    transposes."""
    n, c = x.shape[0], x.shape[-1]
    g = num_groups
    spatial = x.shape[1:-1]
    xf = x.to(_F32).reshape(n, -1, g, c // g)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    dv = xf - mean
    var = (dv * dv).mean(dim=(1, 3), keepdim=True)
    y = (dv * torch.rsqrt(var + epsilon)).reshape(n, *spatial, c)
    if gamma is not None:
        y = y * gamma.to(_F32)
    if beta is not None:
        y = y + beta.to(_F32)
    if activation == "silu":
        y = y * torch.sigmoid(y)
    elif activation is not None:
        raise ValueError(f"group_norm: unknown activation {activation!r}")
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check(x3, num_groups, tensors):
    if x3.dim() != 3 or x3.dtype not in _TAG:
        raise ValueError(f"x must be [n, hw, c] of {list(_TAG)}; got "
                         f"{tuple(x3.shape)} {x3.dtype}")
    n, hw, c = x3.shape
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups "
                         f"{num_groups}")
    if n > 65535:
        raise ValueError(f"batch {n} exceeds 65535")
    for name, t, dtype, shape in tensors:
        if t.device != x3.device:
            raise ValueError(f"{name} is on {t.device}, x on {x3.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape}; "
                             f"got {t.dtype} {tuple(t.shape)}")


def _fn(name, argtypes):
    from . import _build

    fn = getattr(_build.library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _card_clusters(tag, n, hw, c, g):
    """``_launch_plan``'s ``clusters`` on the card for a launch over
    ``[n, hw, c]`` in ``g`` groups: how many clusters of a plan's kernel
    the card holds at once (``_card.held_clusters`` through
    ``pt_group_norm_plan_<tag>``, which refuses a plan the kernels do not
    take)."""
    out = ctypes.POINTER(ctypes.c_int)
    fn = _fn(f"pt_group_norm_plan_{tag}", [_I] * 10 + [out, out])

    def clusters(plan, backward):
        return held_clusters(fn, (n, hw, c, g, plan.slab, plan.ranks,
                                  plan.vec, int(plan.resident), plan.threads,
                                  int(backward)), plan, "group norm")

    return clusters


_PLANS = {}  # the card's plans by their arguments: each found once


def _card_plan(x3, g, backward, *tensors):
    """``_launch_plan`` for a launch over ``x3`` and ``tensors`` on the
    card, computed once per shape, type, direction and alignment (it
    costs tens of us of host time, and a UNet step makes 112 calls)."""
    n, hw, c = x3.shape
    key = (x3.device, x3.dtype, n, hw, c, g, backward,
           _alignment(x3, *tensors))
    if key not in _PLANS:
        _PLANS[key] = _launch_plan(
            n, hw, c, g, x3.element_size(), backward=backward,
            align=key[-1],
            clusters=_card_clusters(_TAG[x3.dtype], n, hw, c, g),
            sms=sm_count(x3.device))
    return _PLANS[key]


def _fwd_cuda(x3, gamma, beta, num_groups, eps, act):
    n, hw, c = x3.shape
    _check(x3, num_groups, [("x", x3, x3.dtype, (n, hw, c)),
                            ("gamma", gamma, _F32, (c,)),
                            ("beta", beta, _F32, (c,))])
    y = torch.empty_like(x3)
    mean = torch.empty((n, num_groups), dtype=_F32, device=x3.device)
    rstd = torch.empty_like(mean)
    plan = _card_plan(x3, num_groups, False, y)
    fn = _fn(f"pt_group_norm_fwd_{_TAG[x3.dtype]}",
             [_P] * 6 + [_I] * 4 + [ctypes.c_float] + [_I] * 6 + [_P])
    with torch.cuda.device(x3.device):
        err = fn(x3.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, hw, c,
                 num_groups, float(eps), int(act == "silu"), plan.slab,
                 plan.ranks, plan.vec, int(plan.resident), plan.threads,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"group norm forward failed to launch: CUDA "
                           f"error {err}")
    LAUNCHES["group_norm_fwd"] += 1
    return y, mean, rstd


def _bwd_cuda(x3, dy3, gamma, beta, mean, rstd, num_groups, act):
    n, hw, c = x3.shape
    g = num_groups
    _check(x3, g, [("x", x3, x3.dtype, (n, hw, c)),
                   ("dy", dy3, x3.dtype, (n, hw, c)),
                   ("gamma", gamma, _F32, (c,)), ("beta", beta, _F32, (c,)),
                   ("mean", mean, _F32, (n, g)), ("rstd", rstd, _F32, (n, g))])
    dx = torch.empty_like(x3)
    dgamma = torch.empty((n, c), dtype=_F32, device=x3.device)
    dbeta = torch.empty_like(dgamma)
    plan = _card_plan(x3, g, True, dy3, dx)
    fn = _fn(f"pt_group_norm_bwd_{_TAG[x3.dtype]}",
             [_P] * 9 + [_I] * 10 + [_P])
    with torch.cuda.device(x3.device):
        err = fn(x3.data_ptr(), dy3.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                 dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), n, hw,
                 c, g, int(act == "silu"), plan.slab, plan.ranks, plan.vec,
                 int(plan.resident), plan.threads,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"group norm backward failed to launch: CUDA "
                           f"error {err}")
    LAUNCHES["group_norm_bwd"] += 1
    return dx, dgamma, dbeta


def _stats_like(x3, cols):
    return x3.new_empty((x3.shape[0], cols), dtype=_F32)


FWD_OP = _ops.define(
    "group_norm_fwd",
    "(Tensor x3, Tensor gamma, Tensor beta, int num_groups, float eps, "
    "str? act) -> (Tensor, Tensor, Tensor)", 12,
    lambda *a: tuple(t.contiguous() for t in group_norm_fwd_plain(*a)),
    _fwd_cuda,
    lambda x3, gamma, beta, g, eps, act: (
        x3.new_empty(x3.shape), _stats_like(x3, g), _stats_like(x3, g)))
BWD_OP = _ops.define(
    "group_norm_bwd",
    "(Tensor x3, Tensor dy3, Tensor gamma, Tensor beta, Tensor mean, "
    "Tensor rstd, int num_groups, str? act) -> (Tensor, Tensor, Tensor)",
    13, lambda *a: tuple(t.contiguous() for t in group_norm_bwd_plain(*a)),
    _bwd_cuda,
    lambda x3, *a: (x3.new_empty(x3.shape), _stats_like(x3, x3.shape[2]),
                    _stats_like(x3, x3.shape[2])))


def group_norm_fwd(x3, gamma, beta, num_groups: int, eps: float, act=None):
    """Row 12 (op ``paddle_tpu::group_norm_fwd``): y, mean, rstd as
    ``group_norm_fwd_plain``; x3 contiguous [n, hw, c], gamma and beta
    float32 [c]."""
    _check_act(act)
    _ops.check_device(x3, "the group norm kernels")
    return FWD_OP(x3, gamma, beta, int(num_groups), float(eps), act)


def group_norm_bwd(x3, dy3, gamma, beta, mean, rstd, num_groups: int,
                   act=None):
    """Row 13 (op ``paddle_tpu::group_norm_bwd``): dx and the per-sample
    dgamma, dbeta partials [n, c], as ``group_norm_bwd_plain``."""
    _check_act(act)
    _ops.check_device(x3, "the group norm kernels")
    return BWD_OP(x3, dy3, gamma, beta, mean, rstd, int(num_groups), act)


# ---------------------------------------------------------------------------
# autograd and entry point
# ---------------------------------------------------------------------------
class _FusedGroupNorm(torch.autograd.Function):
    """GroupNorm(+activation) over x3 [n, hw, c] with the kernels'
    backward (JAX ``_fused_group_norm3`` with ``_fused_fwd``/
    ``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, x3, gamma, beta, num_groups, eps, act):
        y, mean, rstd = group_norm_fwd(
            x3, gamma.to(_F32).contiguous(), beta.to(_F32).contiguous(),
            num_groups, eps, act)
        ctx.save_for_backward(x3, gamma, beta, mean, rstd)
        ctx.attrs = (num_groups, act)
        return y

    @staticmethod
    def backward(ctx, dy):
        x3, gamma, beta, mean, rstd = ctx.saved_tensors
        num_groups, act = ctx.attrs
        dx, dgamma, dbeta = group_norm_bwd(
            x3, dy.contiguous(), gamma.to(_F32).contiguous(),
            beta.to(_F32).contiguous(), mean, rstd, num_groups, act)
        return (dx, dgamma.sum(dim=0).to(gamma.dtype),
                dbeta.sum(dim=0).to(beta.dtype), None, None, None)


def fused_group_norm(x, gamma, beta, num_groups: int, epsilon: float = 1e-5,
                     activation=None):
    """Fused GroupNorm(+activation) over NHWC ``x [n, h, w, c]``; gamma,
    beta [c]; ``activation`` None or "silu" (applied inside the kernel
    after the affine). Differentiable through row 13."""
    _check_act(activation)
    if x.dim() != 4:
        raise ValueError(f"fused_group_norm takes NHWC [n, h, w, c]; got "
                         f"{tuple(x.shape)}")
    n, h, w, c = x.shape
    x3 = x.reshape(n, h * w, c).contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta)):
        y = _FusedGroupNorm.apply(x3, gamma, beta, int(num_groups),
                                  float(epsilon), activation)
    else:
        y, _, _ = group_norm_fwd(x3, gamma.to(_F32).contiguous(),
                                 beta.to(_F32).contiguous(),
                                 int(num_groups), float(epsilon), activation)
    return y.reshape(n, h, w, c)
