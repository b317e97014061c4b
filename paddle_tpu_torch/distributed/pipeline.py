"""Pipeline parallelism (counterpart of ``paddle_tpu/distributed/
pipeline.py``; parity: fleet/meta_parallel/pipeline_parallel.py's 1F1B
and F-then-B schedules, pp_layers.py's ``PipelineLayer``/``LayerDesc``
segmentation).

The JAX package runs the pipeline as one SPMD program whose activations
move by ``ppermute``. The port is PyTorch's form of it: one process a
rank; each pp rank holds and runs only its stages' layers, and the
activations and their gradients move between adjacent pp ranks by
``batch_isend_irecv`` on the pp group.

- ``segment_layers`` and ``SegmentPlan``: JAX's cost-balanced contiguous
  split of the trunk's layers into stages (uniform or not). A stage runs
  its own layers; the JAX program pads every stage to the largest and
  masks the padding, which a rank of its own does not need (so the
  plan keeps no padding indices).
- ``PipelineLayer``: a homogeneous trunk, its parameters stacked over the
  layers (``<name with . as __>`` ``[L, ...]``, spec ``("pp",)`` + the
  layer's), run through one prototype layer with each layer's slice
  bound (``torch.func.functional_call``). ``PipelineModule``: pre layers,
  the trunk, post layers; ``SharedLayerDesc``s of one key build one layer
  (a tied embedding).
- ``pipeline_apply``: GPipe over a pp group, differentiable.
- ``PipelineTrainStep``: the train step (``trainer.TrainStep``'s update,
  optimizer state, ZeRO stages, tp, dp and fsdp) with the schedule of
  ``strategy.pipeline_configs``: ``schedule_mode`` ``"1F1B"``/``"VPP"``
  (JAX's order: F(v, f) at pair tick v + f, B(v, b) at 2(V-1) - v + b,
  V = pp x ``vpp_degree`` virtual stages placed round-robin, virtual
  stage v on pp rank v mod pp) or ``"F-then-B"`` (the GPipe forward of
  every micro-batch, then the backward), over ``accumulate_steps``
  micro-batches; the loss is their mean. ``strategy.recompute``
  recomputes each layer in the backward.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..core.module import Layer
from ..core.parameter import Parameter
from ..trainer.train_step import TrainStep, _as_tensor
from . import sharding as shd
from .parallel_layers.mp_layers import axis_group, p2p_exchange

# the layer dim of a trunk parameter held by its stage: a name no mesh
# has, so the sharding engine neither cuts it nor puts fsdp there
STAGE_LAYERS = "pp_stage"


def segment_layers(costs, num_stages: int):
    """Cost-balanced contiguous segmentation (parity: fleet pp_layers
    ``segment_layers``): split ``costs`` into ``num_stages`` contiguous
    groups minimising the largest group's cost. Returns the boundaries
    [0, b1, ..., L]."""
    costs = list(costs)
    L = len(costs)
    if num_stages <= 0 or L < num_stages:
        raise ValueError(f"cannot split {L} layers into {num_stages} stages")
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def greedy(cap):
        bounds, i = [0], 0
        for stage in range(num_stages):
            start = i
            last_possible = L - (num_stages - stage - 1)
            while (i < last_possible
                   and (prefix[i + 1] - prefix[start] <= cap or i == start)):
                i += 1
            bounds.append(i)
        return bounds if bounds[-1] == L else None

    lo, hi = max(costs), prefix[-1]
    for _ in range(60):  # binary search of the bottleneck stage's cost
        mid = (lo + hi) / 2
        if greedy(mid) is not None:
            hi = mid
        else:
            lo = mid
    return greedy(hi)


class SegmentPlan:
    """A stage (or chunk) partition of an L-layer trunk by
    ``segment_layers``: ``bounds``, ``sizes``, and ``layers(v)``, part v's
    layer indices."""

    def __init__(self, costs, parts: int):
        self.bounds = segment_layers(costs, parts)
        self.parts = parts
        self.sizes = [b - a for a, b in zip(self.bounds, self.bounds[1:])]

    def layers(self, v: int) -> range:
        return range(self.bounds[v], self.bounds[v + 1])


def stage_layers(plan: SegmentPlan, pp: int, rank: int) -> List[int]:
    """The layers pp rank ``rank`` holds: its virtual stages v = c * pp +
    rank, c = 0 .. parts / pp - 1, in order."""
    return [j for c in range(plan.parts // pp)
            for j in plan.layers(c * pp + rank)]


class LayerDesc:
    """Parity: fleet LayerDesc, a deferred layer constructor."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self) -> nn.Module:
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """Parity: fleet SharedLayerDesc: the descs of one ``key`` build one
    layer (tied weights, such as the embedding and the LM head); a later
    one may call it as ``forward_func(layer, x)``. Under pp the layer
    lives on the first and the last stage (every pp rank holds it) and
    its two gradients are summed over pp before the update."""

    def __init__(self, key, layer_cls, *args, forward_func=None, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.key = key
        self.forward_func = forward_func


class PipelineLayer(Layer):
    """Parity: fleet PipelineLayer over a homogeneous trunk of
    ``num_layers`` layers of ``layer_desc``: each parameter of the layer
    stacked over the layers as ``<name with . as __>`` [L, ...] (spec
    ``("pp",)`` + the layer's), run by one prototype layer (kept outside
    the module's parameters) with layer j's slices bound.
    ``forward(x, n_micro, mesh)`` runs the stages of a pp mesh over
    ``n_micro`` micro-batches (``pipeline_apply``) and the layers in
    order otherwise. ``held`` lists the layers this rank holds (all
    until ``PipelineTrainStep`` keeps its stages' only)."""

    def __init__(self, layer_desc: LayerDesc, num_layers: int,
                 num_stages: Optional[int] = None, seg_method="uniform",
                 costs=None):
        super().__init__()
        self.num_layers = num_layers
        self.num_stages = num_stages
        self.costs = list(costs) if costs is not None else None
        layers = [layer_desc.build() for _ in range(num_layers)]
        proto = layers[0]
        self._stacked_names = []
        per = [dict(layer.named_parameters()) for layer in layers]
        for name, p in list(proto.named_parameters()):
            spec = ("pp",) + tuple(p.spec if getattr(p, "spec", None)
                                   is not None else [None] * p.dim())
            stacked = torch.stack([d[name].detach() for d in per])
            flat = name.replace(".", "__")
            self.add_parameter(flat, Parameter(
                stacked, trainable=p.requires_grad, spec=spec))
            self._stacked_names.append((flat, name))
        del per, layers
        # the prototype's own values are never read: every call binds a
        # layer's slices
        for mod in proto.modules():
            for k, v in list(mod._parameters.items()):
                if v is not None:
                    mod._parameters[k] = nn.Parameter(
                        torch.empty(v.shape, dtype=v.dtype, device="meta"),
                        requires_grad=v.requires_grad)
        self._proto = [proto]
        self.held = list(range(num_layers))
        self._plan_cache = {}

    @property
    def prototype(self) -> nn.Module:
        return self._proto[0]

    def stage_params(self) -> Dict[str, torch.Tensor]:
        return {flat: self._parameters[flat]
                for flat, _ in self._stacked_names}

    def apply_layer(self, j: int, x, recompute: bool = False, stacked=None):
        """Layer ``j`` (a held layer's index) on ``x``, with its slices of
        ``stacked`` (default the held parameters: ``stage_params()``)."""
        pos = self.held.index(j)
        stacked = stacked if stacked is not None else self.stage_params()
        params = {orig: stacked[flat][pos]
                  for flat, orig in self._stacked_names}

        def run(x, *vals):
            return torch.func.functional_call(
                self.prototype, dict(zip(params, vals)), (x,))

        if recompute:
            return shd.recompute(run, x, *params.values())
        return run(x, *params.values())

    def forward(self, x, n_micro: int = 1, mesh=None):
        mesh = mesh if mesh is not None else shd.current_mesh()
        grp = axis_group(mesh, "pp")
        if grp is None:
            for j in range(self.num_layers):
                x = self.apply_layer(j, x)
            return x
        if grp.size not in self._plan_cache:
            self._plan_cache[grp.size] = SegmentPlan(
                self.costs or [1.0] * self.num_layers, grp.size)
        mine = self._plan_cache[grp.size].layers(grp.rank)

        def stage_fn(params, h):
            for j in mine:
                h = self.apply_layer(j, h, stacked=params)
            return h

        if x.shape[0] % n_micro:
            raise ValueError("batch not divisible by n_micro")
        mbs = x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])
        ys = pipeline_apply(stage_fn, self.stage_params(), mbs, mesh=mesh,
                            n_micro=n_micro)
        if grp.rank != grp.size - 1:
            return ys
        return ys.reshape(x.shape[:1] + ys.shape[2:])


class PipelineModule(Layer):
    """Parity: fleet pp_layers.PipelineLayer over a heterogeneous
    ``LayerDesc`` list: the longest homogeneous run of descs is the
    pipelined trunk (``PipelineLayer``), the descs before it the pre
    layers (``pre_<i>``, run by the first stage), those after it the post
    layers (``post_<i>``, run by the last stage); ``SharedLayerDesc``s of
    one key build one layer (``shared_<key>``). ``seg_method``
    ``"layer:<regex>"`` counts the trunk layers whose class name matches
    as cost 1 (others 0); ``cost_fn(desc)`` gives costs itself; the
    stages split the costs by ``segment_layers`` (``segments``). The pre
    and post layers handle tensor parallelism themselves."""

    tensor_parallel = True
    tp = None

    def __init__(self, descs, num_stages: Optional[int] = None,
                 seg_method: str = "uniform", cost_fn=None):
        super().__init__()
        if seg_method != "uniform" and not seg_method.startswith("layer:"):
            raise ValueError(
                f"seg_method={seg_method!r}: expected 'uniform' or "
                "'layer:<regex>' (fleet pp_layers convention)")
        self.num_stages = num_stages
        self._shared = {}
        self._shared_fwd = {}
        sig = [self._sig(d) for d in descs]
        lo, hi = self._longest_run(sig)
        if hi - lo < 2:
            raise ValueError(
                "PipelineModule needs a homogeneous run of >=2 LayerDescs "
                "to pipeline (the transformer trunk)")
        self.trunk_range = (lo, hi)
        if cost_fn is not None:
            self.trunk_costs = [float(cost_fn(d)) for d in descs[lo:hi]]
            if not any(self.trunk_costs):
                raise ValueError("cost_fn returned 0 for every trunk layer: "
                                 "the balanced partition is degenerate")
        elif seg_method.startswith("layer:"):
            import re

            pat = re.compile(seg_method[len("layer:"):])
            self.trunk_costs = [1.0 if pat.search(d.layer_cls.__name__)
                                else 0.0 for d in descs[lo:hi]]
            if not any(self.trunk_costs):
                raise ValueError(
                    f"seg_method={seg_method!r} matches no trunk layer "
                    f"({descs[lo].layer_cls.__name__})")
        else:
            self.trunk_costs = [1.0] * (hi - lo)
        self.pre = [self._build(d, f"pre_{i}")
                    for i, d in enumerate(descs[:lo])]
        self.trunk = PipelineLayer(descs[lo], hi - lo, num_stages=num_stages,
                                   costs=self.trunk_costs)
        self.post = [self._build(d, f"post_{i}")
                     for i, d in enumerate(descs[hi:])]
        if num_stages:
            self.segments = segment_layers(self.trunk_costs, num_stages)

    @staticmethod
    def _sig(d):
        return (d.layer_cls, repr(d.args), repr(sorted(d.kwargs.items())),
                isinstance(d, SharedLayerDesc))

    @staticmethod
    def _longest_run(sig):
        best, i = (0, 0), 0
        while i < len(sig):
            j = i
            while j < len(sig) and sig[j] == sig[i] and not sig[i][3]:
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = max(j, i + 1)
        return best

    def _build(self, desc, attr):
        if isinstance(desc, SharedLayerDesc):
            if desc.key not in self._shared:
                layer = desc.build()
                self._shared[desc.key] = layer
                self.add_sublayer(f"shared_{desc.key}", layer)
            self._shared_fwd[attr] = desc.forward_func
            return ("shared", desc.key, attr)
        self.add_sublayer(attr, desc.build())
        return ("own", attr, attr)

    def apply_seq(self, entries, x):
        for kind, key, attr in entries:
            if kind == "shared":
                layer = self._shared[key]
                fwd = self._shared_fwd.get(attr)
                x = fwd(layer, x) if fwd is not None else layer(x)
            else:
                x = getattr(self, key)(x)
        return x

    def forward(self, x, n_micro: int = 1, mesh=None):
        """pre -> the trunk (pipelined over a pp mesh) -> post. Over pp
        the result is on the last stage; the other ranks get
        ``pipeline_apply``'s handle."""
        mesh = mesh if mesh is not None else shd.current_mesh()
        grp = axis_group(mesh, "pp")
        h = self.trunk(self.apply_seq(self.pre, x), n_micro=n_micro,
                       mesh=mesh)
        if grp is not None and grp.rank != grp.size - 1:
            return h
        return self.apply_seq(self.post, h)


# ---------------------------------------------------------------------------
# point-to-point between pp ranks (``mp_layers.p2p_exchange``)
# ---------------------------------------------------------------------------
class _Local:
    """A pp group of one rank (no pp axis)."""

    size, rank, axis, group = 1, 0, "pp", None


class _GPipe(torch.autograd.Function):
    """GPipe over the pp group: stage s runs micro-batch f at tick s + f
    and sends its output on; the backward runs the ticks in reverse and
    sends the input gradients back. With ``remat`` a stage keeps its
    inputs only and recomputes its forward in the backward."""

    @staticmethod
    def forward(ctx, x, stage_fn, names, grp, n_micro, remat, *vals):
        s, n = grp.rank, grp.size
        ctx.attrs = (stage_fn, names, grp, n_micro, remat)
        params = dict(zip(names, vals))
        shape, dtype = tuple(x.shape[1:]), x.dtype
        inps, outs, ys = {}, {}, []
        buf = None
        for t in range(n_micro + n - 1):
            f = t - s
            out = None
            if 0 <= f < n_micro:
                inp = x[f] if s == 0 else buf
                with torch.enable_grad():
                    leaf = inp.detach().requires_grad_(inp.is_floating_point())
                    ps = {k: v.detach().requires_grad_(v.requires_grad)
                          for k, v in params.items()}
                    if remat:
                        with torch.no_grad():
                            out = stage_fn(ps, leaf)
                    else:
                        out = stage_fn(ps, leaf)
                        outs[f] = (out, ps)
                inps[f] = leaf
                if s == n - 1:
                    ys.append(out.detach())
            nxt = t + 1 - s  # the micro-batch arriving for tick t + 1
            sends = [(s + 1, out.detach(), 0)] if out is not None \
                and s < n - 1 else []
            buf = x.new_empty(shape, dtype=dtype) if s > 0 \
                and 0 <= nxt < n_micro else None
            p2p_exchange(grp, sends, [(s - 1, buf, 0)] if buf is not None
                      else [])
        ctx.inps, ctx.outs = inps, outs
        ctx.save_for_backward(*vals)
        if s == n - 1:
            return torch.stack(ys)
        return x.new_zeros((0,))

    @staticmethod
    def backward(ctx, gys):
        stage_fn, names, grp, n_micro, remat = ctx.attrs
        vals = ctx.saved_tensors
        s, n = grp.rank, grp.size
        dparams = [None] * len(vals)
        dx = {}
        gbuf = None
        for t in range(n_micro + n - 1):
            f = t - (n - 1 - s)
            dinp = None
            if 0 <= f < n_micro:
                g = gys[f] if s == n - 1 else gbuf
                leaf = ctx.inps[f]
                with torch.enable_grad():
                    if remat:
                        ps = {k: v.detach().requires_grad_(v.requires_grad)
                              for k, v in zip(names, vals)}
                        out = stage_fn(ps, leaf)
                    else:
                        out, ps = ctx.outs.pop(f)
                    wrt = [leaf] + [ps[k] for k in names if
                                    ps[k].requires_grad]
                    grads = torch.autograd.grad(out, wrt, g,
                                                allow_unused=True)
                dinp = grads[0]
                it = iter(grads[1:])
                for i, k in enumerate(names):
                    if ps[k].requires_grad:
                        gp = next(it)
                        if gp is not None:
                            dparams[i] = gp if dparams[i] is None \
                                else dparams[i] + gp
                if s == 0:
                    dx[f] = dinp
            nxt = t + 1 - (n - 1 - s)  # the micro-batch of tick t + 1
            sends = [(s - 1, dinp, 1)] if dinp is not None and s > 0 else []
            gbuf = torch.empty_like(ctx.inps[nxt]) if s < n - 1 \
                and 0 <= nxt < n_micro else None
            p2p_exchange(grp, sends, [(s + 1, gbuf, 1)] if gbuf is not None
                      else [])
        ctx.inps = ctx.outs = None
        x_grad = None
        if s == 0 and all(dx.get(f) is not None for f in range(n_micro)):
            x_grad = torch.stack([dx[f] for f in range(n_micro)])
        return (x_grad, None, None, None, None, None, *dparams)


def pipeline_apply(stage_fn: Callable, stage_params, x, *, mesh=None,
                   n_micro: int, axis: str = "pp", remat: bool = True):
    """GPipe: ``y = stage_{pp-1}(... stage_0(x))`` over ``n_micro``
    micro-batches, on the pp group of ``mesh`` (default the ambient one).

    ``stage_fn(params, x_mb) -> y_mb`` is this rank's stage (activations
    keep their shape and dtype across stages); ``stage_params`` a dict of
    this rank's stage's tensors; ``x`` [n_micro, mb, ...], the same on
    every rank (stage 0 reads it; the others take its shape). Returns the
    outputs [n_micro, mb, ...] on the last stage and, on the other
    ranks, a zero-element tensor: differentiable, so every rank calling
    ``backward`` on what it got (the others with ``.sum()``) runs the
    pipeline's backward; gradients reach ``stage_params`` and, on stage
    0, ``x``. ``remat`` recomputes each stage's forward in the backward
    (JAX's ``jax.checkpoint``)."""
    grp = axis_group(mesh if mesh is not None else shd.current_mesh(), axis)
    if grp is None:
        grp = _Local()
    names = list(stage_params)
    return _GPipe.apply(x, stage_fn, names, grp, n_micro, remat,
                        *[stage_params[k] for k in names])


def run_schedule(grp, vpp: int, n_micro: int, f_then_b: bool, first,
                 stage, last, h_meta, seed: float):
    """This pp rank's part of a pipeline schedule, eagerly with autograd.

    Virtual stage v = c * pp + rank (chunk c of ``vpp``); ``first(f)`` is
    micro-batch f's input of virtual stage 0, ``stage(v, h)`` runs
    virtual stage v, ``last(out, f)`` the loss of micro-batch f on the
    last one; ``h_meta`` = (shape, dtype, device) of the activations. 1F1B
    (JAX's order): F(v, f) at tick v + f, B(v, b) at 2(V-1) - v + b;
    F-then-B: every forward, then B(v, b) at (n + V - 1) + (V-1-v) + b.
    Within a tick each chunk runs its F, then its B; then the outputs go
    to the next virtual stage's rank and the input gradients to the
    previous one's, in one ``batch_isend_irecv`` (tags: the receiving
    chunk, F even, B odd). Each loss's backward is seeded with ``seed``;
    gradients accumulate in the leaves' ``.grad``. Returns the float32 sum
    of the losses this rank computed."""
    P, s = grp.size, grp.rank
    V = P * vpp
    hshape, hdtype, dev = h_meta
    t_fwd = n_micro + V - 1

    def b_tick(v):
        return t_fwd + (V - 1 - v) if f_then_b else 2 * (V - 1) - v

    total = 2 * t_fwd if f_then_b else n_micro + 2 * (V - 1)
    stash, fbuf, bbuf = {}, {}, {}
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(total):
        sends = []
        for c in range(vpp):
            v = c * P + s
            f = t - v
            if 0 <= f < n_micro:
                inp = first(f) if v == 0 else fbuf.pop(c).requires_grad_()
                out = stage(v, inp)
                if v == V - 1:
                    out = last(out, f).float()
                    loss_sum += out.detach()
                else:
                    sends.append(((v + 1) % P, out.detach(),
                                  2 * ((v + 1) // P)))
                stash[(c, f)] = (inp, out)
            b = t - b_tick(v)
            if 0 <= b < n_micro:
                inp, out = stash.pop((c, b))
                if v == V - 1:
                    (out * seed).backward()
                else:
                    out.backward(bbuf.pop(c))
                if v > 0:
                    sends.append(((v - 1) % P, inp.grad,
                                  2 * ((v - 1) // P) + 1))
        recvs = []
        for c in range(vpp):
            v = c * P + s
            if v > 0 and 0 <= t + 1 - v < n_micro:
                fbuf[c] = torch.empty(hshape, dtype=hdtype, device=dev)
                recvs.append(((v - 1) % P, fbuf[c], 2 * c))
            if v < V - 1 and 0 <= t + 1 - b_tick(v) < n_micro:
                bbuf[c] = torch.empty(hshape, dtype=hdtype, device=dev)
                recvs.append(((v + 1) % P, bbuf[c], 2 * c + 1))
        p2p_exchange(grp, sorted(sends, key=lambda e: e[2]),
                  sorted(recvs, key=lambda e: e[2]))
    return loss_sum


def pipeline_1f1b_step(first_fn: Callable, stage_fn: Callable,
                       last_fn: Callable, first_params, stage_params,
                       last_params, x_mbs, aux_mbs, *, mesh=None,
                       axis: str = "pp", vpp: int = 1):
    """One pipelined loss and gradient under the 1F1B schedule (JAX's
    ``pipeline_1f1b_step``, in its SPMD form).

    ``first_fn(first_params, x_mb) -> h`` (virtual stage 0's input),
    ``stage_fn(chunk_params, h) -> h`` (one virtual stage),
    ``last_fn(last_params, y_mb, aux_mb) -> scalar`` (the loss, a mean
    over the micro-batch). ``first_params``/``last_params``: dicts of
    tensors, the same on every rank; ``stage_params``: a dict of this
    rank's chunks, leading dim ``vpp``, chunk c being virtual stage
    ``c * pp + rank`` (JAX's round-robin placement); ``x_mbs``/``aux_mbs``
    [n_micro, ...], the same on every rank. Returns ``(loss, dfirst,
    dstage, dlast)`` for the mean over the micro-batches: the loss and
    ``dfirst``/``dlast`` on every rank (summed over pp), ``dstage`` this
    rank's chunks' gradients."""
    grp = axis_group(mesh if mesh is not None else shd.current_mesh(), axis)
    grp = grp if grp is not None else _Local()
    n_micro = x_mbs.shape[0]

    def leaves(d):
        return {k: v.detach().requires_grad_() for k, v in d.items()}

    fp, sp, lp = leaves(first_params), leaves(stage_params), \
        leaves(last_params)
    with torch.no_grad():
        h0 = first_fn(fp, x_mbs[0])
    loss = run_schedule(
        grp, vpp, n_micro, False, lambda f: first_fn(fp, x_mbs[f]),
        lambda v, h: stage_fn({k: t[v // grp.size] for k, t in sp.items()},
                              h),
        lambda y, f: last_fn(lp, y, aux_mbs[f]),
        (tuple(h0.shape), h0.dtype, h0.device), 1.0 / n_micro) / n_micro

    def grads(d, over_pp):
        out = {}
        for k, v in d.items():
            g = v.grad if v.grad is not None else torch.zeros_like(v)
            if over_pp and grp.size > 1:
                g = g.contiguous()
                dist.all_reduce(g, group=grp.group)
            out[k] = g
        return out

    if grp.size > 1:
        dist.all_reduce(loss, group=grp.group)
    return loss, grads(fp, True), grads(sp, False), grads(lp, True)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _mean_loss(out, aux):
    return out.mean()


class PipelineTrainStep(TrainStep):
    """1F1B / VPP / F-then-B training of a ``PipelineModule`` over a mesh
    with a pp axis (parity: fleet PipelineParallel.train_batch); with no
    mesh (and a strategy of degree 1), the same schedule on one process.

    ``run(x, aux)``: ``x`` [batch, ...] the module's input and ``aux``
    what ``loss_fn(out_mb, aux_mb)`` (a mean over the micro-batch;
    default ``out.mean()``) takes, both cut into ``accumulate_steps``
    micro-batches along dim 0 (each rank's ``(dp, fsdp)`` rows of each);
    returns the mean of the micro-batches' losses. Each pp rank keeps its
    stages' layers of the trunk (the rest of its copy of the stacked
    parameters is dropped); the pre and post parameters are held by every
    pp rank, run by the first and the last stage, and their gradients are
    summed over pp. The update, the optimizer state (its slots of the
    held layers), ZeRO stages 1-3 over fsdp, tp and the gradients'
    reduction over dp and fsdp are ``trainer.TrainStep``'s. Over dp x
    fsdp the loss is the mean of the ranks' means (exact for a loss
    that is a mean over equal rows). ``state_dict()`` gathers the stacked
    trunk over pp: its names are JAX's ``PipelineTrainStep.params`` keys
    (``trunk.<flat>`` [L, ...] and the pre/post parameters' own). sep and
    ep above 1 are refused (ROADMAP.md Queue C)."""

    def __init__(self, module: PipelineModule, optimizer, mesh=None,
                 strategy=None, loss_fn=None, **kw):
        from .strategy import DistributedStrategy
        from .topology import build_mesh

        strategy = strategy or DistributedStrategy()
        h = strategy.hybrid_configs
        if mesh is None and h.total() > 1:
            mesh = build_mesh(dp=h.dp_degree, pp=h.pp_degree,
                              fsdp=h.sharding_degree, tp=h.mp_degree)
        pcfg = strategy.pipeline_configs
        self.schedule = str(getattr(pcfg, "schedule_mode", "1F1B"))
        one_f_one_b = self.schedule.upper() in ("1F1B", "VPP")
        self.vpp = max(1, int(getattr(pcfg, "vpp_degree", 1))) \
            if one_f_one_b else 1
        self.n_micro = max(1, int(getattr(pcfg, "accumulate_steps", 1)))
        self.recompute = bool(getattr(strategy, "recompute", False))
        self.module = module
        grp = axis_group(mesh, "pp") or _Local()
        self.pp_group = grp
        trunk = module.trunk
        L = trunk.num_layers
        costs = getattr(module, "trunk_costs", None) or [1.0] * L
        self._plan_v = SegmentPlan(
            costs, grp.size * max(1, int(getattr(pcfg, "vpp_degree", 1))))
        self._plan_pp = SegmentPlan(costs, grp.size)
        self.plan = self._plan_v if one_f_one_b else self._plan_pp
        self.layers_of = {r: stage_layers(self.plan, grp.size, r)
                          for r in range(grp.size)}
        held = self.layers_of[grp.rank]
        if trunk.held != list(range(L)):
            raise ValueError("the module's trunk was cut already")
        with torch.no_grad():
            idx = torch.as_tensor(held, dtype=torch.long)
            for flat, _ in trunk._stacked_names:
                p = trunk._parameters[flat]
                p.data = p.data.index_select(0, idx.to(p.device))
                p.spec = (STAGE_LAYERS,) + tuple(p.spec[1:])
        trunk.held = held
        # in the stack's order: every rank gathers them in turn
        self._trunk_names = [f"trunk.{flat}"
                             for flat, _ in trunk._stacked_names]
        from .parallel_layers.mp_layers import set_tensor_parallel

        set_tensor_parallel(trunk.prototype, mesh)
        super().__init__(module, optimizer, mesh, strategy,
                         loss_fn=loss_fn or _mean_loss, batch_seq_axis=None,
                         **kw)
        if self._plan is not None and grp.size > 1:
            for n in self._trunk_names:
                if n in self._plan.info:
                    self._plan.layer_axes[n] = ("pp",)
        # the micro-batches are accumulate_steps', as in JAX's step
        self.gradient_merge_k = 1
        self._h_meta = None

    # the step's hooks ---------------------------------------------------
    def _check_model(self, mesh):
        for a in ("sep", "ep"):
            if shd._size(mesh, a) > 1:
                raise NotImplementedError(
                    f"PipelineTrainStep over {a} > 1 is not in the port "
                    f"(ROADMAP.md Queue C)")

    def _cost_flops(self, batch):
        """Telemetry's MFU: a pipeline step's FLOPs are not probed."""
        return None

    def run(self, x, aux=None, sharded: bool = False):
        """One optimizer step over the global batch (``x``, ``aux``);
        with ``sharded``, this rank's rows of it."""
        return super().run({"x": x, "aux": aux}, sharded)

    def _forward_backward(self, batch):
        """Without a mesh: the schedule on this process alone."""
        loss_sum = self._schedule(batch["x"], batch["aux"],
                                  1.0 / self.n_micro)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self._param_objs.items()}
        return loss_sum / self.n_micro, grads

    def _mesh_forward_backward(self, batch):
        plan, params = self._plan, self._param_objs
        full = self._bind_gathered()
        n_rows = self._batch_ranks()
        loss_sum = self._schedule(batch["x"], batch["aux"],
                                  1.0 / (self.n_micro * n_rows))
        self._unbind()
        grp = self.pp_group
        with torch.no_grad():
            loss = loss_sum / (self.n_micro * n_rows)
            if grp.size > 1:
                plan.all_reduce(loss, ("pp",))
            loss = plan.all_reduce(loss)
            grads = {}
            for n, p in params.items():
                src = full.get(n, p)
                g = src.grad if src.grad is not None else \
                    torch.zeros_like(src)
                src.grad = None
                if n not in self._trunk_names and grp.size > 1:
                    g = plan.all_reduce(g.contiguous(), ("pp",))
                grads[n] = plan.reduce_grad(n, g)
        return loss, grads

    # the schedule ---------------------------------------------------------
    def _split(self, t):
        if t is None or not isinstance(t, torch.Tensor) or t.dim() == 0:
            return [t] * self.n_micro
        if t.shape[0] % self.n_micro:
            raise ValueError(f"batch {t.shape[0]} not divisible by "
                             f"accumulate_steps {self.n_micro}")
        return list(t.chunk(self.n_micro))

    def _stage(self, v, h):
        trunk = self.module.trunk
        for j in self.plan.layers(v):
            h = trunk.apply_layer(j, h, self.recompute)
        return h

    def _schedule(self, x, aux, seed):
        """This rank's part of the schedule over the batch; the sum of
        the micro-batches' losses on the last stage (0 elsewhere)."""
        module = self.module
        xs, auxs = self._split(x), self._split(aux)
        if self._h_meta is None or self._h_meta[0] != tuple(xs[0].shape):
            with torch.no_grad():
                h0 = module.apply_seq(module.pre, xs[0])
            self._h_meta = (tuple(xs[0].shape), tuple(h0.shape), h0.dtype)

        def last(out, f):
            return self.loss_fn(module.apply_seq(module.post, out),
                                auxs[f])

        return run_schedule(
            self.pp_group, self.vpp, self.n_micro,
            self.schedule.upper() not in ("1F1B", "VPP"),
            lambda f: module.apply_seq(module.pre, xs[f]), self._stage,
            last, self._h_meta[1:] + (self.device,), seed)

    # state ----------------------------------------------------------------
    def _assemble(self, t):
        """The [L, ...] stack from every pp rank's held layers."""
        grp = self.pp_group
        if grp.size == 1:
            return t
        L = self.module.trunk.num_layers
        lmax = max(len(v) for v in self.layers_of.values())
        pad = torch.zeros((lmax,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        pad[:t.shape[0]] = t
        out = pad.new_empty((grp.size * lmax,) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, pad, group=grp.group)
        full = pad.new_empty((L,) + tuple(t.shape[1:]))
        for r, layers in self.layers_of.items():
            full[layers] = out[r * lmax:r * lmax + len(layers)]
        return full

    def state_dict(self, sharded: bool = False):
        """TrainStep's gathered state with each trunk entry (and its
        slots) assembled over pp into [L, ...]."""
        if sharded:
            raise NotImplementedError(
                "PipelineTrainStep.state_dict(sharded=True): a stage's "
                "layers are not one block; the gathered state is taken")
        sd = super().state_dict()
        if self._plan is None:
            return sd
        info = self._plan.info
        for n in self._trunk_names:
            shape = info[n]["shape"]
            sd["params"][n] = self._assemble(sd["params"][n])
            for k, v in sd["opt_state"]["slots"].get(n, {}).items():
                if tuple(v.shape) == shape:
                    sd["opt_state"]["slots"][n][k] = self._assemble(v)
            if n in sd["opt_state"].get("master", {}):
                sd["opt_state"]["master"][n] = self._assemble(
                    sd["opt_state"]["master"][n])
        return sd

    def set_state_dict(self, sd):
        """Restore ``state_dict()``'s layout: each trunk entry's held
        layers, then TrainStep's restore."""
        L = self.module.trunk.num_layers
        idx = self.module.trunk.held

        def held(v):
            t = _as_tensor(v, self.device)
            return t[idx] if t.dim() and t.shape[0] == L else t

        sd = dict(sd)
        sd["params"] = {n: held(v) if n in self._trunk_names else v
                        for n, v in sd["params"].items()}
        if "opt_state" in sd:
            opt = dict(sd["opt_state"])
            opt["slots"] = {n: ({k: held(v) for k, v in sl.items()}
                                if n in self._trunk_names else sl)
                            for n, sl in opt["slots"].items()}
            if "master" in opt:
                opt["master"] = {n: held(v) if n in self._trunk_names else v
                                 for n, v in opt["master"].items()}
            sd["opt_state"] = opt
        return super().set_state_dict(sd)
