"""Jobs of the port's multi-rank tests of checkpoints, pipelines, sequence
and expert parallelism (``tests/test_torch_checkpoint.py``,
``test_torch_pipeline.py``, ``test_torch_seq_parallel.py`` and the
expert-parallel cases of ``test_torch_moe.py``), run by
``torch_dist_pool.GlooPool``.

Each job is a function of this module, so a worker imports torch and the
port and nothing of JAX. A job builds its own mesh; a rank outside the
mesh returns None. Inputs are the JAX side's global arrays, of which
each rank takes its block; outputs are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from torch_dist_pool import _np, _strategy


def _mesh(mesh_kw):
    from paddle_tpu_torch import distributed as D

    kw = {k: v for k, v in mesh_kw.items() if k != "stage"}
    mesh = D.build_mesh(**kw)
    return mesh if mesh.get_coordinate() is not None else None


def _rows(mesh, x):
    """This rank's (dp, fsdp) block of the rows of ``x``."""
    from paddle_tpu_torch.distributed import sharding as shd

    lo, hi, _ = shd.dim_range(x.shape[0], ("dp", "fsdp"), mesh)
    return torch.as_tensor(np.asarray(x))[lo:hi].clone()


def _reduce_grads(model, mesh, axes=("dp", "fsdp")):
    """Every parameter's gradient summed over ``axes``, then gathered
    from the blocks to the global shape."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import sharding as shd

    out = {}
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        g = g.contiguous()
        for a in axes:
            if shd._size(mesh, a) > 1:
                dist.all_reduce(g, group=mesh.get_group(a))
        out[n] = _np(shd.gather_full(g, p.placement, p.global_shape, mesh))
    return out


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------
def moe_layer_job(kind, kw, mesh_kw, state, x):
    """A MoE layer (``kind`` of ``distributed.moe``, weights ``state``)
    over ``build_mesh(**mesh_kw)``: this rank's rows of ``y``, the aux
    loss, and the global gradients of ``sum(y**2) + aux`` (each rank's
    aux term over the dp x fsdp ranks, so the sum counts it once)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.distributed import moe, sharding as shd

    mesh = _mesh(mesh_kw)
    if mesh is None:
        return None
    layer = getattr(moe, kind)(x.shape[-1], kw.pop("num_experts"),
                               device="cpu", **kw)
    load_numpy_state_dict(layer, state)
    D.place_params_on_mesh(layer, mesh, D.DistributedStrategy())
    local = {n: tuple(p.shape) for n, p in layer.named_parameters()}
    xl = _rows(mesh, x)
    with shd.mesh_context(mesh):
        y, aux = layer(xl)
    n_rows = shd._size(mesh, "dp") * shd._size(mesh, "fsdp")
    ((y.float() ** 2).sum() + aux / n_rows).backward()
    return {"y": _np(y), "aux": float(aux), "grads": _reduce_grads(layer,
                                                                   mesh),
            "local_shapes": local,
            "drop": float(layer.last_drop_fraction)}


def moe_train_job(mesh_kw, state, cfg, batch, steps, opt_kw):
    """``steps`` AdamW steps of the tiny ERNIE-MoE through ``TrainStep``
    over the mesh: the losses and the gathered parameters."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.models import ErnieMoEConfig, ErnieMoEForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    kw, s = _strategy(mesh_kw)
    s.hybrid_configs.ep_degree = kw.get("ep", 1)
    mesh = _mesh(mesh_kw)
    if mesh is None:
        return None
    model = ErnieMoEForCausalLM(ErnieMoEConfig.tiny(**cfg), device="cpu")
    load_numpy_state_dict(model, state)
    ts = TrainStep(model, topt.AdamW(
        grad_clip=topt.ClipGradByGlobalNorm(1.0), **opt_kw), mesh, s)
    losses = [float(ts.run(batch)) for _ in range(steps)]
    sd = ts.state_dict()
    return {"losses": losses,
            "params": {n: _np(v) for n, v in sd["params"].items()},
            "local_shapes": {n: tuple(p.shape)
                             for n, p in model.named_parameters()}}


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------
def pipeline_apply_job(ws, x, n_micro):
    """GPipe at pp = world: stage s is ``tanh(mb @ ws[s])``; the outputs
    (on the last stage) and each stage's gradient of ``sum(y**2)``."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.pipeline import pipeline_apply

    pp = dist.get_world_size()
    mesh = _mesh(dict(pp=pp))
    s = mesh.get_local_rank("pp")
    w = torch.as_tensor(ws[s]).requires_grad_()
    ys = pipeline_apply(lambda p, mb: torch.tanh(mb @ p["w"]), {"w": w},
                        torch.as_tensor(x), mesh=mesh, n_micro=n_micro)
    last = s == pp - 1
    ((ys ** 2).sum() if last else ys.sum()).backward()
    return {"ys": _np(ys) if last else None, "gw": _np(w.grad)}


def pipeline_layer_job(stacked, x, n_micro, pp):
    """``PipelineLayer`` of ``nn.Linear(16, 16)`` (weights ``stacked``)
    over pp: the output on the last stage."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.distributed.pipeline import (
        LayerDesc,
        PipelineLayer,
    )

    mesh = _mesh(dict(pp=pp))
    if mesh is None:
        return None
    n = stacked["weight"].shape[0]
    trunk = PipelineLayer(LayerDesc(nn.Linear, 16, 16, device="cpu"), n,
                          num_stages=pp)
    load_numpy_state_dict(trunk, stacked)
    with torch.no_grad():
        y = trunk(torch.as_tensor(x), n_micro=n_micro, mesh=mesh)
    return _np(y) if mesh.get_local_rank("pp") == pp - 1 else None


def _f1b_fns():
    def first(fp, x):
        return torch.tanh(x @ fp["emb"])

    def stage(cp, h):
        return torch.tanh(h @ cp["w"] + cp["b"])

    def last(lp, y, aux):
        return ((y @ lp["head"] - aux) ** 2).mean()

    return first, stage, last


def f1b_job(fp, sp, lp, x, aux, pp, vpp):
    """``pipeline_1f1b_step`` at (pp, vpp): rank s passes virtual stages
    s, s + pp, ... of ``sp``; the loss, the first/last gradients and this
    rank's chunks' gradients with their virtual stages."""
    from paddle_tpu_torch.distributed.pipeline import pipeline_1f1b_step

    mesh = _mesh(dict(pp=pp))
    if mesh is None:
        return None
    s = mesh.get_local_rank("pp")
    vs = [c * pp + s for c in range(vpp)]
    t = {k: torch.as_tensor(v) for k, v in sp.items()}
    mine = {k: v[vs] for k, v in t.items()}
    first, stage, last = _f1b_fns()
    loss, dfp, dsp, dlp = pipeline_1f1b_step(
        first, stage, last, {k: torch.as_tensor(v) for k, v in fp.items()},
        mine, {k: torch.as_tensor(v) for k, v in lp.items()},
        torch.as_tensor(x), torch.as_tensor(aux), mesh=mesh, vpp=vpp)
    return {"loss": float(loss), "vs": vs,
            "dfp": {k: _np(v) for k, v in dfp.items()},
            "dsp": {k: _np(v) for k, v in dsp.items()},
            "dlp": {k: _np(v) for k, v in dlp.items()}}


def _tied_descs(vocab, h, L):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.pipeline import (
        LayerDesc,
        SharedLayerDesc,
    )

    return ([SharedLayerDesc("emb", nn.Embedding, vocab, h, device="cpu")]
            + [LayerDesc(nn.Linear, h, h, device="cpu") for _ in range(L)]
            + [SharedLayerDesc("emb", nn.Embedding, vocab, h,
                               forward_func=_tied_logits, device="cpu")])


def _tied_logits(layer, x):
    return x @ layer.weight.T


def _onehot_mse(logits, labels):
    return ((logits - torch.nn.functional.one_hot(
        labels.long(), logits.shape[-1]).to(logits.dtype)) ** 2).mean()


def _llama_ce(logits, labels):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def pipeline_forward_job(state, L, ids, pp, n_micro):
    """The tied module's forward over pp: the logits on the last stage."""
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.distributed.pipeline import PipelineModule

    mesh = _mesh(dict(pp=pp))
    if mesh is None:
        return None
    m = PipelineModule(_tied_descs(12, 16, L), num_stages=pp)
    load_numpy_state_dict(m, state)
    with torch.no_grad():
        out = m(torch.as_tensor(ids), n_micro=n_micro, mesh=mesh)
    return _np(out) if mesh.get_local_rank("pp") == pp - 1 else None


def pipeline_train_job(kind, mesh_kw, state, cfg, schedule, vpp, n_micro,
                       ids, labels, steps, opt, stage=0, recompute=False):
    """``steps`` steps of ``PipelineTrainStep`` over a ``kind`` module
    ("tied": the embedding/Linear trunk/tied head, ``cfg`` its L;
    "llama": ``llama_pipeline_module(LlamaConfig.tiny(**cfg))``): the
    losses, the gathered parameters and the held trunk layers' shape."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.distributed.pipeline import PipelineModule
    from paddle_tpu_torch.models import LlamaConfig, llama_pipeline_module

    mesh = _mesh(mesh_kw)
    if mesh is None:
        return None
    if kind == "tied":
        m = PipelineModule(_tied_descs(12, 16, cfg), num_stages=mesh_kw["pp"])
        loss_fn = _onehot_mse
    else:
        m = llama_pipeline_module(LlamaConfig.tiny(**cfg),
                                  num_stages=mesh_kw["pp"], device="cpu")
        loss_fn = _llama_ce
    load_numpy_state_dict(m, state)
    s = D.DistributedStrategy()
    s.pipeline_configs.schedule_mode = schedule
    s.pipeline_configs.vpp_degree = vpp
    s.pipeline_configs.accumulate_steps = n_micro
    s.recompute = recompute
    if stage:
        s.sharding = True
        s.sharding_configs.stage = stage
    name, kw = opt
    ts = D.PipelineTrainStep(m, getattr(topt, name)(**kw), mesh, s, loss_fn)
    losses = [float(ts.run(ids, labels)) for _ in range(steps)]
    sd = ts.state_dict()
    return {"losses": losses,
            "params": {n: _np(v) for n, v in sd["params"].items()},
            "held": list(m.trunk.held),
            "local": {n: tuple(p.shape) for n, p in m.named_parameters()}}


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------
def attention_job(kind, q, k, v, causal, n, grads, tp=1):
    """Ring (``kind`` "ring") or Ulysses attention over sep = ``n`` (x tp):
    this rank's sequence block of the output and, with ``grads``, of the
    gradients of ``sum(out**2)`` by q, k and v."""
    from paddle_tpu_torch.distributed import sharding as shd
    from paddle_tpu_torch.kernels.ring_attention import ring_attention
    from paddle_tpu_torch.kernels.ulysses import ulysses_attention

    mesh = _mesh(dict(sep=n, tp=tp))
    if mesh is None:
        return None
    c = mesh.get_local_rank("sep")
    t = shd._coord(mesh, "tp")

    def block(a):
        a = torch.as_tensor(a)
        a = a.chunk(tp, dim=2)[t]          # this rank's tp heads
        return a.chunk(n, dim=1)[c].clone().requires_grad_(grads)

    ql, kl, vl = block(q), block(k), block(v)
    with shd.mesh_context(mesh):
        if kind == "ring":
            out = ring_attention(ql, kl, vl, mesh=mesh, causal=causal)
        else:
            out = ulysses_attention(ql, kl, vl, causal=causal,
                                    use_flash=False)
    res = {"out": _np(out), "sep": c, "tp": t}
    if grads:
        (out ** 2).sum().backward()
        res.update(dq=_np(ql.grad), dk=_np(kl.grad), dv=_np(vl.grad))
    return res


def sep_train_job(mesh_kw, state, cfg, batch, steps, opt_kw):
    """``steps`` AdamW steps of the tiny Llama through ``TrainStep`` over a
    mesh with a sep axis (``mesh_kw``'s ``sep`` or ``cp``): the losses and
    the gathered parameters."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    kw = dict(mesh_kw)
    s = D.DistributedStrategy()
    s.hybrid_configs = D.HybridConfig(
        dp_degree=kw.get("dp", 1), mp_degree=kw.get("tp", 1),
        sharding_degree=kw.get("fsdp", 1), sep_degree=kw.get("sep", 1),
        cp_degree=kw.get("cp", 1))
    if kw.pop("stage", 0):
        s.sharding = True
        s.sharding_configs.stage = 3
    model = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_numpy_state_dict(model, state)
    # no mesh given: the step builds it from the strategy (cp on sep)
    ts = TrainStep(model, topt.AdamW(
        grad_clip=topt.ClipGradByGlobalNorm(1.0), **opt_kw), None, s)
    losses = [float(ts.run(batch)) for _ in range(steps)]
    sd = ts.state_dict()
    return {"losses": losses,
            "params": {n: _np(v) for n, v in sd["params"].items()},
            "local_batch": {n: tuple(v.shape)
                            for n, v in ts.shard_batch(batch).items()}}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def ckpt_reshard_job(path, arrays, save_kw, save_specs, load_kw, load_specs,
                     bf16=False):
    """Save this rank's block of each of ``arrays`` (spec ``save_specs``
    over ``build_mesh(**save_kw)``), then load each at ``load_specs`` over
    ``build_mesh(**load_kw)``: the loaded blocks and their slices."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed import sharding as shd

    mesh = _mesh(save_kw)
    state = {}
    for n, a in arrays.items():
        t = torch.as_tensor(a)
        t = t.to(torch.bfloat16) if bf16 else t
        spec = save_specs[n]
        state[n] = ckpt.Sharded(shd.cut(t, spec, mesh), tuple(t.shape),
                                spec, mesh)
    ckpt.save_state_dict(state, path)
    mesh2 = _mesh(load_kw)
    loaded = ckpt.load_state_dict(path, shardings={
        n: shd.Sharding(mesh2, s) for n, s in load_specs.items()})
    out = {}
    for n, t in loaded.items():
        sl = shd.block_slices(tuple(arrays[n].shape), load_specs[n], mesh2)
        out[n] = (_np(t), [(s.start, s.stop) for s in sl], str(t.dtype))
    return out


def ckpt_train_job(mesh_kw, state, batch, steps, opt_kw, load=None,
                   save=None, sharded=True, async_save=False):
    """The tiny Llama's ``TrainStep`` over the mesh from the weights
    ``state``: with ``load``, this rank's blocks of a checkpoint restored
    first (``state_shardings``); ``steps`` steps; with ``save``, the state
    saved (this rank's blocks, or gathered), by ``AsyncCheckpointer`` with
    ``async_save``. The losses and the gathered parameters."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    kw, s = _strategy(mesh_kw)
    mesh = _mesh(mesh_kw)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_numpy_state_dict(model, state)
    ts = TrainStep(model, topt.AdamW(
        grad_clip=topt.ClipGradByGlobalNorm(1.0), **opt_kw), mesh, s)
    if load is not None:
        ts.set_state_dict(ckpt.load_state_dict(
            load, shardings=ts.state_shardings()))
    losses = [float(ts.run(batch)) for _ in range(steps)]
    if save is not None:
        sd = ts.state_dict(sharded=sharded)
        if async_save:
            saver = ckpt.AsyncCheckpointer()
            saver.save(sd, save)
            saver.wait_until_finished()
        else:
            ckpt.save_state_dict(sd, save)
    gathered = ts.state_dict()
    return {"losses": losses, "step": gathered["step"],
            "params": {n: _np(v) for n, v in gathered["params"].items()}}


def moe_refusal_job():
    """A dropless MoE layer at ep = 4 over 6 tokens: the name of what it
    raises (before any collective)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import moe, sharding as shd

    mesh = _mesh(dict(ep=4))
    layer = moe.DroplessMoELayer(8, 4, d_hidden=16, device="cpu")
    D.place_params_on_mesh(layer, mesh, D.DistributedStrategy())
    try:
        with shd.mesh_context(mesh):
            layer(torch.zeros((2, 3, 8)))
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def pipeline_ckpt_job(state, load, save, ids, labels, steps, opt_kw):
    """The tied module's ``PipelineTrainStep`` at dp 2 x pp 2 (1F1B, 2
    micro-batches, AdamW ``opt_kw``): the state of checkpoint ``load``
    (a JAX ``{"params", "opt_state"}``) restored, ``steps`` steps, its
    gathered state saved to ``save``; the losses and the parameters.
    (Every rank of the job saves and loads: the barriers are the
    world's.)"""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed.pipeline import PipelineModule

    mesh = _mesh(dict(dp=2, pp=2))
    m = PipelineModule(_tied_descs(12, 16, 4), num_stages=2)
    load_numpy_state_dict(m, state)
    s = D.DistributedStrategy()
    s.pipeline_configs.accumulate_steps = 2
    ts = D.PipelineTrainStep(m, topt.AdamW(**opt_kw), mesh, s, _onehot_mse)
    ts.set_state_dict(ckpt.load_state_dict(load))
    losses = [float(ts.run(ids, labels)) for _ in range(steps)]
    sd = ts.state_dict()
    ckpt.save_state_dict(sd, save)
    return {"losses": losses,
            "params": {n: _np(v) for n, v in sd["params"].items()}}
