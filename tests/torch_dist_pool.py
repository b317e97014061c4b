"""A pool of gloo worker processes for the port's multi-rank tests, and
the jobs they run.

``GlooPool(n, tmpdir)`` starts ``n`` processes once (start method
``spawn``, ``torch.set_num_threads(1)``); they join one gloo group through
a ``file://`` rendezvous under ``tmpdir`` (no TCP port, so parallel test
workers never collide) and take jobs over queues: ``pool.run(fn, *args)``
runs ``fn(*args)`` on every rank and returns the results in rank order,
raising with the workers' tracebacks when one failed. Jobs are module
functions here, so a worker imports torch and the port and nothing of
JAX. Each job builds its own mesh; the hybrid group is reset after it.
"""

from __future__ import annotations

import datetime
import os
import queue
import traceback

import numpy as np
import torch

JOB_TIMEOUT = 180


class GlooPool:
    def __init__(self, n: int, tmpdir: str):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n = n
        self.inq = [ctx.Queue() for _ in range(n)]
        self.outq = ctx.Queue()
        init = f"file://{os.path.join(str(tmpdir), 'rendezvous')}"
        self.procs = [ctx.Process(target=_worker,
                                  args=(r, n, init, self.inq[r], self.outq),
                                  daemon=True) for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args):
        for q in self.inq:
            q.put((fn, args))
        got = {}
        try:
            for _ in range(self.n):
                rank, ok, val = self.outq.get(timeout=JOB_TIMEOUT)
                got[rank] = (ok, val)
        except queue.Empty:
            raise AssertionError(f"{fn.__name__}: ranks {sorted(got)} "
                                 f"answered within {JOB_TIMEOUT} s") from None
        bad = {r: v for r, (ok, v) in got.items() if not ok}
        if bad:
            raise AssertionError(f"{fn.__name__} failed:\n" + "\n".join(
                f"--- rank {r}\n{v}" for r, v in sorted(bad.items())))
        return [got[r][1] for r in range(self.n)]

    def close(self):
        for q in self.inq:
            q.put(None)
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()


def _worker(rank, n, init, inq, outq):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.topology import (
        set_hybrid_communicate_group,
    )

    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n,
                            timeout=datetime.timedelta(seconds=120))
    while True:
        job = inq.get()
        if job is None:
            break
        fn, args = job
        try:
            outq.put((rank, True, fn(*args)))
        except BaseException:
            outq.put((rank, False, traceback.format_exc()))
        finally:
            set_hybrid_communicate_group(None)
    dist.destroy_process_group()


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy() if t.is_floating_point() \
            else t.detach().numpy()
    return t


def _rank():
    import torch.distributed as dist

    return dist.get_rank()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def collectives_job(mesh_kw, axis, data):
    """Every collective over ``axis`` of ``build_mesh(**mesh_kw)``;
    ``data`` maps a case to its JAX global input, of which this rank
    takes its block along the axis. Returns ``{case: numpy output}``,
    the comm log and the axis coordinate."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import stream
    from paddle_tpu_torch.observability import comm

    mesh = D.build_mesh(**mesh_kw)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    c = mesh.get_local_rank(axis)

    def block(name):
        g = torch.as_tensor(data[name])
        return g.chunk(n)[c].clone()

    out = {}
    prev = flags.flag("telemetry")
    flags.set_flags({"telemetry": True})
    comm.reset_comm_log()
    try:
        with D.sharding.mesh_context(mesh):
            for op in ("sum", "max", "min", "avg", "prod"):
                out[f"all_reduce_{op}"] = D.all_reduce(
                    block("x" if op != "prod" else "pos"), op=op, group=axis)
            out["all_gather"] = D.all_gather(block("x"), group=axis)
            out["reduce_scatter"] = D.reduce_scatter(block("rs"), group=axis)
            out["alltoall"] = D.alltoall(block("a2a"), group=axis)
            out["alltoall_single"] = D.alltoall_single(block("a2a"),
                                                       group=axis)
            splits = np.asarray(data["splits"])
            out["ragged_matrix"] = D.alltoall_single(
                block("ragged"), in_split_sizes=splits,
                out_split_sizes=splits.T, group=axis)
            # the log of the calls the JAX side makes too
            core_log = [(e["op"], e["axis"], e["traced_calls"])
                        for e in comm.comm_log()]
            lst = D.all_gather([], block("x"), group=axis)
            out["all_gather_list"] = torch.stack(lst)
            out["alltoall_list"] = torch.cat(D.alltoall(
                list(block("a2a").chunk(n)), [], group=axis))
            out["ragged_row"] = D.alltoall_single(
                block("ragged"), in_split_sizes=splits[c].tolist(),
                group=axis)
            out["broadcast"] = D.broadcast(block("x"), src=1, group=axis)
            out["reduce"] = D.reduce(block("x"), dst=1, group=axis)
            pieces = [torch.full((2,), float(i)) for i in range(n)]
            out["scatter"] = D.scatter(None, pieces, src=0, group=axis)
            out["gather"] = torch.stack(D.gather(block("x"), group=axis))
            # the JAX ring edges src -> src + 1, per rank
            x = block("x")
            src = 0
            if c == src:
                D.send(x, dst=src + 1, group=axis)
            elif c == src + 1:
                D.recv(x, src=src, group=axis)
            out["recv"] = x.clone()
            y = block("x")
            dst = n - 1
            if c == dst - 1:
                D.isend(y, dst=dst, group=axis).wait()
            elif c == dst:
                D.irecv(y, src=dst - 1, group=axis).wait()
            out["isend"] = D.wait(y.clone())
            z = block("x")
            ops = []
            if c % 2 == 0:
                ops.append(D.P2POp(D.isend, z.clone(), c + 1, axis))
            else:
                ops.append(D.P2POp(D.irecv, z, c - 1, axis))
            for t in D.batch_isend_irecv(ops):
                t.wait()
            out["batch_p2p"] = z
            D.barrier(group=axis)
            task = stream.all_reduce(block("x"), group=axis, sync_op=False)
            out["stream_all_reduce"] = task.wait()
            task = stream.all_gather(block("x"), group=axis, sync_op=False)
            out["stream_all_gather"] = task.wait()
            objs = D.all_gather_object([], {"c": c}, group=axis)
            lst = [f"from {c}", c]
            D.broadcast_object_list(lst, src=1, group=axis)
            log = [(e["op"], e["axis"], e["traced_calls"])
                   for e in comm.comm_log()]
    finally:
        flags.set_flags({"telemetry": prev})
        comm.reset_comm_log()
    return {"coord": c, "out": {k: _np(v) for k, v in out.items()},
            "objects": objs, "broadcast_objects": lst, "log": log,
            "core_log": core_log}


def groups_job():
    """``new_group``/``get_group``/``destroy_process_group`` (of a group)
    and the Fleet queries on a (dp 2, tp 2) hybrid group."""
    from paddle_tpu_torch import distributed as D

    s = D.DistributedStrategy()
    s.hybrid_configs = D.HybridConfig(dp_degree=2, mp_degree=2)
    D.fleet.init(is_collective=True, strategy=s)
    hcg = D.get_hybrid_communicate_group()
    q = {name: getattr(hcg, name)() for name in (
        "get_data_parallel_world_size", "get_data_parallel_rank",
        "get_model_parallel_world_size", "get_model_parallel_rank",
        "get_sharding_parallel_world_size", "get_sharding_parallel_rank",
        "get_pipe_parallel_world_size", "get_stage_id",
        "get_sep_parallel_world_size", "get_sep_parallel_rank",
        "get_expert_parallel_world_size", "get_expert_parallel_rank")}
    q["is_first_stage"] = hcg.is_first_stage
    q["is_last_stage"] = hcg.is_last_stage
    q["topology"] = hcg.topology()
    tpg = hcg.get_model_parallel_group()
    dpg = hcg.get_data_parallel_group()
    q["tp_group"] = (tpg.axis, tpg.nranks, tpg.rank, tpg.ranks)
    q["dp_group"] = (dpg.axis, dpg.nranks, dpg.rank, dpg.ranks)
    g = D.new_group(axis="tp")
    q["axis_group"] = (g.nranks, D.get_group(g.id) is g)
    me = _rank()
    pair = [me - me % 2, me - me % 2 + 1]
    g2 = D.new_group(ranks=pair)
    q["ranks_group_axis"] = g2.axis
    odd = D.new_group(ranks=[0, 3])
    q["odd_group_axis"] = odd.axis
    if me in (0, 3):
        q["odd_sum"] = float(D.all_reduce(torch.tensor([float(me)]),
                                          group=odd))
    t = torch.tensor([1.0])
    q["default_group_sum"] = float(D.all_reduce(t))  # the "dp" axis
    D.destroy_process_group(g)
    q["destroyed"] = D.get_group(g.id) is None
    q["fleet"] = (D.fleet.worker_index(), D.fleet.worker_num(),
                  D.fleet.is_first_worker(), D.fleet.get_strategy() is s)
    D.fleet.barrier_worker()
    m = torch.nn.Linear(2, 2)
    q["passes"] = (D.fleet.distributed_model(m) is m,
                   D.fleet.distributed_optimizer(s) is s)
    env = D.ParallelEnv()
    q["env"] = (env.rank, env.world_size, D.get_rank(), D.get_world_size(),
                D.is_initialized())
    try:
        D.build_mesh(dp=8)
        q["too_few"] = None
    except Exception as e:
        q["too_few"] = type(e).__name__
    return q


# ---------------------------------------------------------------------------
# tensor-parallel layers
# ---------------------------------------------------------------------------
class _Pair(torch.nn.Module):
    tensor_parallel = True

    def __init__(self, layer):
        super().__init__()
        self.layer = layer


def mp_layer_job(kind, tp, weights, x, dy, kw):
    """One tensor-parallel layer at tp = ``tp`` (the whole job a tp
    group; the layer built at the global shape from ``weights``, then
    placed): its output and the gradients of its parameter blocks and of
    its input, for an upstream gradient ``dy``."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.convert import load_numpy_state_dict

    import torch.distributed as dist

    mesh = D.build_mesh(dp=dist.get_world_size() // tp, tp=tp)
    gen = torch.Generator().manual_seed(0)
    if kind == "column":
        layer = D.ColumnParallelLinear(*weights["weight"].shape,
                                       has_bias="bias" in weights,
                                       device="cpu", generator=gen, **kw)
    elif kind == "row":
        layer = D.RowParallelLinear(*weights["weight"].shape,
                                    has_bias="bias" in weights,
                                    device="cpu", generator=gen, **kw)
    elif kind == "embedding":
        layer = D.VocabParallelEmbedding(*weights["weight"].shape,
                                         device="cpu", generator=gen)
    else:
        layer = D.ParallelCrossEntropy(**kw)
    if weights:
        load_numpy_state_dict(layer, weights)
    D.place_params_on_mesh(_Pair(layer), mesh, D.DistributedStrategy())
    c = mesh.get_local_rank("tp")
    if kind == "cross_entropy":
        logits, label = x
        xin = torch.as_tensor(logits).chunk(tp, -1)[c].clone()
        xin.requires_grad_(True)
        y = layer(xin, torch.as_tensor(label))
    else:
        xin = torch.as_tensor(x)
        if kind == "row" and kw.get("input_is_parallel", True):
            xin = xin.chunk(tp, -1)[c].clone()
        if xin.is_floating_point():
            xin.requires_grad_(True)
        y = layer(xin)
    (y * torch.as_tensor(dy if kind != "column" or kw.get("gather_output")
                         else np.split(dy, tp, -1)[c])).sum().backward()
    grads = {n: _np(p.grad) for n, p in layer.named_parameters()}
    return {"coord": c, "y": _np(y), "grads": grads,
            "dx": _np(xin.grad) if xin.grad is not None else None}


# ---------------------------------------------------------------------------
# auto_parallel
# ---------------------------------------------------------------------------
def auto_parallel_job(x):
    from paddle_tpu_torch import distributed as D

    pm = D.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "tp"])
    g = torch.as_tensor(x)
    y = D.shard_tensor(g, pm, [D.Shard(0), D.Shard(1)])
    out = {"local": _np(D.dtensor_to_local(y)),
           "placements": [repr(p) for p in D.get_placements(y, pm)]}
    z = D.reshard(y, pm, [D.Replicate(), D.Shard(0)])
    out["resharded_local"] = _np(D.dtensor_to_local(z))
    out["unsharded"] = _np(D.unshard_dtensor(z))
    w = D.dtensor_from_fn(torch.ones, pm, [D.Replicate(), D.Replicate()],
                          (2, 3))
    out["from_fn"] = _np(D.dtensor_to_local(w))
    p = torch.nn.Parameter(g.clone())
    q = D.shard_tensor(p, pm, [D.Shard(0), D.Replicate()])
    out["param_spec"] = q.spec
    lin = torch.nn.Linear(4, 2)
    D.shard_layer(lin, pm)
    out["layer_placements"] = [repr(pl) for pl in
                               D.get_placements(lin.weight, pm)]
    # each dp rank holds a partial sum (here: the whole x)
    part = D.auto_parallel._dt().DTensor.from_local(
        g.clone(), pm.device_mesh,
        [D.Partial().to_torch(), D.Replicate().to_torch()])
    out["partial_placements"] = [repr(pl) for pl in
                                 D.get_placements(part, pm)]
    out["partial_to_replicate"] = _np(D.unshard_dtensor(
        D.reshard(part, pm, [D.Replicate(), D.Replicate()])))
    D.set_mesh(pm)
    out["get_mesh"] = D.get_mesh() is pm
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _strategy(mesh_kw, merge_k=1):
    from paddle_tpu_torch import distributed as D

    kw = dict(mesh_kw)
    stage = kw.pop("stage", 0)
    s = D.DistributedStrategy()
    s.hybrid_configs = D.HybridConfig(dp_degree=kw.get("dp", 1),
                                      mp_degree=kw.get("tp", 1),
                                      sharding_degree=kw.get("fsdp", 1))
    if stage:
        s.sharding = True
        s.sharding_configs.stage = stage
    if merge_k > 1:
        s.gradient_merge = True
        s.gradient_merge_k_steps = merge_k
    return kw, s


def train_job(mesh_kw, state, cfg, batch, steps, opt_kw, merge_k=1,
              resume=None, family="Llama"):
    """``steps`` AdamW steps of the tiny ``family`` causal LM (Llama or
    GPT; weights ``state``) through ``TrainStep`` over
    ``build_mesh(**mesh_kw)``; the losses and the gathered parameters
    after the last step. ``resume``: a JAX ``TrainStep.state_dict``
    (numpy) to load first."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import models
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.trainer import TrainStep

    kw, s = _strategy(mesh_kw, merge_k)
    mesh = D.build_mesh(**kw)
    config = getattr(models, f"{family}Config").tiny(**cfg)
    model = getattr(models, f"{family}ForCausalLM")(config, device="cpu")
    load_numpy_state_dict(model, state)
    opt = topt.AdamW(grad_clip=topt.ClipGradByGlobalNorm(1.0), **opt_kw)
    ts = TrainStep(model, opt, mesh, s, telemetry=True)
    if resume is not None:
        ts.set_state_dict(resume)
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(ts.run(batch)))
        norms.append(float(ts.last_grad_norm))
    sd = ts.state_dict()
    return {"losses": losses, "norms": norms,
            "params": {n: _np(v) for n, v in sd["params"].items()},
            "slots": {n: {k: _np(v) for k, v in sl.items()}
                      for n, sl in sd["opt_state"]["slots"].items()},
            "local_shapes": {n: tuple(p.shape)
                             for n, p in model.named_parameters()}}


def refusals_job():
    """What a mesh refuses: tp over a model whose layers do not run it,
    a tp that does not divide the heads, a model whose loss the step
    cannot count at dp > 1, a pipeline model over pp (its step is
    ``PipelineTrainStep``), sep over a model that does not run it, and
    sep with cp."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import (
        BertConfig,
        BertForMaskedLM,
        GPTConfig,
        GPTForCausalLM,
        LlamaConfig,
        LlamaForCausalLM,
    )
    from paddle_tpu_torch.trainer import TrainStep

    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:
            out[name] = (type(e).__name__, str(e))

    _, s = _strategy(dict(dp=2, tp=2))
    catch("gpt_tp", lambda: TrainStep(
        GPTForCausalLM(GPTConfig.tiny(), device="cpu"), topt.AdamW(),
        D.build_mesh(dp=2, tp=2), s))
    _, s4 = _strategy(dict(tp=4))
    catch("heads", lambda: TrainStep(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), topt.AdamW(),
        D.build_mesh(tp=4), s4))
    _, sf = _strategy(dict(fsdp=4, stage=1))
    catch("lamb", lambda: TrainStep(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), topt.Lamb(),
        D.build_mesh(fsdp=4), sf))
    from paddle_tpu_torch.models import llama_pipeline_module

    catch("pp_mesh", lambda: TrainStep(
        llama_pipeline_module(LlamaConfig.tiny(), 2, device="cpu"),
        topt.AdamW(), D.build_mesh(pp=2, dp=2)))
    catch("gpt_sep", lambda: TrainStep(
        GPTForCausalLM(GPTConfig.tiny(), device="cpu"), topt.AdamW(),
        D.build_mesh(dp=2, sep=2)))
    s_both = D.DistributedStrategy()
    s_both.hybrid_configs = D.HybridConfig(sep_degree=2, cp_degree=2)
    catch("sep_and_cp", lambda: TrainStep(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), topt.AdamW(),
        None, s_both))
    # a masked LM's loss has no loss_count: refused over fsdp, before
    # ZeRO-3 cuts its parameters
    _, s3 = _strategy(dict(fsdp=4, stage=3))
    bert = BertForMaskedLM(BertConfig.tiny(), device="cpu")
    shapes = [tuple(p.shape) for p in bert.parameters()]
    catch("bert_fsdp", lambda: TrainStep(bert, topt.AdamW(),
                                         D.build_mesh(fsdp=4), s3))
    out["bert_uncut"] = shapes == [tuple(p.shape) for p in bert.parameters()]
    return out


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------
def batch_sampler_job(n_items, batch_size, shuffle, epochs):
    """This rank's batches of a ``DistributedBatchSampler`` built without
    ``num_replicas``/``rank`` (read from the gloo group), per epoch."""
    from paddle_tpu_torch import io

    sampler = io.DistributedBatchSampler(list(range(n_items)), batch_size,
                                         shuffle=shuffle)
    out = []
    for e in range(epochs):
        sampler.set_epoch(e)
        out.append([list(b) for b in sampler])
    return sampler.nranks, sampler.local_rank, out


# ---------------------------------------------------------------------------
# the abstract step's memory plan
# ---------------------------------------------------------------------------
def abstract_plan_job(mesh_kw, cfg, batch):
    """This rank's planned argument bytes of ``TrainStep(abstract=True)``
    over ``build_mesh(**mesh_kw)`` (the tiny Llama built under
    ``meta_init``), and the bytes the real step holds on this rank: its
    carried parameters, masters, slots, step and batch rows."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import models
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.core.meta import meta_init
    from paddle_tpu_torch.trainer import TrainStep, memplan

    kw, s = _strategy(mesh_kw)
    out = {}
    for abstract in (True, False):
        mesh = D.build_mesh(**kw)
        config = models.LlamaConfig.tiny(**cfg)
        if abstract:
            with meta_init():
                model = models.LlamaForCausalLM(config, device="cpu")
        else:
            model = models.LlamaForCausalLM(config, device="cpu")
        ts = TrainStep(model, topt.AdamW(1e-3, multi_precision=True), mesh,
                       s, abstract=abstract)
        if abstract:
            ma = ts.lower(batch).compile().memory_analysis()
            out["planned"] = ma.argument_size_in_bytes
            out["alias"] = ma.alias_size_in_bytes
            out["meta"] = all(p.device.type == "meta"
                              for p in model.parameters())
        else:
            out["held"] = memplan.nbytes(
                {n: p for n, p in ts._param_objs.items()
                 if n not in ts._master_dtypes}) \
                + memplan.nbytes(ts.opt_state) \
                + memplan.nbytes(ts.shard_batch(batch))
    return out
