"""Abstract parameters (``paddle_tpu_torch/core/meta.py``) and
``TrainStep(abstract=True)`` with ``lower(...).compile().memory_analysis()``
(``trainer/memplan.py``) against the JAX package
(``tests/test_memplan.py``'s meta-init and abstract-step cases):

- ``meta_init`` makes every parameter a ``meta`` tensor that keeps its
  initializer, buffers stay concrete, ``to(dtype)`` recasts them, and
  ``materialize`` draws a runnable model (the same values as a model
  built with that generator's draws);
- the abstract step holds no parameter memory and ``run`` raises; its
  planned argument bytes are exactly the bytes the real step holds
  (parameters it carries, masters, slots, step, batch), paired and
  master-only; output and alias bytes follow JAX's donation; the fake
  run's temp is positive and bounded;
- over 4 gloo ranks at fsdp 2 x tp 2 with ZeRO-3, each rank's planned
  argument bytes equal that rank's real tensors, and JAX's
  ``argument_size_in_bytes`` of the same step (whose rng key, unused by
  a model that draws nothing, is pruned from its arguments).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import models
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import device as core_device
from paddle_tpu_torch.core.meta import is_abstract, materialize, meta_init
from paddle_tpu_torch.trainer import TrainStep, memplan

import torch_dist_pool as tdp


@pytest.fixture(autouse=True)
def on_cpu():
    saved = core_device._current
    tpt.set_device("cpu")
    yield
    core_device.set_current(saved)


def test_meta_init_builds_abstract_params():
    with meta_init():
        model = models.LlamaForCausalLM(models.LlamaConfig.tiny(),
                                        device="cpu")
    params = dict(model.named_parameters())
    assert params and all(is_abstract(p) for p in params.values())
    assert all(callable(p.init_fn) for p in params.values())
    assert all(not is_abstract(b) for b in model.buffers())
    model.to(torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 and is_abstract(p)
               for p in model.parameters())
    model.to(torch.float32)
    materialize(model, seed=0)
    assert not any(is_abstract(p) for p in model.parameters())
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, 16)))
    loss = model(ids, labels=ids)
    assert torch.isfinite(loss)
    # the same seed draws the same values; names, specs and ties kept
    with meta_init():
        again = models.LlamaForCausalLM(models.LlamaConfig.tiny(),
                                        device="cpu")
    materialize(again, seed=0)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
        assert a.name == b.name and a.spec == b.spec


def _bf16_cfg():
    return dataclasses.replace(models.LlamaConfig.tiny(), dtype="bfloat16")


def _step(cfg, abstract, residency):
    if abstract:
        with meta_init():
            model = models.LlamaForCausalLM(cfg, device="cpu")
    else:
        model = models.LlamaForCausalLM(cfg, device="cpu")
    opt = topt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                     multi_precision=True,
                     grad_clip=topt.ClipGradByGlobalNorm(1.0))
    return TrainStep(model, opt, abstract=abstract,
                     master_residency=residency)


@pytest.mark.parametrize("cfg,residency", [
    (models.LlamaConfig.tiny(), "paired"),
    (_bf16_cfg(), "paired"),
    (_bf16_cfg(), "master_only")], ids=["f32", "bf16-paired",
                                        "bf16-master-only"])
def test_abstract_step_plans_the_real_steps_bytes(cfg, residency):
    batch = {"input_ids": np.zeros((2, 32), np.int64),
             "labels": np.zeros((2, 32), np.int64)}
    ts = _step(cfg, True, residency)
    with pytest.raises(RuntimeError, match="abstract"):
        ts.run(batch)
    assert all(is_abstract(p) for p in ts.model.parameters()
               if p.requires_grad)
    ma = ts.lower(batch).compile().memory_analysis()
    real = _step(cfg, False, residency)
    held = memplan.nbytes({n: p for n, p in real._param_objs.items()
                           if n not in real._master_dtypes}) \
        + memplan.nbytes(real.opt_state) \
        + memplan.nbytes(real.shard_batch(batch))
    assert ma.argument_size_in_bytes == held
    batch_bytes = 2 * 2 * 32 * 8
    assert ma.alias_size_in_bytes == held - batch_bytes
    assert ma.output_size_in_bytes == ma.alias_size_in_bytes + 4
    # the step's transients: at least the gradients, and less than ten
    # times the state
    grads = memplan.nbytes({n: p for n, p in real._param_objs.items()})
    assert grads <= ma.temp_size_in_bytes < 10 * held
    real.run(batch)  # the real step runs where the plan was made


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = tdp.GlooPool(4, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _jax_argument_bytes(batch):
    from paddle_tpu import distributed as jdist
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.core.meta import meta_init as jmeta_init
    from paddle_tpu.distributed.strategy import (
        DistributedStrategy,
        HybridConfig,
    )
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu.trainer import TrainStep as JTrainStep

    with jmeta_init():
        model = LlamaForCausalLM(LlamaConfig.tiny(use_flash_attention=False))
    mesh = jdist.build_mesh(fsdp=2, tp=2, devices=jax.devices()[:4])
    s = DistributedStrategy()
    s.hybrid_configs = HybridConfig(sharding_degree=2, mp_degree=2)
    s.sharding = True
    s.sharding_configs.stage = 3
    ts = JTrainStep(model, jopt.AdamW(1e-3, multi_precision=True), mesh, s,
                    abstract=True)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, jnp.int32)
              for k, v in batch.items()}
    lowered = ts.lower(shapes)
    return lowered.compile().memory_analysis().argument_size_in_bytes


def test_abstract_plan_over_four_gloo_ranks_matches_real_and_jax(pool):
    batch = {"input_ids": np.zeros((2, 32), np.int32),
             "labels": np.zeros((2, 32), np.int32)}
    res = pool.run(tdp.abstract_plan_job,
                   dict(fsdp=2, tp=2, stage=3),
                   dict(use_flash_attention=False), batch)
    for r in res:
        assert r["meta"] and r["planned"] == r["held"], r
    # JAX's step takes an rng key too, but this model draws nothing, so
    # jit prunes the unused argument: the terms are the same on both sides
    want = _jax_argument_bytes(batch)
    assert [r["planned"] for r in res] == [want] * 4
