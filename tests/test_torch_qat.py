"""Quantization-aware training and PTQ in the port
(``paddle_tpu_torch/quantization/{__init__,qat,observer}.py``) against
the JAX package on the CPU, from the same numpy weights and inputs:
``FakeQuant``'s forward, straight-through gradient and EMA against the
JAX layer run eagerly; ``QuantConfig``'s semantics; the five observers'
scales; PTQ's ``act_scale`` through ``state_dict``; a QAT tiny Mamba
trained 5 ``TrainStep`` steps against the JAX ``TrainStep`` (each step
from the JAX step's state within 1e-5, the free-running trajectory within
1e-4), its ``amax`` buffers against the JAX layers' EMA over the same
per-step forwards, its eval logits in the JAX model, and the logits
after ``QAT.convert`` to int8 and int4."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import quantization as JQ
from paddle_tpu.models import MambaConfig as JConfig
from paddle_tpu.models import MambaForCausalLM as JModel
from paddle_tpu.trainer import TrainStep as JTrainStep
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import quantization as TQ
from paddle_tpu_torch.convert import (
    load_numpy_state_dict,
    load_numpy_train_state,
)
from paddle_tpu_torch.models import MambaConfig, MambaForCausalLM
from paddle_tpu_torch.trainer import TrainStep

CFG = dict(use_chunked_scan=True, scan_chunk=16)


@pytest.fixture
def on_cpu():
    from paddle_tpu_torch.core import device as core_device

    saved = core_device._current
    tdevice.set_device("cpu")
    yield
    core_device.set_current(saved)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _state(jlayer):
    return {k: np.asarray(v) for k, v in jlayer.state_dict().items()}


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ------------------------------------------------------------- FakeQuant
@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_forward_gradient_and_ema_match_jax_eager(bits, on_cpu):
    """Training forwards over three batches (the batch max, the EMA moving
    after each), then an eval forward at the EMA: outputs and ``amax``
    equal to the JAX layer's eager ones; the gradient is the identity
    (straight through), as ``jax.grad``'s."""
    tq, jq = TQ.FakeQuant(bits=bits), JQ.FakeQuant(bits=bits)
    assert tq.qmax == jq.qmax == 2 ** (bits - 1) - 1
    for i in range(3):
        x = _x(4, 33, seed=i, scale=1.0 + i)
        _close(tq(torch.from_numpy(x)), jq(jnp.asarray(x)))
        _close(tq.amax, jq._buffers["amax"])
    assert float(tq.amax) != 1.0
    x = _x(4, 33, seed=7, scale=5.0)
    tq.eval()
    jq.eval()
    y = tq(torch.from_numpy(x))
    _close(y, jq(jnp.asarray(x)))
    # eval clips to the EMA's range
    assert float(y.abs().max()) <= float(tq.amax) * (1 + 1e-6)
    tq.train()
    w = _x(4, 33, seed=8)
    xt = torch.from_numpy(x).requires_grad_()
    (tq(xt) * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda v: (jq(v) * jnp.asarray(w)).sum())(jnp.asarray(x))
    _close(xt.grad, jg)
    _close(xt.grad, w)


def test_fake_quant_rounds_half_to_even_and_keeps_bf16_sums_float32(on_cpu):
    fq = TQ.FakeQuant(bits=8)
    # amax 127: scale 1, so x / scale lands on .5 exactly
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    np.testing.assert_array_equal(fq(x).numpy(),
                                  [0.0, 2.0, 2.0, -0.0, -2.0, 127.0])
    jx = jnp.asarray(_x(3, 8, seed=3), jnp.bfloat16)
    y = TQ.FakeQuant()(torch.from_numpy(np.asarray(jx, np.float32)).to(
        torch.bfloat16))
    jy = JQ.FakeQuant()(jx)
    assert y.dtype == torch.float32 and jy.dtype == jnp.float32
    _close(y, jy)


# -------------------------------------------------- QuantConfig, observers
def test_quantconfig_instance_template_and_none_semantics(on_cpu):
    """The port of the JAX package's test of the same name."""
    cfg = TQ.QuantConfig(activation=TQ.FakeQuant(bits=4), weight=None)
    model = tnn.Sequential(tnn.Linear(16, 16), tnn.Linear(16, 16))
    qm = TQ.QAT(cfg).quantize(model, inplace=False)
    qls = [m for m in qm.sublayers(include_self=True)
           if isinstance(m, TQ.QuantedLinear)]
    assert len(qls) == 2
    assert qls[0].act_quanter is not qls[1].act_quanter
    assert qls[0].act_quanter.qmax == 7
    assert all(q.wt_quanter is None for q in qls)
    # the original is untouched (inplace=False deep-copies)
    assert not any(isinstance(m, TQ.QuantedLinear) for m in model)
    cfg2 = TQ.QuantConfig(activation=None, weight=None)
    qm2 = TQ.QAT(cfg2).quantize(model, inplace=False)
    assert not any(isinstance(m, TQ.QuantedLinear)
                   for m in qm2.sublayers(include_self=True))
    cfg3 = TQ.QuantConfig(activation=TQ.FakeQuant(bits=4))
    lyr = model[0]
    cfg3.add_layer_config(lyr, weight=None)
    got = cfg3._for(lyr)
    assert got["weight"] is None and got["activation"] is not None
    cfg4 = TQ.QuantConfig().add_type_config(tnn.Linear, activation=None)
    assert cfg4._for(lyr)["activation"] is None
    assert cfg4._for(lyr)["weight"] is TQ.UNSET


def test_observers_scales_match_jax():
    """Absmax, EMA, Percentile (its reservoir over batches larger than
    it) and MSE: the same scales as JAX; BaseObserver has none."""
    batches = [_x(4096, seed=i, scale=1 + i) for i in range(4)]
    batches[2][5] = 40.0  # an outlier
    for name, kw in (("AbsmaxObserver", {}), ("EMAObserver", {}),
                     ("PercentileObserver", dict(percentile=99.0,
                                                 max_samples=5000)),
                     ("MSEObserver", {})):
        tobs, jobs = getattr(TQ, name)(**kw), getattr(JQ, name)(**kw)
        for b in batches:
            out = tobs(torch.from_numpy(b))
            jobs(jnp.asarray(b))
            assert torch.equal(out, torch.from_numpy(b))
        for qmax in (127, 7):
            np.testing.assert_allclose(tobs.scale(qmax), jobs.scale(qmax),
                                       rtol=1e-6, err_msg=name)
    with pytest.raises(NotImplementedError):
        TQ.BaseObserver().scale()


# --------------------------------------------------------------------- PTQ
def test_ptq_act_scale_through_state_dict_matches_jax(on_cpu):
    """PTQ with AbsmaxObserver: calibrate on 3 batches, convert int8; the
    ``act_scale`` (a float assigned to the buffer) equals JAX's, survives
    ``state_dict`` and loads into the port from the JAX converted model
    with no renaming; the converted outputs agree."""
    jm = jnn.Sequential(jnn.Linear(16, 16), jnn.ReLU(), jnn.Linear(16, 8))
    tm = tnn.Sequential(tnn.Linear(16, 16), tnn.ReLU(), tnn.Linear(16, 8))
    tm.set_state_dict(_state(jm))
    tp = TQ.PTQ().quantize(tm, inplace=False)
    jp = JQ.PTQ().quantize(jm, inplace=False)
    for i in range(3):
        x = _x(8, 16, seed=20 + i, scale=1 + i)
        tp(torch.from_numpy(x))
        jp(jnp.asarray(x))
    tinf = TQ.PTQ().convert(tp, inplace=False)
    jinf = JQ.PTQ().convert(jp, inplace=False)
    sd, jsd = tinf.state_dict(), _state(jinf)
    assert set(sd) == set(jsd)
    for key in ("0.act_scale", "2.act_scale"):
        assert isinstance(tinf[int(key[0])].act_scale, torch.Tensor)
        assert float(sd[key]) > 0
        np.testing.assert_allclose(float(sd[key]), float(jsd[key]),
                                   rtol=1e-6)
    x = _x(8, 16, seed=30)
    _close(tinf(torch.from_numpy(x)), jinf(jnp.asarray(x)), 1e-5)
    fresh = tnn.Sequential(
        TQ.WeightOnlyLinear(16, 16), tnn.ReLU(), TQ.WeightOnlyLinear(16, 8))
    load_numpy_state_dict(fresh, jsd)
    _close(fresh(torch.from_numpy(x)), jinf(jnp.asarray(x)), 1e-5)
    np.testing.assert_allclose(float(fresh[0].act_scale),
                               float(jsd["0.act_scale"]))


# ------------------------------------------------------ QAT on tiny Mamba
def _qat_tiny(jstate):
    """The port's QAT tiny Mamba with the JAX QAT state (source weights and
    ``amax`` buffers) loaded with no renaming, and its ``TrainStep``."""
    model = TQ.QAT(TQ.QuantConfig()).quantize(
        MambaForCausalLM(MambaConfig.tiny(**CFG), device="cpu"))
    load_numpy_state_dict(model, jstate)
    return model, TrainStep(model, topt.AdamW(**OPT))


OPT = dict(learning_rate=3e-3, weight_decay=0.01, multi_precision=True)


@pytest.fixture(scope="module")
def qat_runs():
    """A tiny float32 Mamba (chunked scan, chunk 16) made QAT by both
    packages, 5 AdamW ``TrainStep`` steps on one batch each. The port
    runs twice: free, and with the JAX step's state (parameters, Adam
    moments, step count) loaded before each of its steps."""
    pt.seed(5)
    jmodel = JQ.QAT(JQ.QuantConfig()).quantize(JModel(JConfig.tiny(**CFG)))
    jstate = _state(jmodel)
    js = JTrainStep(jmodel, jopt.AdamW(**OPT),
                    jdist.build_mesh(devices=jax.devices()[:1]))
    ids = np.random.default_rng(0).integers(0, 256, (2, 32))
    batch = {"input_ids": ids, "labels": ids}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlosses, jsteps = [], []
    for _ in range(6):
        jsteps.append(jax.tree_util.tree_map(np.asarray, js.state_dict()))
        if len(jsteps) <= 5:
            jlosses.append(float(js.run(jbatch)))
    free, ts = _qat_tiny(jstate)
    free_losses = [float(ts.run(batch)) for _ in range(5)]
    synced, ts = _qat_tiny(jstate)
    synced_losses = []
    for k in range(5):
        load_numpy_train_state(ts, jsteps[k])
        synced_losses.append(float(ts.run(batch)))
    return dict(jmodel=jmodel, jstate=jstate, ids=ids, jlosses=jlosses,
                jsteps=jsteps, free=free, free_losses=free_losses,
                synced=synced, synced_losses=synced_losses,
                synced_params=ts.state_dict()["params"])


def test_qat_mamba_quantizes_the_mixer_linears(qat_runs):
    tmodel, jstate = qat_runs["free"], qat_runs["jstate"]
    quanted = [m for m in tmodel.sublayers() if isinstance(m,
                                                           TQ.QuantedLinear)]
    assert len(quanted) == 4 * 2
    assert sum(isinstance(m, TQ.FakeQuant) for m in tmodel.sublayers()) == 16
    keys = set(tmodel.state_dict())
    assert keys == set(jstate) and len(keys) == 22 + 16
    assert "layers.0.mixer.in_proj.source.weight" in keys
    assert "layers.1.mixer.out_proj.act_quanter.amax" in keys


def test_qat_mamba_train_step_losses_match_jax(qat_runs):
    """Each of the 5 steps from the JAX step's state: the loss within 1e-5
    of JAX's, and after the last update every parameter within 1e-5 of
    JAX's (relative to its norm). The free-running trajectory stays
    within 1e-4: fake-quant rounding turns float noise into whole
    quantization steps, and in the port alone a 1e-7 relative change of
    the starting weights moves the fifth loss by 2.4e-5 (2e-7 without
    QAT), so 1e-5 is not a bound two implementations can hold there."""
    np.testing.assert_allclose(qat_runs["synced_losses"],
                               qat_runs["jlosses"], rtol=1e-5)
    final = qat_runs["jsteps"][5]["params"]
    for name, p in qat_runs["synced_params"].items():
        gap = np.linalg.norm(_np(p) - final[name]) / max(
            np.linalg.norm(final[name]), 1e-30)
        assert gap <= 1e-5, (name, gap)
    np.testing.assert_allclose(qat_runs["free_losses"], qat_runs["jlosses"],
                               rtol=1e-4)
    for losses in (qat_runs["free_losses"], qat_runs["synced_losses"]):
        assert losses[-1] < losses[0]


def test_qat_amax_is_the_ema_of_the_per_step_maxima(qat_runs):
    """Every training forward of the port's step moves each ``amax``: after
    5 steps from the JAX states it equals what the JAX layers reach
    eagerly from 1.0 over forwards at the same 5 parameter sets. The JAX
    ``TrainStep`` itself leaves every ``amax`` at 1.0 (its jitted forward
    never updates it: ROADMAP Queue C)."""
    tmodel, jmodel = qat_runs["synced"], qat_runs["jmodel"]
    assert all(float(v) == 1.0 for k, v in jmodel.state_dict().items()
               if k.endswith("amax"))
    pt.seed(5)
    eager = JQ.QAT(JQ.QuantConfig()).quantize(JModel(JConfig.tiny(**CFG)))
    eager.set_state_dict(qat_runs["jstate"])
    for state in qat_runs["jsteps"][:5]:
        eager.set_state_dict(state["params"])
        eager(jnp.asarray(qat_runs["ids"]))
    want = {k: float(v) for k, v in eager.state_dict().items()
            if k.endswith("amax")}
    got = {k: float(v) for k, v in tmodel.state_dict().items()
           if k.endswith("amax")}
    assert set(got) == set(want) and len(got) == 16
    assert all(v != 1.0 for v in got.values())
    np.testing.assert_allclose([got[k] for k in want], list(want.values()),
                               rtol=1e-6)


def _trained_pair(qat_runs):
    """The port's trained QAT Mamba in eval mode, and a JAX QAT Mamba with
    its state (``amax`` included) loaded."""
    tmodel = qat_runs["synced"].eval()
    pt.seed(5)
    jmodel = JQ.QAT(JQ.QuantConfig()).quantize(JModel(JConfig.tiny(**CFG)))
    missing, unexpected = jmodel.set_state_dict(
        {k: v.detach().numpy() for k, v in tmodel.state_dict().items()})
    assert not missing and not unexpected
    return tmodel, jmodel.eval()


def test_trained_qat_state_gives_the_jax_eval_logits(qat_runs):
    tmodel, jmodel = _trained_pair(qat_runs)
    ids = qat_runs["ids"]
    with torch.no_grad():
        logits = tmodel(torch.from_numpy(ids))
    _close(logits, jmodel(jnp.asarray(ids)), 1e-5)


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_qat_convert_logits_match_jax(qat_runs, weight_dtype):
    """``QAT.convert`` of the trained models: every QuantedLinear a
    WeightOnlyLinear (int8 per channel; int4 in groups of 128 rows, or
    one group where 128 does not divide the width) and the logits equal
    JAX's."""
    tmodel, jmodel = _trained_pair(qat_runs)
    tconv = TQ.QAT(TQ.QuantConfig()).convert(tmodel, inplace=False,
                                             weight_dtype=weight_dtype)
    jconv = JQ.QAT(JQ.QuantConfig()).convert(jmodel, inplace=False,
                                             weight_dtype=weight_dtype)
    wols = [m for m in tconv.sublayers()
            if isinstance(m, TQ.WeightOnlyLinear)]
    assert len(wols) == 8 and not any(
        isinstance(m, TQ.QuantedLinear) for m in tconv.sublayers())
    assert set(tconv.state_dict()) == set(jconv.state_dict())
    ids = qat_runs["ids"]
    with torch.no_grad():
        logits = tconv(torch.from_numpy(ids))
    _close(logits, jconv(jnp.asarray(ids)), 1e-5)
