"""The port's ``hapi`` against the JAX package's on the CPU: ``Model.fit``
(shuffled over two epochs, evaluating after each), ``evaluate``,
``predict``, ``save`` and ``load`` on an MLP and on the tiny Llama
(``tests/serving_utils.py``'s ``LlamaConfig.tiny()``), with per-step
losses and final parameters held to the JAX ``Model``; files written by
the port's ``Model.save`` resume the JAX ``Model``; the callbacks
(``EarlyStopping``, ``ReduceLROnPlateau``, ``LRSchedulerCallback``,
``ModelCheckpoint``, ``MetricsLogger``) make JAX's decisions; ``fit``
trains inside ``no_grad()``; and ``summary``/``flops`` print and return
what JAX's do for an MLP, a conv net and the tiny Llama. Their
shape-only pass runs on the ``meta`` device, through the Llama's
attention and the UNet's channels-last GroupNorm, launching no kernel.

Tolerances: float32 both ways, 1e-5 for losses, parameters and outputs
(training sums in other orders over a few Adam steps). The tiny Llama's
final parameters: all but a thousandth of the entries within 1e-5, and
every entry within 1e-2 x lr x steps, since Adam's normalised update
turns a near-zero gradient that the two frameworks round apart into up
to a whole step (2 of its 8192 ``gate_proj`` entries move 6.7e-5), and
its outputs after training within 1e-4."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import contextlib
import io as _io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import hapi as jhapi
from paddle_tpu import io as jio
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import hapi as thapi
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF

TOL = 1e-5


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def carry(jm, tm):
    load_numpy_state_dict(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    return tm


class JMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(5, 8)
        self.fc2 = jnn.Linear(8, 3)

    def forward(self, x):
        return self.fc2(jnp.tanh(self.fc1(x)))


class TMLP(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(5, 8, device="cpu")
        self.fc2 = tnn.Linear(8, 3, device="cpu")

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


def _mse_j(out, y):
    return jnp.mean((out - y) ** 2)


def _mse_t(out, y):
    return torch.mean((out - y) ** 2)


def _lm_j(logits, labels):
    return JF.cross_entropy(logits[:, :-1], labels[:, 1:])


def _lm_t(logits, labels):
    return TF.cross_entropy(logits[:, :-1], labels[:, 1:])


class Losses:
    """Records every step's loss (the same callback class works in both
    packages: it only reads ``logs``)."""

    def __init__(self, base):
        self.cb = type("Rec", (base,), {
            "on_train_batch_end": lambda s, step, logs=None:
                self.steps.append(logs["loss"]),
            "on_eval_end": lambda s, logs=None:
                self.evals.append(logs["loss"])})()
        self.steps, self.evals = [], []


def _fit_both(jnet, tnet, jloss, tloss, data, epochs=2, batch_size=4,
              lr=0.01, eval_rows=None, adam_noise=False):
    jl, tl = Losses(jcb.Callback), Losses(tcb.Callback)
    jmodel = jpt.Model(jnet).prepare(
        jopt.AdamW(learning_rate=lr, weight_decay=0.01), jloss)
    tmodel = tpt.Model(tnet).prepare(
        topt.AdamW(learning_rate=lr, weight_decay=0.01), tloss)
    jds, tds = jio.TensorDataset(list(data)), tio.TensorDataset(list(data))
    ev_j = ev_t = None
    if eval_rows is not None:
        ev_j = jio.TensorDataset([d[:eval_rows] for d in data])
        ev_t = tio.TensorDataset([d[:eval_rows] for d in data])
    jmodel.fit(jds, ev_j, batch_size=batch_size, epochs=epochs, verbose=0,
               callbacks=[jl.cb])
    tmodel.fit(tds, ev_t, batch_size=batch_size, epochs=epochs, verbose=0,
               callbacks=[tl.cb])
    np.testing.assert_allclose(tl.steps, jl.steps, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.evals, jl.evals, rtol=TOL, atol=TOL)
    jp = dict(jnet.named_parameters())
    steps = len(tl.steps)
    for n, p in tnet.named_parameters():
        if not adam_noise:
            close(p, jp[n].value)
            continue
        # Adam's normalised update turns a near-zero gradient that the
        # two frameworks round apart into up to lr per step: a few
        # entries may move by that much, all others stay within TOL
        diff = np.abs(_np(p) - _np(jp[n].value))
        assert (diff > TOL).mean() < 1e-3, n
        assert diff.max() <= 1e-2 * lr * steps, n
    return jmodel, tmodel, tl


def _mlp_data(n=18, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 5)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32))


def test_mlp_fit_evaluate_predict_save_load_match_jax(tmp_path):
    jnet = JMLP()
    tnet = carry(jnet, TMLP())
    x, y = _mlp_data()
    jmodel, tmodel, tl = _fit_both(jnet, tnet, _mse_j, _mse_t, (x, y),
                                   eval_rows=8)
    assert len(tl.steps) == 2 * 5 and len(tl.evals) == 2
    ev = tio.TensorDataset([x[:8], y[:8]])
    jev = jio.TensorDataset([x[:8], y[:8]])
    assert tmodel.evaluate(ev, batch_size=4, verbose=0)["loss"] == \
        pytest.approx(jmodel.evaluate(jev, batch_size=4, verbose=0)["loss"],
                      rel=TOL, abs=TOL)
    got = tmodel.predict(tio.TensorDataset([x]), batch_size=5)
    want = jmodel.predict(jio.TensorDataset([x]), batch_size=5)
    assert isinstance(got, np.ndarray) and got.shape == (18, 3)
    close(got, want)
    # save; a fresh port model loads it, and the JAX Model resumes from it
    path = str(tmp_path / "mlp")
    tmodel.save(path)
    assert os.path.exists(path + ".pdparams") and os.path.exists(
        path + ".pdopt")
    fresh = tpt.Model(TMLP()).prepare(topt.AdamW(learning_rate=0.01,
                                                 weight_decay=0.01), _mse_t)
    fresh.load(path)
    for (n, a), (_, b) in zip(fresh.network.named_parameters(),
                              tnet.named_parameters()):
        assert torch.equal(a, b), n
    assert fresh.evaluate(ev, batch_size=4, verbose=0)["loss"] == \
        tmodel.evaluate(ev, batch_size=4, verbose=0)["loss"]
    jfresh = jpt.Model(JMLP()).prepare(jopt.AdamW(learning_rate=0.01,
                                                  weight_decay=0.01), _mse_j)
    jfresh.load(path)
    # one more epoch from the same files in both packages
    jl, tl2 = Losses(jcb.Callback), Losses(tcb.Callback)
    jfresh.fit(jio.TensorDataset([x, y]), batch_size=6, verbose=0,
               callbacks=[jl.cb])
    fresh.fit(tio.TensorDataset([x, y]), batch_size=6, verbose=0,
              callbacks=[tl2.cb])
    np.testing.assert_allclose(tl2.steps, jl.steps, rtol=TOL, atol=TOL)
    assert int(fresh._opt_state["step"]) == 2 * 5 + 3


def test_tiny_llama_fit_evaluate_predict_save_load_match_jax(tmp_path):
    jpt.seed(0)
    jnet = JLlama(JConfig.tiny())
    tnet = carry(jnet, LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, JConfig.tiny().vocab_size, (8, 16)).astype(
        np.int64)
    jmodel, tmodel, tl = _fit_both(jnet, tnet, _lm_j, _lm_t, (ids, ids),
                                   lr=3e-3, adam_noise=True)
    assert len(tl.steps) == 4 and tl.steps[-1] < tl.steps[0]
    got = tmodel.predict(tio.TensorDataset([ids[:4]]), batch_size=2)
    want = jmodel.predict(jio.TensorDataset([ids[:4].astype(np.int32)]),
                          batch_size=2)
    with torch.no_grad():
        assert np.array_equal(got, tnet(torch.from_numpy(ids[:4])).numpy())
    # the parameters' Adam noise (above) carried through the forward
    close(got, want, 1e-4)
    ev_t = tio.TensorDataset([ids[:4], ids[:4]])
    loss_t = tmodel.evaluate(ev_t, batch_size=2, verbose=0)["loss"]
    loss_j = jmodel.evaluate(jio.TensorDataset([ids[:4], ids[:4]]),
                             batch_size=2, verbose=0)["loss"]
    assert loss_t == pytest.approx(loss_j, rel=1e-4)
    # the port's files load into a fresh JAX model: the same evaluate loss
    path = str(tmp_path / "llama")
    tmodel.save(path)
    jpt.seed(1)
    jfresh = jpt.Model(JLlama(JConfig.tiny())).prepare(
        jopt.AdamW(learning_rate=3e-3, weight_decay=0.01), _lm_j)
    jfresh.load(path)
    assert jfresh.evaluate(jio.TensorDataset([ids[:4], ids[:4]]),
                           batch_size=2, verbose=0)["loss"] == \
        pytest.approx(loss_t, rel=TOL)
    tfresh = tpt.Model(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                        seed=1)).prepare(
        topt.AdamW(learning_rate=3e-3, weight_decay=0.01), _lm_t)
    tfresh.load(path)
    assert tfresh.evaluate(ev_t, batch_size=2, verbose=0)["loss"] == loss_t


def test_fit_trains_inside_no_grad_and_keeps_the_network_until_epoch_end():
    jnet = JMLP()
    tnet = carry(jnet, TMLP())
    x, y = _mlp_data(8)
    before = tnet.fc1.weight.detach().clone()
    seen = []

    class Peek(tcb.Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append(torch.equal(self.model.network.fc1.weight, before))

    model = tpt.Model(tnet).prepare(topt.SGD(0.1), _mse_t)
    with tpt.no_grad():
        model.fit(tio.TensorDataset([x, y]), batch_size=4, verbose=0,
                  callbacks=[Peek()])
    # the network's parameters change only when the epoch ends, as in JAX
    assert seen == [True, True]
    assert not torch.equal(tnet.fc1.weight, before)
    jmodel = jpt.Model(jnet).prepare(jopt.SGD(0.1), _mse_j)
    jmodel.fit(jio.TensorDataset([x, y]), batch_size=4, verbose=0)
    close(tnet.fc1.weight, jnet.fc1.weight.value)


# ------------------------------------------------------------- callbacks
class _Holder:
    """The part of a ``Model`` a callback reads."""

    def __init__(self, opt):
        self._optimizer = opt
        self.stop_training = False


def test_early_stopping_and_reduce_lr_make_jax_decisions():
    evals = [1.0, 0.9, 0.95, 0.97, 0.85, 0.86, 0.87, 0.88, 0.5]
    for kw in (dict(patience=1), dict(patience=0, min_delta=0.02),
               dict(mode="max", patience=2, baseline=0.9)):
        j, t = jcb.EarlyStopping(**kw), tcb.EarlyStopping(**kw)
        jh, th = _Holder(None), _Holder(None)
        j.set_model(jh)
        t.set_model(th)
        for v in evals:
            j.on_eval_end({"loss": v})
            t.on_eval_end({"loss": v})
            assert (th.stop_training, t.wait, t.best) == (
                jh.stop_training, j.wait, j.best)
    for sched in (False, True):
        jo = jopt.AdamW(learning_rate=jopt.lr.StepDecay(0.1, 3) if sched
                        else 0.1)
        to = topt.AdamW(learning_rate=topt.lr.StepDecay(0.1, 3) if sched
                        else 0.1)
        kw = dict(factor=0.5, patience=2, cooldown=1, min_lr=0.02,
                  verbose=0)
        j, t = jcb.ReduceLROnPlateau(**kw), tcb.ReduceLROnPlateau(**kw)
        j.set_model(_Holder(jo))
        t.set_model(_Holder(to))
        for v in evals + [0.6, 0.61, 0.62, 0.63, 0.64, 0.65]:
            j.on_eval_end({"loss": [v]})
            t.on_eval_end({"loss": [v]})
            jt = jo._lr_scheduler if sched else jo
            tt = to._lr_scheduler if sched else to
            assert tt.base_lr == pytest.approx(jt.base_lr)
            assert (t.wait, t.cooldown_counter) == (j.wait,
                                                    j.cooldown_counter)


def test_fit_with_callbacks_matches_jax(tmp_path):
    jnet = JMLP()
    tnet = carry(jnet, TMLP())
    x, y = _mlp_data(12, seed=1)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    jl, tl = Losses(jcb.Callback), Losses(tcb.Callback)
    jmodel = jpt.Model(jnet).prepare(
        jopt.AdamW(learning_rate=jopt.lr.StepDecay(0.05, 1, gamma=0.5)),
        _mse_j)
    tmodel = tpt.Model(tnet).prepare(
        topt.AdamW(learning_rate=topt.lr.StepDecay(0.05, 1, gamma=0.5)),
        _mse_t)
    jcbs = [jl.cb, jcb.LRScheduler(), jcb.ModelCheckpoint(2, jdir),
            jcb.EarlyStopping(patience=0, min_delta=10.0)]
    tcbs = [tl.cb, tcb.LRScheduler(), tcb.ModelCheckpoint(2, tdir),
            tcb.EarlyStopping(patience=0, min_delta=10.0),
            tcb.MetricsLogger(), tcb.VisualDL(os.path.join(tdir, "vdl"))]
    jcbs.append(jcb.VisualDL(os.path.join(jdir, "vdl")))
    jmodel.fit(jio.TensorDataset([x, y]), jio.TensorDataset([x, y]),
               batch_size=4, epochs=5, verbose=0, callbacks=jcbs)
    saved = tflags.flag("telemetry")
    tflags.set_flags({"telemetry": True})
    try:
        tmodel.fit(tio.TensorDataset([x, y]), tio.TensorDataset([x, y]),
                   batch_size=4, epochs=5, verbose=0, callbacks=tcbs)
    finally:
        tflags.set_flags({"telemetry": saved})
    np.testing.assert_allclose(tl.steps, jl.steps, rtol=TOL, atol=TOL)
    assert tmodel.stop_training == jmodel.stop_training is True
    assert len(tl.evals) == len(jl.evals) == 2
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    # VisualDL's scalars: the same records (train every 10th step, eval)
    import json

    recs = []
    for d in (tdir, jdir):
        with open(os.path.join(d, "vdl", "scalars.jsonl")) as f:
            recs.append([json.loads(line) for line in f])
    assert [(r["tag"], r["step"]) for r in recs[0]] == [
        (r["tag"], r["step"]) for r in recs[1]]
    for a, b in zip(*recs):
        assert a["loss"] == pytest.approx(b["loss"], rel=TOL, abs=TOL)
    state = jpt.load(os.path.join(tdir, "epoch_1.pdparams"))
    close(state["fc2.weight"], tnet.fc2.weight)
    from paddle_tpu_torch import observability as tobs

    # MetricsLogger published the last epoch's mean loss and counted the
    # steps
    reg = tobs.registry.global_registry()
    assert reg.gauge("pt_hapi_train_loss").value() == pytest.approx(
        (sum(tl.steps[-3:]) / 3))
    assert reg.counter("pt_hapi_steps_total").value() >= len(tl.steps)


def test_prog_bar_logger_prints_as_jax():
    outs = []
    for pt_, cb in ((jpt, jcb), (tpt, tcb)):
        logger = cb.ProgBarLogger(log_freq=1, verbose=1)
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            logger.on_epoch_begin(0)
            logger.on_train_batch_end(0, {"loss": 0.5, "acc": 1})
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


# ------------------------------------------------------- summary, flops
class JConv(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = jnn.Conv2D(3, 8, 3, padding=1)
        self.fc = jnn.Linear(8 * 6 * 6, 4)

    def forward(self, x):
        h = jnp.maximum(self.conv(x), 0)
        return self.fc(h.reshape(h.shape[0], -1))


class TConv(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv2D(3, 8, 3, padding=1, device="cpu")
        self.fc = tnn.Linear(8 * 6 * 6, 4, device="cpu")

    def forward(self, x):
        h = torch.relu(self.conv(x))
        return self.fc(h.reshape(h.shape[0], -1))


def _printed(fn, *a, **kw):
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


@pytest.mark.parametrize("which", ["mlp", "conv", "llama"])
def test_summary_and_flops_match_jax(which):
    if which == "mlp":
        jnet = JMLP()
        tnet, size, jdt, tdt = carry(jnet, TMLP()), (2, 5), None, None
    elif which == "conv":
        jnet = JConv()
        tnet, size, jdt, tdt = carry(jnet, TConv()), (2, 3, 6, 6), None, None
    else:
        jpt.seed(0)
        jnet = JLlama(JConfig.tiny())
        tnet = carry(jnet, LlamaForCausalLM(LlamaConfig.tiny(),
                                            device="cpu"))
        size, jdt, tdt = (2, 16), jnp.int32, "int64"
    got, gtext = _printed(thapi.summary, tnet, size, dtypes=tdt)
    want, wtext = _printed(jhapi.summary, jnet, size, dtypes=jdt)
    assert got == want
    assert gtext == wtext
    for detail in (False, True):
        got, gtext = _printed(thapi.flops, tnet, size, dtypes=tdt,
                              print_detail=detail)
        want, wtext = _printed(jhapi.flops, jnet, size, dtypes=jdt,
                               print_detail=detail)
        assert got == want > 0
        assert gtext == wtext
    # the model stays where it is, with its values
    assert all(p.device.type == "cpu" for p in tnet.parameters())
    if which == "mlp":
        x = np.ones((2, 5), np.float32)
        got, _ = _printed(thapi.summary, tnet, input=torch.tensor(x))
        want, _ = _printed(jhapi.summary, jnet, input=x)
        assert got == want


def test_shape_only_pass_reaches_no_kernel():
    """The meta-device pass goes through the Llama's flash attention and
    the UNet's channels-last GroupNorm on their plain versions: meta
    tensors never take the kernel dispatch."""
    from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig
    from paddle_tpu_torch.nn import functional as F

    assert not tfa.use_kernel(torch.empty(1, device="meta"))
    assert not tfa.use_kernel(torch.empty(1))
    q = torch.empty(2, 16, 4, 8, device="meta")
    assert tfa.flash_attention(q, q, q, causal=True).device.type == "meta"
    x = torch.empty(2, 4, 4, 16, device="meta")
    assert F.group_norm(x, 4, data_format="NHWC").shape == x.shape
    saved = tflags.flag("conv_layout")
    tflags.set_flags({"conv_layout": "NHWC"})
    try:
        unet = UNet2DConditionModel(UNetConfig.tiny(), device="cpu")
    finally:
        tflags.set_flags({"conv_layout": saved})
    out, text = _printed(thapi.summary, unet,
                         [(1, 4, 16, 16), (1,), (1, 8, 32)],
                         dtypes=["float32", "int64", "float32"])
    assert out["total_params"] == sum(p.numel() for p in unet.parameters())
    assert "GroupNorm" in text
    assert thapi.flops(unet, [(1, 4, 16, 16), (1,), (1, 8, 32)],
                       dtypes=["float32", "int64", "float32"]) > 0
    assert all(p.device.type == "cpu" for p in unet.parameters())
