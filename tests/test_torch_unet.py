"""The port's SD UNet (``paddle_tpu_torch/models/unet.py``) and its layers
against the JAX package on the CPU: the tiny UNet's output, denoising
loss and every parameter's gradient after ``load_numpy_state_dict``, in
the NCHW layout and channels-last (where the GroupNorms take the fused
path: the plain rows 12-13 against JAX's interpreted kernels); a 5-step
``TrainStep`` trajectory against the JAX ``TrainStep`` on a one-device
CPU mesh; ``conv2d``, ``interpolate``, ``layer_norm`` and the timestep
embedding; and the layout policy. Inputs come from numpy with one seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import flags as jflags
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.module import Layer
from paddle_tpu.models import UNet2DConditionModel as JModel
from paddle_tpu.models import UNetConfig as JConfig
from paddle_tpu.models import unet as junet
from paddle_tpu.nn import functional as JF
from paddle_tpu.trainer import TrainStep as JTrainStep
from paddle_tpu_torch import flags
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig
from paddle_tpu_torch.models import unet as tunet
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import layout
from paddle_tpu_torch.trainer import TrainStep


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


class _JWrap(Layer):
    """``benchmarks/suite.py: bench_unet``'s adapter: the denoising MSE in
    float32."""

    def __init__(self, unet):
        super().__init__()
        self.unet = unet

    def forward(self, sample, timestep, context, target):
        pred = self.unet(sample, timestep, context)
        diff = pred.astype(jnp.float32) - target.astype(jnp.float32)
        return jnp.mean(diff ** 2)


class _TWrap(torch.nn.Module):
    def __init__(self, unet):
        super().__init__()
        self.unet = unet

    def forward(self, sample, timestep, context, target):
        pred = self.unet(sample, timestep, context)
        return (pred.float() - target.float()).square().mean()


def _pair(seed=5, **cfg):
    pt.seed(seed)
    jmodel = _JWrap(JModel(JConfig.tiny(**cfg)))
    state = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}
    tmodel = _TWrap(UNet2DConditionModel(UNetConfig.tiny(**cfg),
                                         device="cpu"))
    load_numpy_state_dict(tmodel, state)
    return jmodel, tmodel


def _batch(seed=0, b=2, size=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 4, size, size)).astype(np.float32)
    return {"sample": x, "timestep": rng.integers(0, 1000, (b,)),
            "context": rng.standard_normal((b, 7, 32)).astype(np.float32),
            "target": x}


def _unet_params(params):
    """The wrapper's parameters as the UNet's own names."""
    return {k.removeprefix("unet."): v for k, v in params.items()}


@pytest.mark.parametrize("channels_last", [False, True])
def test_tiny_unet_output_loss_and_every_gradient_match_jax(channels_last):
    from paddle_tpu.core.functional import extract_params, functional_call

    jmodel, tmodel = _pair(channels_last=channels_last)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}

    def jloss(p):
        pred = functional_call(jmodel.unet, _unet_params(p), jb["sample"],
                               jb["timestep"], jb["context"])
        return jnp.mean((pred - jb["target"]) ** 2), pred

    # the JAX side's NHWC GroupNorms through their plain reference (the
    # interpreted kernels are held against rows 12-13 in
    # tests/test_torch_group_norm.py): the same numbers, a shorter compile
    jflags.set_flags({"fused_group_norm": False})
    try:
        (want_loss, want_pred), want = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(extract_params(jmodel))
    finally:
        jflags.set_flags({"fused_group_norm": True})
    with torch.no_grad():
        _close(tmodel.unet(tb["sample"], tb["timestep"], tb["context"]),
               want_pred, 1e-5)
    loss = tmodel(**tb)
    loss.backward()
    _close(loss, want_loss, 1e-5)
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want) and len(got) == 286
    for name, g in want.items():
        _close(got[name].grad, g, 1e-5)


def test_train_step_loss_trajectory_matches_jax():
    """Five AdamW steps on one fixed batch, channels-last (the card's
    layout, through the fused GroupNorm path): losses within 1e-5."""
    jmodel, tmodel = _pair(seed=7, channels_last=False)
    opt = dict(learning_rate=1e-3, weight_decay=0.01, multi_precision=True)
    js = JTrainStep(jmodel, jopt.AdamW(**opt),
                    jdist.build_mesh(devices=jax.devices()[:1]))
    ts = TrainStep(tmodel, topt.AdamW(**opt))
    batch = _batch(seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(5):
        want = float(js.run(jbatch))
        losses.append(float(ts.run(batch)))
        np.testing.assert_allclose(losses[-1], want, rtol=1e-5)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC", "scope"])
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, 0),
                                            (2, (0, 2))])
def test_conv2d_matches_jax(fmt, stride, padding):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 7, 5)).astype(np.float32)  # NCHW
    w = rng.standard_normal((4, 6, 3, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = JF.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
                     padding)
    if fmt == "NCHW":
        got = TF.conv2d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                        stride, padding)
    else:
        xl = torch.tensor(x).permute(0, 2, 3, 1).contiguous()
        if fmt == "NHWC":
            got = TF.conv2d(xl, torch.tensor(w), torch.tensor(b), stride,
                            padding, data_format="NHWC")
        else:  # declared NCHW inside a channels-last scope
            with layout.channels_last_scope():
                got = TF.conv2d(xl, torch.tensor(w), torch.tensor(b), stride,
                                padding)
        got = got.permute(0, 3, 1, 2)
    _close(got, want, 1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TF.conv2d(torch.tensor(x), torch.tensor(w), padding=((1, 2), (0, 1)))


@pytest.mark.parametrize("size,scale", [(None, 2), ((5, 3), None),
                                        (7, None)])
def test_interpolate_nearest_matches_jax(size, scale):
    x = np.random.default_rng(3).standard_normal((2, 3, 4, 6)).astype(
        np.float32)
    want = JF.interpolate(jnp.asarray(x), size, scale, "nearest")
    got = TF.interpolate(torch.tensor(x), size, scale, "nearest")
    _close(got, want, 0)
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    want = JF.interpolate(jnp.asarray(xl), size, scale, "nearest",
                          data_format="NHWC")
    _close(TF.interpolate(torch.tensor(xl), size, scale, "nearest",
                          "NHWC"), want, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TF.interpolate(torch.tensor(x), size, scale, "bilinear")


def test_layer_norm_and_timestep_embedding_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3 + 1
    w, b = rng.standard_normal(16), rng.standard_normal(16)
    for dt in ("float32", "bfloat16"):
        jx = jnp.asarray(x, getattr(jnp, dt))
        tx = torch.tensor(x).to(getattr(torch, dt))
        want = JF.layer_norm(jx, 16, jnp.asarray(w, jx.dtype),
                             jnp.asarray(b, jx.dtype))
        got = TF.layer_norm(tx, 16, torch.tensor(w).to(tx.dtype),
                            torch.tensor(b).to(tx.dtype))
        assert got.dtype == tx.dtype
        _close(got, want, 1e-5 if dt == "float32" else 1e-2)
    t = np.array([0, 1, 17, 999])
    _close(tunet.timestep_embedding(torch.as_tensor(t), 32),
           junet.timestep_embedding(jnp.asarray(t), 32), 1e-5)


def test_layout_policy():
    """An explicit setting wins; the flag forces NHWC or NCHW; "auto"
    means NHWC for a model on the card and NCHW on the CPU. The scope
    resolves declared NCHW only while open, and ``declared_scope``
    suspends it."""
    assert layout.decide(True, "cpu") and not layout.decide(False, "cuda")
    assert layout.decide(None, "cuda") and layout.decide(None, "cuda:0")
    assert not layout.decide(None, "cpu") and not layout.decide(None)
    for v, want in (("NHWC", True), ("NCHW", False)):
        flags.set_flags({"conv_layout": v})
        try:
            assert layout.decide(None, "cpu") is want
            assert layout.decide(None, "cuda") is want
        finally:
            flags.set_flags({"conv_layout": "auto"})
    assert layout.resolve("NCHW") == "NCHW" and not layout.active()
    with layout.channels_last_scope():
        assert layout.active() and layout.resolve("NCHW") == "NHWC"
        assert layout.resolve("NHWC") == "NHWC"
        with layout.declared_scope():
            assert layout.resolve("NCHW") == "NCHW"
        assert layout.resolve("NCHW") == "NHWC"
    with layout.channels_last_scope(False):
        assert not layout.active()
    assert not layout.active()
