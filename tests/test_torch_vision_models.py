"""The port's vision zoo (``paddle_tpu_torch/vision/models``) against
the JAX package on the CPU, float32, the port's weights carried into the
JAX models (``tests/torch_parity.py``):

- a bottleneck ``ResNet(BottleneckBlock, [1, 1, 1, 1], num_classes=10)``
  at 64 x 64, batch 2 (the last BatchNorm reduces over 2 x 2 x 2 = 8
  values), NCHW and channels-last: logits in training and eval mode, the
  loss and every gradient (1e-5 / 1e-4 of each tensor's largest entry),
  and a 5-step AdamW ``TrainStep`` trajectory of both layouts trained
  together against the jitted JAX step; the GroupNorm ``norm_layer``
  arm channels-last the same way, without the trajectory;
- one eval forward of ``mobilenet_v2``, ``mobilenet_v3_small``,
  ``googlenet``, ``shufflenet_v2_x1_0``, ``squeezenet1_1`` and ``LeNet``
  at their smallest valid inputs;
- every other constructor's ``state_dict`` keys, shapes and parameter
  count, no forward; a JAX ``resnet18`` state dict loaded strictly."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu import nn as jnn
from paddle_tpu.core.functional import extract_params, functional_call
from paddle_tpu.core.meta import meta_init
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision import models as jzoo
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.vision import models as tzoo
from torch_parity import (close, jax_twin, jit_o0, scaled_close, to_torch,
                          trajectory)

RESNET_BATCH = {"x": np.random.default_rng(0).standard_normal(
    (2, 3, 64, 64)).astype(np.float32),
    "labels": np.random.default_rng(1).integers(0, 10, (2,))}


def _resnet(channels_last, gn=False, seed=0):
    kw = dict(num_classes=10, channels_last=channels_last)
    tkw, jkw = dict(kw), dict(kw)
    if gn:
        # built inside the model's device scope: the factory passes none
        tkw["norm_layer"] = lambda c: tnn.GroupNorm(8, c)
        jkw["norm_layer"] = lambda c: jnn.GroupNorm(8, c)
    tmodel = tzoo.ResNet(tzoo.BottleneckBlock, [1, 1, 1, 1], device="cpu",
                         seed=seed, **tkw)
    return jax_twin(lambda: jzoo.resnet.ResNet(
        jzoo.resnet.BottleneckBlock, [1, 1, 1, 1], **jkw), tmodel), tmodel


ARMS = {"nchw": dict(channels_last=False),
        "nhwc": dict(channels_last=True),
        "gn_nhwc": dict(channels_last=True, gn=True)}


@pytest.fixture(scope="module")
def resnets():
    """Each arm's training and eval logits, loss and gradients in one
    jitted call."""
    pairs = {arm: _resnet(**kw) for arm, kw in ARMS.items()}
    x = jnp.asarray(RESNET_BATCH["x"])
    y = jnp.asarray(RESNET_BATCH["labels"])

    def body(params):
        out = {}
        for arm, (jm, _) in pairs.items():
            p = params[arm]
            eval_logits = None
            if arm != "gn_nhwc":  # (GroupNorm: eval is training's)
                jm.eval()
                eval_logits = functional_call(jm, p, x)
                jm.train()

            def loss(q, jm=jm):
                # the model's own loss: cross_entropy of its logits
                logits = functional_call(jm, q, x)
                return JF.cross_entropy(logits, y), logits

            (value, train_logits), grads = jax.value_and_grad(
                loss, has_aux=True)(p)
            out[arm] = (train_logits, eval_logits, value, grads)
        return out

    params = {arm: extract_params(jm) for arm, (jm, _) in pairs.items()}
    # the JAX side's NHWC GroupNorms through their plain reference (the
    # interpreted kernels are held against rows 12-13 in
    # tests/test_torch_group_norm.py): the same numbers, a shorter compile
    jflags.set_flags({"fused_group_norm": False})
    try:
        out = jit_o0(body, params)
    finally:
        jflags.set_flags({"fused_group_norm": True})
    return pairs, jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_bottleneck_resnet_logits_loss_and_every_gradient_match_jax(
        arm, resnets):
    pairs, out = resnets
    _, tmodel = pairs[arm]
    train_logits, eval_logits, loss, grads = out[arm]
    batch = to_torch(RESNET_BATCH)
    with torch.no_grad():
        # eval first: a training forward moves the running statistics
        tmodel.eval()
        close(tmodel(batch["x"]), train_logits if eval_logits is None
              else eval_logits)
        tmodel.train()
        close(tmodel(batch["x"]), train_logits)
    got = tmodel(**batch)
    got.backward()
    close(got, loss)
    named = dict(tmodel.named_parameters())
    assert set(named) == set(grads)
    for name, g in grads.items():
        scaled_close(named[name].grad, g)
    norms = [m for m in tmodel.sublayers()
             if isinstance(m, (tnn.BatchNorm2D, tnn.GroupNorm))]
    assert len(norms) == 1 + 4 * 3 + 4
    assert all(p.device.type == "cpu" for p in tmodel.parameters())


def _both(pkg, nchw, nhwc):
    """One model training both layouts: the sum of their losses."""
    class Both(pkg.Layer):
        def __init__(self):
            super().__init__()
            self.nchw, self.nhwc = nchw, nhwc

        def forward(self, x, labels):
            return self.nchw(x, labels=labels) + self.nhwc(x, labels=labels)

    return Both()


def test_bottleneck_resnet_train_step_trajectories_match_jax():
    """NCHW and channels-last trained together (one JAX step to compile):
    5 AdamW steps of the summed losses within 1e-4 relative."""
    (j1, t1), (j2, t2) = _resnet(False, seed=4), _resnet(True, seed=5)
    trajectory(_both(jnn, j1, j2), _both(tnn, t1, t2), RESNET_BATCH, steps=5)


# eval mode: no dropout draws, and BatchNorm over the 2 values of a 1 x 1
# map at batch 2 would amplify rounding
ZOO = {
    "mobilenet_v2": (dict(num_classes=10), (2, 3, 32, 32)),
    "mobilenet_v3_small": (dict(num_classes=10), (2, 3, 32, 32)),
    "googlenet": (dict(num_classes=10), (2, 3, 32, 32)),
    "shufflenet_v2_x1_0": (dict(num_classes=10), (2, 3, 32, 32)),
    "squeezenet1_1": (dict(num_classes=10), (2, 3, 32, 32)),
    "LeNet": (dict(), (2, 1, 28, 28)),
}


@pytest.fixture(scope="module")
def zoo():
    pairs, inputs = {}, {}
    for i, (name, (kw, shape)) in enumerate(ZOO.items()):
        tmodel = getattr(tzoo, name)(device="cpu", seed=i, **kw).eval()
        jmodel = jax_twin(lambda: getattr(jzoo, name)(**kw), tmodel)
        jmodel.eval()
        pairs[name] = (jmodel, tmodel)
        inputs[name] = np.random.default_rng(i).standard_normal(
            shape).astype(np.float32)

    def body(params):
        return {n: functional_call(jm, params[n], jnp.asarray(inputs[n]))
                for n, (jm, _) in pairs.items()}

    params = {n: extract_params(jm) for n, (jm, _) in pairs.items()}
    return pairs, inputs, jax.tree_util.tree_map(
        np.asarray, jit_o0(body, params))


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_forward_matches_jax(name, zoo):
    pairs, inputs, want = zoo
    _, tmodel = pairs[name]
    with torch.no_grad():
        close(tmodel(torch.tensor(inputs[name])), want[name])


def test_googlenet_training_forward_returns_the_aux_heads():
    model = tzoo.googlenet(num_classes=7, device="cpu")
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        out, aux1, aux2 = model(x)
        assert out.shape == aux1.shape == aux2.shape == (2, 7)
        model.eval()
        assert model(x).shape == (2, 7)


@pytest.fixture
def no_init(monkeypatch):
    """Parameters allocated and not drawn: the keys test needs shapes
    only, and full-size draws cost seconds on the CPU."""
    from paddle_tpu_torch.core import initializer as TI
    from paddle_tpu_torch.core.device import current_device

    def empty(self, shape_or_tensor, dtype=None, device=None,
              generator=None):
        if isinstance(shape_or_tensor, torch.Tensor):
            return shape_or_tensor
        return torch.empty(tuple(shape_or_tensor), dtype=dtype,
                           device=current_device(device))

    monkeypatch.setattr(TI.Initializer, "__call__", empty)


OTHERS = sorted(set(tzoo.CONSTRUCTORS) - set(ZOO) - {"resnet18"})


@pytest.mark.parametrize("name", OTHERS + ["resnet18"])
def test_constructor_state_dict_matches_jax(name, no_init):
    """Keys, shapes (parameters and the BatchNorms' buffers) and the
    parameter count of the JAX constructor's model."""
    tmodel = getattr(tzoo, name)(device="cpu")
    with meta_init():
        jmodel = getattr(jzoo, name)()
    want = {k: tuple(v.shape) for k, v in jmodel.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in tmodel.state_dict().items()} \
        == want
    count = sum(int(np.prod(p.shape)) for _, p in jmodel.named_parameters())
    assert sum(p.numel() for p in tmodel.parameters()) == count


def test_every_constructor_and_lenet_is_exported():
    assert len(tzoo.CONSTRUCTORS) == 23
    for name in [*tzoo.CONSTRUCTORS, "LeNet"]:
        assert callable(getattr(tzoo, name)) and hasattr(jzoo, name)
    from paddle_tpu_torch import vision

    assert vision.resnet50 is tzoo.resnet50


def test_a_jax_resnet18_state_dict_loads_strictly():
    """A JAX ``resnet18`` state dict (parameters and the BatchNorms'
    ``_mean``/``_variance``) loads into the port's with no missing or
    unexpected key, every value carried."""
    with meta_init():
        jmodel = jzoo.resnet18()
    rng = np.random.default_rng(0)
    state = {k: (rng.standard_normal(v.shape).astype(np.float32)
                 if isinstance(v, jax.ShapeDtypeStruct) else np.asarray(v))
             for k, v in jmodel.state_dict().items()}
    state = {k: v + (0.5 if k.endswith("_variance") else 0.0)
             for k, v in state.items()}
    assert any(k.endswith("._mean") for k in state)
    tmodel = tzoo.resnet18(device="cpu")
    load_numpy_state_dict(tmodel, state)
    for k, v in tmodel.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k])
    with pytest.raises(KeyError, match="missing"):
        load_numpy_state_dict(tmodel, {k: v for k, v in state.items()
                                       if not k.endswith("_mean")})
