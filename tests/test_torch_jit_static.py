"""``paddle_tpu_torch.jit`` on ``torch.export`` and ``static.InputSpec``
against the JAX package (``tests/test_misc_namespaces.py``'s jit and
``InputSpec`` cases, on both packages): ``to_static`` traces once per
signature and checks its specs with JAX's messages; ``save``/``load``
round-trip a layer with its weights embedded, with dynamic dims that
serve sizes never traced (1 included) and the unnamed-dims-are-shared
rule; the tiny Llama (the port's with a ``None`` batch and sequence),
Mamba and UNet go through ``save``/``load`` in both packages and the
loaded outputs agree (float32, 1e-5); a program loads only on the
device type it was exported on."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import jit as jjit
from paddle_tpu import models as jmodels
from paddle_tpu import static as jstatic
import paddle_tpu_torch as tpt
from paddle_tpu_torch import jit, models, static
from paddle_tpu_torch.core import device as core_device
from torch_parity import carry, close, jax_call, jax_twin


@pytest.fixture(autouse=True)
def on_cpu():
    saved = core_device._current
    tpt.set_device("cpu")
    yield
    core_device.set_current(saved)


def _linear_pair(i=4, o=2):
    jpt.seed(0)
    jlin = jpt.nn.Linear(i, o)
    tlin = tpt.nn.Linear(i, o)
    carry(jlin, tlin)
    return jlin, tlin


def test_input_spec_matches_jax():
    for shape, dtype, name in (([None, 8], "int64", None),
                               ([3, 4], "float32", "x")):
        j, t = jstatic.InputSpec(shape, dtype, name), \
            static.InputSpec(shape, dtype, name)
        assert t.shape == j.shape and t.name == j.name
        assert repr(t).startswith("InputSpec(shape=")
    s = static.InputSpec([None, 8], "int64").to_struct(batch_size=4)
    assert s.shape == jstatic.InputSpec([None, 8], "int64").to_struct(
        batch_size=4).shape == (4, 8)
    with pytest.raises(ValueError, match="dynamic dim"):
        static.InputSpec([4, None], "int64").to_struct()
    t = torch.zeros(2, 3, dtype=torch.int32)
    spec = static.InputSpec.from_tensor(t, name="ids")
    assert spec.shape == (2, 3) and spec.dtype == torch.int32
    # unnamed specs share one dim per position; named ones have their own
    scope = {}
    a = static.InputSpec([None, 4]).to_symbolic_struct(scope=scope)
    b = static.InputSpec([None, 4]).to_symbolic_struct(scope=scope)
    c = static.InputSpec([None, 4], name="y").to_symbolic_struct(
        prefix="y_", scope=scope)
    assert a[0] is b[0] and c[0] is not a[0] and set(scope) == {"d0", "y_0"}
    with static.program_guard(static.Program()), static.name_scope("blk"):
        assert static.default_main_program() is static.default_main_program()


def test_to_static_traces_once_per_signature_and_checks_specs():
    jlin, tlin = _linear_pair()
    jts = jjit.to_static(jlin, input_spec=[jstatic.InputSpec([None, 4])])
    ts = jit.to_static(tlin, input_spec=[static.InputSpec([None, 4])])
    x = np.ones((3, 4), np.float32)
    close(ts(torch.tensor(x)), jts(jnp.asarray(x)))
    ts(torch.ones(3, 4))
    ts(torch.ones(5, 4))
    assert len(ts.programs) == 2
    for fn, arr in ((jts, jnp.ones((3, 5))), (ts, torch.ones(3, 5))):
        with pytest.raises(ValueError, match="does not match"):
            fn(arr)
    with pytest.raises(ValueError, match="input_spec entries"):
        ts(torch.ones(3, 4), torch.ones(3, 4))
    # a plain function
    double = jit.to_static(lambda v: v * 2)
    assert torch.equal(double(torch.ones(2)), torch.full((2,), 2.0))


def test_save_load_with_static_and_dynamic_specs(tmp_path):
    jlin, tlin = _linear_pair()
    for name, spec in (("static", [static.InputSpec([3, 4], "float32",
                                                    name="x")]),
                       ("tensor", [torch.zeros(3, 4)])):
        jit.save(tlin, str(tmp_path / name), input_spec=spec)
        loaded = jit.load(str(tmp_path / name))
        x = np.ones((3, 4), np.float32)
        close(loaded(torch.tensor(x)), jlin(jnp.asarray(x)))
    jit.save(tlin, str(tmp_path / "dyn"),
             input_spec=[static.InputSpec([None, 4], "float32")])
    jjit.save(jlin, str(tmp_path / "jdyn"),
              input_spec=[jstatic.InputSpec([None, 4], "float32")])
    loaded, jloaded = jit.load(str(tmp_path / "dyn")), \
        jjit.load(str(tmp_path / "jdyn"))
    for b in (1, 3, 6):
        x = np.random.default_rng(b).standard_normal((b, 4)).astype(
            np.float32)
        close(loaded(torch.tensor(x)), jloaded(jnp.asarray(x)))
    assert isinstance(loaded, jit.TranslatedLayer)
    assert loaded.meta["device_type"] == "cpu"
    # two unnamed [None, 4] inputs are equal-batch, as in JAX
    add = jit.to_static(lambda a, b: a + b)
    ep = jit.save(add, str(tmp_path / "pair"),
                  input_spec=[static.InputSpec([None, 4])] * 2)
    assert len({str(s) for s in ep.range_constraints}) == 1


def test_load_refuses_another_device_type(tmp_path, monkeypatch):
    _, tlin = _linear_pair()
    jit.save(tlin, str(tmp_path / "m"),
             input_spec=[static.InputSpec([None, 4])])
    monkeypatch.setattr(jit, "current_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(ValueError, match="exported on cpu"):
        jit.load(str(tmp_path / "m"))


def _llama():
    tm = models.LlamaForCausalLM(models.LlamaConfig.tiny(), device="cpu",
                                 seed=1)
    jm = jax_twin(lambda: jmodels.LlamaForCausalLM(
        jmodels.LlamaConfig.tiny()), tm)
    ids = np.random.default_rng(0).integers(0, 256, (3, 17))
    # the port's program has a dynamic sequence too (the JAX export
    # refuses a symbolic one: its rope slice does not broadcast)
    return jm, tm.eval(), (([None, None], "int32"), ([None, 17], "int32")), \
        (ids.astype(np.int32),)


def _mamba():
    tm = models.MambaForCausalLM(models.MambaConfig.tiny(num_hidden_layers=1),
                                 device="cpu", seed=2)
    jm = jax_twin(lambda: jmodels.MambaForCausalLM(
        jmodels.MambaConfig.tiny(num_hidden_layers=1)), tm)
    ids = np.random.default_rng(1).integers(0, 256, (3, 32))
    spec = ([None, 32], "int32")
    return jm, tm.eval(), (spec, spec), (ids.astype(np.int32),)


class _JUNet(jpt.nn.Layer):
    def __init__(self, unet):
        super().__init__()
        self.unet = unet

    def forward(self, sample, timestep, context):
        return self.unet(sample, timestep, context)


def _unet():
    tm = models.UNet2DConditionModel(models.UNetConfig.tiny(block_out_channels=(32,)), device="cpu",
                                     seed=3)
    jm = _JUNet(jax_twin(lambda: jmodels.UNet2DConditionModel(
        jmodels.UNetConfig.tiny(block_out_channels=(32,))), tm))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    return jm, tm.eval(), None, (x, t, ctx)


@pytest.mark.parametrize("make", [_llama, _mamba, _unet],
                         ids=["llama", "mamba", "unet"])
def test_models_save_and_load_in_both_packages(make, tmp_path):
    jm, tm, specs, inputs = make()
    if specs is not None:
        (tshape, dtype), (jshape, _) = specs
        tspecs = [static.InputSpec(tshape, dtype)]
        jspecs = [jstatic.InputSpec(jshape, dtype)]
    else:
        tspecs = [torch.as_tensor(a) for a in inputs]
        jspecs = [jnp.asarray(a) for a in inputs]
    jit.save(tm, str(tmp_path / "t"), input_spec=tspecs)
    jjit.save(jm, str(tmp_path / "j"), input_spec=jspecs)
    tl, jl = jit.load(str(tmp_path / "t")), jjit.load(str(tmp_path / "j"))
    got = tl(*(torch.as_tensor(a) for a in inputs))
    close(got, jl(*(jnp.asarray(a) for a in inputs)))
    with torch.no_grad():
        assert torch.equal(got, tm(*(torch.as_tensor(a) for a in inputs)))
    if specs is None:
        return
    # a batch of one, never traced
    close(tl(torch.as_tensor(inputs[0][:1])), jl(jnp.asarray(inputs[0][:1])))
    if tspecs[0].shape[1] is None:
        # sequences never traced (the rope tables bound them by the
        # model's positions): the port's program against its eager
        # forward, and one against the JAX model's
        ids = inputs[0]
        for b, s in ((1, 9), (2, 1)):
            x = torch.as_tensor(ids[:b, :s])
            with torch.no_grad():
                assert torch.equal(tl(x), tm(x))
        close(tl(torch.as_tensor(ids[:1, :9])),
              jax_call(jm, jnp.asarray(ids[:1, :9])))
