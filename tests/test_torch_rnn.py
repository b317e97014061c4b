"""The port's recurrent layers (``paddle_tpu_torch/nn/layer/rnn.py``:
``SimpleRNN``, ``LSTM``, ``GRU``) against the JAX package on the CPU: 2
layers, bidirectional, batch-first and time-major, with and without
initial states: the outputs, the final states and every parameter's
gradient (and the input's) after ``load_numpy_state_dict``, float32, 1e-5
for forwards and 1e-4 of each gradient's largest entry. The independent
witness: ``torch.nn.RNN``/``LSTM``/``GRU`` with the weights transposed by
``convert.rnn_state_dict_to_torch``. A bf16 layer's float32 carry gives
float32 outputs and states in both packages."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import carry, close, jit_o0, scaled_close

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.core.functional import extract_params, functional_call
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import rnn_state_dict_to_torch

B, S, IN, H = 3, 7, 8, 16

# (id, layer, constructor kwargs, time major, initial states)
CASES = [
    ("simple_tanh_bidirect", "SimpleRNN", dict(num_layers=2,
                                               direction="bidirect"),
     False, False),
    ("simple_relu_states", "SimpleRNN", dict(activation="relu"), False,
     True),
    ("lstm_bidirectional", "LSTM", dict(num_layers=2,
                                        direction="bidirectional"), False,
     False),
    ("lstm_time_major_states", "LSTM", dict(num_layers=2, time_major=True),
     True, True),
    ("gru_bidirect_states", "GRU", dict(num_layers=2, direction="bidirect"),
     False, True),
    ("gru_time_major", "GRU", dict(time_major=True), True, False),
]


def _inputs(name, kw, time_major, with_states, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, B, IN) if time_major else (B, S, IN))
    args = [x.astype(np.float32)]
    if with_states:
        ndir = 2 if kw.get("direction", "forward") != "forward" else 1
        shape = (kw.get("num_layers", 1) * ndir, B, H)
        states = [rng.standard_normal(shape).astype(np.float32) * 0.5
                  for _ in range(2 if name == "LSTM" else 1)]
        args.append(tuple(states) if name == "LSTM" else states[0])
    return args


def _weights(shape, xp):
    n = int(np.prod(shape))
    return xp.cos(xp.arange(n, dtype=xp.float32) * 0.3).reshape(shape) + 1.2


def _objective(out, states, xp):
    """A weighted sum of the outputs and every final state."""
    states = states if isinstance(states, tuple) else (states,)
    return sum((t * _weights(t.shape, xp)).sum() for t in (out, *states))


def _pair(name, kw, seed):
    pt.seed(seed)
    jlayer = getattr(jnn, name)(IN, H, **kw)
    tlayer = getattr(tnn, name)(IN, H, **kw, device="cpu")
    return jlayer, carry(jlayer, tlayer)


def _jax_run(jlayer, args):
    def f(params, x, *states):
        out, last = functional_call(jlayer, params, x, *states)
        return _objective(out, last, jnp), (out, last)

    grad = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)
    (_, (out, last)), (gp, gx) = jit_o0(grad, extract_params(jlayer),
                                        *[jnp.asarray(a) if not isinstance(
                                            a, tuple) else tuple(map(
                                                jnp.asarray, a))
                                          for a in args])
    return out, last, gp, gx


def _torch_run(tlayer, args):
    x = torch.tensor(args[0], requires_grad=True)
    rest = [tuple(map(torch.as_tensor, a)) if isinstance(a, tuple)
            else torch.as_tensor(a) for a in args[1:]]
    out, last = tlayer(x, *rest)
    _objective(out, last, torch).backward()
    return out, last, x.grad


def _states(last):
    return last if isinstance(last, tuple) else (last,)


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_rnn_outputs_states_and_gradients_match_jax(cid):
    _, name, kw, time_major, with_states = next(
        c for c in CASES if c[0] == cid)
    jlayer, tlayer = _pair(name, kw, seed=len(cid))
    args = _inputs(name, kw, time_major, with_states)
    jout, jlast, jgp, jgx = _jax_run(jlayer, args)
    out, last, gx = _torch_run(tlayer, args)
    close(out, jout)
    assert len(_states(last)) == len(_states(jlast))
    for got, want in zip(_states(last), _states(jlast)):
        close(got, want)
    scaled_close(gx, jgx)
    params = dict(tlayer.named_parameters())
    assert set(params) == set(jgp)
    for n, g in jgp.items():
        scaled_close(params[n].grad, g)


def test_parameter_layout_and_names_are_the_jax_ones():
    layer = tnn.GRU(IN, H, num_layers=2, direction="bidirect", device="cpu")
    shapes = {n: tuple(p.shape) for n, p in layer.named_parameters()}
    assert shapes["weight_ih_l0"] == (IN, 3 * H)
    assert shapes["weight_ih_l1_rev"] == (2 * H, 3 * H)
    assert shapes["weight_hh_l1"] == (H, 3 * H)
    assert len(shapes) == 16
    assert all(float(p.detach().abs().max()) == 0.0
               for n, p in layer.named_parameters() if n.startswith("bias"))
    with pytest.raises(ValueError, match="direction"):
        tnn.LSTM(IN, H, direction="backward", device="cpu")


# the independent witness: torch.nn's own recurrent layers
WITNESS = [("SimpleRNN", torch.nn.RNN), ("LSTM", torch.nn.LSTM),
           ("GRU", torch.nn.GRU)]


@pytest.mark.parametrize("name,ref_cls", WITNESS,
                         ids=[w[0] for w in WITNESS])
def test_rnn_matches_torch_nn_with_transposed_weights(name, ref_cls):
    layer = getattr(tnn, name)(IN, H, num_layers=2, direction="bidirect",
                               device="cpu", generator=torch.Generator()
                               .manual_seed(4))
    with torch.no_grad():  # nonzero biases, so their layout is checked too
        for n, p in layer.named_parameters():
            if n.startswith("bias"):
                p.copy_(torch.linspace(-0.3, 0.3, p.numel()))
    ref = ref_cls(IN, H, num_layers=2, bidirectional=True, batch_first=True)
    ref.load_state_dict(rnn_state_dict_to_torch(layer.state_dict()))
    x = torch.as_tensor(_inputs(name, {}, False, False)[0])
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    out, last = layer(xs[0])
    rout, rlast = ref(xs[1])
    close(out, rout)
    for got, want in zip(_states(last), _states(rlast)):
        close(got, want)
    _objective(out, last, torch).backward()
    _objective(rout, rlast, torch).backward()
    scaled_close(xs[0].grad, xs[1].grad)


def test_bf16_layer_runs_a_float32_carry_as_jax_does():
    """A bf16 LSTM: the input projection in bf16, the carry float32 (JAX's
    init), each matmul promoted as ``jnp.matmul`` promotes: float32
    outputs and states in both packages, within bf16's rounding."""
    jlayer, tlayer = _pair("LSTM", dict(num_layers=2, direction="bidirect"),
                           seed=9)
    jlayer = jlayer.astype("bfloat16")
    tlayer = tlayer.to(torch.bfloat16)
    x = _inputs("LSTM", {}, False, False)[0]
    jout, (jh, jc) = jax.jit(lambda a: jlayer(a))(
        jnp.asarray(x, jnp.bfloat16))
    out, (h, c) = tlayer(torch.as_tensor(x).to(torch.bfloat16))
    assert (out.dtype, h.dtype, c.dtype) == (torch.float32,) * 3
    assert (jout.dtype, jh.dtype, jc.dtype) == (jnp.float32,) * 3
    for got, want in ((out, jout), (h, jh), (c, jc)):
        close(got, want, tol=3e-2)
