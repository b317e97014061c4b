"""Helpers the port's model parity tests share
(``tests/test_torch_{gpt,bert,t5,moe,transformer,vit,vision_*}.py``):
numpy views of either framework's tensors, the tolerance checks,
carrying a JAX model's weights into its port counterpart, JAX's loss and
gradients of a model, and the port's gradients held against them.

Tolerances (float32 on both sides): 1e-5 for forwards, the two
frameworks' float32 matmuls and reductions summing in other orders; 1e-4
for gradients and TrainStep trajectories, which add the backward's sums
and, over steps, Adam's normalised updates on top."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.core.functional import extract_params, functional_call
from paddle_tpu_torch.convert import load_numpy_state_dict

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def as_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def close(got, want, tol=FWD_TOL):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


def scaled_close(got, want, tol=GRAD_TOL):
    """Every entry within ``tol`` of the largest magnitude of ``want``
    (how the vision tests hold gradients)."""
    g, w = as_np(got), as_np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
    err = float(np.abs(g - w).max(initial=0.0))
    assert err <= tol * scale, f"max error {err:.3e} > {tol} x {scale:.3e}"


def carry(jmodel, tmodel):
    """``tmodel`` with ``jmodel``'s weights (strict: every key and shape
    must match)."""
    return load_numpy_state_dict(
        tmodel, {k: np.asarray(v) for k, v in jmodel.state_dict().items()})


def jax_twin(make_jax, tmodel):
    """The JAX model ``make_jax()`` builds, under JAX's meta init (no
    initializer runs: each would compile one program a shape), holding
    ``tmodel``'s weights and buffers (strict: every key and shape)."""
    from paddle_tpu.core.meta import meta_init

    with meta_init():
        jmodel = make_jax()
    state = {k: v.detach().float().cpu().numpy()
             for k, v in tmodel.state_dict().items()}
    own = jmodel.state_dict()
    assert set(own) == set(state), sorted(set(own) ^ set(state))
    assert all(tuple(own[k].shape) == state[k].shape for k in own)
    jmodel.set_state_dict(state)
    return jmodel


def jit_o0(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimisation level
    0: the parity tests' programs run once, and compile in two thirds of
    the default's time."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def jax_call(jmodel, *args, **kw):
    """The JAX model's forward, jitted (one compile is cheaper than
    dispatching each operation eagerly)."""
    def f(p):
        return functional_call(jmodel, p, *args, **kw)

    return jax.jit(f)(extract_params(jmodel))


def jax_value_and_grads(jmodel, *args, **kw):
    """The JAX model's output (a scalar loss) and its gradient by
    parameter name, through ``functional_call``, jitted."""
    def f(p):
        return functional_call(jmodel, p, *args, **kw)

    return jax.jit(jax.value_and_grad(f))(extract_params(jmodel))


def check_grads(tmodel, want, tol=GRAD_TOL):
    """Every port parameter's ``.grad`` against JAX's gradient of the same
    name; the two models name the same parameters. A parameter the loss
    does not reach has no ``.grad`` in torch and zeros in JAX."""
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        p = got[name]
        close(p.grad if p.grad is not None else torch.zeros_like(p), g, tol)


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def trajectory(jmodel, tmodel, batch, steps=3, tol=GRAD_TOL):
    """``steps`` AdamW steps (float32 masters, as the JAX suite trains)
    on one fixed batch through the JAX ``TrainStep`` on a one-device CPU
    mesh and the port's ``TrainStep``: the losses step by step within
    ``tol`` relative, and falling."""
    from paddle_tpu import distributed as jdist
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.trainer import TrainStep as JTrainStep
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.trainer import TrainStep

    opt = dict(learning_rate=3e-3, weight_decay=0.01, multi_precision=True)
    js = JTrainStep(jmodel, jopt.AdamW(**opt),
                    jdist.build_mesh(devices=jax.devices()[:1]))
    ts = TrainStep(tmodel, topt.AdamW(**opt))
    losses = []
    for _ in range(steps):
        want = float(js.run(to_jax(batch)))
        losses.append(float(ts.run(batch)))
        np.testing.assert_allclose(losses[-1], want, rtol=tol)
    assert losses[-1] < losses[0]
    return losses
