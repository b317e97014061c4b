"""``paddle_tpu_torch.distribution`` against ``paddle_tpu.distribution``
(``tests/test_distribution.py``'s cases on both packages): the public
names; every density, entropy and KL divergence on the same float32
parameters and values at 1e-5 (relative to each result's magnitude);
the KL registry ahead of the built-in pairs; transforms and
``TransformedDistribution``; ``ExponentialFamily``'s entropy by autograd.
Samples are the port's own draws (an explicit generator; JAX threads
keys): their shapes, supports and, over 20000 draws, means within 5
standard errors of each distribution's mean."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu import distribution as jd
from paddle_tpu_torch import distribution as td
from paddle_tpu_torch.core import device as core_device


@pytest.fixture(autouse=True)
def on_cpu():
    saved = core_device._current
    tpt.set_device("cpu")
    yield
    core_device.set_current(saved)


def near(got, want, tol=1e-5):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    fin = np.isfinite(w)
    assert np.array_equal(fin, np.isfinite(g))
    scale = max(float(np.abs(w[fin]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=tol * scale)
    assert np.array_equal(g[~fin], w[~fin])


RNG = np.random.default_rng(0)
POS = (RNG.random(3) + 0.5).astype(np.float32)
POS2 = (RNG.random(3) + 0.7).astype(np.float32)
LOC = RNG.standard_normal(3).astype(np.float32)
P = np.array([0.2, 0.5, 0.9], np.float32)
PROBS = np.array([0.1, 0.3, 0.6], np.float32)
CONC = np.array([[0.5, 1.5, 2.0], [3.0, 1.0, 0.7]], np.float32)

# name -> (args, values for log_prob); every parameter array is float32
CASES = {
    "Normal": ((LOC, POS), RNG.standard_normal(3)),
    "Uniform": ((LOC, LOC + POS), LOC + np.array([0.1, -1.0, 0.2])),
    "Categorical": ((np.log(np.stack([PROBS, PROBS[::-1], PROBS ** 2])),),
                    np.array([0, 2, 1])),
    "Bernoulli": ((P,), np.array([1.0, 0.0, 1.0])),
    "Exponential": ((POS,), np.array([0.3, -1.0, 2.0])),
    "Laplace": ((LOC, POS), RNG.standard_normal(3)),
    "Gumbel": ((LOC, POS), RNG.standard_normal(3)),
    "Gamma": ((POS, POS2), np.array([0.5, 2.0, -1.0])),
    "Beta": ((POS, POS2), np.array([0.2, 0.9, 1.5])),
    "Dirichlet": ((CONC,), np.array([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1]])),
    "LogNormal": ((LOC, POS), np.array([0.5, 2.0, -1.0])),
    "Multinomial": ((5, PROBS), np.array([1.0, 1.0, 3.0])),
    "Poisson": ((POS * 3,), np.array([0.0, 2.0, 5.0])),
    "Geometric": ((P,), np.array([0.0, 3.0, 1.0])),
    "Cauchy": ((LOC, POS), RNG.standard_normal(3)),
    "StudentT": ((POS * 4, LOC, POS2), RNG.standard_normal(3)),
    "Binomial": ((np.array([5.0, 8.0, 3.0], np.float32), P),
                 np.array([2.0, 8.0, 0.0])),
    "ContinuousBernoulli": ((np.array([0.2, 0.5, 0.8], np.float32),),
                            np.array([0.3, 0.5, 0.9])),
}


def _pair(name):
    args, value = CASES[name]
    t = getattr(td, name)(*(torch.tensor(a) if isinstance(a, np.ndarray)
                            else a for a in args))
    j = getattr(jd, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                            else a for a in args))
    return t, j, (value if name == "Categorical"
                  else value.astype(np.float32))


def test_public_names_match_jax():
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and getattr(getattr(mod, n), "__module__", None)
                == mod.__name__}

    names = public(jd)
    assert len(names) == 30 and names == public(td)


@pytest.mark.parametrize("name", sorted(CASES))
def test_log_prob_and_entropy_match_jax(name):
    t, j, value = _pair(name)
    near(t.log_prob(torch.tensor(value)), j.log_prob(jnp.asarray(value)))
    if hasattr(jd.Distribution, "entropy") and name not in (
            "Multinomial", "Poisson", "Binomial", "ContinuousBernoulli"):
        near(t.entropy(), j.entropy())
    for attr in ("mean", "variance"):
        if isinstance(getattr(type(j), attr, None), property):
            near(getattr(t, attr), getattr(j, attr))


KL_PAIRS = ["Normal", "Categorical", "Bernoulli", "Exponential", "Gamma",
            "Beta", "Dirichlet", "Cauchy"]


@pytest.mark.parametrize("name", KL_PAIRS)
def test_kl_divergence_matches_jax(name):
    t, j, _ = _pair(name)
    args, _ = CASES[name]
    args2 = tuple(np.flip(a).copy() if isinstance(a, np.ndarray) else a
                  for a in args)
    t2 = getattr(td, name)(*(torch.tensor(a) if isinstance(a, np.ndarray)
                             else a for a in args2))
    j2 = getattr(jd, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                             else a for a in args2))
    near(td.kl_divergence(t, t2), jd.kl_divergence(j, j2))


def test_kl_special_cases_registry_and_independent():
    u1, u2 = td.Uniform(0.0, 1.0), td.Uniform(-1.0, 2.0)
    ju1, ju2 = jd.Uniform(0.0, 1.0), jd.Uniform(-1.0, 2.0)
    near(td.kl_divergence(u1, u2), jd.kl_divergence(ju1, ju2))
    near(td.kl_divergence(u2, u1), jd.kl_divergence(ju2, ju1))  # inf
    ind = td.Independent(td.Normal(torch.tensor(LOC), torch.tensor(POS)), 1)
    ind2 = td.Independent(td.Normal(torch.tensor(POS), torch.tensor(POS2)), 1)
    jind = jd.Independent(jd.Normal(jnp.asarray(LOC), jnp.asarray(POS)), 1)
    jind2 = jd.Independent(jd.Normal(jnp.asarray(POS), jnp.asarray(POS2)), 1)
    near(td.kl_divergence(ind, ind2), jd.kl_divergence(jind, jind2))
    v = RNG.standard_normal(3).astype(np.float32)
    near(ind.log_prob(torch.tensor(v)), jind.log_prob(jnp.asarray(v)))
    near(ind.entropy(), jind.entropy())

    class Mine(td.Normal):
        pass

    @td.register_kl(Mine, td.Normal)
    def _(p, q):
        return torch.tensor(42.0)

    assert float(td.kl_divergence(Mine(0.0, 1.0), td.Normal(0.0, 1.0))) \
        == 42.0
    with pytest.raises(NotImplementedError):
        td.kl_divergence(td.Normal(0.0, 1.0), td.Gamma(1.0, 1.0))


def test_transforms_match_jax():
    x = RNG.standard_normal(4).astype(np.float32)
    tt = [td.AffineTransform(0.5, 2.0), td.ExpTransform()]
    jt = [jd.AffineTransform(0.5, 2.0), jd.ExpTransform()]
    for t, j in zip(tt + [td.SigmoidTransform(), td.TanhTransform(),
                          td.ChainTransform(tt)],
                    jt + [jd.SigmoidTransform(), jd.TanhTransform(),
                          jd.ChainTransform(jt)]):
        y = t.forward(torch.tensor(x))
        near(y, j.forward(jnp.asarray(x)))
        near(t.forward_log_det_jacobian(torch.tensor(x)),
             j.forward_log_det_jacobian(jnp.asarray(x)))
        near(t.inverse(y), x, 1e-4)
    tdist = td.TransformedDistribution(td.Normal(0.0, 1.0), tt)
    jdist = jd.TransformedDistribution(jd.Normal(0.0, 1.0), jt)
    v = np.array([0.7, 2.0, 5.0], np.float32)
    near(tdist.log_prob(torch.tensor(v)), jdist.log_prob(jnp.asarray(v)))


def test_exponential_family_entropy_by_autograd():
    class Exp(td.ExponentialFamily):
        rate = 2.0

        @property
        def _natural_parameters(self):
            return (torch.tensor(-self.rate),)

        def _log_normalizer(self, t):
            return -torch.log(-t)

    class JExp(jd.ExponentialFamily):
        rate = 2.0

        @property
        def _natural_parameters(self):
            return (jnp.asarray(-self.rate),)

        def _log_normalizer(self, t):
            return -jnp.log(-t)

    near(Exp().entropy(), JExp().entropy())
    near(Exp().entropy(), td.Exponential(2.0).entropy())


# name -> (mean, variance) of one draw
MOMENTS = {
    "Normal": (LOC, POS ** 2),
    "Uniform": (LOC + POS / 2, POS ** 2 / 12),
    "Bernoulli": (P, P * (1 - P)),
    "Exponential": (1 / POS, 1 / POS ** 2),
    "Laplace": (LOC, 2 * POS ** 2),
    "Gumbel": (LOC + 0.5772156649 * POS, math.pi ** 2 / 6 * POS ** 2),
    "Gamma": (POS / POS2, POS / POS2 ** 2),
    "Beta": (POS / (POS + POS2),
             POS * POS2 / ((POS + POS2) ** 2 * (POS + POS2 + 1))),
    "Poisson": (POS * 3, POS * 3),
    "Geometric": ((1 - P) / P, (1 - P) / P ** 2),
    "Binomial": (np.array([5.0, 8.0, 3.0]) * P,
                 np.array([5.0, 8.0, 3.0]) * P * (1 - P)),
}


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_samples_have_the_distributions_moments(name):
    t, _, _ = _pair(name)
    g = torch.Generator().manual_seed(7)
    n = 20000
    x = t.sample((n,), generator=g)
    assert tuple(x.shape) == (n, 3)
    mean, var = MOMENTS[name]
    se = np.sqrt(np.asarray(var, np.float64) / n)
    err = np.abs(x.double().mean(0).numpy() - np.asarray(mean, np.float64))
    assert np.all(err < 5 * se), (err, se)
    # the same generator state draws the same samples
    again = t.sample((n,), generator=torch.Generator().manual_seed(7))
    assert torch.equal(x, again)


def test_other_samplers_shapes_and_supports():
    g = torch.Generator().manual_seed(1)
    for name, shape in (("Categorical", (50, 3)), ("Dirichlet", (50, 2, 3)),
                        ("Multinomial", (50, 3)), ("Cauchy", (50, 3)),
                        ("StudentT", (50, 3)), ("LogNormal", (50, 3)),
                        ("ContinuousBernoulli", (50, 3))):
        t, _, _ = _pair(name)
        x = t.sample((50,), generator=g)
        assert tuple(x.shape) == shape, name
    t, _, _ = _pair("Dirichlet")
    assert torch.allclose(t.sample((5,), generator=g).sum(-1),
                          torch.ones(5, 2))
    t, _, _ = _pair("Multinomial")
    assert torch.all(t.sample((5,), generator=g).sum(-1) == 5)
    t, _, _ = _pair("ContinuousBernoulli")
    x = t.sample((100,), generator=g)
    assert torch.all((x >= 0) & (x <= 1))
    # without a generator: the port's generator for the device
    tpt.seed(3)
    a = td.Normal(0.0, 1.0).sample((4,))
    tpt.seed(3)
    assert torch.equal(a, td.Normal(0.0, 1.0).sample((4,)))
