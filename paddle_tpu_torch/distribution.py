"""Probability distributions (counterpart of
``paddle_tpu/distribution.py``; parity: ``paddle.distribution``): the
same 30 public names, densities, entropies and KL divergences, in
float32.

Sampling takes an explicit ``generator=`` (``sample(shape,
generator=None)``); without one it draws from the port's generator for
the parameters' device (``core.random.default_generator``), which
``paddle_tpu_torch.seed`` seeds. The draws are the port's own (torch's
samplers, or JAX's formula where JAX builds the sampler from uniforms);
their distributions, not their bits, match JAX's. A parameter given as
a number is placed beside the tensor parameters, or on the current
device when there are none.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .core import random as random_mod
from .core.device import current_device

_EULER_GAMMA = 0.5772156649015329


def _params(*xs):
    """``xs`` as float32 tensors on one device: that of the first tensor
    among them, else the current device."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    dev = current_device() if dev is None else dev
    return [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in xs]


def _gen(generator, t):
    return (generator if generator is not None
            else random_mod.default_generator(t.device))


def _shape(shape, *ts):
    return tuple(shape) + tuple(torch.broadcast_shapes(
        *(t.shape for t in ts)))


def _uniform(shape, t, generator, low=0.0, high=1.0):
    u = torch.rand(shape, generator=_gen(generator, t), device=t.device)
    return low + (high - low) * u


def _as(value, like):
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _std_gamma(conc, shape, generator):
    conc = conc.expand(shape).contiguous()
    return torch._standard_gamma(conc, generator=_gen(generator, conc))


class Distribution:
    def sample(self, shape=(), generator=None):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def probs(self, value):
        return torch.exp(self.log_prob(value))


class Normal(Distribution):
    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    def sample(self, shape=(), generator=None):
        shape = _shape(shape, self.loc, self.scale)
        z = torch.randn(shape, generator=_gen(generator, self.loc),
                        device=self.loc.device)
        return self.loc + self.scale * z

    rsample = sample

    def log_prob(self, value):
        var = self.scale ** 2
        return (-((_as(value, self.loc) - self.loc) ** 2) / (2 * var)
                - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)

    def kl_divergence(self, other: "Normal"):
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


class Uniform(Distribution):
    def __init__(self, low, high):
        self.low, self.high = _params(low, high)

    def sample(self, shape=(), generator=None):
        return _uniform(_shape(shape, self.low, self.high), self.low,
                        generator, self.low, self.high)

    def log_prob(self, value):
        value = _as(value, self.low)
        inside = (value >= self.low) & (value <= self.high)
        return torch.where(inside, -torch.log(self.high - self.low),
                           -math.inf)

    def entropy(self):
        return torch.log(self.high - self.low)


class Categorical(Distribution):
    def __init__(self, logits=None, probs=None):
        if logits is None:
            (probs,) = _params(probs)
            logits = torch.log(probs + 1e-30)
        (self.logits,) = _params(logits)

    def sample(self, shape=(), generator=None):
        shape = tuple(shape)
        p = torch.softmax(self.logits, -1).reshape(-1, self.logits.shape[-1])
        n = max(1, math.prod(shape))
        draws = torch.multinomial(p, n, replacement=True,
                                  generator=_gen(generator, p))
        draws = draws.T.reshape(shape + tuple(self.logits.shape[:-1]))
        return draws

    def log_prob(self, value):
        logp = F.log_softmax(self.logits, dim=-1)
        idx = torch.as_tensor(value, device=logp.device).long()
        logp = logp.expand(tuple(idx.shape) + logp.shape[-1:])
        return torch.gather(logp, -1, idx[..., None]).squeeze(-1)

    def entropy(self):
        logp = F.log_softmax(self.logits, dim=-1)
        return -(torch.exp(logp) * logp).sum(-1)


class Bernoulli(Distribution):
    def __init__(self, probs):
        (self.probs_,) = _params(probs)

    def sample(self, shape=(), generator=None):
        p = self.probs_.expand(tuple(shape) + tuple(self.probs_.shape))
        return torch.bernoulli(p, generator=_gen(generator, p))

    def log_prob(self, value):
        p = self.probs_.clamp(1e-7, 1 - 1e-7)
        value = _as(value, p)
        return value * torch.log(p) + (1 - value) * torch.log1p(-p)

    def entropy(self):
        p = self.probs_.clamp(1e-7, 1 - 1e-7)
        return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))


class Exponential(Distribution):
    def __init__(self, rate):
        (self.rate,) = _params(rate)

    def sample(self, shape=(), generator=None):
        shape = tuple(shape) + tuple(self.rate.shape)
        e = torch.empty(shape, device=self.rate.device).exponential_(
            generator=_gen(generator, self.rate))
        return e / self.rate

    def log_prob(self, value):
        value = _as(value, self.rate)
        return torch.where(value >= 0,
                           torch.log(self.rate) - self.rate * value,
                           -math.inf)

    def entropy(self):
        return 1.0 - torch.log(self.rate)

    @property
    def mean(self):
        return 1.0 / self.rate


class Laplace(Distribution):
    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    def sample(self, shape=(), generator=None):
        u = _uniform(_shape(shape, self.loc, self.scale), self.loc,
                     generator, -0.5, 0.5)
        # the inverse cdf, as jax.random.laplace draws
        return self.loc - self.scale * torch.sign(u) * torch.log1p(
            -2 * u.abs().clamp(max=0.5 - 1e-7))

    def log_prob(self, value):
        return (-(_as(value, self.loc) - self.loc).abs() / self.scale
                - torch.log(2 * self.scale))

    def entropy(self):
        return 1.0 + torch.log(2 * self.scale)


class Gumbel(Distribution):
    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    def sample(self, shape=(), generator=None):
        u = _uniform(_shape(shape, self.loc, self.scale), self.loc,
                     generator).clamp(1e-12, 1 - 1e-7)
        return self.loc - self.scale * torch.log(-torch.log(u))

    def log_prob(self, value):
        z = (_as(value, self.loc) - self.loc) / self.scale
        return -(z + torch.exp(-z)) - torch.log(self.scale)

    def entropy(self):
        return torch.log(self.scale) + 1.0 + _EULER_GAMMA


class Gamma(Distribution):
    def __init__(self, concentration, rate):
        self.concentration, self.rate = _params(concentration, rate)

    def sample(self, shape=(), generator=None):
        shape = _shape(shape, self.concentration, self.rate)
        return _std_gamma(self.concentration, shape, generator) / self.rate

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        value = _as(value, a)
        v = torch.where(value > 0, value, 1.0)
        lp = (a * torch.log(b) + (a - 1) * torch.log(v) - b * v
              - torch.lgamma(a))
        return torch.where(value > 0, lp, -math.inf)

    def entropy(self):
        a, b = self.concentration, self.rate
        return (a - torch.log(b) + torch.lgamma(a)
                + (1 - a) * torch.digamma(a))

    @property
    def mean(self):
        return self.concentration / self.rate


class Beta(Distribution):
    def __init__(self, alpha, beta):
        self.alpha, self.beta = _params(alpha, beta)

    def sample(self, shape=(), generator=None):
        shape = _shape(shape, self.alpha, self.beta)
        x = _std_gamma(self.alpha, shape, generator)
        y = _std_gamma(self.beta, shape, generator)
        return x / (x + y)

    def log_prob(self, value):
        a, b = self.alpha, self.beta
        value = _as(value, a)
        inside = (value > 0) & (value < 1)
        v = torch.where(inside, value, 0.5)
        lp = ((a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v)
              - _betaln(a, b))
        return torch.where(inside, lp, -math.inf)

    def entropy(self):
        a, b = self.alpha, self.beta
        dg = torch.digamma
        return (_betaln(a, b) - (a - 1) * dg(a) - (b - 1) * dg(b)
                + (a + b - 2) * dg(a + b))

    @property
    def mean(self):
        return self.alpha / (self.alpha + self.beta)


class Dirichlet(Distribution):
    def __init__(self, concentration):
        (self.concentration,) = _params(concentration)

    def sample(self, shape=(), generator=None):
        a = self.concentration.expand(
            tuple(shape) + tuple(self.concentration.shape)).contiguous()
        return torch._sample_dirichlet(a, generator=_gen(generator, a))

    def log_prob(self, value):
        a = self.concentration
        return ((a - 1) * torch.log(_as(value, a))).sum(-1) \
            + torch.lgamma(a.sum(-1)) - torch.lgamma(a).sum(-1)

    def entropy(self):
        a = self.concentration
        a0 = a.sum(-1)
        k = a.shape[-1]
        dg = torch.digamma
        return (torch.lgamma(a).sum(-1) - torch.lgamma(a0)
                + (a0 - k) * dg(a0) - ((a - 1) * dg(a)).sum(-1))


class LogNormal(Distribution):
    def __init__(self, loc, scale):
        self.base = Normal(loc, scale)
        self.loc, self.scale = self.base.loc, self.base.scale

    def sample(self, shape=(), generator=None):
        return torch.exp(self.base.sample(shape, generator))

    def log_prob(self, value):
        value = _as(value, self.loc)
        v = torch.where(value > 0, value, 1.0)
        lp = self.base.log_prob(torch.log(v)) - torch.log(v)
        return torch.where(value > 0, lp, -math.inf)

    def entropy(self):
        return self.base.entropy() + self.loc

    @property
    def mean(self):
        return torch.exp(self.loc + self.scale ** 2 / 2)


class Multinomial(Distribution):
    def __init__(self, total_count, probs):
        self.total_count = int(total_count)
        (self.probs_,) = _params(probs)

    def sample(self, shape=(), generator=None):
        shape = tuple(shape)
        k = self.probs_.shape[-1]
        cat = Categorical(logits=torch.log(self.probs_ + 1e-30))
        draws = cat.sample(shape + (self.total_count,), generator)
        return F.one_hot(draws, k).to(torch.float32).sum(dim=len(shape))

    def log_prob(self, value):
        value = _as(value, self.probs_)
        return (math.lgamma(self.total_count + 1.0)
                - torch.lgamma(value + 1.0).sum(-1)
                + (value * torch.log(self.probs_ + 1e-30)).sum(-1))


class Poisson(Distribution):
    def __init__(self, rate):
        (self.rate,) = _params(rate)

    def sample(self, shape=(), generator=None):
        r = self.rate.expand(tuple(shape) + tuple(self.rate.shape))
        return torch.poisson(r.contiguous(), generator=_gen(generator, r))

    def log_prob(self, value):
        value = _as(value, self.rate)
        v = torch.where(value >= 0, value, 0.0)
        lp = (v * torch.log(self.rate) - self.rate
              - torch.lgamma(v + 1.0))
        return torch.where(value >= 0, lp, -math.inf)

    @property
    def mean(self):
        return self.rate


def _builtin_kl(p: Distribution, q: Distribution):
    dg = torch.digamma
    if isinstance(p, Normal) and isinstance(q, Normal):
        return p.kl_divergence(q)
    if isinstance(p, Categorical) and isinstance(q, Categorical):
        lp = F.log_softmax(p.logits, -1)
        lq = F.log_softmax(q.logits, -1)
        return (torch.exp(lp) * (lp - lq)).sum(-1)
    if isinstance(p, Bernoulli) and isinstance(q, Bernoulli):
        pp = p.probs_.clamp(1e-7, 1 - 1e-7)
        qq = q.probs_.clamp(1e-7, 1 - 1e-7)
        return pp * (torch.log(pp) - torch.log(qq)) + \
            (1 - pp) * (torch.log1p(-pp) - torch.log1p(-qq))
    if isinstance(p, Uniform) and isinstance(q, Uniform):
        out = torch.log((q.high - q.low) / (p.high - p.low))
        ok = (q.low <= p.low) & (p.high <= q.high)
        return torch.where(ok, out, math.inf)
    if isinstance(p, Exponential) and isinstance(q, Exponential):
        r = p.rate / q.rate
        return torch.log(r) + 1.0 / r - 1.0
    if isinstance(p, Gamma) and isinstance(q, Gamma):
        pa, pb, qa, qb = p.concentration, p.rate, q.concentration, q.rate
        return ((pa - qa) * dg(pa) - torch.lgamma(pa) + torch.lgamma(qa)
                + qa * (torch.log(pb) - torch.log(qb))
                + pa * (qb - pb) / pb)
    if isinstance(p, Beta) and isinstance(q, Beta):
        gl_t = _betaln(q.alpha, q.beta) - _betaln(p.alpha, p.beta)
        return (gl_t + (p.alpha - q.alpha) * dg(p.alpha)
                + (p.beta - q.beta) * dg(p.beta)
                + (q.alpha - p.alpha + q.beta - p.beta)
                * dg(p.alpha + p.beta))
    if isinstance(p, Dirichlet) and isinstance(q, Dirichlet):
        pa, qa = p.concentration, q.concentration
        pa0 = pa.sum(-1)
        return (torch.lgamma(pa0) - torch.lgamma(pa).sum(-1)
                - torch.lgamma(qa.sum(-1)) + torch.lgamma(qa).sum(-1)
                + ((pa - qa) * (dg(pa) - dg(pa0)[..., None])).sum(-1))
    raise NotImplementedError(
        f"kl_divergence({type(p).__name__}, {type(q).__name__})")


# ---------------------------------------------------------------------------
# transforms and TransformedDistribution
# ---------------------------------------------------------------------------
class Transform:
    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def forward_log_det_jacobian(self, x):
        raise NotImplementedError


class AffineTransform(Transform):
    """y = loc + scale * x."""

    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    def forward(self, x):
        return self.loc + self.scale * x

    def inverse(self, y):
        return (y - self.loc) / self.scale

    def forward_log_det_jacobian(self, x):
        return torch.log(self.scale.abs()).expand(torch.as_tensor(x).shape)


class ExpTransform(Transform):
    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def forward_log_det_jacobian(self, x):
        return x


class SigmoidTransform(Transform):
    def forward(self, x):
        return torch.sigmoid(x)

    def inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def forward_log_det_jacobian(self, x):
        return -F.softplus(-x) - F.softplus(x)


class TanhTransform(Transform):
    def forward(self, x):
        return torch.tanh(x)

    def inverse(self, y):
        return torch.atanh(y.clamp(-1 + 1e-6, 1 - 1e-6))

    def forward_log_det_jacobian(self, x):
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class ChainTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def forward(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def inverse(self, y):
        for t in reversed(self.transforms):
            y = t.inverse(y)
        return y

    def forward_log_det_jacobian(self, x):
        total = 0.0
        for t in self.transforms:
            total = total + t.forward_log_det_jacobian(x)
            x = t.forward(x)
        return total


class TransformedDistribution(Distribution):
    """A base distribution pushed through a bijector (or a list of them,
    composed left to right)."""

    def __init__(self, base: Distribution, transforms):
        self.base = base
        if isinstance(transforms, (list, tuple)):
            transforms = ChainTransform(transforms)
        self.transform = transforms

    def sample(self, shape=(), generator=None):
        return self.transform.forward(self.base.sample(shape, generator))

    def log_prob(self, value):
        x = self.transform.inverse(value)
        return (self.base.log_prob(x)
                - self.transform.forward_log_det_jacobian(x))


# ---------------------------------------------------------------------------
# the long tail
# ---------------------------------------------------------------------------
class Geometric(Distribution):
    """Failures before the first success: P(X=k) = (1-p)^k p."""

    def __init__(self, probs):
        (self.probs_,) = _params(probs)

    @property
    def mean(self):
        return (1.0 - self.probs_) / self.probs_

    @property
    def variance(self):
        return (1.0 - self.probs_) / (self.probs_ ** 2)

    def sample(self, shape=(), generator=None):
        shape = tuple(shape) + tuple(self.probs_.shape)
        u = _uniform(shape, self.probs_, generator, 1e-7, 1.0)
        return torch.floor(torch.log(u) / torch.log1p(-self.probs_))

    def log_prob(self, value):
        p = self.probs_.clamp(1e-7, 1 - 1e-7)
        return _as(value, p) * torch.log1p(-p) + torch.log(p)

    def entropy(self):
        p = self.probs_.clamp(1e-7, 1 - 1e-7)
        q = 1.0 - p
        return -(q * torch.log(q) + p * torch.log(p)) / p


class Cauchy(Distribution):
    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    def sample(self, shape=(), generator=None):
        shape = _shape(shape, self.loc, self.scale)
        c = torch.empty(shape, device=self.loc.device).cauchy_(
            generator=_gen(generator, self.loc))
        return self.loc + self.scale * c

    rsample = sample

    def log_prob(self, value):
        z = (_as(value, self.loc) - self.loc) / self.scale
        return -torch.log(math.pi * self.scale * (1.0 + z * z))

    def entropy(self):
        return torch.log(4 * math.pi * self.scale)

    def cdf(self, value):
        z = (_as(value, self.loc) - self.loc) / self.scale
        return torch.atan(z) / math.pi + 0.5

    def kl_divergence(self, other: "Cauchy"):
        num = (self.scale + other.scale) ** 2 + (self.loc - other.loc) ** 2
        return torch.log(num / (4.0 * self.scale * other.scale))


class StudentT(Distribution):
    def __init__(self, df, loc=0.0, scale=1.0):
        self.df, self.loc, self.scale = _params(df, loc, scale)

    def sample(self, shape=(), generator=None):
        shape = _shape(shape, self.df, self.loc, self.scale)
        z = torch.randn(shape, generator=_gen(generator, self.df),
                        device=self.df.device)
        chi2 = 2.0 * _std_gamma(self.df / 2, shape, generator)
        return self.loc + self.scale * z * torch.rsqrt(chi2 / self.df)

    rsample = sample

    def log_prob(self, value):
        v = self.df
        z = (_as(value, v) - self.loc) / self.scale
        return (torch.lgamma((v + 1) / 2) - torch.lgamma(v / 2)
                - 0.5 * torch.log(v * math.pi) - torch.log(self.scale)
                - (v + 1) / 2 * torch.log1p(z * z / v))

    def entropy(self):
        dg = torch.digamma
        v = self.df
        return ((v + 1) / 2 * (dg((v + 1) / 2) - dg(v / 2))
                + 0.5 * torch.log(v) + _betaln(v / 2, _as(0.5, v))
                + torch.log(self.scale))


class Binomial(Distribution):
    def __init__(self, total_count, probs):
        self.total_count, self.probs_ = _params(total_count, probs)

    @property
    def mean(self):
        return self.total_count * self.probs_

    @property
    def variance(self):
        return self.total_count * self.probs_ * (1 - self.probs_)

    def sample(self, shape=(), generator=None):
        shape = _shape(shape, self.total_count, self.probs_)
        n = self.total_count.expand(shape).contiguous()
        p = self.probs_.expand(shape).contiguous()
        return torch.binomial(n, p, generator=_gen(generator, n))

    def log_prob(self, value):
        k = _as(value, self.probs_)
        n = self.total_count
        p = self.probs_.clamp(1e-7, 1 - 1e-7)
        return (torch.lgamma(n + 1) - torch.lgamma(k + 1)
                - torch.lgamma(n - k + 1)
                + k * torch.log(p) + (n - k) * torch.log1p(-p))


class ContinuousBernoulli(Distribution):
    """Density C(l) l^x (1-l)^(1-x) on [0, 1]."""

    def __init__(self, probs, lims=(0.499, 0.501)):
        (self.probs_,) = _params(probs)
        self._lims = lims

    def _near(self):
        l = self.probs_.clamp(1e-6, 1 - 1e-6)
        near = (l > self._lims[0]) & (l < self._lims[1])
        return l, near, torch.where(near, 0.25, l)

    def _log_C(self):
        l, near, safe = self._near()
        log_c = torch.log(
            (2.0 * torch.atanh(1.0 - 2.0 * safe)).abs()
            / (1.0 - 2.0 * safe).abs())
        x = l - 0.5
        taylor = math.log(2.0) + 4.0 / 3.0 * x * x
        return torch.where(near, taylor, log_c)

    def log_prob(self, value):
        l = self.probs_.clamp(1e-6, 1 - 1e-6)
        x = _as(value, l)
        return self._log_C() + x * torch.log(l) + (1.0 - x) * torch.log1p(-l)

    def sample(self, shape=(), generator=None):
        shape = tuple(shape) + tuple(self.probs_.shape)
        u = _uniform(shape, self.probs_, generator, 1e-6, 1 - 1e-6)
        _, near, safe = self._near()
        icdf = (torch.log1p(u * (2.0 * safe - 1.0) / (1.0 - safe))
                / (torch.log(safe) - torch.log1p(-safe)))
        return torch.where(near, u, icdf)

    rsample = sample


class Independent(Distribution):
    """The last ``reinterpreted_batch_ndims`` batch dims as event dims
    (``log_prob`` and ``entropy`` sum over them)."""

    def __init__(self, base, reinterpreted_batch_ndims):
        self.base = base
        self.ndims = int(reinterpreted_batch_ndims)

    def sample(self, shape=(), generator=None):
        return self.base.sample(shape, generator)

    def log_prob(self, value):
        return self.base.log_prob(value).sum(
            dim=tuple(range(-self.ndims, 0)))

    def entropy(self):
        return self.base.entropy().sum(dim=tuple(range(-self.ndims, 0)))


class ExponentialFamily(Distribution):
    """Subclasses give natural parameters and the log-normalizer A; the
    entropy comes from the Bregman identity H = A - <theta, grad A> +
    E[-h(x)], grad A by autograd (JAX: ``jax.grad``)."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError

    @property
    def _mean_carrier_measure(self):
        return 0.0

    def entropy(self):
        theta = [torch.as_tensor(t, dtype=torch.float32).detach()
                 .requires_grad_(True) for t in self._natural_parameters]
        with torch.enable_grad():
            a_val = self._log_normalizer(*theta)
            grads = torch.autograd.grad(a_val.sum(), theta)
        ent = a_val.detach() + self._mean_carrier_measure
        for t, g in zip(theta, grads):
            ent = ent - t.detach() * g
        return ent


# user-extensible KL registry (parity: paddle.distribution.register_kl)
_KL_REGISTRY = {}


def register_kl(p_cls, q_cls):
    def deco(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn

    return deco


def kl_divergence(p: Distribution, q: Distribution):
    """KL(p || q): a registered function first (``register_kl``), then
    Cauchy, Independent and the built-in pairs, as in JAX."""
    for (pc, qc), fn in _KL_REGISTRY.items():
        if isinstance(p, pc) and isinstance(q, qc):
            return fn(p, q)
    if isinstance(p, Cauchy) and isinstance(q, Cauchy):
        return p.kl_divergence(q)
    if isinstance(p, Independent) and isinstance(q, Independent) \
            and p.ndims == q.ndims:
        return kl_divergence(p.base, q.base).sum(
            dim=tuple(range(-p.ndims, 0)))
    return _builtin_kl(p, q)
