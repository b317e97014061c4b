"""The port's fused GroupNorm (``paddle_tpu_torch/kernels/group_norm.py``)
and ``nn.functional.group_norm`` against the JAX package on the CPU: the
plain versions of rows 12 and 13 against ``_gn_fwd_pallas``/
``_gn_bwd_pallas`` run in interpret mode, as
``tests/test_group_norm_kernel.py`` runs them (activation None and silu,
several channel/group splits, float32 and bf16 inputs); the autograd
gradients against ``jax.grad``; the NHWC reference and the NCHW branch;
the dispatch rules; and the kernels' launch plan at every UNet site and
card-test shape, and the UNet's GroupNorm sites against the model's own
calls. Inputs come from numpy with one seed."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import group_norm as jgn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import flags
from paddle_tpu_torch.kernels import group_norm as tgn
from paddle_tpu_torch.models import (UNet2DConditionModel, UNetConfig,
                                     unet_gn_sites)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import layout
from torch_gn_cases import GN_CASES

# (n, hw, c, groups): cg = 1, 2, 4, 10 (the UNet's 320 / 32) and 16
SHAPES = [(2, 16, 8, 8), (2, 24, 16, 8), (1, 64, 32, 8), (2, 16, 320, 32),
          (3, 9, 64, 4)]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _inputs(n, hw, c, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, hw, c)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((n, hw, c)).astype(np.float32)
    gamma = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(c)).astype(np.float32)
    jx, jdy = jnp.asarray(x), jnp.asarray(dy)
    tx, tdy = torch.tensor(x), torch.tensor(dy)
    if dtype == "bfloat16":
        jx, jdy = jx.astype(jnp.bfloat16), jdy.astype(jnp.bfloat16)
        tx, tdy = tx.bfloat16(), tdy.bfloat16()
    return (jx, jdy, jnp.asarray(gamma), jnp.asarray(beta)), \
        (tx, tdy, torch.tensor(gamma), torch.tensor(beta))


# the outputs in x's dtype: float32 to 1e-5; bf16 within one rounding of
# the same float32 value (2^-8 relative, 1e-2 with room)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("n,hw,c,g", SHAPES)
def test_plain_kernels_match_interpreted_kernels(n, hw, c, g, act, dtype):
    (jx, jdy, jg, jb), (tx, tdy, tg, tb) = _inputs(n, hw, c, seed=c + hw,
                                                    dtype=dtype)
    y, mean, rstd = jgn._gn_fwd_pallas(jx, jg, jb, g, 1e-5, act)
    ty, tmean, trstd = tgn.group_norm_fwd(tx, tg, tb, g, 1e-5, act)
    assert ty.dtype == tx.dtype and tmean.shape == (n, g)
    _close(ty, y, TOL[dtype])
    _close(tmean, mean, 1e-5)
    _close(trstd, rstd, 1e-5)
    dx, dgam, dbeta = jgn._gn_bwd_pallas(jx, jdy, jg, jb, mean, rstd, g,
                                         act)
    tdx, tdg, tdb = tgn.group_norm_bwd(tx, tdy, tg, tb, torch.tensor(
        np.asarray(mean)), torch.tensor(np.asarray(rstd)), g, act)
    assert tdx.dtype == tx.dtype and tdg.shape == (n, c)
    _close(tdx, dx, TOL[dtype])
    # per-sample partials, summed over n as the JAX wrapper sums them
    _close(tdg.sum(0), dgam, 1e-4)
    _close(tdb.sum(0), dbeta, 1e-4)


@pytest.mark.parametrize("act", [None, "silu"])
def test_gradients_match_jax_grad(act):
    """x, gamma and beta gradients through ``_FusedGroupNorm`` (the plain
    rows 12-13) against ``jax.grad`` of the JAX custom VJP."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
    gamma = (1 + 0.3 * rng.standard_normal(32)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(32)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(a, g_, b_):
        return jnp.sum(jgn.fused_group_norm(a, g_, b_, 8, 1e-5, act) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                   (x, gamma, beta)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, gamma, beta)]
    y = tgn.fused_group_norm(*leaves, 8, 1e-5, act)
    _close(y, jgn.fused_group_norm(*map(jnp.asarray, (x, gamma, beta)), 8,
                                   1e-5, act), 1e-5)
    (y * torch.tensor(w)).sum().backward()
    for t, g_ in zip(leaves, want):
        _close(t.grad, g_, 1e-5)


@pytest.mark.parametrize("shape", [(2, 5, 16), (2, 3, 4, 16),
                                   (1, 2, 3, 4, 16)])
@pytest.mark.parametrize("act", [None, "silu"])
def test_reference_matches_jax(shape, act):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    gamma = rng.standard_normal(16).astype(np.float32)
    want = jgn.group_norm_reference(jnp.asarray(x), jnp.asarray(gamma), None,
                                    4, 1e-5, act)
    got = tgn.group_norm_reference(torch.tensor(x), torch.tensor(gamma),
                                   None, 4, 1e-5, act)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt,act", [("NCHW", None), ("NCHW", "silu"),
                                     ("NHWC", "silu"), ("NCL", None)])
def test_functional_group_norm_matches_jax(fmt, act, dtype):
    """Both branches of ``F.group_norm``: NCHW plain torch (the affine
    after the cast to x's dtype, the SiLU through a float32 sigmoid, as
    JAX), 4-D NHWC through the fused path, and a 3-D channels-first
    tensor. Gradients too."""
    rng = np.random.default_rng(11)
    shape = {"NCHW": (2, 16, 3, 5), "NHWC": (2, 3, 5, 16),
             "NCL": (2, 16, 7)}[fmt]
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    df = "NHWC" if fmt == "NHWC" else "NCHW"
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else None)
    tx = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    want = JF.group_norm(jx, 4, jnp.asarray(w), jnp.asarray(b), 1e-5, df,
                         activation=act)
    got = TF.group_norm(tx, 4, torch.tensor(w), torch.tensor(b), 1e-5, df,
                        activation=act)
    # float32 weights promote a bf16 NCHW result, as in JAX
    assert str(got.dtype) == f"torch.{want.dtype}"
    _close(got, want, TOL[dtype])
    if dtype == "float32":
        cot = rng.standard_normal(shape).astype(np.float32)
        jg = jax.grad(lambda a: jnp.sum(JF.group_norm(
            a, 4, jnp.asarray(w), jnp.asarray(b), 1e-5, df,
            activation=act) * cot))(jx)
        (got * torch.tensor(cot)).sum().backward()
        _close(tx.grad, jg, 1e-5)


def test_dispatch_rules(monkeypatch):
    """Inside a channels-last scope a 4-D tensor declared NCHW takes the
    NHWC branch. CPU tensors go to the fused path within the JAX VMEM
    budget and to the reference beyond it, as in JAX; every other tensor
    goes to the kernels whatever its size (here a device that is not the
    card, which the kernel wrapper refuses: the reference would have run
    on it). The flag off selects the reference explicitly."""
    calls = []
    real = tgn.fused_group_norm

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(tgn, "fused_group_norm", spy)
    small = torch.randn(1, 4, 4, 64)
    big = (1, 128, 128, 1024)  # over the JAX kernel's 8 MB budget
    assert tgn.supports_fused(small.shape, 32)
    assert not tgn.supports_fused(big, 32)
    with layout.channels_last_scope():
        TF.group_norm(small, 32)
    assert calls == [(1, 4, 4, 64)]
    # over budget on the CPU: the reference (a cheap stand-in shape with
    # the gate forced shut, as the JAX test forces it)
    monkeypatch.setattr(tgn, "supports_fused", lambda shape, g: False)
    TF.group_norm(small, 32, data_format="NHWC")
    assert len(calls) == 1
    meta = torch.empty(big, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TF.group_norm(meta, 32, data_format="NHWC", activation="silu")
    assert calls[-1] == big
    odd = torch.empty((1, 4, 4, 30), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TF.group_norm(odd, 32, data_format="NHWC")
    flags.set_flags({"fused_group_norm": False})
    try:
        out = TF.group_norm(meta, 32, data_format="NHWC")
    finally:
        flags.set_flags({"fused_group_norm": True})
    assert out.shape == big and len(calls) == 3
    with pytest.raises(ValueError, match="activation"):
        real(small, torch.ones(64), torch.zeros(64), 32, activation="relu")


# ---------------------------------------------------------------------------
# the kernels' launch plan (the card runs it; its geometry is checked here)
# ---------------------------------------------------------------------------
def _unet_shapes():
    """(n, hw, c, g) of every GroupNorm site of the SD UNet at sample_size
    32, batch 4 (``unet_gn_sites``)."""
    cfg = UNetConfig(sample_size=32)
    return list(dict.fromkeys((4, hw, c, cfg.norm_num_groups)
                              for hw, c, _ in unet_gn_sites(cfg, 32)))


UNET_SHAPES = _unet_shapes()
CARD_SHAPES = [(n, h * w, c, g) for n, h, w, c, g, _, _ in GN_CASES]
PLAN_SHAPES = list(dict.fromkeys(UNET_SHAPES + CARD_SHAPES))
ITEMSIZE = {"float32": 4, "float16": 2, "bfloat16": 2}


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", list(ITEMSIZE))
@pytest.mark.parametrize("n,hw,c,g", PLAN_SHAPES)
def test_launch_plan_geometry(n, hw, c, g, dtype, backward):
    """A slab holds whole groups and whole vectors; a vector is at most 16
    bytes; every rank of a cluster of at most 16 CTAs has rows; a resident
    tile fits the shared-memory budget, and every plan the H100's limit;
    the grid (ranks, slabs, n) and the block stay within the limits.
    (Which cluster size the card's occupancy picks is a card test:
    ``test_group_norm_card_plans``.)"""
    size = ITEMSIZE[dtype]
    plan = tgn._launch_plan(n, hw, c, g, size, backward=backward)
    cg = c // g
    assert plan.slab % cg == 0 and c % plan.slab == 0
    assert plan.vec & (plan.vec - 1) == 0 and plan.vec * size <= 16
    assert plan.slab % plan.vec == 0 and c % plan.vec == 0
    assert plan.slab * size >= min(tgn.MIN_ROW_BYTES, c * size)
    assert plan.ranks in (1, 2, 4, 8, 16) and plan.ranks <= tgn.MAX_RANKS
    per = -(-hw // plan.ranks)
    assert (plan.ranks - 1) * per < hw
    assert plan.ranks == 1 or per >= tgn.MIN_ROWS
    assert 32 <= plan.threads <= max(tgn.THREAD_CAPS)
    assert plan.threads % 32 == 0
    assert plan.threads >= min(plan.slab // plan.vec, min(tgn.THREAD_CAPS))
    tiles = (2 if backward else 1) * per * plan.slab * size
    assert plan.smem <= tgn.SMEM_LIMIT
    if plan.resident:
        assert tiles <= plan.smem <= tgn.SMEM_BUDGET
    else:
        assert plan.smem + tiles > tgn.SMEM_BUDGET
    assert c // plan.slab <= 65535 and n <= 65535


def test_launch_plans_take_every_path():
    """The card tests' shapes take clusters of 1, 2, 4 and 8 CTAs, slabs
    of more groups than the CTA has threads (the kernels loop over a
    slab's groups), the re-read path at n 1, 16384 rows in bf16 and
    float32 (forward and backward), and every UNet site keeps its tiles
    resident."""
    ranks, wide = set(), set()
    for n, h, w, c, g, dtype, _ in GN_CASES:
        for backward in (False, True):
            plan = tgn._launch_plan(n, h * w, c, g, dtype.itemsize,
                                    backward=backward)
            ranks.add(plan.ranks)
            if plan.slab // (c // g) > plan.threads:
                wide.add((h * w, c, g))
    assert ranks == {1, 2, 4, 8}
    assert wide == {(1, 48, 48), (16, 296, 296)}
    for size in (2, 4):
        for backward in (False, True):
            assert not tgn._launch_plan(1, 16384, 1024, 32, size,
                                        backward=backward).resident
    for n, hw, c, g in UNET_SHAPES:
        assert tgn._launch_plan(n, hw, c, g, 2, backward=True).resident


def test_launch_plan_vector_follows_alignment():
    """The vector narrows with c and with the pointers' alignment; a
    contiguous view with a storage offset reports its own alignment."""
    assert tgn._launch_plan(4, 256, 640, 32, 2).vec == 8
    assert tgn._launch_plan(4, 256, 640, 32, 2, align=8).vec == 4
    assert tgn._launch_plan(4, 256, 640, 32, 2, align=2).vec == 1
    assert tgn._launch_plan(4, 256, 640, 32, 4, align=8).vec == 2
    assert tgn._launch_plan(1, 15, 30, 3, 2).vec == 2   # 60-byte rows
    buf = torch.empty(4096, dtype=torch.bfloat16)
    assert tgn._alignment(buf) == 16
    assert tgn._alignment(buf[1:]) == 2
    assert tgn._alignment(buf[4:], buf) == 8
    with pytest.raises(ValueError, match="not divisible"):
        tgn._launch_plan(1, 4, 30, 4, 2)
    with pytest.raises(ValueError, match="shared memory"):
        tgn._launch_plan(1, 4, 120000, 1, 4)


@pytest.mark.parametrize("channels", [(32, 64), (32, 64, 64, 64)])
def test_unet_gn_sites_follow_the_model(monkeypatch, channels):
    """``unet_gn_sites`` lists the (hw, channels, activation) of every
    GroupNorm the UNet's forward calls, in call order: two and four levels
    (cross-attention at the last two going down and the first two going
    up), on an 8 x 8 sample."""
    calls = []
    real = tgn.fused_group_norm

    def spy(x, gamma, beta, num_groups, epsilon=1e-5, activation=None):
        n, h, w, c = x.shape
        calls.append((h * w, c, activation))
        return real(x, gamma, beta, num_groups, epsilon, activation)

    monkeypatch.setattr(tgn, "fused_group_norm", spy)
    cfg = UNetConfig.tiny(block_out_channels=channels, channels_last=True)
    model = UNet2DConditionModel(cfg, device="cpu").eval()
    size = 8
    gen = torch.Generator().manual_seed(0)
    sample = torch.randn(1, cfg.in_channels, size, size, generator=gen)
    context = torch.randn(1, 4, cfg.cross_attention_dim, generator=gen)
    with torch.no_grad():
        model(sample, torch.tensor([10]), context)
    assert calls == unet_gn_sites(cfg, size)
    assert len(calls) > 10
