"""``TrainStep`` over a mesh against the JAX ``TrainStep`` on the same
mesh: 5-step AdamW trajectories of ``LlamaConfig.tiny()`` with global-norm
clipping at 1.0 and a batch whose ``-100`` labels fall unevenly over the
ranks, at (dp 4), (fsdp 4) x ZeRO stages 1, 2 and 3, (dp 2, tp 2),
(fsdp 2, tp 2, stage 3) and (dp 2, pp 2) (a pp axis the step
replicates, as JAX's does), plus gradient merge at (dp 2, fsdp 2, stage 3),
the tied head through the chunked loss at tp 2, a GPT at (dp 4), and a
JAX ``state_dict`` resumed on another mesh.

The port runs one gloo process a rank (``tests/torch_dist_pool.py``, four
workers started once for the file); the JAX side runs on
``jax.devices()[:4]``. The losses must agree within rtol 1e-5 at every
step, and the parameters after the last step (gathered from the ranks'
blocks by ``TrainStep.state_dict``) within rtol 1e-4 (atol 1e-6 for
entries near zero)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.strategy import DistributedStrategy as JStrategy
from paddle_tpu.distributed.strategy import HybridConfig as JHybrid
from paddle_tpu import models as jmodels
from paddle_tpu.trainer import TrainStep as JTrainStep

import torch_dist_pool as tdp

N = 4
STEPS = 5
# epsilon 1e-6: with the default 1e-8 Adam's normalised step turns the
# float32 rounding of a near-zero gradient entry (the two frameworks sum
# in other orders) into a visible share of a step, and the meshless port
# and JAX's one-device step already differ by 1.7e-6 after 5 steps
OPT = dict(learning_rate=1e-3, weight_decay=0.01, epsilon=1e-6)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = tdp.GlooPool(N, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _batch():
    """8 rows of 16 tokens; the ignored labels fall unevenly: rank 0's
    rows hold most of them, and at (dp 4) rank 2's rows hold none."""
    ids = np.random.default_rng(0).integers(0, 256, (8, 16))
    labels = ids.copy()
    labels[0, 3:14] = -100
    labels[1, 1:] = -100
    labels[3, 5] = -100
    labels[6, 2:4] = -100
    return {"input_ids": ids, "labels": labels}


def _jax_run(mesh_kw, cfg, steps=STEPS, merge_k=1, family="Llama"):
    kw = dict(mesh_kw)
    stage = kw.pop("stage", 0)
    pt.seed(5)
    jmodel = getattr(jmodels, f"{family}ForCausalLM")(
        getattr(jmodels, f"{family}Config").tiny(**cfg))
    state = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}
    s = JStrategy()
    s.hybrid_configs = JHybrid(dp_degree=kw.get("dp", 1),
                               mp_degree=kw.get("tp", 1),
                               sharding_degree=kw.get("fsdp", 1))
    if stage:
        s.sharding = True
        s.sharding_configs.stage = stage
    if merge_k > 1:
        s.gradient_merge = True
        s.gradient_merge_k_steps = merge_k
    mesh = jdist.build_mesh(devices=jax.devices()[:N], **kw)
    ts = JTrainStep(jmodel, jopt.AdamW(
        grad_clip=jopt.ClipGradByGlobalNorm(1.0), **OPT), mesh, s)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    losses = [float(ts.run(batch)) for _ in range(steps)]
    return state, losses, ts


def _params(ts):
    return {n: np.asarray(jnp.asarray(v, jnp.float32))
            for n, v in ts.state_dict()["params"].items()}


def _check(got, losses, want_params):
    for res in got:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        assert res["losses"] == got[0]["losses"]
        assert set(res["params"]) == set(want_params)
        for n, w in want_params.items():
            np.testing.assert_allclose(res["params"][n], w, rtol=1e-4,
                                       atol=1e-6, err_msg=n)


MESHES = [dict(dp=4), dict(fsdp=4, stage=1), dict(fsdp=4, stage=2),
          dict(fsdp=4, stage=3), dict(dp=2, tp=2),
          dict(fsdp=2, tp=2, stage=3), dict(dp=2, pp=2)]


@pytest.mark.parametrize("mesh_kw", MESHES,
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_train_step_over_a_mesh_matches_jax(pool, mesh_kw):
    state, losses, ts = _jax_run(mesh_kw, {})
    got = pool.run(tdp.train_job, mesh_kw, state, {}, _batch(), STEPS, OPT)
    _check(got, losses, _params(ts))
    assert losses[-1] < losses[0]
    # each rank holds its blocks: tp cuts the heads, ZeRO-3 cuts over fsdp
    shapes = got[0]["local_shapes"]
    tp, fsdp = mesh_kw.get("tp", 1), mesh_kw.get("fsdp", 1)
    q = shapes["model.layers.0.self_attn.q_proj.weight"]
    assert q == (64, 64 // tp)
    embed = shapes["model.embed_tokens.weight"]
    zero3 = mesh_kw.get("stage") == 3
    # spec ("tp", None): ZeRO-3 takes the free hidden dim, as in JAX
    assert embed == (256 // tp, 64 // (fsdp if zero3 else 1))
    # the gathered slots are JAX's too
    jslots = ts.state_dict()["opt_state"]["slots"]
    for n, sl in got[0]["slots"].items():
        for k, v in sl.items():
            np.testing.assert_allclose(v, np.asarray(jslots[n][k]),
                                       rtol=1e-3, atol=1e-7)


def test_gradient_merge_and_the_tied_chunked_head_over_a_mesh(pool):
    # ZeRO-3 merges the gathered tensors' gradients, then reduce-scatters
    mesh_kw = dict(dp=2, fsdp=2, stage=3)
    state, losses, ts = _jax_run(mesh_kw, {}, merge_k=2)
    got = pool.run(tdp.train_job, mesh_kw, state, {}, _batch(), STEPS, OPT,
                   2)
    _check(got, losses, _params(ts))
    cfg = dict(tie_word_embeddings=True, fused_head_loss_chunk=5)
    mesh_kw = dict(fsdp=2, tp=2, stage=3)
    state, losses, ts = _jax_run(mesh_kw, cfg)
    got = pool.run(tdp.train_job, mesh_kw, state, cfg, _batch(), STEPS, OPT)
    _check(got, losses, _params(ts))


def test_gpt_over_dp_matches_jax(pool):
    """GPT's ``loss_count`` makes its loss the global token mean too."""
    cfg = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    state, losses, ts = _jax_run(dict(dp=4), cfg, family="GPT")
    got = pool.run(tdp.train_job, dict(dp=4), state, cfg, _batch(), STEPS,
                   OPT, 1, None, "GPT")
    _check(got, losses, _params(ts))


def test_a_jax_state_dict_resumes_on_another_mesh(pool):
    _, _, ts = _jax_run(dict(dp=4), {}, steps=2)
    sd = jax.tree_util.tree_map(lambda v: np.asarray(v), ts.state_dict())
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    losses = [float(ts.run(batch)) for _ in range(2)]
    state = sd["params"]
    got = pool.run(tdp.train_job, dict(fsdp=2, tp=2, stage=3), state, {},
                   _batch(), 2, OPT, 1, sd)
    _check(got, losses, _params(ts))


def test_what_a_mesh_refuses(pool):
    got = pool.run(tdp.refusals_job)
    for res in got:
        name, msg = res["gpt_tp"]
        assert name == "NotImplementedError"
        assert "GPT" in msg and "next slice" in msg
        assert res["heads"][0] == "ValueError" and "num_key_value_heads" \
            in res["heads"][1]
        assert res["lamb"][0] == "NotImplementedError"
        assert res["pp_mesh"][0] == "NotImplementedError" and "pp" in \
            res["pp_mesh"][1] and "PipelineTrainStep" in res["pp_mesh"][1]
        name, msg = res["gpt_sep"]
        assert name == "NotImplementedError" and "GPT" in msg \
            and "sequence parallelism" in msg
        assert res["sep_and_cp"][0] == "ValueError"
        name, msg = res["bert_fsdp"]
        assert name == "NotImplementedError" and "loss_count" in msg
        assert res["bert_uncut"]
