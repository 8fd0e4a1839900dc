"""Parity of the port's MoE layer (repro_torch.models.moe) with the JAX package.

Weights are made by the JAX package (``init_moe``, ``Model.init``) and
moved with ``convert.params_from_jax``; inputs and router logits come
from numpy seeds. JAX runs on the CPU, the port with device="cpu".

What is held: ``route``'s dispatch (bf16 0/1) bit-equal, its combine
weights and aux loss in f32 to 1e-6; ``apply_moe`` in f32 to 1e-5 at
moe_group 16, 32 and 64 over 64 tokens (G = 4, 2, 1); a tied router
row picks the experts ``jax.lax.top_k`` picks (ties to the lower
index); pad experts are never chosen, even with the largest raw
logits; capacity drops happen where the queue overflows and nowhere
else; ``Model.loss`` of reduced qwen2-moe-a2.7b and llama4-scout
(top-1) equals JAX's in f32 to 1e-5 relative, the 0.01 * aux term
included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import RunConfig as JaxRunConfig, build as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import lm_loss  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"]
F32_TOL = 1e-5
ROUTE_TOL = 1e-6


def _cfgs(arch="qwen2-moe-a2.7b", **changes):
    """(JAX config, port config), reduced: 8 experts padded to 16."""
    return (dataclasses.replace(jax_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def _route_both(jc, tc, logits):
    """route() of both packages on the same (G, S, Ep) f32 logits."""
    jd, jcomb, jaux = jmoe.route(jnp.asarray(logits), jc, logits.shape[1])
    td, tcomb, taux = tmoe.route(torch.from_numpy(logits), tc, logits.shape[1])
    return (np.asarray(jd, np.float32), np.asarray(jcomb), float(jaux)), \
        (td.float().numpy(), tcomb.numpy(), float(taux))


def _assert_route_equal(j, t):
    (jd, jcomb, jaux), (td, tcomb, taux) = j, t
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tcomb, jcomb, atol=ROUTE_TOL, rtol=ROUTE_TOL)
    assert abs(taux - jaux) <= ROUTE_TOL * max(1.0, abs(jaux))


# ---------------------------------------------------------------------------
# capacity and route
# ---------------------------------------------------------------------------
def test_capacity_is_the_references_arithmetic():
    cfg, jc = get_config("qwen2-moe-a2.7b"), jax_config("qwen2-moe-a2.7b")
    for group in (1, 2, 8, 64, 192, 2048, 4096):
        assert tmoe._capacity(cfg, group) == jmoe._capacity(jc, group)
    assert tmoe._capacity(cfg, 2048) == 172          # 4 * 2048 / 60 * 1.25 = 170.7 -> 172
    assert tmoe._capacity(cfg, 8) == 4               # a decode step of 8 requests
    assert tmoe._capacity(dataclasses.replace(cfg, capacity_factor=16.0), 192) == 204


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("G,S", [(1, 64), (3, 16)])
def test_route_matches_jax(arch, G, S):
    jc, tc = _cfgs(arch)
    logits = np.random.default_rng(G * 100 + S).standard_normal(
        (G, S, tc.n_experts_padded)).astype(np.float32)
    j, t = _route_both(jc, tc, logits)
    _assert_route_equal(j, t)
    assert t[0].shape == (G, S, tc.n_experts_padded, tmoe._capacity(tc, S))


def test_top_k_breaks_ties_like_lax_top_k():
    """Tied probabilities: the first k of a stable descending sort, i.e. the
    lower expert index first, as jax.lax.top_k orders them."""
    rows = np.array([
        [0.1] * 16,                                                  # all tied
        [0.1, 0.3, 0.3, 0.2, 0.3, 0.0, 0.3, 0.1] + [0.0] * 8,        # a 4-way tie at the top
        [0.2, 0.1, 0.1, 0.1, 0.1, 0.2, 0.0, 0.2] + [0.0] * 8,        # ties across the k-th place
    ], np.float32)
    for k in (1, 2, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = tmoe.top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tmoe.top_k(torch.from_numpy(rows), 4)[1][1].tolist() == [1, 2, 4, 6]


def test_route_on_a_tied_row_matches_jax():
    """Router logits with exact ties (as bf16 rounding makes them): the
    chosen experts and so the dispatch equal the reference's."""
    jc, tc = _cfgs()
    logits = np.zeros((1, 4, tc.n_experts_padded), np.float32)
    logits[0, 0, :8] = 1.0                               # every real expert tied
    logits[0, 1, [1, 3, 5]] = 2.0                        # three tied for first place
    logits[0, 2, [2, 6]] = 0.5                           # two tied, then six more
    logits[0, 3, 7] = 3.0
    j, t = _route_both(jc, tc, logits)
    _assert_route_equal(j, t)
    chosen = t[0].sum(-1) > 0                            # (1, 4, Ep): kept choices
    assert np.flatnonzero(chosen[0, 0]).tolist() == [0, 1]
    assert np.flatnonzero(chosen[0, 1]).tolist() == [1, 3]
    assert np.flatnonzero(chosen[0, 2]).tolist() == [2, 6]


def test_pad_experts_are_never_chosen():
    """Experts 8-15 of the reduced config are padding: -1e9 before the
    softmax, so they are never chosen even when their raw logits are the
    largest; the aux loss covers the 8 real experts only. Capacity factor
    16: no choice is dropped, so every token keeps its top-2."""
    jc, tc = _cfgs(capacity_factor=16.0)
    assert (tc.n_experts, tc.n_experts_padded) == (8, 16)
    logits = np.random.default_rng(3).standard_normal((2, 32, 16)).astype(np.float32)
    logits[..., 8:] += 100.0
    j, t = _route_both(jc, tc, logits)
    _assert_route_equal(j, t)
    td, tcomb, taux = t
    assert td[..., 8:, :].sum() == 0 and tcomb[..., 8:, :].sum() == 0
    assert td.sum() == 2 * 32 * tc.top_k
    probs = torch.softmax(torch.from_numpy(logits).masked_fill(
        torch.arange(16) >= 8, -1e9), dim=-1)
    me = probs[..., :8].mean(dim=(0, 1))
    assign = torch.from_numpy(td[..., :8, :].sum(-1)).mean(dim=(0, 1))
    assert abs(taux - 8 * float((me * assign).sum())) < ROUTE_TOL


def test_capacity_drops_where_the_queue_overflows():
    """Every token prefers expert 0, then expert 1: at capacity_factor 0.5
    (C = 4 for 16 tokens, top-2) the first 4 tokens are kept in each queue
    and the other choices dropped, slot by slot, as in the reference."""
    jc, tc = _cfgs(capacity_factor=0.5)
    C = tmoe._capacity(tc, 16)
    assert C == 4
    logits = np.full((1, 16, 16), -5.0, np.float32)
    logits[..., 0], logits[..., 1] = 4.0, 3.0
    logits += np.random.default_rng(4).standard_normal(logits.shape).astype(np.float32) * 0.01
    j, t = _route_both(jc, tc, logits)
    _assert_route_equal(j, t)
    td = t[0]
    per_expert = td.sum(axis=(0, 1, 3))
    assert per_expert[0] == per_expert[1] == C and per_expert[2:].sum() == 0
    kept = td.sum(axis=(2, 3))[0]                         # choices kept per token
    assert kept[:4].tolist() == [2] * 4 and kept[4:].sum() == 0
    np.testing.assert_array_equal(td[0, :4, 0].argmax(-1), np.arange(4))   # queue order


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------
def _moe_params(jc):
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jc, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("group", [16, 32, 64])
def test_apply_moe_matches_jax(arch, group):
    jc, tc = _cfgs(arch)
    jp, tp = _moe_params(jc)
    assert sorted(tp) == sorted(jp) and tp["router"].dtype == torch.float32
    assert tp["w1"].shape == (16, 128, 64) and tp["w2"].shape == (16, 64, 128)
    x = np.random.default_rng(group).standard_normal((4, 16, tc.d_model)).astype(np.float32)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jc, JaxRunConfig(
        param_dtype="float32", compute_dtype="float32", moe_group=group))
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x), tc, RunConfig(
        param_dtype=torch.float32, compute_dtype=torch.float32, device="cpu",
        moe_group=group))
    assert ty.shape == (4, 16, tc.d_model) and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=F32_TOL, rtol=F32_TOL)
    assert abs(float(taux) - float(jaux)) <= F32_TOL


def test_apply_moe_refuses_a_group_that_does_not_divide_the_tokens():
    _, tc = _cfgs()
    _, tp = _moe_params(_cfgs()[0])
    with pytest.raises(ValueError, match="does not divide"):
        tmoe.apply_moe(tp, torch.zeros((3, 10, tc.d_model)), tc,
                       RunConfig(device="cpu", compute_dtype=torch.float32, moe_group=16))


# ---------------------------------------------------------------------------
# the model's loss, aux included
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_with_aux_matches_jax(arch):
    jc, tc = _cfgs(arch)
    jm = jax_build(jc, JaxRunConfig(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build(tc, RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32,
                             device="cpu"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tc.vocab_size, (2, 17)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    jl, jaux, _ = jm.apply(jp, jb)
    tl, taux, _ = tm.apply(tp, tb)
    assert float(taux) > 0 and abs(float(taux) - float(jaux)) <= F32_TOL * float(jaux)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    jloss, tloss = float(jm.loss(jp, jb)), float(tm.loss(tp, tb))
    assert abs(tloss - jloss) <= F32_TOL * abs(jloss)
    ce = float(lm_loss(tl, tb["labels"], tc))              # the CE alone
    assert abs(tloss - (ce + 0.01 * float(taux))) < 1e-6


def test_llama4_scout_routes_top_1_with_a_shared_expert():
    tc = get_config("llama4-scout-17b-a16e").reduced()
    assert (tc.family, tc.n_experts, tc.n_experts_padded, tc.top_k,
            tc.shared_expert_d_ff) == ("moe", 8, 16, 1, 64)
    tp = build(tc, RunConfig(device="cpu")).init(torch.Generator().manual_seed(0))
    moe = tp["blocks"]["moe"]
    assert moe["router"].shape == (4, 128, 16) and moe["shared"]["w1"].shape == (4, 128, 64)
    assert "mlp" not in tp["blocks"]
