"""Training parity of the port (repro_torch) with the JAX package: the moe
family (qwen2-moe-a2.7b, llama4-scout-17b-a16e).

The reduced configs (4 layers, 8 routed experts padded to 16, one shared
expert; qwen2-moe top-2, llama4-scout top-1) in f32 compute at B=4,
S=32 (one routing group of 128 tokens), on the same numpy batches and
the same weights (made by the JAX package and moved with
``convert.state_from_jax``). JAX runs its jitted ``make_train_step`` on
the CPU; the port runs with device="cpu", where attention is K1's plain
version ``ref.attention_ref``. The comparison is in f32 only: in bf16
the router's near-ties flip between the two packages (ROADMAP §3), so a
token can take another expert in one package than in the other.

Each step is taken with remat off and under ``remat_policy`` "full" and
"dots" on both sides, at the capacity factor 1.25 of the configs and (for
qwen2-moe) at 0.5, where about half the choices are dropped, and with
``grad_accum=2``. Bounds are those of the dense and SSM train steps
(``tests/test_torch_train_ssm.py``): loss, aux, grad norm and lr rel
1e-4; params, m and v 1e-4 absolute, after each of two steps; and every
gradient leaf before each step within 1e-4 of its JAX leaf's largest
value. The peak learning rate is 1e-4 (``OPT`` says why).

Under autograd, ``moe.route`` must give the gradients JAX's autodiff
gives: through the softmax probs, the renormalised gate values into
``combine`` and the aux loss's ``me`` term (its ``assign`` term is built
from the one-hot dispatch and takes none); zero to the pad experts'
router columns (``masked_fill`` where JAX has ``jnp.where``); zero to a
choice dropped past capacity; and the cotangent of a tied top-k value
to the index ``lax.top_k`` picks.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import RunConfig as JaxRunConfig, build as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402

MOE_ARCHS = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"]
B, S = 4, 32
STEP_TOL = 1e-4
ROUTE_GRAD_TOL = 1e-6
# the peak learning rate of chip_smoke.py's train phases [7] and [8]. Adam's
# first step is sign-normalised (g / (|g| + eps), eps = 1e-8), so a gradient
# element within f32 rounding of 0 moves its param by up to 2 lr in either
# package, whichever rounding it got: at the dense tests' 1e-3 one element of
# the moe's wo (-3.7e-9 in JAX, 2.8e-10 here) moved 1.01e-4. The gradients
# themselves are held leaf by leaf before each step.
OPT = dict(lr=1e-4, warmup_steps=1, total_steps=10)
REMAT = {"off": dict(remat=False), "full": dict(remat=True, remat_policy="full"),
         "dots": dict(remat=True, remat_policy="dots")}
# the f32 train state at a step's peak, in bytes a parameter: the old and the
# new params, m and v (AdamW's step is functional), and the gradients
STATE_BYTES_PER_PARAM = 28


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def models(arch, remat="off", **changes):
    """(JAX model, port model) of the reduced ``arch`` in f32, with ``changes``
    to its config."""
    jc = dataclasses.replace(jax_config(arch).reduced(), **changes)
    tc = dataclasses.replace(get_config(arch).reduced(), **changes)
    jm = jax_build(jc, JaxRunConfig(param_dtype="float32", compute_dtype="float32",
                                    **REMAT[remat]))
    tm = build(tc, RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32,
                             device="cpu", **REMAT[remat]))
    return jm, tm


def make_batch(cfg, seed, batch=B, seq=S):
    """A numpy train batch of ``cfg``'s frontend: labels, and tokens, or
    frame embeddings (audio), or tokens and image embeddings (vision)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    out = {"labels": np.ascontiguousarray(toks[:, 1:])}
    if cfg.frontend == "audio":
        out["embeds"] = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = np.ascontiguousarray(toks[:, :-1])
    if cfg.frontend == "vision":
        out["img_embeds"] = rng.standard_normal(
            (batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


def jax_state(jm, gate=None):
    """JAX's initial TrainState from key 0; a vlm's cross gates set to ``gate``."""
    params = jm.init(jax.random.PRNGKey(0))
    if gate is not None:
        params["cross_blocks"]["gate"] = jnp.full_like(params["cross_blocks"]["gate"], gate)
    return ja.init_state(params)


def _leaves_close(jtree, ttree, what, rel_to_max=False):
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves = tree_flatten_with_path(ttree)
    assert list(tleaves) == ["/".join(k.key for k in p) for p, _ in jleaves], what
    for (path, a), (key, b) in zip(jleaves, tleaves.items()):
        a = np.asarray(a, np.float32)
        assert str(jnp.asarray(a).dtype) == str(b.dtype).removeprefix("torch."), (what, key)
        diff = float(np.abs(_np(b) - a).max())
        scale = float(np.abs(a).max()) if rel_to_max else 1.0
        assert diff <= STEP_TOL * (scale or 1.0), (what, key, diff, scale)


def _jax_step_and_grads(jm, trc):
    """One jitted call: JAX's loss, gradients and aux at the state, and its
    train step from it."""
    step = jtrain.make_train_step(jm, jtrain.TrainRunConfig(opt=ja.OptConfig(**OPT), **trc))

    def run(state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(state.params, batch)
        return loss, grads, jm.apply(state.params, batch)[1], step(state, batch)
    return jax.jit(run)


def assert_steps_match_jax(jm, tm, trc=None, steps=2, gate=None, seed=10):
    """``steps`` train steps of both packages from one JAX-made state, on
    ``make_batch``'s batches: before each step the loss, the aux and every
    gradient leaf, after it loss, grad norm, lr, and params, m and v.
    Returns the port's last state and metrics and JAX's gradients before
    the last step."""
    trc = trc or {}
    jrun = _jax_step_and_grads(jm, trc)
    tstep = ttrain.make_train_step(tm, ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT),
                                                             **trc))
    js = jax_state(jm, gate)
    ts = state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    for i in range(steps):
        batch = make_batch(tm.cfg, seed=seed + i)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        jl, jg, jaux, (js_next, jmet) = jrun(js, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, tg = ttrain.value_and_grad(tm.loss, ts.params, tb)
        assert float(tl) == pytest.approx(float(jl), rel=STEP_TOL)
        assert float(tm.apply(ts.params, tb)[1]) == pytest.approx(float(jaux), rel=STEP_TOL)
        _leaves_close(jg, tg, f"grads before step {i + 1}", rel_to_max=True)
        js = js_next
        ts, tmet = tstep(ts, tb)
        assert int(ts.step) == i + 1
        for key in ("loss", "grad_norm", "lr"):
            assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=STEP_TOL), key
        for field in ("params", "m", "v"):
            _leaves_close(getattr(js, field), getattr(ts, field), f"{field} after {i + 1}")
    return ts, tmet, jg


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", list(REMAT))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_jax(arch, remat):
    """Two steps: every gradient leaf, loss, aux, grad norm, lr; then params,
    m and v."""
    assert_steps_match_jax(*models(arch, remat))


def test_train_step_with_capacity_drops_matches_jax():
    """qwen2-moe at capacity factor 0.5 (C = 16 slots for 128 tokens x 2
    choices over 8 experts): most experts overflow, the dropped choices
    take no gradient in either package, and the steps still agree."""
    jm, tm = models("qwen2-moe-a2.7b", capacity_factor=0.5)
    cfg = tm.cfg
    group = B * S
    C = tmoe._capacity(cfg, group)
    assert C == 8 * cfg.top_k and cfg.top_k * group > cfg.n_experts * C   # drops are certain
    assert_steps_match_jax(jm, tm)


def test_grad_accum_matches_full_batch_and_jax():
    """grad_accum=2 on qwen2-moe (remat "full"): each micro-batch routes its
    own 64 tokens, so the mean of the two halves is not the full batch's
    step; it is JAX's grad_accum=2 step (loss = lsum / 2 with the aux of
    each half), after each of two steps."""
    jm, tm = models("qwen2-moe-a2.7b", "full")
    assert_steps_match_jax(jm, tm, trc={"grad_accum": 2})
    # by hand: the micro-batches' losses (aux included) averaged
    state = state_from_jax(jax.tree.map(np.asarray, jax_state(jm)), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tm.cfg, seed=10).items()}
    halves = [{k: v[i * B // 2:(i + 1) * B // 2] for k, v in batch.items()} for i in (0, 1)]
    mean = sum(float(tm.loss(state.params, h)) for h in halves) / 2
    step = ttrain.make_train_step(tm, ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT),
                                                            grad_accum=2))
    _, m1 = step(state, batch)
    assert float(m1["loss"]) == pytest.approx(mean, rel=1e-6)


# ---------------------------------------------------------------------------
# route and top_k under autograd, against jax.vjp
# ---------------------------------------------------------------------------
def _route_vjp_both(arch, logits, capacity_factor=1.25, aux_ct=1.0, seed=0):
    """The gradient of <combine, R> + aux_ct * aux with respect to the
    logits, in both packages, for a random R."""
    jc = dataclasses.replace(jax_config(arch).reduced(), capacity_factor=capacity_factor)
    tc = dataclasses.replace(get_config(arch).reduced(), capacity_factor=capacity_factor)
    G, Sg, Ep = logits.shape
    C = tmoe._capacity(tc, Sg)
    R = np.random.default_rng(seed).standard_normal((G, Sg, Ep, C)).astype(np.float32)

    def jf(x):
        _, comb, aux = jmoe.route(x, jc, Sg)
        return jnp.sum(comb * R) + aux_ct * aux
    jg = np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(logits)))
    x = torch.from_numpy(logits.copy()).requires_grad_(True)
    disp, comb, aux = tmoe.route(x, tc, Sg)
    (tg,) = torch.autograd.grad((comb * torch.from_numpy(R)).sum() + aux_ct * aux, x)
    return jg, tg.numpy(), disp, tc


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_route_gradient_matches_jax(arch, capacity_factor):
    """Through the probs, the renormalised gates into combine and the aux's
    ``me``; the pad experts' router columns (8..15) get exactly zero."""
    logits = np.random.default_rng(1).standard_normal((2, 64, 16)).astype(np.float32)
    jg, tg, _, tc = _route_vjp_both(arch, logits, capacity_factor)
    np.testing.assert_allclose(tg, jg, atol=ROUTE_GRAD_TOL, rtol=ROUTE_GRAD_TOL)
    assert tc.n_experts_padded > tc.n_experts
    assert not tg[..., tc.n_experts:].any() and not jg[..., tc.n_experts:].any()
    assert np.abs(tg[..., :tc.n_experts]).max() > 0


def test_aux_gradient_is_the_me_term_only():
    """With combine's cotangent 0 the logits' gradient is the aux's, through
    ``me`` alone: E * assign_e / (G * S) on each token's softmax, with
    ``assign`` (from the one-hot dispatch) held constant, in both packages."""
    arch = "qwen2-moe-a2.7b"
    logits = np.random.default_rng(2).standard_normal((1, 64, 16)).astype(np.float32)
    tc = get_config(arch).reduced()
    jc = jax_config(arch).reduced()
    jg = np.asarray(jax.jit(jax.grad(lambda x: jmoe.route(x, jc, 64)[2]))(
        jnp.asarray(logits)))
    x = torch.from_numpy(logits.copy()).requires_grad_(True)
    disp, _, aux = tmoe.route(x, tc, 64)
    (tg,) = torch.autograd.grad(aux, x)
    np.testing.assert_allclose(tg.numpy(), jg, atol=ROUTE_GRAD_TOL, rtol=ROUTE_GRAD_TOL)
    E = tc.n_experts
    assign = disp[..., :E, :].float().sum(-1).mean(dim=(0, 1))             # constant
    z = x.detach().requires_grad_(True)
    probs = torch.softmax(z.masked_fill(torch.arange(16) >= E, -1e9), dim=-1)
    (expect,) = torch.autograd.grad(E * (probs[..., :E].mean(dim=(0, 1)) * assign).sum(), z)
    np.testing.assert_allclose(tg.numpy(), expect.numpy(), atol=1e-7, rtol=1e-6)


def test_dropped_choice_takes_no_gradient():
    """At capacity factor 0.5 a token all of whose choices were dropped
    reaches combine nowhere: with the aux's cotangent 0 its logits' row
    gets exactly zero gradient in both packages, and a token with both
    choices kept does not. (qwen2-moe's top-2: under top-1, llama4-scout's,
    the renormalised gate of a kept choice is v / v = 1, so no token's row
    takes a gradient through combine.)"""
    arch = "qwen2-moe-a2.7b"
    logits = np.random.default_rng(3).standard_normal((1, 128, 16)).astype(np.float32)
    jg, tg, disp, tc = _route_vjp_both(arch, logits, capacity_factor=0.5, aux_ct=0.0)
    dropped = (disp.float().sum(dim=(-1, -2)) == 0)[0].numpy()             # (128,)
    kept_all = (disp.float().sum(dim=(-1, -2)) == tc.top_k)[0].numpy()
    assert dropped.sum() >= 8 and kept_all.sum() >= 8
    for g in (tg, jg):
        assert not g[0, dropped].any()
        assert (np.abs(g[0, kept_all]).max(axis=-1) > 0).all()
    np.testing.assert_allclose(tg, jg, atol=ROUTE_GRAD_TOL, rtol=ROUTE_GRAD_TOL)


def test_top_k_sends_a_tied_cotangent_where_lax_top_k_does():
    """Ties at the k-th value: the cotangent of each returned value goes to
    the index ``lax.top_k`` picked (the lower one) in both packages."""
    probs = np.array([[0.1, 0.3, 0.2, 0.3, 0.3, 0.05],
                      [0.2, 0.2, 0.2, 0.2, 0.1, 0.1]], np.float32)
    ct = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    jg = np.asarray(jax.grad(lambda p: jnp.sum(jax.lax.top_k(p, 3)[0] * ct))(
        jnp.asarray(probs)))
    x = torch.from_numpy(probs.copy()).requires_grad_(True)
    vals, idx = tmoe.top_k(x, 3)
    (tg,) = torch.autograd.grad((vals * torch.from_numpy(ct)).sum(), x)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tg.numpy(), jg)
    np.testing.assert_array_equal(tg.numpy()[0], [0, 1, 0, 2, 3, 0])


# ---------------------------------------------------------------------------
# the model's aux under remat, and what AdamW does with the moe tree
# ---------------------------------------------------------------------------
@functools.cache
def _aux_loss_and_grads(**remat):
    """(aux, loss, grads) of the reduced qwen2-moe in f32 under ``remat``."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    rc = RunConfig(compute_dtype=torch.float32, device="cpu", **remat)
    params = build(cfg, rc).init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, seed=5).items()}
    model = build(cfg, rc)
    return (model.apply(params, batch)[1], *ttrain.value_and_grad(model.loss, params, batch))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_aux_survives_remat(policy):
    """The checkpointed block returns (h, kv, aux): under "full" and "dots"
    the summed aux, the loss and every gradient equal remat off's bit for bit."""
    aux0, loss0, g0 = _aux_loss_and_grads()
    aux1, loss1, g1 = _aux_loss_and_grads(remat=True, remat_policy=policy)
    assert float(aux0) > 0 and torch.equal(aux1, aux0) and torch.equal(loss1, loss0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)
    assert float(g0["blocks"]["moe"]["router"].abs().sum()) > 0


def test_adamw_decays_pad_expert_rows():
    """The pad experts' rows (router columns, w1 and w2 slices) take no
    gradient but, as slices of matrices, are decayed as in JAX: Adam's
    update there is the decay alone, p (1 - lr wd)."""
    _, tm = models("qwen2-moe-a2.7b")
    state = ttrain.init_sharded_state(tm, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tm.cfg, seed=4).items()}
    _, grads = ttrain.value_and_grad(tm.loss, state.params, batch)
    new, met = ttrain.make_train_step(tm, ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT)))(
        state, batch)
    E = tm.cfg.n_experts
    decay = 1 - float(met["lr"]) * ta.OptConfig(**OPT).weight_decay
    for name, sl in (("router", (..., slice(E, None))), ("w1", (slice(None), slice(E, None))),
                     ("w2", (slice(None), slice(E, None)))):
        before, after = state.params["blocks"]["moe"][name][sl], new.params["blocks"]["moe"][name][sl]
        assert not grads["blocks"]["moe"][name][sl].any()
        assert float(before.abs().max()) > 0
        torch.testing.assert_close(after, before * decay, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_descends_and_finite(arch):
    """The moe cases of tests/test_arch_smoke.py, on the port: the same batch
    twice, so the loss must drop; the router and every expert leaf take a
    gradient."""
    cfg = get_config(arch).reduced()
    step, _, _, _, _, model = ttrain.build_train_step(
        cfg, None, B=2, S=32, rc=RunConfig(device="cpu", remat=True),
        trc=ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT)))
    state = ta.init_state(model.init(torch.Generator().manual_seed(0)))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 1, batch=2).items()}
    _, grads = ttrain.value_and_grad(model.loss, state.params, batch)
    for name in ("router", "w1", "w2", "w3"):
        assert float(grads["blocks"]["moe"][name].abs().sum()) > 0, name
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    assert bool(torch.isfinite(m1["loss"])) and bool(torch.isfinite(m2["grad_norm"]))
    assert float(m2["loss"]) < float(m1["loss"])


# ---------------------------------------------------------------------------
# the full-size train states, on the meta device
# ---------------------------------------------------------------------------
def assert_meta_state_matches_jax(arch):
    """``build_train_step``'s meta state against JAX's ``init_eval_shape`` and
    ``eval_shape(init_state)``: every params, m and v leaf with JAX's path
    key, shape and dtype, in JAX's order, and step an int32 scalar. Returns
    the number of parameters."""
    cfg = get_config(arch)
    _, state_meta, batch_meta, _, _, _ = ttrain.build_train_step(
        cfg, None, B=B, S=S, rc=RunConfig(device="cpu", remat=True))
    jparams = jax_build(jax_config(arch), JaxRunConfig(param_dtype="float32")).init_eval_shape()
    jstate = jax.eval_shape(ja.init_state, jparams)
    for field in ("params", "m", "v"):
        expect = {"/".join(k.key for k in path): (tuple(a.shape), str(a.dtype))
                  for path, a in jax.tree_util.tree_flatten_with_path(
                      getattr(jstate, field))[0]}
        got = {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for k, t in tree_flatten_with_path(getattr(state_meta, field)).items()}
        assert list(got) == list(expect) and got == expect, field
        assert all(t.device.type == "meta" for t in tree_leaves(getattr(state_meta, field)))
    assert (tuple(state_meta.step.shape), str(state_meta.step.dtype)) == \
        ((), "torch.int32") == (tuple(jstate.step.shape), "torch." + str(jstate.step.dtype))
    jb = jtrain.train_batch_specs(jax_config(arch), B, S)
    assert {k: tuple(v.shape) for k, v in batch_meta.items()} == \
        {k: tuple(v.shape) for k, v in jb.items()}
    return sum(t.numel() for t in tree_leaves(state_meta.params))


def train_state_gb(cfg, n_params):
    """The f32 train state at the step's peak, in GB."""
    return STATE_BYTES_PER_PARAM * n_params / 1e9


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_meta_train_state_matches_jax(arch):
    """And the reckoning that sets the card's depth cut: at 28 bytes a
    parameter, qwen2-moe-a2.7b at full depth needs 424 GB, and 2 of its 24
    layers (the untied 151,936-row embedding and head, 0.62 B, plus 0.605 B
    a layer) 51 GB."""
    n = assert_meta_state_matches_jax(arch)
    cfg = get_config(arch)
    if arch == "qwen2-moe-a2.7b":
        cut = dataclasses.replace(cfg, n_layers=2)
        n_cut = sum(t.numel() for t in tree_leaves(build(cut, RunConfig(
            device="meta")).init_eval_shape()))
        per_layer = (n - n_cut) / (cfg.n_layers - 2)
        print(f"{arch}: {n:,} params, {train_state_gb(cfg, n):.1f} GB at "
              f"{STATE_BYTES_PER_PARAM} B/param; cut to 2 layers {n_cut:,} params, "
              f"{train_state_gb(cut, n_cut):.1f} GB ({per_layer / 1e9:.3f} B a layer)")
        assert 420 < train_state_gb(cfg, n) < 430
        assert 0.60e9 < per_layer < 0.61e9
        assert 50 < train_state_gb(cut, n_cut) < 52
        assert train_state_gb(cut, n_cut) + 0.605e9 * STATE_BYTES_PER_PARAM / 1e9 > 66
    else:
        print(f"{arch}: {n:,} params, {train_state_gb(cfg, n):.1f} GB at "
              f"{STATE_BYTES_PER_PARAM} B/param: no single card holds it")
        assert train_state_gb(cfg, n) > 80


# ---------------------------------------------------------------------------
# chip_smoke.py's routing comparison
# ---------------------------------------------------------------------------
@pytest.fixture
def chip_smoke():
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import chip_smoke
    return chip_smoke


def test_routing_diff_tells_near_ties_from_flips(chip_smoke):
    """Three tokens of top-2 over 4 experts: the first routed alike; the
    second swaps experts 2 and 3, whose probabilities differ by 5e-6 (a
    near-tie); the third takes expert 1 in place of 2, 0.1 apart (a flip).
    A kept place that differs marks its token too."""
    probs = torch.tensor([[0.4, 0.3, 0.2, 0.1],
                          [0.1, 0.1, 0.400005, 0.4],
                          [0.5, 0.2, 0.3, 0.0]])
    kept = torch.ones((3, 4), dtype=torch.bool)
    a = [{"idx": torch.tensor([[0, 1], [2, 3], [0, 2]]), "probs": probs, "kept": kept}]
    b = [{"idx": torch.tensor([[0, 1], [3, 2], [0, 1]]), "probs": probs, "kept": kept}]
    got = chip_smoke.routing_diff(a, b)
    assert (got["flips"], got["near_ties"]) == (2, 1)
    assert got["differ"].tolist() == [[False, True, True]]
    other = [dict(b[0], idx=a[0]["idx"], kept=kept.clone())]
    other[0]["kept"][0, 3] = False
    got = chip_smoke.routing_diff(a, other)
    assert (got["flips"], got["near_ties"]) == (0, 0)
    assert got["differ"].tolist() == [[True, False, False]]


def test_record_routing_under_a_gradient(chip_smoke):
    """``record_routing`` logs each MoE layer's top-k indices, probabilities
    and kept places, detached, while the loss takes its gradient; two runs
    of one model route alike."""
    _, tm = models("qwen2-moe-a2.7b")
    params = ttrain.init_sharded_state(tm, seed=0).params
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tm.cfg, seed=7).items()}
    logs = []
    for _ in range(2):
        log = []
        with chip_smoke.record_routing(log):
            ttrain.value_and_grad(tm.loss, params, batch)
        logs.append(log)
    assert len(logs[0]) == tm.cfg.n_layers
    entry = logs[0][0]
    assert tuple(entry["idx"].shape) == (B * S, tm.cfg.top_k)
    assert tuple(entry["probs"].shape) == tuple(entry["kept"].shape) == \
        (B * S, tm.cfg.n_experts_padded)
    assert not entry["probs"].requires_grad
    assert bool(entry["kept"].sum(-1).le(tm.cfg.top_k).all())
    got = chip_smoke.routing_diff(*logs)
    assert got["flips"] == 0 and not got["differ"].any()
