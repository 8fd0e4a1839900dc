"""Training parity of the port (repro_torch) with the JAX package, dense family.

Loss, AdamW, int8 compression and the train step, on the same numpy
inputs and the same weights (made by the JAX package and moved with
``convert.params_from_jax`` / ``state_from_jax``), at the reduced
qwen2-0.5b in f32 compute with its vocab cut to 500 (padded to 512, so
the padded-vocab mask is exercised). JAX runs on the CPU; the port runs
with device="cpu", where its attention takes K1's plain version, whose
autograd is the reference's.

Tolerances: the CE and ``Model.loss`` rel 1e-5; ``global_norm`` and
``apply_updates`` 1e-6; int8 compression exact; the train step's loss,
grad norm and lr rel 1e-4, its params, m and v 1e-4 absolute.
``schedule`` is exact through the warmup and within 2^-22 * lr after
it: the cosine comes from glibc's ``cosf`` in XLA and from PyTorch's own
cos, which differ in the last bit (2^-24 at most) at about 2% of
arguments; scaled by (1 - min_lr_ratio) / 2 and carried through three
more roundings, that stays under 2^-22 of the peak lr.
With int8 compression, a gradient that lies within the two frameworks'
rounding of a half quantum quantizes to neighbouring int8 levels (4 of
657,536 elements at this test's first step): Adam's step turns such a
flip into a difference of up to the learning rate. Those elements,
found from both frameworks' raw gradients, are held to one quantum's
effect; every other element to 1e-4.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import RunConfig as JaxRunConfig, build as jax_build  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro.parallel import compression as jcomp  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.parallel import compression as tcomp  # noqa: E402
from repro_torch.parallel.mesh import P  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402
from repro_torch.runtime.specs import train_batch_specs  # noqa: E402
from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,  # noqa: E402
                              tree_rebuild, tree_unflatten)

VOCAB = 500            # padded to 512: the CE masks 12 slots
STEP_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _models(compute="float32"):
    """(JAX model, port model) of the reduced qwen2-0.5b, vocab 500."""
    jc = dataclasses.replace(jax_config("qwen2-0.5b").reduced(), vocab_size=VOCAB)
    tc = dataclasses.replace(get_config("qwen2-0.5b").reduced(), vocab_size=VOCAB)
    jm = jax_build(jc, JaxRunConfig(param_dtype="float32", compute_dtype=compute))
    tm = build(tc, RunConfig(param_dtype=torch.float32,
                             compute_dtype=getattr(torch, compute), device="cpu"))
    return jm, tm


def _batch(B=4, S=16, seed=0, vocab=VOCAB):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "labels": np.ascontiguousarray(toks[:, 1:])}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab", [VOCAB, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_cross_entropy_matches_jax(dtype, vocab):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 512)) * 4).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    lj = jnp.asarray(logits, jnp.dtype(dtype))
    lt = torch.from_numpy(logits).to(getattr(torch, dtype))
    expect = jl.softmax_cross_entropy(lj, jnp.asarray(labels), vocab)
    got = tl.softmax_cross_entropy(lt, torch.from_numpy(labels), vocab)
    assert got.dtype == torch.float32 and got.shape == (3, 7)
    np.testing.assert_allclose(_np(got), np.asarray(expect), rtol=1e-5, atol=0)


def test_padded_vocab_slots_take_no_gradient():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 512)).astype(np.float32))
    logits.requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, VOCAB, (2, 5)).astype(np.int32))
    tl.softmax_cross_entropy(logits, labels, VOCAB).sum().backward()
    assert torch.all(logits.grad[..., VOCAB:] == 0)
    assert torch.all(logits.grad[..., :VOCAB].abs().sum(-1) > 0)


def test_lm_loss_adds_weighted_aux():
    tc = get_config("qwen2-0.5b").reduced()
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((2, 4, 512)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 512, (2, 4)))
    ce = tt.lm_loss(logits, labels, tc)
    aux = torch.tensor(2.5)
    assert torch.equal(tt.lm_loss(logits, labels, tc, aux, aux_weight=0.1), ce + 0.1 * aux)


def test_model_loss_matches_jax():
    jm, tm = _models()
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    batch = _batch()
    expect = float(jm.loss(jp, _jax_batch(batch)))
    got = tm.loss(tp, _torch_batch(batch))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(expect, rel=1e-5)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", [dict(), dict(lr=3e-4, warmup_steps=2, total_steps=8),
                                 dict(lr=1e-3, warmup_steps=7, total_steps=33,
                                      min_lr_ratio=0.05)])
def test_schedule_matches_jax(opt):
    jcfg, tcfg = ja.OptConfig(**opt), ta.OptConfig(**opt)
    last = tcfg.total_steps + 20
    for s in sorted(set(range(0, last, max(1, last // 300))) | {tcfg.warmup_steps, last}):
        expect = np.asarray(ja.schedule(jnp.int32(s), jcfg))
        got = ta.schedule(torch.tensor(s, dtype=torch.int32), tcfg)
        assert got.dtype == torch.float32
        if s < tcfg.warmup_steps:
            assert got.numpy() == expect, s
        else:
            np.testing.assert_allclose(got.numpy(), expect, rtol=0,
                                       atol=2.0 ** -22 * tcfg.lr)


def _opt_tree(seed):
    """A params-like tree with a bf16 matrix, a 1-d leaf and nested dicts."""
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((16, 8)) * 0.5).astype(np.float32),
        "bias": (rng.standard_normal((8,)) * 0.1).astype(np.float32),
        "blocks": {"stacked": (rng.standard_normal((3, 8, 4)) * 0.2).astype(np.float32),
                   "half": np.asarray(jnp.asarray(rng.standard_normal((4, 6)),
                                                  jnp.bfloat16))},
    }


def test_global_norm_matches_jax():
    tree = _opt_tree(4)
    expect = float(ja.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = ta.global_norm(params_from_jax(tree, device="cpu"))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(expect, abs=1e-6, rel=1e-6)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])      # below and above the clip
def test_apply_updates_matches_jax(grad_scale):
    params = _opt_tree(5)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    js = ja.init_state(jax.tree.map(jnp.asarray, params))
    ts = ta.init_state(params_from_jax(params, device="cpu"))
    for i in range(3):
        grads = jax.tree.map(lambda p: np.asarray(p, np.float32), _opt_tree(10 + i))
        grads = jax.tree.map(lambda g: g * grad_scale, grads)
        grads["blocks"]["half"] = np.asarray(jnp.asarray(grads["blocks"]["half"],
                                                         jnp.bfloat16))
        old_t = ts
        js, jmet = ja.apply_updates(js, jax.tree.map(jnp.asarray, grads), ja.OptConfig(**cfg))
        ts, tmet = ta.apply_updates(ts, params_from_jax(grads, device="cpu"),
                                    ta.OptConfig(**cfg))
        assert ts is not old_t and int(old_t.step) == i      # the old state is kept
        assert int(ts.step) == int(js.step) == i + 1 and ts.step.dtype == torch.int32
        for key in ("lr", "grad_norm"):
            assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=1e-6)
        for field in ("params", "m", "v"):
            for a, b in zip(jax.tree.leaves(getattr(js, field)),
                            tree_leaves(getattr(ts, field))):
                assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
                np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                           atol=1e-6, rtol=1e-6)


def _unfused_apply_updates(state, grads, cfg):
    """``apply_updates`` as the port wrote it before its terms went in place:
    a new tensor for each term (the reference the fused one must equal bit
    for bit)."""
    gnorm = ta.global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = ta.schedule(step, cfg)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, state.params, grads, state.m, state.v)
    pick = [tree_map(lambda t: t[i], out, is_leaf=lambda x: isinstance(x, tuple))
            for i in range(3)]
    return ta.TrainState(*pick, step), {"lr": lr, "grad_norm": gnorm}


def _stacked_tree(seed, scale=1.0):
    """f32 and bf16 leaves: stacked (L, a, b), 2-d, 1-d and a scalar."""
    rng = np.random.default_rng(seed)

    def leaf(*shape, dtype=torch.float32):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dtype)
    return {"blocks": {"w1": leaf(6, 8, 5), "wo": leaf(5, 4, 3, dtype=torch.bfloat16),
                       "ln": leaf(6, 8)},
            "embed": leaf(30, 7), "head": leaf(12, 7, dtype=torch.bfloat16),
            "bias": leaf(9), "norm": leaf(9, dtype=torch.bfloat16),
            "gate": leaf(1).reshape(())}


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(
        v.float().numpy(), jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        for k, v in tree.items()}


@pytest.mark.parametrize("slice_bytes", [None, 64])          # whole leaves; 4 slices each
def test_apply_updates_equals_the_unfused_formula(monkeypatch, slice_bytes):
    """At steps 1-3 (the third with gradients large enough to clip), the
    update written in place, whole or in ``_SLICES`` slices, is bit-equal
    to the unfused formula, and within 1e-6 of JAX's ``apply_updates``;
    handed over (``free_grads``), the gradients' tree is emptied and the
    result is the same."""
    if slice_bytes is not None:
        monkeypatch.setattr(ta, "_SLICE_BYTES", slice_bytes)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    params = _stacked_tree(1)
    fused = unfused = ta.init_state(params)
    js = ja.init_state(_jax_tree(params))
    for i in range(3):
        grads = _stacked_tree(10 + i, 30.0 if i == 2 else 0.01)
        unfused, umet = _unfused_apply_updates(unfused, grads, ta.OptConfig(**cfg))
        handed = tree_map(lambda t: t, grads)
        fused, fmet = ta.apply_updates(fused, handed, ta.OptConfig(**cfg), free_grads=True)
        assert handed == {}, handed
        js, _ = ja.apply_updates(js, _jax_tree(grads), ja.OptConfig(**cfg))
        assert (float(fmet["grad_norm"]) > 1.0) == (i == 2)      # the clip is active at step 3
        for field in ("params", "m", "v"):
            for a, b, j in zip(tree_leaves(getattr(unfused, field)),
                               tree_leaves(getattr(fused, field)),
                               jax.tree.leaves(getattr(js, field))):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert torch.equal(a, b), (i, field)
                np.testing.assert_allclose(_np(b), np.asarray(j, np.float32),
                                           atol=1e-6, rtol=1e-6)


def _traced_update(update, param_dtype):
    """The live-storage high-water mark of one AdamW update of qwen2-0.5b's
    meta train state (no storage: the trace counts the storages the update
    makes), the new state's bytes, and the largest leaf's f32 bytes."""
    from repro_torch.launch.trace_analysis import TraceAnalysis
    model = build(get_config("qwen2-0.5b"), RunConfig(device="meta", param_dtype=param_dtype))
    state = ta.init_state(model.init_eval_shape())
    grads = tree_map(torch.empty_like, state.params)
    with TraceAnalysis() as trace:
        new, _ = update(state, grads, ta.OptConfig())
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(new))
    largest = max(t.numel() for t in tree_leaves(state.params)) * 4
    return trace.stats.peak_live_bytes, nbytes, largest


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_apply_updates_holds_the_new_state_and_one_scratch_buffer(param_dtype):
    """qwen2-0.5b's update (its 136 M-row embedding the largest leaf) holds
    at its peak the new state and at most one f32 buffer the size of the
    largest leaf: a slice's scratch (two for a bf16 param). The unfused
    formula held four whole leaves more."""
    dtype = getattr(torch, param_dtype)
    peak, state, largest = _traced_update(ta.apply_updates, dtype)
    old_peak, _, _ = _traced_update(_unfused_apply_updates, dtype)
    print(f"{param_dtype} params: peak {peak / 1e9:.3f} GB, new state {state / 1e9:.3f} GB, "
          f"largest leaf in f32 {largest / 1e9:.3f} GB; unfused peak {old_peak / 1e9:.3f} GB")
    assert peak <= state + largest, (peak, state, largest)
    assert old_peak > state + 3 * largest, (old_peak, state, largest)


def test_init_state_is_f32_zeros_and_int32_step():
    ts = ta.init_state(params_from_jax(_opt_tree(6), device="cpu"))
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for m, v, p in zip(tree_leaves(ts.m), tree_leaves(ts.v), tree_leaves(ts.params)):
        assert m.dtype == v.dtype == torch.float32 and m.shape == p.shape
        assert not m.any() and not v.any() and m.data_ptr() != v.data_ptr()


def test_tree_helpers_follow_sorted_keys():
    tree = {"b": 1, "a": {"d": 2, "c": 3}}
    assert tree_leaves(tree) == [3, 2, 1]
    assert tree_unflatten(tree, [30, 20, 10]) == {"a": {"c": 30, "d": 20}, "b": 10}
    assert tree_map(lambda x, y: x + y, tree, tree) == {"b": 2, "a": {"d": 4, "c": 6}}
    with pytest.raises(ValueError):
        tree_unflatten(tree, [1, 2, 3, 4])


def test_tree_paths_cover_namedtuples_sequences_and_is_leaf():
    state = ta.TrainState(params={"w": 1, "b": [2, 3]}, m={"w": 4, "b": [5, 6]},
                       v={"w": 7, "b": [8, 9]}, step=10)
    flat = tree_flatten_with_path(state)
    assert list(flat) == [".params/b/0", ".params/b/1", ".params/w", ".m/b/0", ".m/b/1",
                          ".m/w", ".v/b/0", ".v/b/1", ".v/w", ".step"]
    assert tree_leaves(state) == list(flat.values())
    back = tree_rebuild(state, {k: -x for k, x in flat.items()})
    assert type(back) is ta.TrainState and back.params == {"w": -1, "b": [-2, -3]}
    assert back.step == -10
    pairs = tree_map(lambda x: (x, -x), {"a": 1, "b": 2})
    assert tree_map(lambda t: t[1], pairs, is_leaf=lambda x: isinstance(x, tuple)) == {
        "a": -1, "b": -2}


def test_tree_walks_and_a_train_step_hold_no_reference_cycle():
    """With Python's cyclic collector off, a train state's leaves are freed as
    soon as the last reference to the state goes: neither the tree walks nor
    the step leave a cycle behind (a self-calling closure in the walks once
    held every leaf it saw, a whole state and its gradients, until the
    collector happened to run, which ran a card out of memory)."""
    import gc
    import weakref
    _, tm = _models()
    step = ttrain.make_train_step(tm, ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT)))
    gc.collect()
    gc.disable()
    try:
        state = ttrain.init_sharded_state(tm, seed=0)
        refs = [weakref.ref(t) for t in tree_leaves(state)]
        new, _ = step(state, _torch_batch(_batch()))
        tree_map(lambda t: t + 1, tree_unflatten(state, tree_leaves(state)))
        del state
        assert all(r() is None for r in refs)
        refs = [weakref.ref(t) for t in tree_leaves(new)]
        del new
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------
def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((64, 33)) * 0.01).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "c": {"d": (rng.standard_normal((4, 5, 6)) * 3).astype(np.float32),
                  "e": np.asarray(jnp.asarray(rng.standard_normal((9, 3)), jnp.bfloat16))}}


def test_quantize_dequantize_int8_is_exact():
    tree = _grad_tree(7)
    expect = jcomp.quantize_dequantize_int8(jax.tree.map(jnp.asarray, tree))
    got = tcomp.quantize_dequantize_int8(params_from_jax(tree, device="cpu"))
    for a, b in zip(jax.tree.leaves(expect), tree_leaves(got)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_ef_compress_is_exact():
    jres = jcomp.init_residual(jax.tree.map(jnp.asarray, _grad_tree(8)))
    tres = tcomp.init_residual(params_from_jax(_grad_tree(8), device="cpu"))
    for i in range(3):
        tree = _grad_tree(20 + i)
        jdq, jres = jcomp.ef_compress(jax.tree.map(jnp.asarray, tree), jres)
        tdq, tres = tcomp.ef_compress(params_from_jax(tree, device="cpu"), tres)
        for a, b in zip(jax.tree.leaves((jdq, jres)), tree_leaves(tdq) + tree_leaves(tres)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _int8_levels(g):
    """The int8 level of every element, as ``compression._q8`` picks it (0 for
    tensors of fewer than 2 dims, which pass uncompressed)."""
    g = np.asarray(g, np.float32)
    if g.ndim < 2:
        return np.zeros(g.shape)
    scale = np.float32(np.abs(g).max() / np.float32(127.0) + np.float32(1e-12))
    return np.clip(np.round(g / scale), -127, 127)


@pytest.mark.parametrize("mode", ["plain", "grad_accum=2", "int8"])
def test_train_step_matches_jax(mode):
    """Two steps from one state: loss, grad norm, lr; then params, m and v."""
    jm, tm = _models()
    trc = dict(grad_accum=2 if mode == "grad_accum=2" else 1,
               compression="int8" if mode == "int8" else None)
    jstep = jax.jit(jtrain.make_train_step(jm, jtrain.TrainRunConfig(
        opt=ja.OptConfig(**OPT), **trc)))
    tstep = ttrain.make_train_step(tm, ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT), **trc))
    js = ja.init_state(jm.init(jax.random.PRNGKey(0)))
    ts = state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    flipped, quanta, gmax = None, None, None
    for i in range(2):
        batch = _batch(seed=10 + i)
        if mode == "int8":     # elements whose int8 level differs between the frameworks
            _, gj = jax.value_and_grad(jm.loss)(js.params, _jax_batch(batch))
            _, gt = ttrain.value_and_grad(tm.loss, ts.params, _torch_batch(batch))
            gj = [np.asarray(a, np.float32) for a in jax.tree.leaves(gj)]
            lj = [_int8_levels(a) for a in gj]
            lt = [_int8_levels(b.numpy()) for b in tree_leaves(gt)]
            assert all(np.abs(a - b).max() <= 1 for a, b in zip(lj, lt))
            now = [a != b for a, b in zip(lj, lt)]
            step_q = [np.abs(a).max() / 127.0 for a in gj]
            step_max = [np.abs(a).max() for a in gj]
            if flipped is None:
                flipped, quanta, gmax = now, step_q, step_max
            else:
                flipped = [f | n for f, n in zip(flipped, now)]
                quanta = [max(a, b) for a, b in zip(quanta, step_q)]
                gmax = [max(a, b) for a, b in zip(gmax, step_max)]
            n_flipped = sum(int(f.sum()) for f in flipped)
            assert n_flipped <= 1e-4 * sum(f.size for f in flipped), n_flipped
        js, jmet = jstep(js, _jax_batch(batch))
        ts, tmet = tstep(ts, _torch_batch(batch))
        assert int(ts.step) == i + 1
        for key in ("loss", "grad_norm", "lr"):
            assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=STEP_TOL), key
        for field in ("params", "m", "v"):
            jleaves, tleaves = jax.tree.leaves(getattr(js, field)), tree_leaves(getattr(ts, field))
            assert len(jleaves) == len(tleaves)
            for n, (a, b) in enumerate(zip(jleaves, tleaves)):
                diff = np.abs(_np(b) - np.asarray(a, np.float32))
                if flipped is not None:
                    # one int8 level's effect: up to the lr on a param (Adam's
                    # normalised step), a quantum on m, quantum * (2 |g| + quantum) on v
                    q = quanta[n]
                    bound = {"params": 2 * OPT["lr"], "m": q,
                             "v": q * (2 * gmax[n] + q)}[field]
                    assert np.all(diff[flipped[n]] <= bound), (field, n)
                    diff = np.where(flipped[n], 0.0, diff)
                assert diff.max() <= STEP_TOL, (field, n, float(diff.max()))


def test_train_step_keeps_its_input_state():
    _, tm = _models()
    step = ttrain.make_train_step(tm, ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT)))
    state = ttrain.init_sharded_state(tm, None, None, seed=0)
    before = tree_map(torch.clone, state.params)
    new, _ = step(state, _torch_batch(_batch()))
    assert int(state.step) == 0 and int(new.step) == 1
    for a, b, c in zip(tree_leaves(before), tree_leaves(state.params),
                       tree_leaves(new.params)):
        assert torch.equal(a, b) and not b.requires_grad and not c.requires_grad
    assert any(not torch.equal(b, c) for b, c in zip(tree_leaves(state.params),
                                                      tree_leaves(new.params)))


def test_value_and_grad_reaches_every_leaf_and_gives_zeros_to_unused():
    _, tm = _models()
    params = ttrain.init_sharded_state(tm, seed=1).params
    params = dict(params, unused=torch.ones(3))
    loss, grads = ttrain.value_and_grad(tm.loss, params, _torch_batch(_batch()))
    assert not loss.requires_grad and loss.dim() == 0
    assert torch.equal(grads["unused"], torch.zeros(3))
    attn = grads["blocks"]["attn"]
    for name in ("wq", "wk", "wv", "wo"):
        assert attn[name].abs().sum() > 0, name


def test_build_train_step_meta_and_mesh():
    tc = get_config("qwen2-0.5b").reduced()
    rc = RunConfig(device="cpu")
    step, state_meta, batch_meta, st_sh, b_sh, model = ttrain.build_train_step(
        tc, None, B=2, S=8, rc=rc)
    assert st_sh is None and b_sh is None and callable(step)
    assert all(t.device.type == "meta" for t in tree_leaves(state_meta.params))
    assert all(t.dtype == torch.float32 for t in tree_leaves(state_meta.m))
    assert state_meta.step.dtype == torch.int32
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch_meta.items()} == \
        {"tokens": ((2, 8), torch.int32), "labels": ((2, 8), torch.int32)}
    assert all(t.device.type == "meta" for t in train_batch_specs(tc, 2, 8).values())
    # a mesh gives the shardings (the spec functions read only its axis sizes)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    *_, st_sh, b_sh, sharded = ttrain.build_train_step(tc, mesh, B=2, S=8, rc=rc)
    assert sharded.rc.attn_shard == "heads" and sharded.rc.constrain is not rc.constrain
    assert st_sh.params["blocks"]["attn"]["wq"].spec == P(None, "data", "model")
    assert st_sh.m["embed"].spec == st_sh.params["embed"].spec == P("model", "data")
    assert st_sh.step.spec == P() and b_sh["tokens"].spec == P("data", None)
    with pytest.raises(ValueError):
        ttrain.TrainRunConfig(compression="fp8")
    with pytest.raises(ValueError):
        ttrain.TrainRunConfig(grad_accum=0)


def test_init_sharded_state_is_seeded():
    _, tm = _models()
    a = ttrain.init_sharded_state(tm, seed=3)
    b = ttrain.init_sharded_state(tm, seed=3)
    c = ttrain.init_sharded_state(tm, seed=4)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))
    assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                     tree_leaves(c.params)))


def test_cpu_train_step_launches_no_kernel():
    _, tm = _models()
    step = ttrain.make_train_step(tm, ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT)))
    before = (ops.attention.launches, ops.ssd.launches)
    step(ttrain.init_sharded_state(tm), _torch_batch(_batch()))
    assert (ops.attention.launches, ops.ssd.launches) == before


# ---------------------------------------------------------------------------
# the dense cases of tests/test_arch_smoke.py, on the port
# ---------------------------------------------------------------------------
def _arch_batch(cfg, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}


def test_train_step_descends_and_finite():
    cfg = get_config("qwen2-0.5b").reduced()
    step, _, _, _, _, model = ttrain.build_train_step(
        cfg, None, B=2, S=32, rc=RunConfig(device="cpu"),
        trc=ttrain.TrainRunConfig(opt=ta.OptConfig(lr=1e-3, warmup_steps=1,
                                                   total_steps=10)))
    state = ta.init_state(model.init(torch.Generator().manual_seed(0)))
    batch = _arch_batch(cfg)
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)   # same batch twice -> loss must drop
    assert bool(torch.isfinite(m1["loss"])) and bool(torch.isfinite(m2["loss"]))
    assert float(m2["loss"]) < float(m1["loss"])
    assert int(state.step) == 2


def test_grad_accumulation_matches_full_batch():
    """grad_accum=2 over the same data == single big batch (to fp tolerance)."""
    cfg = get_config("qwen2-0.5b").reduced()
    rc = RunConfig(device="cpu")
    trc1 = ttrain.TrainRunConfig(opt=ta.OptConfig(lr=1e-3), grad_accum=1)
    trc2 = ttrain.TrainRunConfig(opt=ta.OptConfig(lr=1e-3), grad_accum=2)
    step1, *_, model = ttrain.build_train_step(cfg, None, B=4, S=16, rc=rc, trc=trc1)
    step2, *_ = ttrain.build_train_step(cfg, None, B=4, S=16, rc=rc, trc=trc2)
    batch = _arch_batch(cfg, B=4, S=16)
    state = ta.init_state(model.init(torch.Generator().manual_seed(0)))
    _, ma = step1(state, batch)
    _, mb = step2(state, batch)
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=2e-2)


# ---------------------------------------------------------------------------
# chip_smoke.py's train phase, rehearsed on the CPU
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


def test_chip_smoke_train_phase_rehearses_on_cpu(chip_smoke, tmp_path):
    cfg = get_config("qwen2-0.5b").reduced()
    res = chip_smoke.train(cfg, device="cpu", batch=2, seq_len=16, steps=3,
                           resume_after=1, ckpt_dir=tmp_path)
    assert len(res["metrics"]) == 3 and len(res["step_ms"]) == 3
    assert res["launches_per_step"] == [{"attention": 0, "ssd": 0}] * 3
    assert res["resume_loss_err"] <= chip_smoke.RESUME_TOL
    assert res["resume_params_err"] <= chip_smoke.RESUME_TOL
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in res["metrics"])
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000001"]
    errs = chip_smoke.train_consistency(dataclasses.replace(cfg, n_layers=2),
                                        device="cpu", batch=2, seq_len=16)
    assert errs["loss_rel"] == errs["grad_norm_rel"] == errs["params_abs"] == 0.0
    assert set(errs["grads_rel"]) == set(tree_flatten_with_path(build(
        dataclasses.replace(cfg, n_layers=2), RunConfig(device="cpu")).init_eval_shape()))
    assert max(errs["grads_rel"].values()) == 0.0
    assert all(errs["grads_scale"][f"blocks/attn/{w}"] > 0 for w in ("wq", "wk", "wv"))
