"""Training parity of the port (repro_torch) with the JAX package: the ssm
(mamba2-2.7b) and hybrid (zamba2-1.2b) families.

The reduced configs in f32 compute at B=4, S=32, ``ssd_chunk=8`` (4
chunks, so the inter-chunk recurrence carries a state), on the same
numpy batches and the same weights (made by the JAX package and moved
with ``convert.state_from_jax``). JAX runs its jitted ``make_train_step``
on the CPU; the port runs with device="cpu", where the SSD scan is K2's
plain version ``models.ssm.ssd_chunked``, whose autograd is the
reference's (JAX differentiates its own ``ssd_chunked``), and the
hybrid's attention K1's (``ref.attention_ref``).

Each step is taken with remat off and under ``remat_policy`` "full" and
"dots", on both sides. Tolerances are those of the dense train step
(``tests/test_torch_train.py``): loss, grad norm and lr rel 1e-4;
params, m and v 1e-4 absolute, after each of two steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import RunConfig as JaxRunConfig, build as jax_build  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

B, S, CHUNK = 4, 32, 8
STEP_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
REMAT = {"off": dict(remat=False), "full": dict(remat=True, remat_policy="full"),
         "dots": dict(remat=True, remat_policy="dots")}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _models(arch, remat="off", **kw):
    """(JAX model, port model) of the reduced ``arch`` in f32, chunk 8."""
    jm = jax_build(jax_config(arch).reduced(),
                   JaxRunConfig(param_dtype="float32", compute_dtype="float32",
                                ssd_chunk=CHUNK, **REMAT[remat]))
    tm = build(get_config(arch).reduced(),
               RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32,
                         device="cpu", ssd_chunk=CHUNK, **REMAT[remat], **kw))
    return jm, tm


def _batch(vocab, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "labels": np.ascontiguousarray(toks[:, 1:])}


def assert_steps_match_jax(jm, tm, trc=None, steps=2):
    """``steps`` train steps of both packages from one JAX-made state."""
    trc = trc or {}
    jstep = jax.jit(jtrain.make_train_step(jm, jtrain.TrainRunConfig(
        opt=ja.OptConfig(**OPT), **trc)))
    tstep = ttrain.make_train_step(tm, ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT),
                                                             **trc))
    js = ja.init_state(jm.init(jax.random.PRNGKey(0)))
    ts = state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    for i in range(steps):
        batch = _batch(tm.cfg.vocab_size, seed=10 + i)
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tmet = tstep(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert int(ts.step) == i + 1
        for key in ("loss", "grad_norm", "lr"):
            assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=STEP_TOL), key
        for field in ("params", "m", "v"):
            jleaves = jax.tree.leaves(getattr(js, field))
            tleaves = tree_leaves(getattr(ts, field))
            assert len(jleaves) == len(tleaves)
            for n, (a, b) in enumerate(zip(jleaves, tleaves)):
                assert str(a.dtype) == str(b.dtype).removeprefix("torch."), (field, n)
                diff = np.abs(_np(b) - np.asarray(a, np.float32)).max()
                assert diff <= STEP_TOL, (field, n, float(diff))
    return ts


@pytest.mark.parametrize("remat", list(REMAT))
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_train_step_matches_jax(arch, remat):
    """Two steps: loss, grad norm, lr; then params, m and v."""
    assert_steps_match_jax(*_models(arch, remat))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_every_mamba2_leaf_gets_a_gradient(arch):
    """The SSM leaves that stay f32 (A_log, dt_bias, D_skip) and the
    projections into the scan get non-zero gradients through it; for the
    hybrid, so does the shared block's attention, summed over its
    applications."""
    _, tm = _models(arch)
    params = ttrain.init_sharded_state(tm, seed=1).params
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg.vocab_size, 3).items()}
    _, grads = ttrain.value_and_grad(tm.loss, params, batch)
    mamba = grads["blocks"]["mamba"]
    for name in ("in_x", "in_z", "in_B", "in_C", "in_dt", "conv_x", "A_log",
                 "dt_bias", "D_skip", "out"):
        assert mamba[name].dtype == params["blocks"]["mamba"][name].dtype
        assert float(mamba[name].abs().sum()) > 0, name
    if arch == "zamba2-1.2b":
        for name in ("wq", "wk", "wv", "wo"):
            assert float(grads["shared_block"]["attn"][name].abs().sum()) > 0, name


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_train_step_descends_and_finite(arch):
    """The ssm and hybrid cases of tests/test_arch_smoke.py, on the port:
    the same batch twice, so the loss must drop."""
    cfg = get_config(arch).reduced()
    step, _, _, _, _, model = ttrain.build_train_step(
        cfg, None, B=2, S=32, rc=RunConfig(device="cpu", remat=True, ssd_chunk=CHUNK),
        trc=ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT)))
    state = ta.init_state(model.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    before = (ops.attention.launches, ops.ssd.launches)
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    assert (ops.attention.launches, ops.ssd.launches) == before   # the CPU launches none
    assert bool(torch.isfinite(m1["loss"])) and bool(torch.isfinite(m2["grad_norm"]))
    assert float(m2["loss"]) < float(m1["loss"])
    assert int(state.step) == 2
