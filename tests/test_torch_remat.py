"""``RunConfig.remat`` / ``remat_policy`` in the port, against the JAX package.

``transformer._maybe_remat`` checkpoints each layer's block under a
gradient: ``"dots"`` saves the matmul outputs and recomputes the rest,
every other policy recomputes the whole block, as the JAX package's
``_maybe_remat`` does. Remat changes no number: on the CPU the loss and
every gradient are bit-equal with it off and on, and the train step
matches the JAX package's at the bounds of ``tests/test_torch_train.py``
(loss, grad norm, lr rel 1e-4; params, m, v 1e-4). Which policy ran is
read from the matmuls executed in a forward + backward: the full path
runs each block's forward matmuls a second time, ``"dots"`` none.

Also here: the hybrid's ``grad_accum=2`` against its full batch and the
JAX package's, and the meta-device train state of the two dense configs
that the card cannot (deepseek-67b) or can only just (qwen2-1.5b) hold,
against the JAX package's ``init_eval_shape``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import set_checkpoint_early_stop  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import RunConfig as JaxRunConfig, build as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402
from tests.test_torch_train_ssm import (B, CHUNK, OPT, S, _batch, _models,  # noqa: E402
                                        assert_steps_match_jax)

POLICIES = ["full", "everything", "none", "dots"]


class _CountDots(TorchDispatchMode):
    """Counts the matmuls (``transformer._DOTS``) that execute under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in tt._DOTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _run_loss_and_grads(arch, remat=False, remat_policy="none"):
    """(loss, grads, matmuls executed) of one forward + backward, f32 on the CPU."""
    model = build(get_config(arch).reduced(),
                  RunConfig(compute_dtype=torch.float32, device="cpu", ssd_chunk=CHUNK,
                            remat=remat, remat_policy=remat_policy))
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg.vocab_size, 5).items()}
    with _CountDots() as count:
        loss, grads = ttrain.value_and_grad(model.loss, params, batch)
    return loss, grads, count.n


# each configuration runs once for the tests that compare it (they only read)
_loss_and_grads = functools.cache(_run_loss_and_grads)


def test_run_config_defaults_are_the_jax_packages():
    assert (RunConfig().remat, RunConfig().remat_policy) == \
        (JaxRunConfig().remat, JaxRunConfig().remat_policy) == (False, "none")


def test_dense_train_step_under_full_remat_matches_jax():
    assert_steps_match_jax(*_models("qwen2-0.5b", "full"))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b", "zamba2-1.2b"])
def test_every_policy_but_dots_recomputes_the_whole_block(arch, policy):
    """The loss and every gradient equal remat off's bit for bit. The full
    path (any policy but "dots") runs each block's forward matmuls again in
    the backward; "dots" runs none again: it saved their outputs."""
    loss0, grads0, dots0 = _loss_and_grads(arch)
    loss, grads, dots = _loss_and_grads(arch, remat=True, remat_policy=policy)
    assert torch.equal(loss, loss0)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads0)):
        assert torch.equal(a, b)
    _, _, dots_full = _loss_and_grads(arch, remat=True, remat_policy="full")
    assert dots_full > dots0
    assert dots == (dots0 if policy == "dots" else dots_full), (dots, dots0, dots_full)


def test_the_hybrids_shared_block_is_not_rematted():
    """As in the JAX package (``_hybrid_forward``): only the Mamba2 bodies
    are checkpointed. The matmuls that run again under "full" are those of
    the Mamba2 blocks' forwards (projections and the scan's einsums), and
    none of the shared block's. (By default the recompute stops once it
    has remade what the backward needs, so it skips each block's last
    matmul, the out-projection, whose output nothing saves.)"""
    cfg = get_config("zamba2-1.2b").reduced()
    rc = RunConfig(compute_dtype=torch.float32, device="cpu", ssd_chunk=CHUNK)
    params = build(cfg, rc).init(torch.Generator().manual_seed(0))
    h = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        with _CountDots() as mamba:
            tt._apply_mamba_block(tt._layers(params["blocks"], cfg.n_layers)[0], h, cfg, rc)
        with _CountDots() as shared:
            tt._apply_attn_block(params["shared_block"], h, cfg, rc,
                                 torch.arange(S)[None, :])
    assert mamba.n > 0 and shared.n > 0
    _, _, dots0 = _loss_and_grads("zamba2-1.2b")
    with set_checkpoint_early_stop(False):   # recompute each block to its end
        _, _, dots_full = _run_loss_and_grads("zamba2-1.2b", remat=True, remat_policy="full")
    assert dots_full - dots0 == cfg.n_layers * mamba.n


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_value_and_grad_under_remat_reaches_every_leaf(policy):
    """Every leaf gets its gradient through the checkpointed blocks, and a
    leaf the loss does not reach gets zeros, as ``jax.grad`` gives."""
    model = build(get_config("zamba2-1.2b").reduced(),
                  RunConfig(compute_dtype=torch.float32, device="cpu", ssd_chunk=CHUNK,
                            remat=True, remat_policy=policy))
    params = dict(model.init(torch.Generator().manual_seed(2)), unused=torch.ones(3))
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg.vocab_size, 6).items()}
    _, grads = ttrain.value_and_grad(model.loss, params, batch)
    assert torch.equal(grads["unused"], torch.zeros(3))
    for key, g in tree_flatten_with_path(grads).items():
        if key not in ("unused", "shared_block/ln1", "shared_block/ln2"):
            assert float(g.abs().sum()) > 0, key


def test_remat_without_grad_is_the_plain_forward():
    """Prefill (no gradient) under remat is the forward with remat off."""
    cfg = get_config("zamba2-1.2b").reduced()
    rc = RunConfig(compute_dtype=torch.float32, device="cpu")
    params = build(cfg, rc).init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_batch(cfg.vocab_size, 7)["tokens"])
    with torch.no_grad():
        expect, cache0 = build(cfg, rc).prefill(params, {"tokens": tokens})
        with _CountDots() as count:
            got, cache = build(cfg, rc.replace(remat=True)).prefill(params,
                                                                    {"tokens": tokens})
    assert torch.equal(got, expect) and count.n > 0
    for a, b in zip(tree_leaves(cache["ssm"]), tree_leaves(cache0["ssm"])):
        assert torch.equal(a, b)


def test_hybrid_grad_accum_matches_full_batch_and_jax():
    """grad_accum=2 under remat "full": the mean of two half-batch gradients
    is the full batch's (loss, grad norm rel 1e-5, Adam's m 1e-6), and two
    steps match the JAX package's grad_accum=2 steps."""
    jm, tm = _models("zamba2-1.2b", "full")
    state = ttrain.init_sharded_state(tm, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg.vocab_size, 8).items()}
    metrics, states = [], []
    for accum in (1, 2):
        step = ttrain.make_train_step(tm, ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT),
                                                                grad_accum=accum))
        new, met = step(state, batch)
        metrics.append(met)
        states.append(new)
    for key in ("loss", "grad_norm"):
        assert float(metrics[1][key]) == pytest.approx(float(metrics[0][key]), rel=1e-5)
    for a, b in zip(tree_leaves(states[1].m), tree_leaves(states[0].m)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert_steps_match_jax(jm, tm, trc={"grad_accum": 2})


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-67b"])
def test_meta_train_state_matches_jax_shapes(arch):
    """``build_train_step`` on the meta device (no storage): every params,
    m and v leaf has the JAX package's shape and dtype, in its order."""
    step, state_meta, batch_meta, _, _, model = ttrain.build_train_step(
        get_config(arch), None, B=B, S=S, rc=RunConfig(device="cpu", remat=True))
    assert callable(step) and model.rc.remat
    jshapes = jax_build(jax_config(arch), JaxRunConfig(param_dtype="float32")).init_eval_shape()
    jleaves = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    expect = {"/".join(k.key for k in path): (tuple(a.shape), str(a.dtype))
              for path, a in jleaves}
    for field in ("params", "m", "v"):
        got = {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for k, t in tree_flatten_with_path(getattr(state_meta, field)).items()}
        assert list(got) == list(expect), field
        assert got == expect, field
        assert all(t.device.type == "meta" for t in tree_leaves(getattr(state_meta, field)))
    n = sum(t.numel() for t in tree_leaves(state_meta.params))
    assert n == get_config(arch).param_count() + get_config(arch).d_model   # + final_norm
    assert {k: tuple(v.shape) for k, v in batch_meta.items()} == \
        {"tokens": (B, S), "labels": (B, S)}


def test_remat_off_is_the_block_itself():
    """remat off, whatever the policy says: the block, not a checkpoint."""
    def fn(x):
        return x
    for policy in POLICIES:
        assert tt._maybe_remat(fn, RunConfig(remat=False, remat_policy=policy)) is fn


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 7, rehearsed on the CPU
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


def test_expected_train_launches(chip_smoke):
    """K1 and K2 a train step: twice per rematted layer, once per shared-block
    application (never rematted)."""
    full = RunConfig(remat=True, remat_policy="full")
    expect = {
        "zamba2-1.2b": ({"attention": 6, "ssd": 38}, {"attention": 6, "ssd": 76}),
        "mamba2-2.7b": ({"attention": 0, "ssd": 64}, {"attention": 0, "ssd": 128}),
        "qwen2-1.5b": ({"attention": 28, "ssd": 0}, {"attention": 56, "ssd": 0}),
    }
    for arch, (off, on) in expect.items():
        cfg = get_config(arch)
        assert chip_smoke.expected_train_launches(cfg, RunConfig()) == off
        assert chip_smoke.expected_train_launches(cfg, full) == on
        assert chip_smoke.expected_train_launches(cfg, full.replace(remat_policy="dots")) == on
    cut = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=chip_smoke.SSM_TRAIN_LAYERS)
    assert chip_smoke.expected_train_launches(cut, full) == {"attention": 0, "ssd": 32}
    cut = dataclasses.replace(get_config("zamba2-1.2b"),
                              n_layers=chip_smoke.HYBRID_PLAIN_LAYERS)
    assert chip_smoke.expected_launches(cut) == {"attention": 1, "ssd": 6}


def test_chip_smoke_phase_7_rehearses_on_cpu(chip_smoke):
    cfg = get_config("zamba2-1.2b").reduced()
    rc = chip_smoke.train_rc("cpu", remat=True, remat_policy="full", ssd_chunk=CHUNK)
    res = chip_smoke.train(cfg, device="cpu", batch=2, seq_len=16, steps=2, rc=rc)
    assert res["launches_per_step"] == [{"attention": 0, "ssd": 0}] * 2
    assert "resume_loss_err" not in res and res["max_memory_allocated"] is None
    assert all(np.isfinite(m["loss"]) for m in res["metrics"])
    errs = chip_smoke.train_consistency(cfg, device="cpu", batch=2, seq_len=16,
                                        remat=True, ssd_chunk=CHUNK)
    assert errs["loss_rel"] == errs["grad_norm_rel"] == errs["params_abs"] == 0.0
    assert max(errs["grads_rel"].values()) == 0.0
    assert all(errs["grads_scale"][f"blocks/mamba/{w}"] > 0
               for w in ("in_x", "in_B", "in_C", "in_dt", "A_log"))
    agree = chip_smoke.remat_agreement(cfg, device="cpu", batch=2, seq_len=32)
    assert list(agree) == ["off", "full", "dots"]
    assert all(run["loss_rel"] == run["grads_rel"] == 0.0 for run in agree.values())
    # the train shapes: K2 at chunk 32 on bf16 inputs is bound by its bytes
    for arch, (b, s, h, p, n, chunk) in chip_smoke.K2_TRAIN_SHAPES.items():
        assert (b, s, chunk) == (8, 512, 32)
        assert chip_smoke.ssd_bound(b, s, h, p, n, chunk, torch.bfloat16,
                                    torch.bfloat16)[1] == "bytes"
