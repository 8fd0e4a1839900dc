"""Training parity of the port (repro_torch) with the JAX package: gemma-7b.

The reduced gemma-7b at its own head_dim of 256 (4 layers, d_model 128,
4 query heads over 2 KV heads) in f32 compute at B=4, S=32, through
``tests/test_torch_train_moe.assert_steps_match_jax``: before each of
two steps the loss and every gradient leaf (1e-4 of the JAX leaf's
largest value), after it loss, grad norm and lr (rel 1e-4) and params,
m and v (1e-4), with remat off and "full" on both sides. These are the
paths no other train test reaches: GeGLU (``gelu_mlp``), the embedding
scaled by sqrt(d_model), the tied embedding (no ``head`` leaf: the one
``embed`` leaf takes the gradient of the input lookup and of the output
projection) and attention at head_dim 256. On the CPU attention is K1's
plain version; on the card (``tests/test_torch_cuda.py``) the same step
runs K1 through ``FlashAttentionFn``.

Also: the meta train state of full-size gemma-7b against JAX's, the 28
bytes a parameter that set ``chip_smoke.py``'s depth cut (4 of 28
layers), and phase 9's helpers rehearsed at the reduced size.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from tests.test_torch_train_moe import (STEP_TOL, assert_meta_state_matches_jax,  # noqa: E402
                                        assert_steps_match_jax, jax_state, models,
                                        train_state_gb)

GEMMA = "gemma-7b"
HD = 256


@functools.cache
def _models(remat):
    return models(GEMMA, remat, head_dim=HD)


@pytest.mark.parametrize("remat", ["off", "full"])
def test_train_step_matches_jax(remat):
    """Two steps: every gradient leaf, loss, grad norm, lr; then params, m and v."""
    jm, tm = _models(remat)
    cfg = tm.cfg
    assert (cfg.resolved_head_dim, cfg.gelu_mlp, cfg.scale_embeddings, cfg.tie_embeddings,
            cfg.n_heads, cfg.n_kv_heads) == (HD, True, True, True, 4, 2)
    ts, _, _ = assert_steps_match_jax(jm, tm)
    assert "head" not in ts.params and ts.params["blocks"]["attn"]["wq"].shape == \
        (cfg.n_layers, cfg.d_model, cfg.n_heads * HD)


def test_tied_embedding_gradient_is_one_leaf_from_the_input_and_the_head():
    """Tokens drawn from the first 64 of 512 rows: the rows no input token
    looks up take the output projection's gradient only, the others both;
    the one ``embed`` leaf matches JAX's within 1e-4 of its largest value,
    on the rows of each kind."""
    jm, tm = _models("off")
    rng = np.random.default_rng(21)
    batch = {"tokens": rng.integers(0, 64, (4, 32)).astype(np.int32),
             "labels": rng.integers(0, tm.cfg.vocab_size, (4, 32)).astype(np.int32)}
    js = jax_state(jm)
    ts = state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    _, jg = jax.jit(jax.value_and_grad(jm.loss))(js.params,
                                                 {k: jnp.asarray(v) for k, v in batch.items()})
    _, tg = ttrain.value_and_grad(tm.loss, ts.params,
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    assert "head" not in tg and "head" not in jg
    got, expect = tg["embed"].numpy(), np.asarray(jg["embed"], np.float32)
    scale = float(np.abs(expect).max())
    for rows in (slice(0, 64), slice(64, tm.cfg.vocab_size)):
        assert float(np.abs(got[rows]).max()) > 0
        assert float(np.abs(got[rows] - expect[rows]).max()) <= STEP_TOL * scale
    # the looked-up rows carry the input's share on top of the head's: their
    # gradient is larger than the head's alone would give the unused rows
    assert np.abs(got[:64]).mean() > np.abs(got[64:]).mean()


def test_meta_train_state_matches_jax_and_sets_the_depth_cut():
    """Full-size gemma-7b's meta train state against JAX's, and the reckoning
    at 28 bytes a parameter: 239 GB at 28 layers, 53.0 GB at 4 (1.894 B
    parameters), 60.8 GB at 5 (2.171 B)."""
    n = assert_meta_state_matches_jax(GEMMA)
    cfg = get_config(GEMMA)
    assert 238 < train_state_gb(cfg, n) < 240
    for layers, params_b, gb in ((4, 1.894, 53.0), (5, 2.171, 60.8)):
        cut = dataclasses.replace(cfg, n_layers=layers)
        n_cut = sum(t.numel() for t in tree_leaves(build(cut, RunConfig(
            device="meta")).init_eval_shape()))
        assert round(n_cut / 1e9, 3) == params_b and round(train_state_gb(cut, n_cut), 1) == gb


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 9, rehearsed on the CPU
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


def test_phase_9_cut_launches_and_bounds(chip_smoke):
    """4 layers under remat "full": K1 twice a layer, 8 a step; the cut's
    train state from the meta tree; K1's hd 256 shape under a gradient and
    its backward's bound: bytes, as the forward's (causal: the 8 x 512 x
    512 x 16 heads' half-masked scores are too few operations for the
    tensor cores' peak), twice the forward's bytes."""
    full = chip_smoke.train_rc("cpu", remat=True, remat_policy="full")
    cfg, label = chip_smoke.cut_depth(chip_smoke.GEMMA_ARCH, chip_smoke.TRAIN_9_LAYERS)
    assert label == "gemma-7b (4 of 28 layers)"
    assert chip_smoke.expected_train_launches(cfg, full) == {"attention": 8, "ssd": 0}
    assert round(chip_smoke._train_state_gb(cfg), 1) == 53.0
    shape = chip_smoke.K1_GEMMA_TRAIN
    assert shape == (8, 512, 512, 16, 16, 256)
    bwd, by = chip_smoke.attention_bwd_bound(*shape, torch.bfloat16, True)
    fwd, fby = chip_smoke.attention_bound(*shape, torch.bfloat16, True)
    assert by == fby == "bytes" and bwd == pytest.approx(2 * fwd)


def test_chip_smoke_phase_9_rehearses_on_cpu(chip_smoke):
    """Phase 9's train run and f32 kernels-vs-plain gradients at the reduced
    gemma-7b (hd 256): finite, no launch on the CPU, plain against plain
    bit-equal, and every leaf phase 9 requires non-zero is."""
    rc = chip_smoke.train_rc("cpu", remat=True, remat_policy="full")
    cfg = dataclasses.replace(get_config(GEMMA).reduced(), head_dim=HD, n_layers=2)
    res = chip_smoke.train(cfg, device="cpu", batch=2, seq_len=8, steps=2, rc=rc,
                           lr=chip_smoke.TRAIN_9_LR)
    assert res["launches_per_step"] == [{"attention": 0, "ssd": 0}] * 2
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in res["metrics"])
    errs = chip_smoke.grads_vs_plain(cfg, device="cpu", batch=2, seq_len=8)
    assert errs["loss_rel"] == 0.0 and max(errs["grads_rel"].values()) == 0.0
    nonzero = ["embed"] + [f"blocks/attn/{w}" for w in ("wq", "wk", "wv", "wo")] + [
        f"blocks/mlp/{w}" for w in ("w1", "w2", "w3")]
    assert all(errs["grads_scale"][key] > 0 for key in nonzero)
