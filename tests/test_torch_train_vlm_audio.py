"""Training parity of the port (repro_torch) with the JAX package: the vlm
family (llama-3.2-vision-11b) and the audio family (musicgen-medium).

The reduced configs in f32 compute at B=4, S=32, on the same numpy
batches (tokens and 16 image embeddings for the vlm; frame embeddings in
place of tokens for audio) and the same weights, through
``tests/test_torch_train_moe.assert_steps_match_jax``: before each of two
steps the loss and every gradient leaf (1e-4 of the JAX leaf's largest
value), after it loss, grad norm and lr (rel 1e-4) and params, m and v
(1e-4), with remat off and "full" on both sides, and with
``grad_accum=2`` (the micro-batch reshape of ``embeds`` and
``img_embeds``).

The vlm's cross-block gates are initialised to 0, and tanh(0) = 0
multiplies the cross-attention away: with them at 0, every cross-block
leaf but the gate gets exactly zero gradient, in both packages (held
here as the reference's behaviour), so a wrong cross path would pass a
step taken from the real init. The step tests set every gate to 0.5 in
both packages' state. The vlm's self-attention blocks are rematted and
its cross blocks are not, as in the JAX package's ``_vlm_forward``. The
audio model never reaches its untied ``embed``: its gradient is zeros,
as ``jax.grad`` gives, and AdamW still decays it; the stacked cross
``gate`` (ndim 1) is not decayed.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.checkpoint import set_checkpoint_early_stop  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402
from tests.test_torch_remat import _CountDots  # noqa: E402
from tests.test_torch_train_moe import (OPT, STATE_BYTES_PER_PARAM, STEP_TOL,  # noqa: E402
                                        assert_meta_state_matches_jax,
                                        assert_steps_match_jax, jax_state, make_batch,
                                        models, train_state_gb)

VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-medium"
GATE = 0.5


def _gate(arch):
    return GATE if arch == VLM else None


@functools.cache
def _steps(arch, remat):
    """Two steps of both packages, held to each other (run once per case)."""
    return assert_steps_match_jax(*models(arch, remat), gate=_gate(arch))


@pytest.mark.parametrize("remat", ["off", "full"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_train_step_matches_jax(arch, remat):
    """Two steps: loss and every gradient leaf, then loss, grad norm, lr,
    params, m and v."""
    _steps(arch, remat)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_grad_accum_matches_jax(arch):
    """grad_accum=2: ``embeds`` (B, S, D) and ``img_embeds`` (B, N, D) cut
    into micro-batches along dim 0 as the tokens are; the loss averaged as
    JAX's ``lsum / a``."""
    assert_steps_match_jax(*models(arch), trc={"grad_accum": 2}, gate=_gate(arch))


def test_zero_gates_give_the_cross_blocks_zero_gradients():
    """At the real init (gates 0) every cross-block leaf but the gate gets a
    gradient of exactly zero in both packages; the gate's own gradient is
    not zero and matches JAX's."""
    jm, tm = models(VLM)
    js = jax_state(jm)
    ts = state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert not ts.params["cross_blocks"]["gate"].any()
    batch = make_batch(tm.cfg, seed=3)
    _, jg = jax.jit(jax.value_and_grad(jm.loss))(
        js.params, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tg = ttrain.value_and_grad(tm.loss, ts.params,
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    jcross = {"/".join(k.key for k in p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(jg["cross_blocks"])[0]}
    tcross = tree_flatten_with_path(tg["cross_blocks"])
    assert list(tcross) == list(jcross) == ["attn/wk", "attn/wo", "attn/wq", "attn/wv",
                                            "gate", "ln"]
    for key, g in tcross.items():
        if key != "gate":
            assert not g.any() and not jcross[key].any(), key
    assert (tcross["gate"].abs() > 0).all()
    np.testing.assert_allclose(tcross["gate"].numpy(), jcross["gate"],
                               rtol=STEP_TOL, atol=STEP_TOL * np.abs(jcross["gate"]).max())


def test_the_vlms_cross_blocks_are_not_rematted():
    """As in the JAX package (``_vlm_forward``): under remat "full" the
    matmuls that run again in the backward are the self-attention blocks'
    (every one of them, with the recompute run to each block's end), and
    none of the cross blocks'. The gate stays f32 under bf16 compute."""
    cfg = get_config(VLM).reduced()
    rc = RunConfig(compute_dtype=torch.float32, device="cpu")
    params = build(cfg, rc).init(torch.Generator().manual_seed(0))
    params["cross_blocks"]["gate"].fill_(GATE)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, seed=4).items()}
    h = torch.randn((4, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), _CountDots() as self_block:
        tt._apply_attn_block(tt._layers(params["blocks"], cfg.n_layers)[0], h, cfg, rc,
                             torch.arange(32)[None, :])
    runs = []
    for r in (rc, rc.replace(remat=True, remat_policy="full")):
        with set_checkpoint_early_stop(False), _CountDots() as count:
            loss, grads = ttrain.value_and_grad(build(cfg, r).loss, params, batch)
        runs.append((loss, grads, count.n))
    (loss0, g0, n0), (loss1, g1, n1) = runs
    assert self_block.n > 0 and n1 - n0 == cfg.n_layers * self_block.n
    assert torch.equal(loss1, loss0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)
    # a cross block's leaves as the block takes them (``_use``, where it runs)
    cast = tt._use("", tt._layers(params["cross_blocks"], tt._n_cross(cfg))[0],
                   rc.replace(compute_dtype=torch.bfloat16))
    assert cast["gate"].dtype == torch.float32
    assert cast["attn"]["wq"].dtype == torch.bfloat16


def test_audio_embed_takes_zeros_and_is_decayed():
    """The audio model reads frame embeddings: its untied ``embed`` is never
    reached, so its gradient is exactly zero (JAX's too) and AdamW's update
    there is the decay alone: after two steps from the JAX state,
    p (1 - lr_1 wd)(1 - lr_2 wd), as in JAX (held by ``_steps``)."""
    jm, tm = models(AUDIO)
    start = state_from_jax(jax.tree.map(np.asarray, jax_state(jm)), device="cpu").params
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tm.cfg, seed=10).items()}
    _, tg = ttrain.value_and_grad(tm.loss, start, batch)
    assert not tg["embed"].any() and float(tg["head"].abs().sum()) > 0
    ts, _, jg = _steps(AUDIO, "off")
    assert not np.asarray(jg["embed"]).any()
    wd = ta.OptConfig(**OPT).weight_decay
    decay = 1.0
    for step in (1, 2):
        decay *= 1 - float(ta.schedule(torch.tensor(step), ta.OptConfig(**OPT))) * wd
    torch.testing.assert_close(ts.params["embed"], start["embed"] * decay, atol=1e-7,
                               rtol=1e-6)


def test_adamw_does_not_decay_the_stacked_gate():
    """The stacked cross ``gate`` has shape (n_cross,), ndim 1: no weight
    decay, as for every ndim < 2 leaf; the matrices are decayed."""
    cfg = get_config(VLM).reduced()
    model = build(cfg, RunConfig(compute_dtype=torch.float32, device="cpu"))
    state = ttrain.init_sharded_state(model, seed=0)
    state.params["cross_blocks"]["gate"].fill_(GATE)
    assert tuple(state.params["cross_blocks"]["gate"].shape) == \
        (cfg.n_layers // cfg.cross_attn_every,)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, seed=6).items()}
    _, grads = ttrain.value_and_grad(model.loss, state.params, batch)
    with torch.no_grad():
        decayed, _ = ta.apply_updates(state, grads, ta.OptConfig(**OPT))
        plain, _ = ta.apply_updates(state, grads, ta.OptConfig(**OPT, weight_decay=0.0))
    assert torch.equal(decayed.params["cross_blocks"]["gate"],
                       plain.params["cross_blocks"]["gate"])
    assert not torch.equal(decayed.params["cross_blocks"]["gate"],
                           state.params["cross_blocks"]["gate"])
    assert not torch.equal(decayed.params["cross_blocks"]["attn"]["wq"],
                           plain.params["cross_blocks"]["attn"]["wq"])


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_train_step_descends_and_finite(arch):
    """The vlm and audio cases of tests/test_arch_smoke.py, on the port,
    under remat: the same batch twice, so the loss must drop."""
    cfg = get_config(arch).reduced()
    step, _, _, _, _, model = ttrain.build_train_step(
        cfg, None, B=2, S=32, rc=RunConfig(device="cpu", remat=True),
        trc=ttrain.TrainRunConfig(opt=ta.OptConfig(**OPT)))
    state = ta.init_state(model.init(torch.Generator().manual_seed(0)))
    if arch == VLM:
        state.params["cross_blocks"]["gate"].fill_(GATE)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 1, batch=2).items()}
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    assert bool(torch.isfinite(m1["loss"])) and bool(torch.isfinite(m2["grad_norm"]))
    assert float(m2["loss"]) < float(m1["loss"])


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_meta_train_state_matches_jax(arch):
    """And the reckoning that sets the card's depth cuts at 28 bytes a
    parameter: musicgen-medium at full depth 51 GB; llama-3.2-vision-11b
    283 GB at full depth, 61 GB cut to one full segment (5 self-attention
    layers and 1 cross block), 93 GB at two."""
    n = assert_meta_state_matches_jax(arch)
    cfg = get_config(arch)
    gb = train_state_gb(cfg, n)
    print(f"{arch}: {n:,} params, {gb:.1f} GB at {STATE_BYTES_PER_PARAM} B/param")
    if arch == AUDIO:
        assert 50 < gb < 52
        return
    assert 280 < gb < 285
    for layers, lo, hi in ((5, 60, 62), (10, 92, 95)):
        cut = dataclasses.replace(cfg, n_layers=layers)
        n_cut = sum(t.numel() for t in tree_leaves(build(cut, RunConfig(
            device="meta")).init_eval_shape()))
        print(f"{arch} cut to {layers} + {layers // cfg.cross_attn_every}: {n_cut:,} "
              f"params, {train_state_gb(cut, n_cut):.1f} GB")
        assert lo < train_state_gb(cut, n_cut) < hi


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 8, rehearsed on the CPU
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


def test_expected_train_launches_count_cross_blocks_once(chip_smoke):
    """K1 a train step under remat: twice per self-attention layer, once per
    cross block (not checkpointed), so 2 * 40 + 8 = 88 for the vlm, not 96;
    and at phase 8's cuts 4, 96 and 11."""
    full = RunConfig(remat=True, remat_policy="full")
    vlm = get_config(VLM)
    assert chip_smoke.expected_train_launches(vlm, RunConfig()) == {"attention": 48, "ssd": 0}
    assert chip_smoke.expected_train_launches(vlm, full) == {"attention": 88, "ssd": 0}
    assert chip_smoke.expected_train_launches(
        vlm, full.replace(remat_policy="dots")) == {"attention": 88, "ssd": 0}
    got = {arch: chip_smoke.expected_train_launches(
        chip_smoke.cut_depth(arch, layers)[0], full)["attention"]
        for arch, layers in chip_smoke.TRAIN_8_LAYERS.items()}
    assert got == {"qwen2-moe-a2.7b": 4, "musicgen-medium": 96, "llama-3.2-vision-11b": 11}
    assert chip_smoke.cut_depth(VLM, 5)[1] == f"{VLM} (5 of 40 layers)"


def test_chip_smoke_phase_8_rehearses_on_cpu(chip_smoke):
    """The train run and the f32 kernels-vs-plain gradients of phase 8 at the
    reduced sizes: frontend batches, the gates at CROSS_GATE, no launch on
    the CPU, and plain against plain bit-equal."""
    rc = chip_smoke.train_rc("cpu", remat=True, remat_policy="full")
    for arch in chip_smoke.TRAIN_8_LAYERS:
        cfg = get_config(arch).reduced()
        batch = next(chip_smoke.synthetic_data(cfg, 2, 16))
        assert set(batch) == {"labels", "embeds" if arch == AUDIO else "tokens"} | (
            {"img_embeds"} if arch == VLM else set())
        res = chip_smoke.train(cfg, device="cpu", batch=2, seq_len=8, steps=2, rc=rc)
        assert res["launches_per_step"] == [{"attention": 0, "ssd": 0}] * 2
        assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                   for m in res["metrics"])
        errs = chip_smoke.grads_vs_plain(cfg, device="cpu", batch=2, seq_len=8)
        assert errs["loss_rel"] == 0.0 and max(errs["grads_rel"].values()) == 0.0
        assert errs["launches"] == {"attention": 0, "ssd": 0}
        if cfg.n_experts:
            assert errs["routing_flips"] == errs["near_ties"] == 0
            assert errs["token_layers"] == cfg.n_layers * 2 * 8
        if arch == VLM:
            assert errs["grads_scale"]["cross_blocks/attn/wq"] > 0
            model = build(cfg, rc)
            state = chip_smoke.init_train_state(model)
            assert bool((state.params["cross_blocks"]["gate"] == chip_smoke.CROSS_GATE).all())


def test_k1_backward_bound_at_the_cross_shape(chip_smoke):
    """K1's backward at the vlm's cross shape is bound by its operations:
    five products over the 512 x 1601 pairs, 2.5 times the forward's."""
    shape = chip_smoke.K1_CROSS_SHAPES[chip_smoke.K1_CROSS_TRAIN]
    assert shape == (8, 512, 1601, 32, 8, 128)
    bwd, by = chip_smoke.attention_bwd_bound(*shape, torch.bfloat16, False)
    fwd, fby = chip_smoke.attention_bound(*shape, torch.bfloat16, False)
    assert by == fby == "operations"
    assert bwd == pytest.approx(2.5 * fwd) and bwd == pytest.approx(0.27159, rel=1e-4)
