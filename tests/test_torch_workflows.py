"""The ML workflow examples' twins (``repro_torch.examples``) against the JAX
package's examples, on the CPU.

The JAX side runs the reference examples' own steps here
(``examples/serve_batch.py``: prefill, the cache grown by G, G - 1
greedy decode steps; ``examples/workflow_train.py``: data_prep takes one
batch, then the train steps, then eval on the next batch); the examples
themselves are not imported. Weights come from the JAX package's
``PRNGKey(0)`` init through ``convert.params_from_jax``, the prompts from
its ``PRNGKey(1)``, the batches from ``SyntheticLM`` (bit-equal in both
packages).

Tolerances. Serve, f32 (the reduced qwen2-0.5b): greedy tokens equal to
JAX's, from the twin's plain loop and from its workflow. Serve, bf16 (the
examples' own compute dtype): the twin's workflow tokens are bit-equal to
its plain loop's (the twin checks that itself), and its decode, fed
JAX's greedy tokens (teacher forcing), gives JAX's logits within 4e-2
absolute, the bf16 logit bound of tests/test_torch_serve.py. Train, f32:
each step's loss and the eval loss within 1e-4 relative, the train
step's bound in tests/test_torch_train.py; the 24 steps stay within the
schedule's warmup but for the last 4, whose cosine differs from XLA's by
at most 2^-22 of the peak lr. Cache length, f32: greedy decode with the
cache grown by 64 and by 65 slots gives logits within 1e-5 and equal
tokens, and noise in the never-written 65th slot changes nothing, bit
for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import RunConfig as JaxRunConfig, build as jax_build  # noqa: E402
from repro.optim.adamw import OptConfig as JaxOptConfig  # noqa: E402
from repro.optim.adamw import init_state as jax_init_state  # noqa: E402
from repro.runtime.train import TrainRunConfig as JaxTrainRunConfig  # noqa: E402
from repro.runtime.train import build_train_step as jax_build_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.examples import serve_batch, workflow_train  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.runtime.serve import grow_cache  # noqa: E402

ARCH = "qwen2-0.5b"
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_LOGIT_TOL = 4e-2         # tests/test_torch_serve.py's bf16 logit bound
STEP_TOL = 1e-4               # tests/test_torch_train.py's train-step loss bound
CACHE_LEN_TOL = 1e-5
# examples/serve_batch.py's defaults; examples/workflow_train.py's batch and seq
B, P, G = 8, 32, 32
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_PHASES = 4, 64, 24, 3


def _jax_params(dtype):
    jm = jax_build(jax_config(ARCH).reduced(),
                   JaxRunConfig(param_dtype="float32", compute_dtype=dtype))
    return jm, jm.init(jax.random.PRNGKey(0))


def _jax_serve(jm, jp, prompts, gen):
    """examples/serve_batch.py's plain serving loop: (tokens, logits of the
    prefill's last position and of each decode step, pos)."""
    decode = jax.jit(jm.decode)
    logits, cache = jm.prefill(jp, {"tokens": prompts})
    step_logits = [np.asarray(logits[:, -1:], np.float32)]
    pad = ((0, 0), (0, 0), (0, gen), (0, 0), (0, 0))
    cache["k"] = jnp.pad(cache["k"], pad)
    cache["v"] = jnp.pad(cache["v"], pad)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = decode(jp, cache, {"tokens": tok})
        step_logits.append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1)), step_logits, int(cache["pos"])


def _serve_inputs(dtype):
    jm, jp = _jax_params(dtype)
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, P), 0,
                                          jm.cfg.vocab_size))
    rc = RunConfig(param_dtype=torch.float32, compute_dtype=TORCH_DTYPE[dtype],
                   device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, prompts, rc, params


def test_serve_twin_matches_the_jax_example_f32():
    jm, jp, prompts, rc, params = _serve_inputs("float32")
    expect, _, pos = _jax_serve(jm, jp, jnp.asarray(prompts), G)
    assert pos == P + G - 1
    out = serve_batch.run(get_config(ARCH).reduced(), params, torch.from_numpy(prompts),
                          gen=G, rc=rc)
    np.testing.assert_array_equal(out["plain_tokens"].numpy(), expect)
    np.testing.assert_array_equal(out["tokens"].numpy(), expect)
    assert out["order_consistent"] and out["lifecycle"] > 0
    assert set(out["pod_seconds"]) == {"prefill", "decode"}
    assert out["k1_launches"] == {"prefill": 0, "decode": 0}     # no card: plain versions


def test_serve_twin_bf16_teacher_forced_against_the_jax_example():
    jm, jp, prompts, rc, params = _serve_inputs("bfloat16")
    cfg = get_config(ARCH).reduced()
    expect, jax_logits, _ = _jax_serve(jm, jp, jnp.asarray(prompts), G)
    out = serve_batch.run(cfg, params, torch.from_numpy(prompts), gen=G, rc=rc)
    assert torch.equal(out["tokens"], out["plain_tokens"]) and out["order_consistent"]

    model = build(cfg, rc)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(logits[:, -1:].float().numpy(), jax_logits[0],
                               atol=BF16_LOGIT_TOL, rtol=0)
    cache = grow_cache(cache, G)
    for t in range(G - 1):
        tok = torch.from_numpy(expect[:, t:t + 1].astype(np.int64))
        lg, cache = model.decode(params, cache, {"tokens": tok})
        np.testing.assert_allclose(lg.float().numpy(), jax_logits[t + 1],
                                   atol=BF16_LOGIT_TOL, rtol=0)


def test_train_twin_matches_the_jax_example(tmp_path):
    jc = jax_config(ARCH).reduced()
    opt = JaxOptConfig(lr=3e-4, warmup_steps=20, total_steps=TRAIN_STEPS)
    step_fn, *_, jm = jax_build_train_step(
        jc, None, B=TRAIN_B, S=TRAIN_S,
        rc=JaxRunConfig(param_dtype="float32", compute_dtype="float32"),
        trc=JaxTrainRunConfig(opt=opt))
    jp = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)     # the step donates jp's buffers
    data = iter(JaxSyntheticLM(JaxDataConfig(TRAIN_B, TRAIN_S, jc.vocab_size)))
    next(data)                                   # data_prep
    state, expect = jax_init_state(jp), []
    for _ in range(TRAIN_STEPS):
        state, m = step_fn(state, next(data))
        expect.append(float(m["loss"]))
    expect_eval = float(jm.loss(state.params, jax.tree.map(jnp.asarray, next(data))))

    out = workflow_train.run(
        get_config(ARCH).reduced(), steps=TRAIN_STEPS, phases=TRAIN_PHASES, batch=TRAIN_B,
        seq=TRAIN_S, rc=RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32,
                                  device="cpu"),
        ckpt_dir=tmp_path, init_params=lambda: params_from_jax(np_params, device="cpu"))
    np.testing.assert_allclose(out["losses"], expect, rtol=STEP_TOL, atol=0)
    assert out["eval_loss"] == pytest.approx(expect_eval, rel=STEP_TOL)
    assert out["retries"] == 1 and out["order_consistent"]
    assert out["latest_step"] == int(state.step) == TRAIN_STEPS
    # phase_2 ran twice (failed, then resumed from its own checkpoint); the
    # last phase finds the step budget spent, as in the reference
    assert [len(v) for v in out["pod_seconds"].values()] == [1, 1, 2, 1, 1]
    per_phase = TRAIN_STEPS // TRAIN_PHASES
    assert len(out["losses"]) == 3 * per_phase


@pytest.mark.parametrize("main, argv", [
    (serve_batch.main, ["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                        "--gen", "4"]),
    (workflow_train.main, ["--device", "cpu", "--steps", "24", "--phases", "3"]),
])
def test_twin_entry_points_run_on_the_cpu(main, argv, capsys):
    main(argv)
    assert capsys.readouterr().out.rstrip().endswith("OK")


def test_twins_stay_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch.main(["--batch", "1", "--prompt-len", "4", "--gen", "2"])


# ---------------------------------------------------------------------------
# chip_smoke.py phase 6, rehearsed on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture
def chip_smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def test_cache_length_f32(chip_smoke):
    cfg = get_config(ARCH).reduced()
    res = chip_smoke.cache_length(cfg, device="cpu", dtype=torch.float32, batch=2,
                                  prompt_len=16, steps=64)
    assert res["tokens"] == 2 * 65
    assert res["logits_max_abs_diff"] <= CACHE_LEN_TOL and res["tokens_differ"] == 0
    assert res["masked_slot_inert"]
    assert chip_smoke.CACHE_LEN_TOL == CACHE_LEN_TOL


def test_chip_smoke_workflow_phase_rehearses_on_cpu(chip_smoke, tmp_path):
    cfg = get_config(ARCH).reduced()
    wf = chip_smoke.serve_workflow(cfg, device="cpu", batch=2, prompt_len=16, gen=5)
    assert torch.equal(wf["tokens"], wf["plain_tokens"]) and wf["tokens"].shape == (2, 5)
    assert wf["launches"] == {"attention": 0, "ssd": 0}
    tw = chip_smoke.train_workflow(cfg, device="cpu", batch=TRAIN_B, seq_len=TRAIN_S,
                                   steps=TRAIN_STEPS, phases=TRAIN_PHASES, ckpt_dir=tmp_path)
    assert tw["retries"] == 1 and tw["step_k1_launches"] == [0] * TRAIN_STEPS
    mm = chip_smoke.matmul_diamond(device="cpu", n=32, iters=2)
    assert sorted(mm["pod_seconds"]) == ["0", "1", "2", "3"] and mm["order_consistent"]
    assert all(np.array_equal(y, mm["outputs"]["0"]) for y in mm["outputs"].values())
    # 4 products of 2 * 8192^3 FLOPs at 67 TFLOP/s
    assert chip_smoke.matmul_bound_s(8192, 4) == pytest.approx(4 * 2 * 8192 ** 3 / 67e12)
