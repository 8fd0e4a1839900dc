"""The port's checkpointer against the JAX package's: one on-disk format.

A ``TrainState`` with a bf16 leaf is written by one package and
restored by the other, both ways; the keys are JAX's pytree paths
(``.params/blocks/ln1``, ``.m/embed``, ``.step``), numbered in the same
sorted order. Restored values are bit-equal (bf16 is stored as f32 and
cast back, which is exact).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import RunConfig as JaxRunConfig, build as jax_build  # noqa: E402
from repro.checkpoint.checkpointer import _flatten as jax_flatten  # noqa: E402
from repro.optim.adamw import TrainState as JaxTrainState  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402
from repro_torch.optim.adamw import TrainState, init_state  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map  # noqa: E402


# the trees a round trip is made of, and leaves whose stored dtype each must keep
TREES = {
    "toy": {".params/blocks/attn/wq": "bfloat16", ".params/blocks/ln1": "float32"},
    # the hybrid's tree: stacked Mamba2 blocks, one unstacked shared block,
    # and the SSM leaves that stay f32 when the other params are bf16
    "zamba2-1.2b": {".params/shared_block/attn/wq": "bfloat16",
                    ".params/blocks/mamba/in_x": "bfloat16",
                    ".params/blocks/mamba/A_log": "float32",
                    ".params/blocks/mamba/dt_bias": "float32",
                    ".params/blocks/mamba/D_skip": "float32",
                    ".m/shared_block/attn/wq": "float32"},
}


def _jax_state(seed=0, tree="toy"):
    """A JAX TrainState with random m and v and step 7: the toy tree (f32
    and bf16 params, nested blocks), or the reduced zamba2-1.2b's params
    in bf16 (made by the JAX package)."""
    rng = np.random.default_rng(seed)
    if tree == "toy":
        params = {
            "embed": jnp.asarray(rng.standard_normal((10, 4)), jnp.float32),
            "final_norm": jnp.asarray(rng.standard_normal((4,)), jnp.float32),
            "blocks": {"ln1": jnp.asarray(rng.standard_normal((2, 4)), jnp.float32),
                       "attn": {"wq": jnp.asarray(rng.standard_normal((2, 4, 8)),
                                                  jnp.bfloat16)}},
        }
    else:
        model = jax_build(jax_config(tree).reduced(), JaxRunConfig(param_dtype="bfloat16"))
        params = model.init(jax.random.PRNGKey(seed))
    m = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), params)
    v = jax.tree.map(lambda p: jnp.asarray(rng.random(p.shape), jnp.float32), params)
    return JaxTrainState(params, m, v, jnp.int32(7))


def _as_numpy(state):
    return jax.tree.map(np.asarray, state)


def _assert_same(jstate, tstate):
    jflat = jax_flatten(jstate)
    tflat = tree_flatten_with_path(tstate)
    assert sorted(jflat) == sorted(tflat)
    for key, a in jflat.items():
        b = tflat[key]
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), key
        assert tuple(a.shape) == tuple(b.shape), key
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())


def test_keys_are_jax_pytree_paths():
    jstate = _jax_state()
    tstate = state_from_jax(_as_numpy(jstate), device="cpu")
    keys = sorted(tree_flatten_with_path(tstate))
    assert keys == sorted(jax_flatten(jstate))
    assert ".params/blocks/ln1" in keys and ".m/embed" in keys and ".step" in keys


@pytest.mark.parametrize("tree", list(TREES))
def test_jax_writes_port_restores(tmp_path, tree):
    jstate = _jax_state(1, tree)
    JaxCheckpointer(tmp_path).save(jstate, 3, blocking=True)
    target = state_from_jax(_as_numpy(_jax_state(2, tree)), device="cpu")
    restored = Checkpointer(tmp_path).restore(target)
    assert isinstance(restored, TrainState)
    flat = tree_flatten_with_path(restored)
    for key, dtype in TREES[tree].items():
        assert str(flat[key].dtype) == f"torch.{dtype}", key
    _assert_same(jstate, restored)


@pytest.mark.parametrize("tree", list(TREES))
def test_port_writes_jax_restores(tmp_path, tree):
    jstate = _jax_state(3, tree)
    ckpt = Checkpointer(tmp_path)
    ckpt.save(state_from_jax(_as_numpy(jstate), device="cpu"), 5)
    ckpt.wait()
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
    assert manifest["step"] == 5
    for key, dtype in TREES[tree].items():
        assert manifest["leaves"][key]["dtype"] == dtype, key
    assert manifest["leaves"][".step"] == {"file": manifest["leaves"][".step"]["file"],
                                           "shape": [], "dtype": "int32"}
    files = [manifest["leaves"][k]["file"] for k in sorted(manifest["leaves"])]
    assert files == [f"leaf_{i:05d}.npy" for i in range(len(files))]
    restored = JaxCheckpointer(tmp_path).restore(_jax_state(4, tree))
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_port_round_trip_onto_a_meta_target(tmp_path):
    state = state_from_jax(_as_numpy(_jax_state(5)), device="cpu")
    ckpt = Checkpointer(tmp_path)
    ckpt.save(state, 1, blocking=True)
    meta = init_state(tree_map(lambda p: p.to("meta"), state.params))
    meta = meta._replace(params=tree_map(lambda p: p.to("meta"), state.params))
    with pytest.raises(ValueError, match="device"):
        ckpt.restore(meta)
    restored = ckpt.restore(meta, device="cpu")
    for a, b in zip(tree_leaves(restored.params) + tree_leaves(restored.m),
                    tree_leaves(state.params) + tree_leaves(state.m)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(restored.step) == 7


def test_retention_keeps_the_newest(tmp_path):
    state = state_from_jax(_as_numpy(_jax_state(6)), device="cpu")
    ckpt = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(state, s)
    ckpt.wait()
    assert ckpt.steps() == [3, 4] and ckpt.latest_step() == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000004"]


def test_no_tmp_left_after_a_save(tmp_path):
    ckpt = Checkpointer(tmp_path)
    ckpt.save(state_from_jax(_as_numpy(_jax_state(7)), device="cpu"), 9)
    ckpt.wait()
    assert not list(tmp_path.glob("*.tmp"))
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000009"]


def test_shape_mismatch_and_missing_leaves_raise(tmp_path):
    state = state_from_jax(_as_numpy(_jax_state(8)), device="cpu")
    ckpt = Checkpointer(tmp_path)
    ckpt.save(state, 1, blocking=True)
    wrong = state._replace(params=dict(state.params, embed=torch.zeros((11, 4))))
    with pytest.raises(ValueError, match="embed"):
        ckpt.restore(wrong)
    extra = state._replace(params=dict(state.params, head=torch.zeros((10, 4))))
    with pytest.raises(ValueError, match="missing"):
        ckpt.restore(extra)
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(state)


def test_save_copies_before_returning(tmp_path):
    """The host copy is taken in save(): later writes to the state do not
    reach the checkpoint."""
    state = state_from_jax(_as_numpy(_jax_state(9)), device="cpu")
    before = state.params["embed"].clone()
    ckpt = Checkpointer(tmp_path)
    ckpt.save(state, 2)
    state.params["embed"].add_(1.0)
    ckpt.wait()
    restored = ckpt.restore(state)
    assert torch.equal(restored.params["embed"], before)


def test_a_failed_write_raises_in_wait(tmp_path):
    state = state_from_jax(_as_numpy(_jax_state(10)), device="cpu")
    ckpt = Checkpointer(tmp_path)
    (tmp_path / "step_00000003.tmp").write_text("a file where a directory goes")
    ckpt.save(state, 3)
    with pytest.raises(OSError):
        ckpt.wait()
