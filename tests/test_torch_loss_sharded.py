"""The port's cross-entropy on vocab-sharded logits (``models/layers.py::
softmax_cross_entropy`` on a DTensor whose last dim is sharded), on CPU
gloo worlds, against the port in one process and against the JAX
package's ``softmax_cross_entropy`` and ``jax.grad``.

Two worlds run at once (``tests/torch_world.py``: spawned ranks, a
``file://`` rendezvous in the test's tmp dir): 4 ranks on a (2, 2) and a
(1, 4) mesh, 3 ranks on (1, 3). Each case places one set of f32 logits
(B=4, S=6, Vp columns) on its mesh: the vocab on "model" (the rows on
"data"), on ("data", "model") together, or on no mesh dim (the tensor
path). Vp = 44 with vocab sizes 40 (the pad inside the last shard) and 30
(on (1, 4) the pad straddles the last two shards; on (1, 3), 44 cut 15,
15, 14, it is the whole last shard), and Vp = 9 on (1, 4), cut 3, 3, 3,
0 (an empty shard). The labels fall on every shard. The loss is the sum
of the rows' CE weighted by seeded weights, so the backward scales by a
cotangent that is not 1.

Held: the per-row loss within 1e-6 relative, the logits' gradient within
1e-6 of its largest value, the padded columns' gradient exactly 0, the
gradient in the logits' own placements; a vocab on no mesh dim bit-equal
to one process. On the ``fake`` backend at tp = 16 the CE's forward and
backward make three all-reduces of one f32 a row and no other
collective.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.models.layers import softmax_cross_entropy  # noqa: E402

TIMEOUT_S = 240
B, S = 4, 6
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-6
FAKE_TP = 16
# name -> (world, mesh (data, model), the vocab's mesh axes, Vp, vocab size)
CASES = {
    "2x2_model_pad_in_last": (4, (2, 2), "model", 44, 40),
    "2x2_model_pad_half": (4, (2, 2), "model", 44, 30),
    "2x2_data_model": (4, (2, 2), ("data", "model"), 44, 30),
    "2x2_replicated_vocab": (4, (2, 2), None, 44, 30),
    "1x4_pad_in_last": (4, (1, 4), "model", 44, 40),
    "1x4_pad_straddles": (4, (1, 4), "model", 44, 30),
    "1x4_empty_shard": (4, (1, 4), "model", 9, 7),
    "1x3_uneven": (3, (1, 3), "model", 44, 40),
    "1x3_last_shard_padded": (3, (1, 3), "model", 44, 30),
}
WORLDS = sorted({c[0] for c in CASES.values()})


def _inputs(vp: int, vocab: int) -> dict:
    rng = np.random.default_rng(vp * 1000 + vocab)
    labels = rng.permutation((np.arange(B * S) * 5) % vocab).reshape(B, S)
    return {"logits": (3 * rng.standard_normal((B, S, vp))).astype(np.float32),
            "labels": labels.astype(np.int64),
            "weights": rng.uniform(0.5, 1.5, (B, S)).astype(np.float32)}


def _rows_axis(mesh: tuple, vocab_axes):
    """The rows' mesh axis: "data" where the vocab leaves it free and it has
    more than one rank."""
    used = (vocab_axes,) if isinstance(vocab_axes, str) else tuple(vocab_axes or ())
    return "data" if "data" not in used and mesh[0] > 1 else None


def sharded_ce(mesh, vocab_axes, inputs: dict, vocab: int) -> dict:
    """The weighted CE of ``inputs`` with the logits placed on ``mesh``
    (rows on ``_rows_axis``, the vocab on ``vocab_axes``): each rank's
    whole loss rows and gradient, and the gradient's placements."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.mesh import P, to_placements
    rows = _rows_axis(tuple(mesh.shape), vocab_axes)
    x = distribute_tensor(torch.as_tensor(inputs["logits"]), mesh,
                          to_placements(mesh, P(rows, None, vocab_axes), 3),
                          src_data_rank=None).requires_grad_(True)
    row_pl = to_placements(mesh, P(rows, None), 2)
    labels, weights = (distribute_tensor(torch.as_tensor(inputs[k]), mesh, row_pl,
                                         src_data_rank=None) for k in ("labels", "weights"))
    loss = softmax_cross_entropy(x, labels, vocab)
    # torch.autograd.grad, as runtime/train.py::value_and_grad takes it: torch
    # 2.11 stores a DTensor leaf's .grad replicated where one rank's shard is
    # empty, though the gradient that flows is vocab-sharded
    (grad,) = torch.autograd.grad((loss * weights).sum().full_tensor(), x)
    return {"loss": loss.full_tensor().detach().numpy(),
            "grad": grad.full_tensor().numpy(),
            "grad_placements": str(tuple(grad.placements)),
            "placements": str(tuple(x.placements))}


def single_ce(inputs: dict, vocab: int) -> dict:
    """The same in one process, on plain tensors."""
    x = torch.as_tensor(inputs["logits"]).clone().requires_grad_(True)
    loss = softmax_cross_entropy(x, torch.as_tensor(inputs["labels"]), vocab)
    (loss * torch.as_tensor(inputs["weights"])).sum().backward()
    return {"loss": loss.detach().numpy(), "grad": x.grad.numpy()}


def worker(rank: int, tmp: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    world = json.loads((tmp / "world.json").read_text())["world"]
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'rendezvous'}",
                            rank=rank, world_size=world)
    out = {}
    for name, (w, shape, vocab_axes, vp, vocab) in CASES.items():
        if w != world:
            continue
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        out[name] = sharded_ce(mesh, vocab_axes, _inputs(vp, vocab), vocab)
    if rank == 0:
        torch.save(out, tmp / "results.pt")
    dist.barrier()
    dist.destroy_process_group()


def run_worlds(tmp: Path) -> dict:
    """Both worlds at once; the results of every case."""
    if __name__ == "__main__":
        from torch_world import join_world, run_world
    else:
        from tests.torch_world import join_world, run_world
    deadline = time.monotonic() + TIMEOUT_S
    runs = []
    for world in WORLDS:
        wdir = tmp / f"world{world}"
        wdir.mkdir()
        (wdir / "world.json").write_text(json.dumps({"world": world}))
        runs.append((wdir, run_world(__file__, world, wdir)))
    for wdir, procs in runs:
        join_world(procs, wdir, deadline, TIMEOUT_S)
    out = {}
    for wdir, _ in runs:
        out.update(torch.load(wdir / "results.pt", weights_only=False))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("ce_worlds"))


def _jax_ce(inputs: dict, vocab: int) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models.layers import softmax_cross_entropy as jax_ce
    labels, weights = jnp.asarray(inputs["labels"]), jnp.asarray(inputs["weights"])
    loss = jax_ce(jnp.asarray(inputs["logits"]), labels, vocab)
    grad = jax.grad(lambda x: (jax_ce(x, labels, vocab) * weights).sum())(
        jnp.asarray(inputs["logits"]))
    return {"loss": np.asarray(loss), "grad": np.asarray(grad)}


def _check(got: dict, ref: dict, vocab: int) -> None:
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL, atol=0)
    scale = np.abs(ref["grad"]).max()
    err = np.abs(got["grad"] - ref["grad"]).max()
    assert err <= GRAD_TOL * scale, (err, scale)
    assert np.all(got["grad"][..., vocab:] == 0)


def check_case(out: dict, name: str, ref: dict) -> None:
    """One case of the worlds against ``ref`` (one process or JAX)."""
    _, _, vocab_axes, _, vocab = CASES[name]
    got = out[name]
    _check(got, ref, vocab)
    assert got["grad_placements"] == got["placements"], got
    if vocab_axes is None:      # the tensor path: bit-equal to one process
        single = single_ce(_inputs(*CASES[name][3:]), vocab)
        assert np.array_equal(got["loss"], single["loss"])
        assert np.array_equal(got["grad"], single["grad"])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_ce_matches_single_process(worlds, name):
    _, _, _, vp, vocab = CASES[name]
    check_case(worlds, name, single_ce(_inputs(vp, vocab), vocab))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_ce_matches_jax(worlds, name):
    _, _, _, vp, vocab = CASES[name]
    check_case(worlds, name, _jax_ce(_inputs(vp, vocab), vocab))


def test_labels_fall_on_every_shard():
    """Every shard that holds a label slot holds a label in each case."""
    for name, (_, shape, vocab_axes, vp, vocab) in CASES.items():
        if vocab_axes is None:
            continue
        axes = (vocab_axes,) if isinstance(vocab_axes, str) else vocab_axes
        parts = int(np.prod([dict(zip(("data", "model"), shape))[a] for a in axes]))
        piece = -(-vp // parts)
        shards = {int(v) // piece for v in _inputs(vp, vocab)["labels"].ravel()}
        assert shards == {r for r in range(parts) if r * piece < vocab}, (name, shards)


_FAKE = """
import json, torch
from repro_torch.launch.dryrun import init_fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.trace_analysis import TraceAnalysis
from repro_torch.models.layers import softmax_cross_entropy
from torch.distributed.tensor import DTensor, Replicate, Shard

TP, B, S, VP, V = TP_, 8, 512, 152064, 151936
init_fake_world(TP)
mesh = make_mesh((1, TP), ("data", "model"))
x = DTensor.from_local(torch.empty(B, S, VP // TP, dtype=torch.bfloat16, device="meta"),
                       mesh, [Shard(0), Shard(2)], run_check=False).requires_grad_(True)
labels = DTensor.from_local(torch.zeros(B, S, dtype=torch.long, device="meta"), mesh,
                            [Shard(0), Replicate()], run_check=False)
g = DTensor.from_local(torch.ones(B, S, device="meta"), mesh, [Shard(0), Replicate()],
                       run_check=False)
with TraceAnalysis() as fwd:
    loss = softmax_cross_entropy(x, labels, V)
with TraceAnalysis() as bwd:
    (grad,) = torch.autograd.grad(loss, x, g)
print(json.dumps({"fwd": dict(fwd.stats.collective_bytes),
                  "fwd_counts": dict(fwd.stats.collective_counts),
                  "bwd": dict(bwd.stats.collective_bytes),
                  "loss": [list(loss.shape), str(loss.placements)],
                  "grad": [list(grad.to_local().shape), str(grad.placements)],
                  "temp": fwd.stats.peak_live_bytes, "rows": B * S}))
"""


def test_sharded_ce_collectives_on_the_fake_backend():
    """qwen2-0.5b's padded vocab on tp = 16 (meta shards, ``fake`` group):
    three all-reduces of ``rows x 4`` bytes in the forward, none in the
    backward, no all-gather; the loss in the rows' placements, the
    gradient vocab-sharded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _FAKE.replace("TP_", str(FAKE_TP))],
                         capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["fwd"] == {"all-reduce": 3 * res["rows"] * 4}, res
    assert res["fwd_counts"] == {"all-reduce": 3}, res
    assert res["bwd"] == {}, res
    assert res["loss"] == [[8, 512], "(Shard(dim=0), Replicate())"], res
    assert res["grad"] == [[8, 512, 152064 // FAKE_TP], "(Shard(dim=0), Shard(dim=2))"], res


def card_check(tmp: Path) -> None:
    """The worlds against the port in one process, without JAX (for the
    card's machine, whose torch may differ from the tests'): ``python
    tests/test_torch_loss_sharded.py card-check <tmp>``."""
    out = run_worlds(tmp)
    for name, (_, _, _, vp, vocab) in CASES.items():
        check_case(out, name, single_ce(_inputs(vp, vocab), vocab))
    test_sharded_ce_collectives_on_the_fake_backend()
    print(f"CARD_CHECK_OK torch {torch.__version__}: {len(CASES)} sharded CE cases on "
          f"gloo worlds of {WORLDS} ranks equal one process; 3 all-reduces at tp {FAKE_TP}")


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), Path(sys.argv[3]))
if __name__ == "__main__" and sys.argv[1:2] == ["card-check"]:
    card_check(Path(sys.argv[2]))
