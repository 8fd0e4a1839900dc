"""The port's cross-entropy on vocab-sharded logits (``models/layers.py::
softmax_cross_entropy`` on a DTensor whose last dim is sharded), on CPU
gloo worlds, against the port in one process and against the JAX
package's ``softmax_cross_entropy`` and ``jax.grad``.

Two worlds run at once (``tests/torch_world.py``: spawned ranks, a
``file://`` rendezvous in the test's tmp dir): 4 ranks on a (2, 2) and a
(1, 4) mesh, 3 ranks on (1, 3). Each case places one set of f32 logits
(B=4, S=6, Vp columns) on its mesh: the vocab on "model" (the rows on
"data"), on ("data", "model") together, or on no mesh dim (the tensor
path), or cut model-major into every rank's piece on a (pod 1, data 2,
model 2) or (pod 2, data 2, model 1) mesh (``VocabPieces`` from
``layers.spread_logits`` against the identity head, which hands each
rank its piece's exact columns; each rank's ``v0`` held to the
model-major order). Vp = 44 with vocab sizes
40 (the pad inside the last shard) and 30
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

The same worlds hold the embedding lookup on a vocab-sharded table
(``layers.vocab_sharded_lookup``, ``LOOKUP_CASES``): a (Vp, 6) table with
its vocab on "model" and D on "data", or its vocab on ("data", "model"),
Vp = 44 cut 22/22 or 15/15/14, tokens on every shard and one in the
padding; the rows and the table's gradient within 1e-6 of one process's
``table[tokens]`` and of ``jnp.take`` + ``jax.grad``, the gradient in the
table's placements. On the ``fake`` backend (data 2, model 8) no
collective of qwen2-0.5b's lookup moves more than a rank's slice.
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
LOOKUP_TOL = 1e-6
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
    # (pod, data, model): the vocab cut model-major into every rank's piece
    # (``layers.spread_logits``) over "model" and then the rows' axes, which
    # follow it: pod x data (the head's D brought together by an all-to-all
    # over data), or pod alone (D all-gathered over data)
    "1x2x2_model_major": (4, (1, 2, 2), ("model", "pod", "data"), 44, 30),
    "2x2x1_rows_on_pod": (4, (2, 2, 1), ("model", "pod"), 44, 40),
}
# the embedding lookup on a vocab-sharded table (Vp, LOOKUP_D):
# name -> (world, mesh (data, model), the vocab's mesh axes, the D's, Vp, vocab size)
LOOKUP_D = 6
LOOKUP_CASES = {
    "lookup_2x2": (4, (2, 2), "model", "data", 44, 40),
    "lookup_2x2_vocab_data_model": (4, (2, 2), ("data", "model"), None, 44, 30),
    "lookup_1x3_uneven": (3, (1, 3), "model", "data", 44, 40),
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


def _axes(shape) -> tuple:
    """The mesh axes of a mesh of ``shape``."""
    return ("pod", "data", "model")[-len(shape):]


def pieces_ce(mesh, vocab_axes, inputs: dict, vocab: int) -> dict:
    """The weighted CE of ``inputs``' logits as ``VocabPieces``: the logits,
    rows on ``vocab_axes[1:]``, through ``layers.spread_logits`` against the
    identity head (vocab on model, D on data), which hands each rank the
    exact columns of its model-major piece; the gradient is the logits'.
    Also each rank's mesh coordinate, piece offset ``v0`` and width."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.layers import spread_logits
    from repro_torch.parallel.mesh import P, to_placements
    logits = torch.as_tensor(inputs["logits"])
    vp = logits.shape[-1]
    rows = tuple(vocab_axes[1:])
    x = distribute_tensor(logits, mesh, to_placements(mesh, P(rows, None, None), 3),
                          src_data_rank=None).requires_grad_(True)
    eye = distribute_tensor(torch.eye(vp), mesh, to_placements(mesh, P("model", "data"), 2),
                            src_data_rank=None)
    row_pl = to_placements(mesh, P(rows, None), 2)
    labels, weights = (distribute_tensor(torch.as_tensor(inputs[k]), mesh, row_pl,
                                         src_data_rank=None) for k in ("labels", "weights"))
    pieces = spread_logits(x, eye)
    loss = softmax_cross_entropy(pieces, labels, vocab)
    (grad,) = torch.autograd.grad((loss * weights).sum().full_tensor(), x)
    pieces_of = [None] * dist.get_world_size()
    dist.all_gather_object(pieces_of, (list(mesh.get_coordinate()), pieces.v0,
                                       pieces.local.shape[-1]))
    return {"loss": loss.full_tensor().detach().numpy(), "grad": grad.full_tensor().numpy(),
            "grad_placements": str(tuple(grad.placements)),
            "placements": str(tuple(x.placements)), "pieces": pieces_of}


def sharded_ce(mesh, vocab_axes, inputs: dict, vocab: int) -> dict:
    """The weighted CE of ``inputs`` with the logits placed on ``mesh``
    (rows on ``_rows_axis``, the vocab on ``vocab_axes``): each rank's
    whole loss rows and gradient, and the gradient's placements."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.mesh import P, to_placements
    if mesh.ndim == 3:
        return pieces_ce(mesh, vocab_axes, inputs, vocab)
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


def _lookup_inputs(vp: int, vocab: int) -> dict:
    """A table, tokens that fall on every vocab shard, one of them in the
    padding (a row past ``vocab``, which the table holds), and weights."""
    rng = np.random.default_rng(vp * 100 + vocab + 7)
    tokens = rng.permutation((np.arange(B * S) * 7) % vocab).reshape(B, S)
    tokens[1, 2] = vp - 2                         # a padded row
    return {"table": rng.standard_normal((vp, LOOKUP_D)).astype(np.float32),
            "tokens": tokens.astype(np.int32),
            "weights": rng.uniform(0.5, 1.5, (B, S, LOOKUP_D)).astype(np.float32)}


def sharded_lookup(mesh, vocab_axes, d_axes, inputs: dict) -> dict:
    """The embedding rows of ``inputs``' tokens from the table placed on
    ``mesh`` (its vocab on ``vocab_axes``, its D on ``d_axes``; the tokens'
    rows on "data" where the vocab leaves it free), and the gradient of
    the weighted sum of the rows: each whole, and the gradient's
    placements."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.layers import vocab_sharded_lookup
    from repro_torch.parallel.mesh import P, to_placements
    x = distribute_tensor(torch.as_tensor(inputs["table"]), mesh,
                          to_placements(mesh, P(vocab_axes, d_axes), 2),
                          src_data_rank=None).requires_grad_(True)
    pl = to_placements(mesh, P(_rows_axis(tuple(mesh.shape), vocab_axes), None, None), 3)
    tokens, weights = (distribute_tensor(torch.as_tensor(inputs[k]), mesh, pl,
                                         src_data_rank=None) for k in ("tokens", "weights"))
    rows = vocab_sharded_lookup(x, tokens)
    (grad,) = torch.autograd.grad((rows * weights).sum().full_tensor(), x)
    return {"rows": rows.full_tensor().detach().numpy(), "grad": grad.full_tensor().numpy(),
            "grad_placements": str(tuple(grad.placements)),
            "placements": str(tuple(x.placements)),
            "rows_placements": str(tuple(rows.placements)),
            "tokens_placements": str(tuple(tokens.placements))}


def single_lookup(inputs: dict) -> dict:
    """The same in one process, on plain tensors."""
    x = torch.as_tensor(inputs["table"]).clone().requires_grad_(True)
    rows = x[torch.as_tensor(inputs["tokens"])]
    (rows * torch.as_tensor(inputs["weights"])).sum().backward()
    return {"rows": rows.detach().numpy(), "grad": x.grad.numpy()}


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
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=_axes(shape))
        out[name] = sharded_ce(mesh, vocab_axes, _inputs(vp, vocab), vocab)
    for name, (w, shape, vocab_axes, d_axes, vp, vocab) in LOOKUP_CASES.items():
        if w != world:
            continue
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        out[name] = sharded_lookup(mesh, vocab_axes, d_axes, _lookup_inputs(vp, vocab))
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


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if len(c[1]) == 3])
def test_model_major_pieces_lie_in_each_ranks_model_slice(worlds, name):
    """Rank (p, d, m) takes piece ``k`` of its model slice, ``k`` its
    coordinates on the rows' axes (pod major): on (1, 2, 2), 44 columns cut
    in slices of 22 on model and pieces of 11, ``v0 = 22·m + 11·(p·D + d)``
    where DTensor's order would give ``11·(p·D·M + d·M + m)``; on (2, 2, 1)
    the rows on pod alone, ``v0 = 22·p`` on both data ranks."""
    _, shape, vocab_axes, vp, _ = CASES[name]
    sizes = dict(zip(_axes(shape), shape))
    slice_ = -(-vp // sizes["model"])
    piece = -(-slice_ // int(np.prod([sizes[a] for a in vocab_axes[1:]])))
    seen = set()
    for coord, v0, width in worlds[name]["pieces"]:
        at = dict(zip(_axes(shape), coord))
        k = 0
        for a in vocab_axes[1:]:
            k = k * sizes[a] + at[a]
        assert (v0, width) == (at["model"] * slice_ + k * piece, piece), (coord, v0)
        seen.add(v0)
    parts = int(np.prod([sizes[a] for a in vocab_axes]))
    assert seen == {k * piece for k in range(parts)}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_ce_matches_single_process(worlds, name):
    _, _, _, vp, vocab = CASES[name]
    check_case(worlds, name, single_ce(_inputs(vp, vocab), vocab))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_ce_matches_jax(worlds, name):
    _, _, _, vp, vocab = CASES[name]
    check_case(worlds, name, _jax_ce(_inputs(vp, vocab), vocab))


def _jax_lookup(inputs: dict) -> dict:
    import jax
    import jax.numpy as jnp
    tokens, weights = jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["weights"])
    table = jnp.asarray(inputs["table"])
    rows = jnp.take(table, tokens, axis=0)
    grad = jax.grad(lambda t: (jnp.take(t, tokens, axis=0) * weights).sum())(table)
    return {"rows": np.asarray(rows), "grad": np.asarray(grad)}


def check_lookup(out: dict, name: str, ref: dict) -> None:
    """One lookup case of the worlds against ``ref`` (one process or JAX):
    the rows within LOOKUP_TOL of their largest value, the table's gradient
    within LOOKUP_TOL of its largest value and in the table's placements,
    the rows in the tokens' (where the vocab leaves their mesh dim free)."""
    got = out[name]
    for key in ("rows", "grad"):
        scale = np.abs(ref[key]).max()
        assert scale > 0 and np.abs(got[key] - ref[key]).max() <= LOOKUP_TOL * scale, key
    assert got["grad_placements"] == got["placements"], got
    if LOOKUP_CASES[name][2] == "model":
        assert got["rows_placements"] == got["tokens_placements"], got


@pytest.mark.parametrize("name", list(LOOKUP_CASES))
def test_vocab_sharded_lookup_matches_single_process(worlds, name):
    check_lookup(worlds, name, single_lookup(_lookup_inputs(*LOOKUP_CASES[name][4:])))


@pytest.mark.parametrize("name", list(LOOKUP_CASES))
def test_vocab_sharded_lookup_matches_jax(worlds, name):
    """Against ``jnp.take`` and ``jax.grad`` on the same inputs."""
    check_lookup(worlds, name, _jax_lookup(_lookup_inputs(*LOOKUP_CASES[name][4:])))


def test_lookup_tokens_fall_on_every_shard():
    """Every vocab shard holds a token in each lookup case, and one token
    reads a padded row."""
    for name, (_, shape, vocab_axes, _, vp, vocab) in LOOKUP_CASES.items():
        axes = (vocab_axes,) if isinstance(vocab_axes, str) else vocab_axes
        parts = int(np.prod([dict(zip(("data", "model"), shape))[a] for a in axes]))
        piece = -(-vp // parts)
        tokens = _lookup_inputs(vp, vocab)["tokens"].ravel()
        assert {int(t) // piece for t in tokens} == set(range(parts)), name
        assert (tokens >= vocab).sum() == 1, name


def test_labels_fall_on_every_shard():
    """Every shard that holds a label slot holds a label in each case."""
    for name, (_, shape, vocab_axes, vp, vocab) in CASES.items():
        if vocab_axes is None:
            continue
        axes = (vocab_axes,) if isinstance(vocab_axes, str) else vocab_axes
        parts = int(np.prod([dict(zip(_axes(shape), shape))[a] for a in axes]))
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
# the lookup of qwen2-0.5b's table (vocab on model, D on data) on a (2, TP / 2) mesh
from repro_torch.launch.trace_analysis import _collective, _tensors
from repro_torch.models.layers import vocab_sharded_lookup
from repro_torch.parallel.mesh import P, to_placements


class Moved(TraceAnalysis):
    def __init__(self):
        super().__init__()
        self.moved = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and not self._propagating and _collective(func):
            self.moved.append([_collective(func)] + [list(t.shape) for t in _tensors(out)])
        return out


D = 896
mesh2 = make_mesh((2, TP // 2), ("data", "model"))
local = torch.empty(VP // (TP // 2), D // 2, dtype=torch.bfloat16, device="meta")
table = DTensor.from_local(local, mesh2, to_placements(mesh2, P("model", "data"), 2),
                           run_check=False).requires_grad_(True)
tokens = DTensor.from_local(torch.zeros(B // 2, S, dtype=torch.long, device="meta"), mesh2,
                            to_placements(mesh2, P("data", None), 2), run_check=False)
with Moved() as lk:
    rows = vocab_sharded_lookup(table, tokens)
    (tgrad,) = torch.autograd.grad(rows, table, torch.ones_like(rows))
print(json.dumps({"lookup": {"moved": lk.moved, "slice": [VP // (TP // 2), D],
                             "rows": [B // 2, S, D], "grad": list(tgrad.to_local().shape),
                             "grad_placements": str(tgrad.placements)},
                  "fwd": dict(fwd.stats.collective_bytes),
                  "fwd_counts": dict(fwd.stats.collective_counts),
                  "bwd": dict(bwd.stats.collective_bytes),
                  "loss": [list(loss.shape), str(loss.placements)],
                  "grad": [list(grad.to_local().shape), str(grad.placements)],
                  "temp": fwd.stats.peak_live_bytes, "rows": B * S}))
"""


@pytest.fixture(scope="module")
def fake():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _FAKE.replace("TP_", str(FAKE_TP))],
                         capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sharded_ce_collectives_on_the_fake_backend(fake):
    """qwen2-0.5b's padded vocab on tp = 16 (meta shards, ``fake`` group):
    three all-reduces of ``rows x 4`` bytes in the forward, none in the
    backward, no all-gather; the loss in the rows' placements, the
    gradient vocab-sharded."""
    res = fake
    assert res["fwd"] == {"all-reduce": 3 * res["rows"] * 4}, res
    assert res["fwd_counts"] == {"all-reduce": 3}, res
    assert res["bwd"] == {}, res
    assert res["loss"] == [[8, 512], "(Shard(dim=0), Replicate())"], res
    assert res["grad"] == [[8, 512, 152064 // FAKE_TP], "(Shard(dim=0), Shard(dim=2))"], res


def test_vocab_sharded_lookup_collectives_on_the_fake_backend(fake):
    """qwen2-0.5b's table (152,064 x 896, bf16) on a (data 2, model 8) mesh of
    the ``fake`` group: the lookup gathers the rank's vocab rows (a table's
    eighth, D whole), all-reduces the rows over model, and its backward
    reduce-scatters the slice's gradient over data into the table's
    placements. No collective takes or gives more than the slice or the
    rows; the whole table never moves."""
    lk = fake["lookup"]
    kinds = {m[0] for m in lk["moved"]}
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= kinds, lk["moved"]
    biggest = max(int(np.prod(m[1])) for m in lk["moved"] if len(m) > 1)
    assert biggest <= max(int(np.prod(lk["slice"])), int(np.prod(lk["rows"]))), lk
    assert lk["grad"] == [lk["slice"][0], lk["slice"][1] // 2], lk
    assert lk["grad_placements"] == "(Shard(dim=1), Shard(dim=0))", lk


def card_check(tmp: Path) -> None:
    """The worlds against the port in one process, without JAX (for the
    card's machine, whose torch may differ from the tests'): ``python
    tests/test_torch_loss_sharded.py card-check <tmp>``."""
    out = run_worlds(tmp)
    for name, (_, _, _, vp, vocab) in CASES.items():
        check_case(out, name, single_ce(_inputs(vp, vocab), vocab))
    for name, case in CASES.items():
        if len(case[1]) == 3:
            test_model_major_pieces_lie_in_each_ranks_model_slice(out, name)
    for name in LOOKUP_CASES:
        check_lookup(out, name, single_lookup(_lookup_inputs(*LOOKUP_CASES[name][4:])))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _FAKE.replace("TP_", str(FAKE_TP))],
                         capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert run.returncode == 0, run.stderr[-3000:]
    fake_out = json.loads(run.stdout.strip().splitlines()[-1])
    test_sharded_ce_collectives_on_the_fake_backend(fake_out)
    test_vocab_sharded_lookup_collectives_on_the_fake_backend(fake_out)
    print(f"CARD_CHECK_OK torch {torch.__version__}: {len(CASES)} sharded CE cases and "
          f"{len(LOOKUP_CASES)} lookups on gloo worlds of {WORLDS} ranks equal one process; "
          f"3 all-reduces at tp {FAKE_TP}; the lookup moves no whole table")


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), Path(sys.argv[3]))
if __name__ == "__main__" and sys.argv[1:2] == ["card-check"]:
    card_check(Path(sys.argv[2]))
