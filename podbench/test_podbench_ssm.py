"""A Mamba2 configuration added to the benchmark as new files and entries
alone, in a temporary copy, run on the CPU at a tiny size in float32
against ``reference/ssm.py``; the weights' rules (the dense leaves bit-equal to the first benchmark's, the
Mamba2 leaves as published, a vector with no rule refused); every cache
leaf compared; the faults an SSM cell can have; the run settings reaching
the program; the SSD's FLOPs and K2's bound in the yardstick."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import shutil

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from podbench import compare, harness, session, traffic, weights, yardstick
from podbench.drivers import prefill, train
from podbench.reference import common
from podbench.reference import model as ref_model
from podbench.test_podbench_faults import _broken_prefill, _broken_train
from podbench.tiny import run_tiny, tiny_cell

REPO = harness.ROOT    # the fixture below points the harness at a copy
AGREE = 1e-4           # float32 on both sides, as test_podbench_reference.py holds the dense cells
MAMBA = {"name": "mamba2-2.7b", "family": "ssm", "n_layers": 64, "d_model": 2560, "n_heads": 0,
         "n_kv_heads": 0, "d_ff": 0, "vocab_size": 50280, "ssm_state": 128, "ssm_head_dim": 64,
         "ssm_expand": 2, "ssm_conv_width": 4, "ssm_chunk": 256, "tie_embeddings": True,
         "norm_eps": 1e-05}
ZAMBA = {"name": "zamba2-1.2b", "family": "hybrid", "n_layers": 38, "d_model": 2048,
         "n_heads": 32, "n_kv_heads": 32, "head_dim": 64, "d_ff": 8192, "vocab_size": 32000,
         "ssm_state": 64, "ssm_head_dim": 64, "ssm_expand": 2, "ssm_conv_width": 4,
         "ssm_chunk": 128, "attn_every": 6, "tie_embeddings": False, "rope_theta": 10000.0,
         "norm_eps": 1e-05}
TRAIN = {"param_dtype": "float32", "compute_dtype": "bfloat16", "remat": True,
         "remat_policy": "full", "ssd_chunk": 32}
SERVE = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
# every width cut, every kind of leaf kept; the program scans at 4 (train) and 8 (serve),
# the reference in blocks of 16: 2 x 32 tokens cross chunk and block boundaries
TINY_SSM = {"n_layers": 2, "d_model": 64, "ssm_state": 16, "ssm_head_dim": 16, "ssm_chunk": 8,
            "vocab_size": 500}
CONFIGS = {
    "mamba2-2.7b": dict(
        arch=MAMBA, train=TRAIN, serve=SERVE, reference={"ssd_block": 256},
        source="https://huggingface.co/state-spaces/mamba2-2.7b", reduced=[],
        init={"dt_min": 0.001, "dt_max": 0.1, "dt_floor": 0.0001},
        tiny={"arch": TINY_SSM, "train": {"ssd_chunk": 4}, "reference": {"ssd_block": 16}}),
    "mamba2-2.7b-l16": dict(
        arch={**MAMBA, "n_layers": 16}, train=TRAIN, serve=SERVE, reference={"ssd_block": 256},
        source="https://huggingface.co/state-spaces/mamba2-2.7b", reduced=["n_layers"],
        tiny={"arch": TINY_SSM, "train": {"ssd_chunk": 4}, "reference": {"ssd_block": 16}}),
}
MIXES = {"docs-4x4096": {"loop": "closed", "batch": 4, "seq_len": 4096, "tokens": "uniform"}}
CELLS = {  # cell: (configuration, traffic, driver)
    "mamba2-2.7b-prefill": ("mamba2-2.7b", "docs-4x4096", "prefill"),
    "mamba2-2.7b-train": ("mamba2-2.7b-l16", "train-4x2048", "train"),
}
DENSE = {"prefill": "qwen2-1.5b-prefill", "train": "qwen2-1.5b-train"}
SSM_CACHE = {"ssm/ssd", "ssm/conv_x", "ssm/conv_B", "ssm/conv_C"}


def add_cells(root) -> None:
    """``CONFIGS``, ``MIXES`` and ``CELLS`` as new files under ``root /
    "podbench"`` and new entries in ``root / "BENCHMARK.json"``, each cell
    a copy of the dense cell of its driver, reporting what it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pkg = root / "podbench"
    for name, conf in CONFIGS.items():
        (pkg / "configs" / f"{name}.json").write_text(json.dumps({"name": name, **conf}))
        bench["configs"].append({"name": name, "source": conf["source"],
                                 "file": f"podbench/configs/{name}.json",
                                 "reduced": conf["reduced"], "why": "Mamba2 layers"})
    for name, mix in MIXES.items():
        (pkg / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, (config, mix, driver) in CELLS.items():
        shutil.copy(pkg / "workloads" / f"{DENSE[driver]}.json", pkg / "workloads" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                                   "why": "K2 and the Mamba2 layers"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if DENSE[driver] in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """The harness reading a temporary copy of the benchmark with ``CELLS`` added."""
    root = tmp_path_factory.mktemp("added")
    shutil.copytree(harness.PKG, root / "podbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.BENCHMARK, root / "BENCHMARK.json")
    add_cells(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "ROOT", root)
        mp.setattr(harness, "PKG", root / "podbench")
        mp.setattr(harness, "BENCHMARK", root / "BENCHMARK.json")
        mp.setattr(traffic, "DIR", root / "podbench" / "traffic")
        yield root


def _digest(tree) -> str:
    h = hashlib.sha256()
    for path, leaf in weights.flatten(tree).items():
        h.update(f"{path}:{leaf.dtype}:{tuple(leaf.shape)}".encode())
        h.update(leaf.float().numpy().tobytes())
    return h.hexdigest()


def _meta(cell):
    """The params meta of the cell's program, as its driver builds it."""
    if cell.workload["driver"] == "train":
        return train.build(cell, "cpu")[1].params
    return prefill.build(cell, "cpu")[1]


# sha256 of the tiny cut's weights, taken at the commit before the rules by shape
PARENT_DIGESTS = {
    ("qwen2-1.5b-train", 2**31 + 12345):
        "3025761915c14d4191ff387f75ff9397d88798ce4fe3cbdf3d1ad0b8e2032157",
    ("qwen2-1.5b-train", 5): "38e927eb4c8fbb09c0fe9e075538fe71def03f98bbfacfe7f90ce1d9fb430c38",
    ("qwen2-1.5b-prefill", 2**31 + 12345):
        "17a3c7fc2505dabf9139da20aabed9eef52954d6613b8dafc9f209b4aef4a22d",
    ("qwen2-1.5b-prefill", 5): "bbb88ae89c6e63e9656bb81398db7be50d3af5889c6ff7312fbe1dbef08f435c",
}


@pytest.mark.parametrize("cell,seed", sorted(PARENT_DIGESTS))
def test_dense_weights_are_bit_equal_to_the_parents(cell, seed):
    c = tiny_cell(cell)
    assert _digest(weights.make(_meta(c), c.config, seed, "cpu")) == PARENT_DIGESTS[cell, seed]


@pytest.mark.parametrize("init", [{}, {"dt_min": 1e-5, "dt_max": 1e-2, "dt_floor": 1e-3}])
def test_mamba2_leaves_lie_in_the_published_ranges(added, init):
    c = tiny_cell("mamba2-2.7b-train")
    c.config["init"] = init
    lo = max(init.get("dt_min", 1e-3), init.get("dt_floor", 1e-4))
    hi = init.get("dt_max", 1e-1)
    flat = weights.flatten(weights.make(_meta(c), c.config, 2**31 + 3, "cpu"))
    A = torch.exp(flat["blocks/mamba/A_log"])
    dt = F.softplus(flat["blocks/mamba/dt_bias"])
    assert A.shape == (2, 8) and bool(((A >= 1) & (A <= 16)).all()) and float(A.max() - A.min()) > 4
    assert bool(((dt >= lo * (1 - 1e-5)) & (dt <= hi * (1 + 1e-5))).all())
    assert float(dt.max() / dt.min()) > 3
    assert bool((flat["blocks/mamba/D_skip"] == 1).all())
    for key in ("blocks/ln", "blocks/mamba/gate_norm"):
        assert 0.005 < float(flat[key].std()) < 0.05
    conv = flat["blocks/mamba/conv_x"]                                   # (L, W, Di): fan-in W
    assert 0.3 < float(conv.std()) * math.sqrt(conv.shape[1]) < 3
    # the fan-in scale times the std: about 1 for in_x, 1/sqrt(L) for the residual output
    out, in_x = (flat[f"blocks/mamba/{k}"] for k in ("out", "in_x"))
    ratio = float(out.std() * math.sqrt(out.shape[1]) / (in_x.std() * math.sqrt(in_x.shape[1])))
    assert 0.3 < ratio * math.sqrt(2) < 3


def _meta_tensor(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("tree,extra,raises", [
    ({"blocks": {"mystery": _meta_tensor(3, 8)}}, {}, True),
    ({"blocks": {"mamba": {"conv_x_bias": _meta_tensor(3, 8)}}}, {}, False),
    ({"blocks": {"moe": {"bias_e": _meta_tensor(3, 4, 8)}}}, {}, False),
    ({"blocks": {"moe": {"bias_e": _meta_tensor(3, 4, 8)}}}, {"stacked": {"blocks/moe": 1}}, True),
    ({"scale": _meta_tensor(8)}, {}, True),
])
def test_a_stacked_vector_with_no_rule_raises(tree, extra, raises):
    config = {"arch": {"n_layers": 3, "ssm_conv_width": 4}, **extra}
    if raises:
        with pytest.raises(ValueError, match="no init rule"):
            weights.make(tree, config, 1, "cpu")
    else:
        weights.make(tree, config, 1, "cpu")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_an_added_cell_agrees_with_the_reference(added, cell):
    out = run_tiny(tiny_cell(cell))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["checks"]
    for name, check in out["checks"].items():
        assert check["value"] <= AGREE, (name, check)


def test_every_cache_leaf_is_compared(added, monkeypatch):
    seen = set()
    add = compare.PrefillTally.add

    def spy(self, leaf, got, want):
        seen.add(leaf)
        assert got.shape == want.shape, leaf
        return add(self, leaf, got, want)
    monkeypatch.setattr(compare.PrefillTally, "add", spy)
    assert run_tiny(tiny_cell("mamba2-2.7b-prefill"))["correct"]
    assert seen == SSM_CACHE | {"logits"}


def test_cache_leaves_are_every_tensor_leaf_by_path():
    """A hybrid's cache, as the program hands it to decode: each layer's k
    and v, the SSM state's four fields by name; the position counter left
    out, and anything else refused."""
    from repro_torch.models.ssm import SSMState
    t = torch.zeros(1)
    cache = {"k": t, "v": t, "ssm": SSMState(t, t, t, t), "pos": 32}
    assert set(prefill.cache_leaves(cache)) == SSM_CACHE | {"k", "v"}
    with pytest.raises(TypeError, match="extra"):
        prefill.cache_leaves({**cache, "extra": "32"})


def test_a_cache_leaf_the_reference_lacks_raises(added, monkeypatch):
    from repro_torch.runtime import serve as rs
    build = rs.build_prefill_step

    def with_extra(*args, **kw):
        step, *rest = build(*args, **kw)

        def extra(params, batch):
            logits, cache = step(params, batch)
            return logits, {**cache, "extra": torch.zeros(1)}
        return (extra, *rest)
    monkeypatch.setattr(rs, "build_prefill_step", with_extra)
    with pytest.raises(KeyError, match="extra"):
        run_tiny(tiny_cell("mamba2-2.7b-prefill"))


@pytest.mark.parametrize("cell,chunk", [("mamba2-2.7b-train", 4), ("mamba2-2.7b-prefill", 8)])
def test_the_program_scans_at_the_configurations_chunk(added, monkeypatch, cell, chunk):
    from repro_torch.kernels import ops
    seen, ssd = set(), ops.ssd

    def spy(*args, chunk, **kw):
        seen.add(chunk)
        return ssd(*args, chunk=chunk, **kw)
    monkeypatch.setattr(ops, "ssd", spy)
    assert run_tiny(tiny_cell(cell))["correct"] and seen == {chunk}


def test_run_config_passes_every_field_and_refuses_others():
    rc = session.run_config({**TRAIN, "moe_group": 64}, "cpu")
    assert (rc.ssd_chunk, rc.moe_group, rc.remat, rc.param_dtype) == (32, 64, True, torch.float32)
    for bad in ({"ssd_chunks": 32}, {"device": "cuda"}):
        with pytest.raises(KeyError):
            session.run_config({**SERVE, **bad}, "cpu")


def _ssm_state_zeroed(monkeypatch):
    """The prefill's cache with only the SSM state handed to decode zeroed."""
    from repro_torch.runtime import serve as rs
    build = rs.build_prefill_step

    def broken(*args, **kw):
        step, *rest = build(*args, **kw)

        def bad(params, batch):
            logits, cache = step(params, batch)
            return logits, {**cache, "ssm": cache["ssm"]._replace(ssd=torch.zeros_like(
                cache["ssm"].ssd))}
        return (bad, *rest)
    monkeypatch.setattr(rs, "build_prefill_step", broken)


def _carry_dropped(monkeypatch):
    """K2 (its plain version on the CPU) dropping the state it carries from
    one chunk to the next: each chunk scanned from a zero state."""
    from repro_torch.kernels import ops
    ssd = ops.ssd

    def dropped(x, dt, A, B, C, *, chunk, init_state=None):
        ys = []
        for s0 in range(0, x.shape[1], chunk):
            part = slice(s0, s0 + chunk)
            y, state = ssd(x[:, part], dt[:, part], A, B[:, part], C[:, part], chunk=chunk,
                           init_state=init_state if s0 == 0 else None)
            ys.append(y)
        return torch.cat(ys, 1), state
    monkeypatch.setattr(ops, "ssd", dropped)


@pytest.mark.parametrize("cell,fault", [
    ("mamba2-2.7b-prefill", "ssm_state"), ("mamba2-2.7b-prefill", "carry"),
    ("mamba2-2.7b-train", "carry"),
    ("mamba2-2.7b-prefill", "unchanged"), ("mamba2-2.7b-prefill", "half"),
    ("mamba2-2.7b-prefill", "token"),
    ("mamba2-2.7b-train", "unchanged"), ("mamba2-2.7b-train", "half"),
    ("mamba2-2.7b-train", "double"), ("mamba2-2.7b-train", "late_unchanged"),
    ("mamba2-2.7b-train", "late_half"),
])
def test_an_ssm_fault_fails(added, monkeypatch, cell, fault):
    if fault == "ssm_state":
        _ssm_state_zeroed(monkeypatch)
    elif fault == "carry":
        _carry_dropped(monkeypatch)
    elif cell.endswith("-train"):
        _broken_train(monkeypatch, fault)
    else:
        _broken_prefill(monkeypatch, fault)
    out = run_tiny(tiny_cell(cell))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["mamba2-2.7b-prefill", "mamba2-2.7b-train"])
def test_ssm_controls_fail(added, cell):
    c = tiny_cell(cell)
    controls = harness.driver(c).CONTROLS
    out = run_tiny(c, controls=controls)
    assert out["correct"] and set(out["controls"]) == set(controls)
    for name, numbers in out["controls"].items():
        ok, checks = compare.judge(numbers, c.workload["limits"])
        assert not ok, (name, checks)


def test_forward_flops_match_the_counter(added):
    c = tiny_cell("mamba2-2.7b-prefill")
    arch, S, block = c.arch, c.mix["seq_len"], 16
    params = weights.make(_meta(c), c.config, 5, "cpu")
    tokens = torch.randint(0, arch["vocab_size"], (2, S))
    run = {"q_block": S, "ssd_block": block}        # one query block: every key scored
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            h = ref_model.hidden(params, arch, tokens, common.exact, run)
            common.logits(params, h, arch, common.exact)
    expect = yardstick.forward_flops(arch, 2, S, head_positions=S, causal=False, chunk=block)
    assert counter.get_total_flops() == expect


def test_the_ssd_reference_is_the_recurrence():
    """``reference.ssm.ssd`` at any block equals the token-by-token
    recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t."""
    from podbench.reference import ssm
    g = torch.Generator().manual_seed(3)
    b, s, h, p, n, G = 2, 12, 4, 3, 5, 2
    x, B, C = (torch.randn(shape, generator=g) for shape in
               ((b, s, h, p), (b, s, G, n), (b, s, G, n)))
    dt = torch.rand(b, s, h, generator=g) * 0.5
    A = -torch.rand(h, generator=g) * 3 - 0.1
    init = torch.randn(b, h, p, n, generator=g)
    st, ys = init.clone(), []
    Bh, Ch = B.repeat_interleave(h // G, 2), C.repeat_interleave(h // G, 2)
    for t in range(s):
        st = (torch.exp(dt[:, t] * A)[..., None, None] * st
              + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :])
        ys.append((st * Ch[:, t, :, None, :]).sum(-1))
    for block in (1, 4, 12):
        y, final = ssm.ssd(x, dt, A, B, C, block, common.exact, init=init)
        torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(final, st, rtol=1e-5, atol=1e-5)


def test_hybrid_flops_are_the_stack_and_the_applications():
    arch = ZAMBA
    ssm_only = {**arch, "family": "ssm"}
    dense = {**arch, "family": "dense", "n_layers": 1}
    head = 2 * 4 * 1 * arch["d_model"] * 32000
    apps = 38 // 6
    assert (yardstick.forward_flops(arch, 4, 4096, head_positions=1)
            == yardstick.forward_flops(ssm_only, 4, 4096, head_positions=1)
            + apps * (yardstick.forward_flops(dense, 4, 4096, head_positions=1) - head))


@pytest.mark.parametrize("cell,reader,chunk", [("mamba2-2.7b-train", "mfu.train", 32),
                                               ("mamba2-2.7b-prefill", "mfu.prefill", 128)])
def test_mfu_counts_the_ssd_at_the_programs_chunk(added, cell, reader, chunk):
    """The train cell scans at its ``ssd_chunk`` (32), the prefill at the
    configuration's 256 cut to K2's 128: each reader counts the SSD there."""
    c = harness.load_cell(cell)
    B, S = c.mix["batch"], c.mix["seq_len"]
    train = reader == "mfu.train"
    view = type("View", (), dict(cell=c, window_s=1.0, steps=1, kernels=[None]))()
    got = harness.load_reader(reader).read(view)
    flops = (3 if train else 1) * yardstick.forward_flops(
        c.arch, B, S, head_positions=S if train else 1, chunk=chunk)
    assert got == pytest.approx(100.0 * flops / yardstick.PEAK_FLOP_PER_S["bfloat16"], rel=1e-12)
    assert flops < (3 if train else 1) * yardstick.forward_flops(
        c.arch, B, S, head_positions=S if train else 1, chunk=256)


# K2's rows of PERF.md section 6: (b, s, h, p, n, chunk)
K2_ROWS = [(8, 512, 80, 64, 128, 128), (8, 512, 64, 64, 64, 128), (8, 512, 80, 64, 128, 32),
           (8, 512, 64, 64, 64, 32), (8, 512, 20, 64, 128, 128), (8, 512, 16, 64, 64, 128)]


@pytest.mark.parametrize("shape", K2_ROWS)
@pytest.mark.parametrize("dtypes,init_state", [(("bfloat16", "bfloat16"), False),
                                                (("float32", "float32"), True)])
def test_ssd_bound_is_chip_smokes(shape, dtypes, init_state):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want_ms, want_by = smoke.ssd_bound(*shape, *(getattr(torch, d) for d in dtypes),
                                       init_state=init_state)
    got_s, got_by = yardstick.ssd_bound(*shape, *dtypes, init_state=init_state)
    assert got_s * 1e3 == pytest.approx(want_ms, rel=1e-12) and got_by == want_by
