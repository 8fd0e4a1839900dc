"""The port's sharded control plane (``repro_torch.core.shard``) against the
JAX package's (``repro.core.shard``).

``core/shard.py`` is copied with only the import rewrite
(``tests/test_torch_core.py`` holds the text). These tests hold what it
does:

* the twins of ``tests/test_shard_plane.py``'s determinism and
  mode-equivalence tests, run through the copy: the pinned ``shard_of``,
  ``shard_seed``, ``partition_nodes``, ``processes=False`` equal to
  ``processes=True`` under the pinned binding digest, the disjoint tenant
  partition and the order-independent merge;
* the same seeded ``_mini_sharded`` plane through both packages: merged
  summary, bindings and per-shard rows equal;
* one case of each failure mode (``on_shard_failure`` "raise",
  "restart", "degrade" under ``REPRO_SHARD_KILL``) and one sharded case
  each of the autoscaler, the gateway and placement, each equal to the
  reference's result;
* a forked worker whose payload raises (here: a ``cuda`` payload on a
  machine without the card; on a card, CUDA used in a worker forked
  after the parent initialised it) comes back as a ``ShardFailure``
  through the error pipe, within its timeout.
"""
import hashlib
import importlib
import re
import time

import numpy as np
import pytest

def _pkg(name):
    """The package's shard, calibration, dag, workflows, autoscaler and
    gateway modules."""
    mods = ("core.shard", "core.calibration", "core.dag", "configs.workflows",
            "core.autoscaler", "core.gateway")
    return {m.split(".")[-1]: importlib.import_module(f"{name}.{m}") for m in mods}


def _canon(obj):
    """NaN-tolerant deep compare form (NaN != NaN breaks dict ==)."""
    if isinstance(obj, dict):
        return {k: _canon(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, float) and obj != obj:
        return "nan"
    return obj


def _workflow(pkg, name):
    return pkg["dag"].make_workflow(name, pkg["workflows"].get_workflow_spec(name))


def _mini_sharded(pkg, processes, workers=2):
    """``tests/test_shard_plane.py::_mini_sharded`` through ``pkg``."""
    wf, ep = _workflow(pkg, "montage"), _workflow(pkg, "epigenomics")
    plane = pkg["shard"].ShardedControlPlane(
        workers, admission_policy="fair-share", seed=42,
        sample_mode="streaming", usage_mode="event", retain_pod_log=False,
        processes=processes, record_bindings=True)
    for j in range(workers):
        plane.add_stream(wf, repeats=6, tenant=f"montage-prod{j}",
                         arrival="concurrent", concurrency=2, priority=10,
                         weight=3.0, deadline_s=180.0)
        plane.add_stream(ep, repeats=6, tenant=f"epigenomics-batch{j}",
                         arrival="poisson", rate=0.5, burst=2, deadline_s=3600.0)
    return plane


def _sharded(pkg, processes, **kw):
    """``tests/test_chaos_plane.py::_sharded`` through ``pkg``: tenants
    batch-a/alpha on shard 0, prod-a/gamma on shard 1."""
    cal = pkg["calibration"]
    plane = pkg["shard"].ShardedControlPlane(
        2, admission_policy="fair-share", seed=42, params=cal.DEFAULT_PARAMS,
        cluster_cfg=cal.PaperCluster(n_nodes=8), sample_mode="streaming",
        usage_mode="event", retain_pod_log=False, lifecycle="fast",
        processes=processes, heartbeat_s=0.2, **kw)
    mont, ep = _workflow(pkg, "montage"), _workflow(pkg, "epigenomics")
    for tenant in ("batch-a", "prod-a"):
        plane.add_stream(mont, repeats=4, tenant=tenant, arrival="concurrent",
                         concurrency=2, priority=10, weight=3.0, deadline_s=180.0)
    for tenant in ("alpha", "gamma"):
        plane.add_stream(ep, repeats=4, tenant=tenant, arrival="poisson", rate=0.5,
                         burst=2, deadline_s=3600.0)
    return plane


# the parts of a shard record that vary from run to run (wall clock, RSS)
# or are objects of one package (compared through their summaries)
_UNSTABLE = {"wall_s", "loop_wall_s", "loop_cpu_s", "peak_rss_mib", "profile",
             "metrics_partial", "exec_stat"}


def _rows(res):
    """Per shard, its record's deterministic fields and its partial's
    tenant and usage summaries."""
    return _canon([{**{k: v for k, v in s.items() if k not in _UNSTABLE},
                    "tenant_rows": s["metrics_partial"].tenant_summary(),
                    "usage": s["metrics_partial"].usage_summary()}
                   for s in res.shards])


def _summary(res):
    return _canon({"tenants": res.tenant_summary(), "usage": res.usage_summary(),
                   "completed": res.completed_workflows, "failed": res.failed_workflows,
                   "events": res.events, "degraded": res.degraded,
                   "failures": res.failures})


# ---------------------------------------------------------------------------
# twins of tests/test_shard_plane.py's partition determinism
# ---------------------------------------------------------------------------
def test_shard_of_is_pinned_stable_hash():
    from repro_torch.core.shard import shard_of
    assert shard_of("montage-prod0", 8) == 2
    assert shard_of("montage-prod0", 1) == 0
    assert all(0 <= shard_of(f"tenant-{i}", 5) < 5 for i in range(100))
    for topo in ("montage", "epigenomics", "cybershake", "ligo"):
        for klass in ("prod", "batch"):
            assert {shard_of(f"{topo}-{klass}{j}", 8) for j in range(8)} == set(range(8))


def test_shard_seed_spawning():
    from repro.core.shard import shard_seed as ref_seed
    from repro_torch.core.shard import shard_seed
    seeds = [shard_seed(42, i) for i in range(16)]
    assert len(set(seeds)) == 16
    assert seeds == [shard_seed(42, i) for i in range(16)] == [ref_seed(42, i)
                                                                 for i in range(16)]
    assert shard_seed(43, 0) != shard_seed(42, 0)


def test_partition_nodes_disjoint_exhaustive():
    from repro.core.shard import partition_nodes as ref_partition
    from repro_torch.core.shard import partition_nodes
    for n, w in ((8000, 8), (10, 3), (5, 5), (7, 2)):
        slices = partition_nodes(n, w)
        assert sum(slices) == n and len(slices) == w and max(slices) - min(slices) <= 1
        assert slices == ref_partition(n, w)


# ---------------------------------------------------------------------------
# in-process vs multi-process, and the reference's run
# ---------------------------------------------------------------------------
# tests/test_shard_plane.py::PINNED_SHARD_BINDINGS, recorded on the reference
PINNED_SHARD_BINDINGS = "93f5b4f868f093d4b454f72593407b0859aa39f2a0e26c84ffdca98a9f60aa3f"


def _binding_digest(bindings):
    h = hashlib.sha256()
    for tenant in sorted(bindings):
        h.update(tenant.encode())
        for line in bindings[tenant]:
            h.update(line.encode())
    return h.hexdigest()


_RUNS = {}


def _mini_run(pkg_name, processes):
    """``_mini_sharded(...).run()``, once per package and mode."""
    key = (pkg_name, processes)
    if key not in _RUNS:
        _RUNS[key] = _mini_sharded(_pkg(pkg_name), processes).run()
    return _RUNS[key]


def test_inprocess_equals_multiprocess_pinned():
    r_in, r_mp = _mini_run("repro_torch", False), _mini_run("repro_torch", True)
    assert r_in.bindings() == r_mp.bindings()
    assert r_in.events == r_mp.events
    assert [s["events"] for s in r_in.shards] == [s["events"] for s in r_mp.shards]
    assert r_in.tenant_summary() == r_mp.tenant_summary()
    assert r_in.usage_summary() == r_mp.usage_summary()
    assert r_in.completed_workflows == r_mp.completed_workflows == 24
    assert _binding_digest(r_in.bindings()) == _binding_digest(r_mp.bindings()) \
        == PINNED_SHARD_BINDINGS


def test_tenant_partition_is_disjoint_and_merged_summary_is_union():
    res = _mini_run("repro_torch", False)
    tenant_sets = [set(s["tenants"]) for s in res.shards]
    for i, a in enumerate(tenant_sets):
        for b in tenant_sets[i + 1:]:
            assert not (a & b)
    union = {}
    for s in res.shards:
        union.update(s["metrics_partial"].tenant_summary())
    assert res.tenant_summary() == union
    assert res.completed_workflows == 24 and res.failed_workflows == 0


def test_metrics_partial_merge_is_order_independent_on_counts():
    from repro_torch.core.metrics import MetricsPartial
    res = _mini_run("repro_torch", False)
    parts = [s["metrics_partial"] for s in res.shards]
    ab, ba = MetricsPartial(), MetricsPartial()
    ab.merge(parts[0])
    ab.merge(parts[1])
    ba.merge(parts[1])
    ba.merge(parts[0])
    assert ab.tenant_summary() == ba.tenant_summary()
    assert ab.completed == ba.completed == res.completed_workflows


@pytest.mark.parametrize("processes", [False, True])
def test_sharded_run_matches_the_reference(processes):
    got, expect = _mini_run("repro_torch", processes), _mini_run("repro", processes)
    assert got.bindings() == expect.bindings()
    assert _summary(got) == _summary(expect)
    assert _rows(got) == _rows(expect)
    assert len(got.shards) == 2 and sum(len(row["bindings"]) for row in _rows(got)) > 0


# ---------------------------------------------------------------------------
# failure modes, each against the reference's result
# ---------------------------------------------------------------------------
def _reason(reason):
    """A failure's reason without the dead worker's exit code: the parent
    reads it as 42 or as None, whichever of the pipe's end and the child's
    reaping it sees first, in either package."""
    return re.sub(r" \(exit code [^)]*\)", "", reason)


def _failure_outcome(pkg_name, policy, monkeypatch):
    """``test_chaos_plane.py``'s dead-shard cases: shard 1 (raise,
    restart) or 0 (degrade) hard-exits at launch."""
    pkg = _pkg(pkg_name)
    monkeypatch.setenv("REPRO_SHARD_KILL", "0" if policy == "degrade" else "1")
    plane = _sharded(pkg, True, on_shard_failure=policy)
    try:
        res = plane.run()
    except pkg["shard"].ShardFailure as exc:
        return {"raised": (exc.shard, exc.tenants, _reason(exc.reason))}
    finally:
        monkeypatch.delenv("REPRO_SHARD_KILL")
    out = _summary(res)
    for failure in out["failures"]:
        failure["reason"] = _reason(failure["reason"])
    return out


@pytest.mark.parametrize("policy", ["raise", "restart", "degrade"])
def test_dead_shard_policy_matches_the_reference(policy, monkeypatch):
    got = _failure_outcome("repro_torch", policy, monkeypatch)
    assert got == _failure_outcome("repro", policy, monkeypatch)
    if policy == "raise":
        shard, tenants, reason = got["raised"]
        assert shard == 1 and tenants and "died" in reason
    elif policy == "restart":     # the respawned shard reruns its spec: a healthy result
        assert not got["degraded"]
        assert got == _summary(_sharded(_pkg("repro_torch"), True).run())
    else:
        assert got["degraded"] and [f["shard"] for f in got["failures"]] == [0]
        assert got["failures"][0]["reason"] == "worker died without result"


def _autoscaler_case(pkg):
    """``test_autoscaler.py::test_sharded_cost_merge_exact``'s plane."""
    cal, asc = pkg["calibration"], pkg["autoscaler"]
    pol = asc.AutoscalePolicy(min_frac=0.2, interval_s=10.0, sustain_s=10.0, idle_s=30.0,
                              scale_step=2)            # test_autoscaler._elastic_policy
    sp = pkg["shard"].ShardedControlPlane(
        2, cluster_cfg=cal.PaperCluster(n_nodes=12), seed=11, autoscale=pol,
        processes=True, usage_mode="event", fold_completed=True, capture_trace=False)
    for i in range(4):
        sp.add_stream(_workflow(pkg, "montage"), repeats=4, tenant=f"t{i}",
                      arrival="concurrent", concurrency=2)
    res = sp.run()
    return _canon((res.cost_summary(), res.autoscaler_counters(), _summary(res)))


def _gateway_case(pkg):
    """``test_gateway.py::test_sharded_inline_equals_forked_with_gateway``'s
    plane, forked."""
    gate = pkg["gateway"].BackpressurePolicy(max_pending=64, retry_after_s=5.0,
                                             max_client_retries=20)
    res = _sharded(pkg, True, gateway=gate).run()
    return _canon((res.gateway_summary(), res.peak_pending_gateway, _summary(res)))


def _placement_case(pkg):
    """``test_placement.py::test_hotspot_summary_sharded_merge``'s plane."""
    cal = pkg["calibration"]
    plane = pkg["shard"].ShardedControlPlane(
        2, admission_policy="fifo", cluster_cfg=cal.hetero_cluster(8, "big-small"),
        seed=31, usage_mode="event", processes=False, fold_completed=True,
        capture_trace=False, placement="scored-spread")
    fan = pkg["dag"].make_workflow("fan", pkg["workflows"].wide_fanout(width=8))
    for t in ("a", "b", "c", "d"):
        plane.add_stream(fan, repeats=2, tenant=t, arrival="concurrent", concurrency=2)
    res = plane.run(horizon_s=200_000)
    return _canon((res.hotspot_summary(), _summary(res)))


@pytest.mark.parametrize("case", ["autoscaler", "gateway", "placement"])
def test_sharded_feature_matches_the_reference(case):
    run = {"autoscaler": _autoscaler_case, "gateway": _gateway_case,
           "placement": _placement_case}[case]
    got = run(_pkg("repro_torch"))
    assert got == run(_pkg("repro"))
    summary = got[-1]
    assert summary["completed"] == {"autoscaler": 16, "gateway": 16, "placement": 8}[case]
    if case == "autoscaler":
        assert got[0]["node_seconds"] > 0 and got[1]["managed_nodes"] == 12
    elif case == "gateway":
        assert got[0]["totals"]["submissions"] == got[0]["totals"]["done"] == 16
    else:
        assert got[0]["nodes"] == 8


# ---------------------------------------------------------------------------
# a forked worker's device error comes back through the error pipe
# ---------------------------------------------------------------------------
def _cuda_payload_plane(pkg):
    """Two tenants on two shards, each a diamond of ``matmul_payload`` pods
    on ``cuda`` under ``payload_mode="real"``, in forked workers."""
    dag, payloads = pkg["dag"], importlib.import_module("repro_torch.core.payloads")
    mm = payloads.matmul_payload(n=8, iters=1, device="cuda")
    edges = {"0": ([], ["1", "2"]), "1": (["0"], ["3"]), "2": (["0"], ["3"]),
             "3": (["1", "2"], [])}
    plane = pkg["shard"].ShardedControlPlane(
        2, payload_mode="real", seed=0, processes=True, heartbeat_s=0.2,
        shard_timeout_s=60.0, cluster_cfg=pkg["calibration"].PaperCluster(n_nodes=4))
    for tenant in ("batch-a", "prod-a"):          # shard 0 and shard 1
        wf = dag.Workflow("diamond", {tid: dag.Task(id=tid, inputs=i, outputs=o, payload=mm)
                                      for tid, (i, o) in edges.items()})
        plane.add_stream(wf, tenant=tenant)
    return plane


def test_forked_worker_device_error_is_a_shard_failure():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py [6] runs this on it")
    plane = _cuda_payload_plane(_pkg("repro_torch"))
    t0 = time.monotonic()
    with pytest.raises(_pkg("repro_torch")["shard"].ShardFailure) as exc:
        plane.run()
    assert time.monotonic() - t0 < 60.0
    assert exc.value.shard == 0 and exc.value.tenants == ["batch-a"]
    assert "CUDA" in exc.value.reason or "cuda" in exc.value.reason


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 6 additions, rehearsed on the CPU
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


def test_chip_smoke_example_twins(chip_smoke):
    """The twins run in the script's process; their lines phase 6 checks."""
    out = chip_smoke.example_twins()
    engines = [line for line in out["quickstart"].splitlines() if "order_consistent=" in line]
    assert len(engines) == 3 and all("order_consistent=True" in line for line in engines)
    rows = out["multi_workflow"].splitlines()
    assert rows[-1] == "OK" and sum(line.endswith(" True") for line in rows) == 4


def test_chip_smoke_sharded_diamonds(chip_smoke):
    """Phase 6's sharded plane at a small matmul on the CPU: one tenant a
    shard, each diamond in order, every pod's output equal; the virtual
    plane forked equal to inline."""
    from repro_torch.core.shard import shard_of
    assert [shard_of(t, 2) for t in chip_smoke.SHARD_TENANTS] == [0, 1]
    real = chip_smoke.sharded_diamonds(processes=False, device="cpu", n=64, iters=1)
    res, log = real["result"], real["log"]
    assert res.completed_workflows == 2 and not res.degraded and len(log) == 8
    for tenant in chip_smoke.SHARD_TENANTS:
        order = [r["task"] for r in log if r["tenant"] == tenant]
        assert order[0] == "0" and order[-1] == "3" and sorted(order) == ["0", "1", "2", "3"]
    assert all(np.array_equal(r["out"], log[0]["out"]) for r in log)
    inline = chip_smoke.sharded_diamonds(processes=False, device=None)["result"]
    forked = chip_smoke.sharded_diamonds(processes=True, device=None)["result"]
    assert forked.tenant_summary() == inline.tenant_summary()
    assert sorted(inline.tenant_summary()) == sorted(chip_smoke.SHARD_TENANTS)
