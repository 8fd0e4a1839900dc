"""The port's copy of the KubeAdaptor control plane (``repro_torch.core``)
against the JAX package's (``repro.core``).

The control plane is host-only Python (plus a C helper built with ``cc``),
so the port keeps a copy of it rather than importing it. These tests hold
the copy to its reference:

* fidelity: each of the 29 modules that the two ML examples reach
  through their imports equals its reference source after the import
  rewrite (``repro.`` -> ``repro_torch.`` on import lines only), but for
  the edits named in ``ALLOWED_EDITS``;
* parity: the same seeded ``stress_payload`` workflows give equal binding
  sequences, virtual lifecycles and order consistency through both
  packages (``run_experiment`` over every engine, a multi-tenant
  ``ControlPlane`` run, a chaos run), and the copy reproduces the
  binding hashes pinned against the reference;
* the ``cc`` helper: the pure-Python backend (``REPRO_SHUFFLE_NO_NATIVE``)
  binds as the native one does, and a failed build raises;
* ``matmul_payload``: the torch twin writes the JAX payload's ``y[0, :4]``
  (f32, 1e-4).
"""
import ast
import hashlib
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

# The two examples' closure under repro.core (and the workflows config
# that core/runner.py imports): computed by test_copied_modules_are_the_closure.
CORE = ["__init__", "autoscaler", "baselines", "calibration", "chaos", "cluster", "dag",
        "descheduler", "engine", "events", "gateway", "informer", "injector", "metrics",
        "payloads", "resources", "runner", "schedulers", "shuffle", "sim", "stats",
        "volumes"]
POLICY = ["__init__", "filters", "ordering", "pipeline", "preemption", "reservations"]
COPIED = ([f"core/{m}.py" for m in CORE] + [f"core/policy/{m}.py" for m in POLICY]
          + ["configs/workflows.py"])

# {module: ({top-level function names, or "__doc__" for the module
# docstring, that the copy changes}, why)}
ALLOWED_EDITS = {
    "core/shuffle.py": (
        {"_load_native"},
        "a failed cc build or load raises with the compiler's stderr; the "
        "reference falls back to the pure-Python backend in silence"),
    "core/payloads.py": (
        {"matmul_payload", "__doc__"},
        "the real payload is torch on an explicit device (cuda unless the "
        "caller asks for the cpu) and synchronises before it returns, where "
        "the reference is jax.jit + block_until_ready"),
}

_IMPORT_LINE = re.compile(r"^\s*(from|import)\s+repro[.\s]")


def rewrite_imports(text: str) -> str:
    """The copy's only systematic change: ``repro.`` -> ``repro_torch.`` on
    import lines (lazy imports inside functions too)."""
    return "".join(re.sub(r"\brepro\.", "repro_torch.", line) if _IMPORT_LINE.match(line)
                   else line for line in text.splitlines(keepends=True))


def _mask(text: str, names) -> str:
    """``text`` with the named top-level functions (and the module docstring,
    for "__doc__") replaced by one placeholder line each."""
    tree = ast.parse(text)
    spans = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            first = min([node.lineno] + [d.lineno for d in node.decorator_list])
            spans.append((first, node.end_lineno, node.name))
    if "__doc__" in names and ast.get_docstring(tree) is not None:
        spans.append((tree.body[0].lineno, tree.body[0].end_lineno, "__doc__"))
    assert {s[2] for s in spans} == set(names), f"allowlisted names not found: {names}"
    lines = text.splitlines()
    for first, last, name in sorted(spans, reverse=True):
        lines[first - 1:last] = [f"<edited: {name}>"]
    return "\n".join(lines)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_reference_after_import_rewrite(rel):
    expect = rewrite_imports((SRC / "repro" / rel).read_text())
    got = (SRC / "repro_torch" / rel).read_text()
    if rel not in ALLOWED_EDITS:
        assert got == expect, f"{rel} differs from its reference beyond the import rewrite"
        return
    names, why = ALLOWED_EDITS[rel]
    assert why
    assert _mask(got, names) == _mask(expect, names), \
        f"{rel} differs from its reference outside {sorted(names)}"
    for name in names:      # each allowlisted edit is real (the list is not stale)
        assert _mask(got, names - {name}) != _mask(expect, names - {name}), name


def _imported_modules(path: Path):
    """Every module named by an import statement anywhere in ``path``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
            for alias in node.names:        # `from repro.core import calibration`
                yield f"{node.module}.{alias.name}"
        elif isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name


def _module_file(mod: str):
    """repro.core.* and repro.configs.workflows -> their file (and, for a
    repro.core submodule, the package __init__ files it runs)."""
    parts = mod.split(".")
    if parts[:2] != ["repro", "core"] and mod != "repro.configs.workflows":
        return []
    base = SRC.joinpath(*parts)
    files = []
    if parts[:2] == ["repro", "core"]:
        for i in range(2, len(parts) + 1):
            init = SRC.joinpath(*parts[:i], "__init__.py")
            if init.exists():
                files.append(init)
    if base.with_suffix(".py").exists():
        files.append(base.with_suffix(".py"))
    return files


def test_copied_modules_are_the_closure():
    todo = [ROOT / "examples" / "serve_batch.py", ROOT / "examples" / "workflow_train.py"]
    seen = set()
    while todo:
        for mod in _imported_modules(todo.pop()):
            for f in _module_file(mod):
                if f not in seen:
                    seen.add(f)
                    todo.append(f)
    closure = sorted(str(f.relative_to(SRC / "repro")) for f in seen)
    assert closure == sorted(COPIED)
    assert "core/shard.py" not in closure
    lines = sum(len((SRC / "repro" / rel).read_text().splitlines()) for rel in closure)
    assert len(closure) == 29 and lines == 8282


# ---------------------------------------------------------------------------
# parity: the same seeded runs through both packages
# ---------------------------------------------------------------------------
def _pkg(name):
    """The package's runner, calibration, dag, chaos and workflows modules."""
    return {m: importlib.import_module(f"{name}.{m}")
            for m in ("core.runner", "core.calibration", "core.dag", "core.chaos",
                      "configs.workflows")}


def _workflow(pkg, name):
    if name == "fan":
        return pkg["core.dag"].make_workflow("fan", pkg["configs.workflows"].wide_fanout(width=12))
    return pkg["core.dag"].make_workflow(name, pkg["configs.workflows"].get_workflow_spec(name))


def _record_bindings(plane):
    seq = []
    inner = plane.cluster._bind

    def record(pod, node):
        seq.append(f"{pod.namespace}/{pod.name}->{node.name}@{plane.sim.now():.4f}")
        return inner(pod, node)
    plane.cluster._bind = record
    return seq


def _outcome(res, seq, *templates):
    """Bindings, and per workflow instance its virtual lifecycle, task start
    times and order consistency."""
    m = res.metrics
    by_name = {wf.name: wf for wf in templates}
    recs = sorted(m.workflows.items())
    assert {n for (n, _), _ in recs} == set(by_name)
    return {"bindings": seq,
            "lifecycles": {key: r.lifecycle for key, r in recs},
            "starts": {key: list(r.starts) for key, r in recs},
            "order": {key: m.order_consistent(by_name[key[0]].with_instance(key[1]))
                      for key, _ in recs},
            "api_calls": res.api_calls}


def _engine_run(pkg_name, engine):
    """``run_experiment`` (serial injection of 2 montage instances); the
    bindings read from the pod log: pod, node, bind, start and finish."""
    pkg = _pkg(pkg_name)
    mont = _workflow(pkg, "montage")
    res = pkg["core.runner"].run_experiment(engine, mont, repeats=2, seed=3)
    seq = [f"{p.namespace}/{p.name}->{p.node}@{p.scheduled:.4f},{p.started:.4f},"
           f"{p.finished:.4f}:{p.phase}" for p in res.cluster.pod_log]
    return _outcome(res, seq, mont)


def _tenants_run(pkg_name):
    pkg = _pkg(pkg_name)
    cal = pkg["core.calibration"]
    plane = pkg["core.runner"].ControlPlane("kubeadaptor", admission_policy="fair-share",
                                            cluster_cfg=cal.PaperCluster(n_nodes=3), seed=11)
    seq = _record_bindings(plane)
    mont, fan = _workflow(pkg, "montage"), _workflow(pkg, "fan")
    plane.add_stream(mont, repeats=2, tenant="a", arrival="concurrent", concurrency=2,
                     weight=2.0)
    plane.add_stream(fan, repeats=2, tenant="b", arrival="poisson", rate=0.5, burst=2,
                     weight=1.0, priority=3)
    res = plane.run(horizon_s=500_000)
    out = _outcome(res, seq, mont, fan)
    out["tenants"] = repr(res.metrics.tenant_summary())
    return out


def _chaos_run(pkg_name):
    pkg = _pkg(pkg_name)
    cal = pkg["core.calibration"]
    chaos = pkg["core.chaos"].ChaosSchedule(
        seed=3, node_kill_interval_s=150.0, node_drain_interval_s=400.0,
        node_downtime_s=60.0, api_fault_rate=0.05, task_crash_rate=0.02,
        start_after_s=30.0)
    plane = pkg["core.runner"].ControlPlane(
        "kubeadaptor", admission_policy="fair-share", seed=7,
        cluster_cfg=cal.PaperCluster(n_nodes=8), lifecycle="fast", chaos=chaos)
    seq = _record_bindings(plane)
    mont = _workflow(pkg, "montage")
    plane.add_stream(mont, repeats=3, tenant="prod", arrival="concurrent", concurrency=2,
                     priority=10, weight=3.0)
    res = plane.run(horizon_s=500_000)
    out = _outcome(res, seq, mont)
    out["chaos"] = res.chaos.counters()
    return out


@pytest.mark.parametrize("engine", ["kubeadaptor", "batchjob", "argo", "direct"])
def test_engines_match_the_reference(engine):
    from repro_torch.core.runner import ENGINES
    assert sorted(ENGINES) == ["argo", "batchjob", "direct", "kubeadaptor"]
    got, expect = _engine_run("repro_torch", engine), _engine_run("repro", engine)
    assert got == expect
    # the direct-submit baseline creates every pod at once: out of order by design
    assert got["bindings"] and all(got["order"].values()) == (engine != "direct")


def test_multi_tenant_control_plane_matches_the_reference():
    got, expect = _tenants_run("repro_torch"), _tenants_run("repro")
    assert got == expect
    assert len(got["lifecycles"]) == 4 and all(v > 0 for v in got["lifecycles"].values())
    assert all(got["order"].values())


def test_chaos_run_matches_the_reference():
    got, expect = _chaos_run("repro_torch"), _chaos_run("repro")
    assert got == expect
    assert got["chaos"]["api_faults"] >= 1


# sha256 over the binding sequence "ns/pod->node@t", recorded against the
# reference core: PINNED of tests/test_scale_core.py and PINNED_MONOLITH of
# tests/test_policy_pipeline.py (same scenarios, run here through the copy)
PINNED = {
    "paper": ("3832b6fec9f1d4afd55898e04dba44377eb37258b3fb3b19c94f9a994f70a3ca", 42),
    "multi": ("546262a798da1d30d32312751fd6aa026f80e335a1e6b0fb56d33d9ef66f1834", 70),
    "fifo": ("cc5570c122ba24a1c4662c055eb6a0f310a8231a6aae1e315fd2398fa8657dfc", 118),
    "priority": ("476cbacf62c6802dfb4d461d20e8cf87778fcfa754002946e5c68cc321880970", 118),
    "fair-share": ("16d8e3450fb7f977c234cfb4e51a00573e528cc48b3f22a1e10aa4fb338c874e", 118),
}


def pinned_bindings(name: str, pkg_name: str = "repro_torch"):
    """The binding sequence of one pinned scenario, through ``pkg_name``."""
    pkg = _pkg(pkg_name)
    cal, ControlPlane = pkg["core.calibration"], pkg["core.runner"].ControlPlane
    if name == "paper":                       # test_scale_core._paper_scenario
        plane = ControlPlane("kubeadaptor", seed=7)
        seq = _record_bindings(plane)
        plane.gateway.load([_workflow(pkg, "montage").with_instance(i) for i in range(2)])
    elif name == "multi":                     # test_scale_core._multi_scenario
        plane = ControlPlane("kubeadaptor", admission_policy="fair-share",
                             cluster_cfg=cal.PaperCluster(n_nodes=3), seed=11)
        seq = _record_bindings(plane)
        plane.add_stream(_workflow(pkg, "montage"), repeats=2, tenant="a",
                         arrival="concurrent", concurrency=2, weight=2.0)
        plane.add_stream(_workflow(pkg, "fan"), repeats=2, tenant="b",
                         arrival="concurrent", concurrency=2, weight=1.0)
    else:                                     # test_policy_pipeline._contended_plane
        plane = ControlPlane("kubeadaptor", admission_policy=name,
                             cluster_cfg=cal.PaperCluster(n_nodes=2), seed=13)
        seq = _record_bindings(plane)
        dag, wfs = pkg["core.dag"], pkg["configs.workflows"]
        plane.add_stream(dag.make_workflow("fan", wfs.wide_fanout(width=14)), repeats=2,
                         tenant="a", arrival="concurrent", concurrency=2, priority=5,
                         weight=3.0)
        plane.add_stream(_workflow(pkg, "montage"), repeats=2, tenant="b",
                         arrival="concurrent", concurrency=2, priority=0, weight=1.0)
        plane.add_stream(_workflow(pkg, "cybershake"), repeats=2, tenant="c",
                         arrival="poisson", rate=0.5, burst=2, priority=2, weight=2.0)
    plane.run(horizon_s=500_000)
    return seq


def _digest(seq):
    return hashlib.sha256("\n".join(seq).encode()).hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_copy_reproduces_the_pinned_binding_hashes(name):
    seq = pinned_bindings(name)
    assert (_digest(seq), len(seq)) == PINNED[name]


# ---------------------------------------------------------------------------
# the cc helper
# ---------------------------------------------------------------------------
def _run_python(code, env=None, timeout=120):
    full_env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{ROOT / 'tests'}", **(env or {}))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, env=full_env, cwd=str(ROOT))


def test_native_and_python_backends_bind_alike():
    from repro_torch.core import shuffle
    assert shuffle._load_native() is not None          # cc builds it here
    native = pinned_bindings("multi")
    code = ("import os, random\n"
            "from repro_torch.core.shuffle import ExactShuffler\n"
            "assert ExactShuffler(random.Random(0)).backend == 'python'\n"
            "from test_torch_core import pinned_bindings\n"
            "print('\\n'.join(pinned_bindings('multi')))\n")
    out = _run_python(code, env={"REPRO_SHUFFLE_NO_NATIVE": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines() == native


@pytest.mark.parametrize("how", ["no cc on PATH", "cc fails"])
def test_failed_native_build_raises(tmp_path, how):
    empty = tmp_path / "bin"
    empty.mkdir()
    code = (
        "import random, sys\n"
        "from pathlib import Path\n"
        "from repro_torch.core import shuffle\n"
        f"shuffle._NATIVE_DIR = Path({str(tmp_path / 'native')!r})\n"
        + ("shuffle._C_SRC = 'this is not C;'\n" if how == "cc fails" else "")
        + "for attempt in range(2):\n"
          "    try:\n"
          "        shuffle.ExactShuffler(random.Random(0))\n"
          "    except RuntimeError as e:\n"
          "        print('raised:', str(e).replace(chr(10), ' '))\n"
          "    else:\n"
          "        sys.exit('no error: fell back to ' + repr(shuffle._native_lib))\n")
    env = {"PATH": str(empty)} if how == "no cc on PATH" else None
    out = _run_python(code, env=env)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    raised = out.stdout.splitlines()
    assert len(raised) == 2 and all(line.startswith("raised: ") for line in raised)
    if how == "cc fails":       # the compiler's stderr comes with it
        assert "cc failed" in raised[0] and "error" in raised[0]


def test_concurrent_native_builds_all_load(tmp_path):
    """Processes that find no helper build it at once (as test workers do):
    each writes its own output and renames it in place, so every one loads."""
    code = ("from pathlib import Path\n"
            "from repro_torch.core import shuffle\n"
            f"shuffle._NATIVE_DIR = Path({str(tmp_path / 'native')!r})\n"
            "assert shuffle._load_native() is not None\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(6)]
    for proc in procs:
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-3000:]
    built = sorted(p.name for p in (tmp_path / "native").iterdir())
    assert len(built) == 1 and built[0].endswith(".so"), built


# ---------------------------------------------------------------------------
# the real payload
# ---------------------------------------------------------------------------
class _Volume(dict):
    def put(self, key, value):
        self[key] = value


def test_matmul_payload_matches_jax():
    pytest.importorskip("torch")
    from repro.core import payloads as jax_payloads
    from repro.core.dag import Task
    from repro_torch.core import payloads
    got, expect = _Volume(), _Volume()
    task = Task(id="mm", inputs=[])
    payloads.matmul_payload(n=256, device="cpu")(got, task)
    jax_payloads.matmul_payload(n=256)(expect, task)
    assert got["mm/out"].dtype == np.float32 and got["mm/out"].shape == (4,)
    np.testing.assert_allclose(got["mm/out"], np.asarray(expect["mm/out"]), rtol=0,
                               atol=1e-4)


def test_matmul_payload_stays_on_the_card_unless_asked():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    from repro_torch.core import payloads
    from repro_torch.core.dag import Task
    with pytest.raises((RuntimeError, AssertionError)):
        payloads.matmul_payload(n=8)(None, Task(id="mm"))
