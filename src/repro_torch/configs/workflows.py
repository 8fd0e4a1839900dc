"""The paper's four real-world scientific workflows (§5.2, Fig 5).

Encoded in the exact ConfigMap JSON format of Listing 1 (input/output/
image/cpuNum/memNum/args per task node). Structures follow the ~20-task
variants from the Pegasus workflow gallery, with entry/exit nodes added
at the entrance and exit (the paper gives every node the same stress
task: ``-c 1 -m 100 -t 5`` -> ~10 s busy).

Level structure (depth includes entry/exit):
  montage      4-6-1-1-4-1-1 core, depth 10   (mProjectPP..mJPEG)
  epigenomics  1-4-4-4-4-1-1 core, depth 9    (fastqSplit..maqIndex)
  cybershake   2-8-8-2 core, depth 6          (ExtractSGT..ZipPSA)
  ligo         4-8-2-4-1 core, depth 7        (TmpltBank..Thinca2)
"""
from __future__ import annotations

from typing import Dict, List

IMAGE = "shanchenggang/task-emulator:latest"
ARGS = ["-c", "1", "-m", "100", "-t", "5"]
CPU, MEM = "1200", "1200"


def _node(inputs: List[str], outputs: List[str]) -> Dict:
    return {"input": inputs, "output": outputs, "image": [IMAGE],
            "cpuNum": [CPU], "memNum": [MEM], "args": list(ARGS)}


def _wire(layers: List[List[str]], edges: Dict[str, List[str]]) -> Dict[str, Dict]:
    """Build ConfigMap dict from explicit edge lists (u -> [v...])."""
    nodes = [n for layer in layers for n in layer]
    spec = {n: _node([], []) for n in nodes}
    for u, vs in edges.items():
        for v in vs:
            spec[u]["output"].append(v)
            spec[v]["input"].append(u)
    return spec


def montage() -> Dict[str, Dict]:
    proj = [f"mProjectPP{i}" for i in range(1, 5)]
    diff = [f"mDiffFit{i}" for i in range(1, 7)]
    bg = [f"mBackground{i}" for i in range(1, 5)]
    layers = [["entry"], proj, diff, ["mConcatFit"], ["mBgModel"], bg,
              ["mImgtbl"], ["mAdd"], ["mJPEG"], ["exit"]]
    edges: Dict[str, List[str]] = {"entry": proj}
    # each mDiffFit consumes an overlapping pair of projections
    pairs = [(0, 1), (1, 2), (2, 3), (0, 2), (1, 3), (0, 3)]
    for d, (a, b) in zip(diff, pairs):
        edges.setdefault(proj[a], []).append(d)
        edges.setdefault(proj[b], []).append(d)
    for d in diff:
        edges.setdefault(d, []).append("mConcatFit")
    edges["mConcatFit"] = ["mBgModel"]
    edges["mBgModel"] = list(bg)
    for i, b in enumerate(bg):   # mBackground_i also re-reads projection i
        edges.setdefault(proj[i], []).append(b)
        edges.setdefault(b, []).append("mImgtbl")
    edges["mImgtbl"] = ["mAdd"]
    edges["mAdd"] = ["mJPEG"]
    edges["mJPEG"] = ["exit"]
    return _wire(layers, edges)


def epigenomics() -> Dict[str, Dict]:
    lanes = range(1, 5)
    filt = [f"filterContams{i}" for i in lanes]
    sol = [f"sol2sanger{i}" for i in lanes]
    bfq = [f"fastq2bfq{i}" for i in lanes]
    mp = [f"map{i}" for i in lanes]
    layers = [["entry"], ["fastqSplit"], filt, sol, bfq, mp,
              ["mapMerge"], ["maqIndex"], ["exit"]]
    edges: Dict[str, List[str]] = {"entry": ["fastqSplit"],
                                   "fastqSplit": list(filt)}
    for a, b, c, d in zip(filt, sol, bfq, mp):
        edges[a] = [b]
        edges[b] = [c]
        edges[c] = [d]
        edges[d] = ["mapMerge"]
    edges["mapMerge"] = ["maqIndex"]
    edges["maqIndex"] = ["exit"]
    return _wire(layers, edges)


def cybershake() -> Dict[str, Dict]:
    sgt = ["ExtractSGT1", "ExtractSGT2"]
    seis = [f"Seismogram{i}" for i in range(1, 9)]
    peak = [f"PeakValCalc{i}" for i in range(1, 9)]
    layers = [["entry"], sgt, seis, peak + ["ZipSeis"], ["ZipPSA"], ["exit"]]
    edges: Dict[str, List[str]] = {"entry": list(sgt)}
    for i, s in enumerate(seis):     # 4 synthesis jobs per SGT extraction
        edges.setdefault(sgt[i // 4], []).append(s)
        edges.setdefault(s, []).extend([peak[i], "ZipSeis"])
    for p in peak:
        edges.setdefault(p, []).append("ZipPSA")
    edges.setdefault("ZipSeis", []).append("exit")
    edges["ZipPSA"] = ["exit"]
    return _wire(layers, edges)


def ligo() -> Dict[str, Dict]:
    bank = [f"TmpltBank{i}" for i in range(1, 5)]
    insp = [f"Inspiral{i}" for i in range(1, 9)]
    thinca = ["Thinca1", "Thinca2"]
    trig = [f"TrigBank{i}" for i in range(1, 5)]
    layers = [["entry"], bank, insp, thinca, trig, ["Thinca2nd"], ["exit"]]
    edges: Dict[str, List[str]] = {"entry": list(bank)}
    for i, s in enumerate(insp):     # 2 inspirals per template bank
        edges.setdefault(bank[i // 2], []).append(s)
        edges.setdefault(s, []).append(thinca[i // 4])
    for i, t in enumerate(trig):     # 2 trigbanks per thinca
        edges.setdefault(thinca[i // 2], []).append(t)
        edges.setdefault(t, []).append("Thinca2nd")
    edges["Thinca2nd"] = ["exit"]
    return _wire(layers, edges)


WORKFLOWS = {
    "montage": montage,
    "epigenomics": epigenomics,
    "cybershake": cybershake,
    "ligo": ligo,
}


def get_workflow_spec(name: str) -> Dict[str, Dict]:
    return WORKFLOWS[name]()


# ---------------------------------------------------------------------------
# Synthetic admission-pressure workload (beyond-paper): a src -> N-wide
# fan-out -> sink DAG that keeps many tasks ready at once, unlike the
# paper DAGs whose narrow phases gate demand. ConfigMap format, so it
# parses through the same path as the scientific workflows.
# ---------------------------------------------------------------------------
def wide_fanout(width: int = 24, duration_s: float = 8.0) -> Dict[str, Dict]:
    secs = str(duration_s / 2.0)            # stress -t secs -> 2x busy time
    spec = {"src": _node([], []), "sink": _node([], [])}
    spec["src"]["args"] = spec["sink"]["args"] = \
        ["-c", "1", "-m", "100", "-t", "0.25"]
    for i in range(width):
        w = f"w{i}"
        spec[w] = _node(["src"], ["sink"])
        spec[w]["args"] = ["-c", "1", "-m", "100", "-t", secs]
        spec["src"]["output"].append(w)
        spec["sink"]["input"].append(w)
    return spec


# ---------------------------------------------------------------------------
# Multi-tenant scenario presets (beyond-paper): named stream mixes for the
# ControlPlane builder. Each entry is a list of add_stream kwargs minus the
# workflow object itself — resolve "workflow" names via get_workflow_spec.
# ---------------------------------------------------------------------------
TENANT_SCENARIOS: Dict[str, List[Dict]] = {
    # the paper's experiment, expressed as one serial default-tenant stream
    "paper-serial": [
        {"workflow": "montage", "repeats": 2, "tenant": "default",
         "arrival": "serial"},
    ],
    # two equal tenants racing fixed-concurrency streams
    "duel": [
        {"workflow": "montage", "repeats": 3, "tenant": "alice",
         "arrival": "concurrent", "concurrency": 2, "weight": 1.0},
        {"workflow": "cybershake", "repeats": 3, "tenant": "bob",
         "arrival": "concurrent", "concurrency": 2, "weight": 1.0},
    ],
    # a heavy production tenant vs a bursty best-effort tenant
    "prod-vs-burst": [
        {"workflow": "ligo", "repeats": 4, "tenant": "prod",
         "arrival": "concurrent", "concurrency": 2,
         "priority": 10, "weight": 3.0},
        {"workflow": "epigenomics", "repeats": 4, "tenant": "burst",
         "arrival": "poisson", "rate": 0.05, "burst": 2,
         "priority": 0, "weight": 1.0},
    ],
}
