"""Quickstart: define a workflow in the paper's ConfigMap JSON format
(Listing 1), run it through KubeAdaptor, and inspect the result. The
twin of ``examples/quickstart.py`` on the port's copy of the control
plane (``repro_torch.core``): host-only, its output byte-equal to the
reference's.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
import json

from repro_torch.core.dag import make_workflow
from repro_torch.core.runner import run_experiment

# Listing-1-style workflow definition: a diamond DAG of stress tasks.
CONFIGMAP = {
    "0": {"input": [], "output": ["1", "2"],
          "image": ["shanchenggang/task-emulator:latest"],
          "cpuNum": ["1200"], "memNum": ["1200"],
          "args": ["-c", "1", "-m", "100", "-t", "5"]},
    "1": {"input": ["0"], "output": ["3"],
          "image": ["shanchenggang/task-emulator:latest"],
          "cpuNum": ["1200"], "memNum": ["1200"],
          "args": ["-c", "1", "-m", "100", "-t", "5"]},
    "2": {"input": ["0"], "output": ["3"],
          "image": ["shanchenggang/task-emulator:latest"],
          "cpuNum": ["1200"], "memNum": ["1200"],
          "args": ["-c", "1", "-m", "100", "-t", "5"]},
    "3": {"input": ["1", "2"], "output": [],
          "image": ["shanchenggang/task-emulator:latest"],
          "cpuNum": ["1200"], "memNum": ["1200"],
          "args": ["-c", "1", "-m", "100", "-t", "5"]},
}


def main():
    wf = make_workflow("quickstart", json.dumps(CONFIGMAP))
    print(f"workflow: {len(wf.tasks)} tasks, levels={[len(l) for l in wf.levels()]}")

    for engine in ("kubeadaptor", "batchjob", "argo"):
        res = run_experiment(engine, wf, repeats=1, seed=0)
        rec = res.metrics.wf_record(wf.with_instance(0))
        print(f"{engine:12s} lifecycle={rec.lifecycle:7.2f}s "
              f"avg_pod_exec={res.metrics.avg_pod_exec_time('quickstart'):5.2f}s "
              f"order_consistent={res.metrics.order_consistent(wf.with_instance(0))} "
              f"apiserver_calls={res.api_calls}")

    print("\ntask start timeline (KubeAdaptor):")
    res = run_experiment("kubeadaptor", wf, repeats=1, seed=0)
    for t, tid in res.metrics.wf_record(wf.with_instance(0)).starts:
        print(f"  t={t:6.2f}s  start {tid}")


if __name__ == "__main__":
    main()
