"""Concurrent multi-workflow run: all four scientific workflows in
flight at once, each in its own namespace, sharing the 6-node cluster —
demonstrates namespace isolation, the resource-gathering admission gate
under contention, and per-workflow order consistency. The twin of
``examples/multi_workflow.py`` on the port's copy of the control plane
(``repro_torch.core``): host-only, its output byte-equal to the
reference's.

  PYTHONPATH=src python -m repro_torch.examples.multi_workflow
"""
from repro_torch.configs.workflows import get_workflow_spec
from repro_torch.core.cluster import Cluster
from repro_torch.core.dag import make_workflow
from repro_torch.core.engine import KubeAdaptorEngine
from repro_torch.core.events import EventRegistry
from repro_torch.core.informer import InformerSet
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.sim import Sim
from repro_torch.core.volumes import VolumeManager


def main():
    sim = Sim()
    cluster = Cluster(sim, seed=0)
    informers = InformerSet(sim, cluster)
    events = EventRegistry(sim)
    volumes = VolumeManager(sim, cluster)
    metrics = MetricsCollector(sim, cluster)
    engine = KubeAdaptorEngine(sim, cluster, informers, events, volumes,
                               metrics)

    wfs = [make_workflow(n, get_workflow_spec(n))
           for n in ("montage", "epigenomics", "cybershake", "ligo")]
    metrics.start_sampling()
    for w in wfs:                      # all four submitted concurrently
        engine.submit(w)
    sim.run(until=10_000)

    print(f"{'workflow':14s} {'lifecycle':>10s} {'consistent':>11s}")
    peak_cpu = max(c for _, c, _ in metrics.samples)
    for w in wfs:
        rec = metrics.wf_record(w)
        ok = metrics.order_consistent(w)
        print(f"{w.name:14s} {rec.lifecycle:9.1f}s {str(ok):>11s}")
        assert rec.ns_deleted > 0 and ok
    cpu_a, _ = cluster.allocatable()
    print(f"\npeak cluster CPU under contention: {peak_cpu}m / {cpu_a}m "
          f"({peak_cpu / cpu_a:.0%}) — admission gate respected")
    print("OK")


if __name__ == "__main__":
    main()
