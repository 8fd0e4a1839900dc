"""LM training orchestrated by the port's KubeAdaptor engine: the torch twin
of ``examples/workflow_train.py``.

The training DAG (namespace-isolated, data flowing through the shared
volume like the paper's PVC):

    data_prep -> phase_1 -> ... -> phase_P -> eval

Each phase resumes from ``Checkpointer.latest_step()``, runs its share
of real train steps and checkpoints at its end; eval restores the last
checkpoint and takes the loss of one more batch. A pod failure on
phase_2 shows the §4.5 fault tolerance: the retried pod resumes from
the checkpoint. The reference polls for a running phase_2 every virtual
second from t=8, which a phase shorter than that escapes; here the
failure is armed by phase_2's first run and fires at that virtual
instant, while the pod is RUNNING, so it always happens.

  PYTHONPATH=src python -m repro_torch.examples.workflow_train [--device cuda]
"""
from __future__ import annotations

import argparse
import math
import tempfile
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.cluster import RUNNING, Cluster
from repro_torch.core.dag import Task, Workflow
from repro_torch.core.engine import KubeAdaptorEngine
from repro_torch.core.events import EventRegistry
from repro_torch.core.informer import InformerSet
from repro_torch.core.injector import WorkflowInjector
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.sim import Sim
from repro_torch.core.volumes import VolumeManager
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.examples import PodRuns
from repro_torch.kernels import ops
from repro_torch.models import RunConfig
from repro_torch.optim.adamw import OptConfig, init_state
from repro_torch.runtime.train import TrainRunConfig, build_train_step

FAILED_TASK = "phase_2"


def run(cfg, *, steps: int, phases: int, batch: int, seq: int, rc: RunConfig,
        ckpt_dir, init_params: Optional[Callable] = None) -> dict:
    """Train ``steps`` steps in ``phases`` workflow pods, then evaluate.

    ``init_params()`` gives the first phase its params (default: the
    port's own init from seed 0). Returns the per-step losses and K1
    launches, the eval loss, the latest checkpointed step, each pod
    run's seconds and K1 launches, and the workflow's record. Raises
    unless the failure fired once and was retried once
    (``retries == 1``), the order is consistent, the loss fell and the
    eval loss is finite.
    """
    ckpt = Checkpointer(ckpt_dir)
    step_fn, state_meta, _, _, _, model = build_train_step(
        cfg, None, B=batch, S=seq, rc=rc,
        trc=TrainRunConfig(opt=OptConfig(lr=3e-4, warmup_steps=20, total_steps=steps)))
    if init_params is None:
        def init_params():
            return model.init(torch.Generator(device=rc.device).manual_seed(0))
    data = iter(SyntheticLM(DataConfig(batch, seq, cfg.vocab_size)))
    losses, step_launches, evals, failed_at = [], [], [], []
    pods = PodRuns(rc.device)

    def data_prep():
        # warm the pipeline + write the tokenizer/dataset manifest
        next(data)
        return {"dataset": "synthetic-zipf", "vocab": cfg.vocab_size}

    def make_phase(phase_idx, n_steps):
        def train_phase():
            if ckpt.latest_step() is None:
                state = init_state(init_params())
            else:
                state = ckpt.restore(state_meta, device=rc.device)
            start = int(state.step)
            for _ in range(start, min(start + n_steps, steps)):
                before = ops.attention.launches
                state, m = step_fn(state, to_device(next(data), rc.device))
                losses.append(float(m["loss"]))
                step_launches.append(ops.attention.launches - before)
            ckpt.save(state, int(state.step), blocking=True)
            return {"phase": phase_idx, "step": int(state.step),
                    "loss": losses[-1] if losses else None}
        return train_phase

    def evaluate():
        state = ckpt.restore(state_meta, device=rc.device)
        with torch.no_grad():
            loss = float(model.loss(state.params, to_device(next(data), rc.device)))
        evals.append(loss)
        return {"eval_loss": loss, "step": int(state.step)}

    def nuke():
        # kill the phase_2 pod while it runs: fault tolerance restarts it
        # and the payload resumes from the checkpoint (no lost progress)
        for p in cluster.list_pods():
            if p.task_id == FAILED_TASK and p.phase == RUNNING:
                cluster.fail_pod(p.namespace, p.name)
                failed_at.append(sim.now())
                return

    def phase_payload(tid, thunk):
        payload = pods.payload(tid, thunk)
        if tid != FAILED_TASK:
            return payload

        def fail_first_run(volume, task):
            payload(volume, task)
            if not failed_at:
                sim.after(0.0, nuke)        # before the pod's finish at now + wall time
        return fail_first_run

    per_phase = steps // phases
    tasks = {"data_prep": Task(id="data_prep", outputs=["phase_1"],
                               payload=pods.payload("data_prep", data_prep),
                               duration_s=1.0)}
    prev = "data_prep"
    for i in range(1, phases + 1):
        tid = f"phase_{i}"
        nxt = f"phase_{i + 1}" if i < phases else "eval"
        tasks[tid] = Task(id=tid, inputs=[prev], outputs=[nxt],
                          payload=phase_payload(tid, make_phase(i, per_phase)),
                          duration_s=5.0)
        prev = tid
    tasks["eval"] = Task(id="eval", inputs=[prev], outputs=[],
                         payload=pods.payload("eval", evaluate), duration_s=2.0)
    wf = Workflow("lmtrain", tasks)

    sim = Sim()
    cluster = Cluster(sim, payload_mode="real", seed=0)
    informers = InformerSet(sim, cluster)
    events = EventRegistry(sim)
    volumes = VolumeManager(sim, cluster)
    metrics = MetricsCollector(sim, cluster)
    engine = KubeAdaptorEngine(sim, cluster, informers, events, volumes, metrics)
    injector = WorkflowInjector(sim, engine.submit)
    engine.on_workflow_done = injector.request_next
    injector.load([wf.with_instance(0)])
    injector.start()

    sim.run(until=1e9)
    rec = metrics.wf_record(wf.with_instance(0))
    ordered = metrics.order_consistent(wf.with_instance(0))
    out = {"losses": losses, "step_k1_launches": step_launches,
           "eval_loss": evals[-1] if evals else None,
           "latest_step": ckpt.latest_step(), "retries": rec.retries,
           "failed_at": failed_at, "lifecycle": rec.lifecycle,
           "order_consistent": ordered,
           "pod_seconds": pods.by_task("seconds"),
           "pod_k1_launches": pods.by_task("k1_launches")}
    if rec.retries != 1 or len(failed_at) != 1:
        raise RuntimeError(f"retries {rec.retries}, failures {failed_at}: expected "
                           f"one of each")
    if not ordered:
        raise RuntimeError("the training workflow ran out of its DAG's order")
    if not losses or not losses[-1] < losses[0]:
        raise RuntimeError(f"training did not descend: {losses}")
    if out["eval_loss"] is None or not math.isfinite(out["eval_loss"]):
        raise RuntimeError(f"eval loss {out['eval_loss']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--phases", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    print(f"arch={cfg.name}  params~{cfg.param_count() / 1e6:.1f}M  "
          f"steps={args.steps} x {args.phases} phases  device={args.device}")
    with tempfile.TemporaryDirectory(prefix="wf_train_") as ckpt_dir:
        out = run(cfg, steps=args.steps, phases=args.phases, batch=args.batch,
                  seq=args.seq, rc=RunConfig(device=args.device), ckpt_dir=ckpt_dir)
    print(f"\nworkflow lifecycle (virtual): {out['lifecycle']:.1f}s  "
          f"retries={out['retries']} (phase_2 failed at t={out['failed_at'][0]:.2f}s)")
    print(f"order consistent: {out['order_consistent']}")
    print(f"steps completed: {out['latest_step']}  loss: {out['losses'][0]:.3f} -> "
          f"{out['losses'][-1]:.3f}  eval loss: {out['eval_loss']:.3f}")
    print("OK")


if __name__ == "__main__":
    main()
