"""Training: the program's train step (``runtime.train.build_train_step``,
no mesh) called in a loop, each step on a new batch of the mix.

Set-up builds the step and its state from the seed and drives it through
its first three steps, the ones the check compares; the same state goes
on into the window. ``train_tokens_per_s`` is every token of every step
in the window over the time from the first step's start to the last
step's end (synchronised). Once the window has closed and the peak is
read, the same step takes one more step from the state the window left
(warmed up, at the schedule's later learning rate), with that state kept
on the host. Then the program's state is freed and the reference follows
the first three steps from the seed's weights, and the late step from
the kept state (``compare.train_numbers``).
"""
from __future__ import annotations

import math
import time

from podbench import compare, session, traffic, weights
from podbench.reference import adamw as ref_adamw
from podbench.reference import common
from podbench.reference import model as ref_model

CHECK_STEPS = 3
CONTROLS = ("fp8", "half")     # what ``run(controls=...)`` can put in the program's place


def _norms(tree) -> dict:
    import torch
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in weights.flatten(tree).items()}


def _update_norms(params, meta, cell, seed, device) -> dict:
    """{leaf: |p - p0|}, p0 the seed's weights made again."""
    import torch
    p0 = weights.flatten(weights.make(meta, cell.config, seed, device))
    return {k: float(torch.linalg.vector_norm(v.float() - p0[k].float()))
            for k, v in weights.flatten(params).items()}


def _reference(cell, control: str | None):
    """The precision and the rows of a reference run: the reference itself
    (``control`` None), or a control in the program's place: ``"fp8"``
    products, or ``"half"`` the batch (the first half of its rows, the
    mean taken over them)."""
    mm = common.fp8 if control == "fp8" else common.exact
    return mm, (cell.mix["batch"] // 2 if control == "half" else None)


def reference_steps(cell, seed: int, meta, feed, device, control=None) -> dict:
    """The reference's first three steps from the seed's weights: their
    losses, the clipped first gradient's norm and the change's norm after
    three steps, by leaf."""
    import torch
    mm, rows = _reference(cell, control)
    opt = cell.workload["optimizer"]
    made = weights.flatten(weights.make(meta, cell.config, seed, device))
    P = {k: v.float().clone().requires_grad_(True) for k, v in made.items()}
    del made
    leaves = list(P.values())
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    losses, grad = [], None
    for t in range(1, CHECK_STEPS + 1):
        b = feed.batch(t - 1)
        tokens, labels = b["tokens"][:rows], b["labels"][:rows]
        loss = ref_model.loss(weights.unflatten(P), cell.arch, tokens, labels, mm,
                              cell.config["reference"])
        grads = torch.autograd.grad(loss, leaves)
        norms = ref_adamw.step(leaves, grads, m, v, t, opt)
        del grads
        losses.append(float(loss.detach()))
        if t == 1:
            grad = {k: float(n) for k, n in zip(P, norms)}
    del m, v
    with torch.no_grad():
        update = _update_norms(weights.unflatten(P), meta, cell, seed, device)
    return {"loss": losses, "grad": grad, "update": update}


def reference_late(cell, kept: dict, t: int, batch, device, control=None) -> dict:
    """The reference's step ``t`` from the kept state (``{"params/..",
    "m/..", "v/.."}`` on the host): its loss, the clipped gradient's norm
    and the change's norm, by leaf."""
    import torch
    mm, rows = _reference(cell, control)
    names = [k[len("params/"):] for k in kept if k.startswith("params/")]
    P = {k: kept["params/" + k].to(device, torch.float32, copy=True).requires_grad_(True)
         for k in names}
    leaves = list(P.values())
    m = [kept["m/" + k].to(device, copy=True) for k in names]
    v = [kept["v/" + k].to(device, copy=True) for k in names]
    loss = ref_model.loss(weights.unflatten(P), cell.arch, batch["tokens"][:rows],
                          batch["labels"][:rows], mm, cell.config["reference"])
    grads = torch.autograd.grad(loss, leaves)
    norms = ref_adamw.step(leaves, grads, m, v, t, cell.workload["optimizer"])
    del grads, m, v
    with torch.no_grad():
        update = {k: float(torch.linalg.vector_norm(P[k] - kept["params/" + k].to(device)))
                  for k in names}
    return {"loss": [float(loss.detach())], "grad": {k: float(n) for k, n in zip(names, norms)},
            "update": update}


def late_step(step, state, batch, b1: float):
    """One more step of the window's call from ``state``: (the state
    before it, on the host; the program's readings: its loss, the clipped
    gradient's norm as the optimizer took it, (m' - b1 m) / (1 - b1), and
    the change's norm, by leaf)."""
    import torch
    kept = {k: v.detach().to("cpu", copy=True) for k, v in
            weights.flatten({"params": state.params, "m": state.m, "v": state.v}).items()}
    new, met = step(state, batch)
    dev = lambda k: kept[k].to(new.step.device)                   # noqa: E731
    m, p = weights.flatten(new.m), weights.flatten(new.params)
    prog = {"loss": [float(met["loss"])],
            "grad": {k: float(torch.linalg.vector_norm((m[k] - b1 * dev("m/" + k)) / (1 - b1)))
                     for k in m},
            "update": {k: float(torch.linalg.vector_norm(p[k].float() - dev("params/" + k).float()))
                       for k in p}}
    return kept, prog


def build(cell, device):
    """(step, state meta): the program's train step as the cell runs it."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime import train as rt
    rc = session.run_config(cell.config["train"], device)
    trc = rt.TrainRunConfig(opt=OptConfig(**cell.workload["optimizer"]))
    step, state_meta, *_ = rt.build_train_step(ArchConfig(**cell.arch), None,
                                               B=cell.mix["batch"], S=cell.mix["seq_len"],
                                               rc=rc, trc=trc)
    return step, state_meta


def setup(cell, seed: int, device):
    """The step, its state after the check's steps, and the program's readings."""
    from repro_torch.optim.adamw import init_state
    step, meta = build(cell, device)
    session.mark("build")
    feed = traffic.Feed(cell.mix, cell.arch["vocab_size"], seed, device)
    state = init_state(weights.make(meta.params, cell.config, seed, device))
    session.sync(device)
    session.mark("weights")
    b1 = cell.workload["optimizer"]["b1"]
    losses, grad = [], None
    for t in range(CHECK_STEPS):
        state, met = step(state, feed.batch(t))
        losses.append(float(met["loss"]))
        if t == 0:
            grad = {k: n / (1 - b1) for k, n in _norms(state.m).items()}
    prog = {"loss": losses, "grad": grad,
            "update": _update_norms(state.params, meta.params, cell, seed, device)}
    session.mark("check steps")
    return step, state, meta, feed, prog


def run(cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
        controls=()) -> dict:
    """One run. ``controls`` (of ``CONTROLS``): also read each in the
    program's place against the reference (``outcome["controls"]``)."""
    import torch
    step, state, meta, feed, prog = setup(cell, seed, device)
    B, S = cell.mix["batch"], cell.mix["seq_len"]
    losses = []
    i = CHECK_STEPS
    out = {}

    def steps(n):
        nonlocal state, i
        for _ in range(n):
            state, met = step(state, feed.batch(i))
            losses.append(met["loss"])
            i += 1

    session.sync(device)
    start = time.perf_counter()
    setup_s = start - t0
    if trace:
        out["view"] = session.traced(cell, device, steps)
    else:
        while True:
            steps(1)
            if time.perf_counter() - start >= seconds:
                break
    session.sync(device)
    window_s = time.perf_counter() - start
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = session.peak_bytes(device)
    late_t, late_batch = i + 1, feed.batch(i)
    kept, late = late_step(step, state, late_batch, cell.workload["optimizer"]["b1"])
    del state, step, losses
    session.release(device)

    numbers, ctl = {}, {}
    with common.no_tf32():
        for control in (None, *controls):
            first = reference_steps(cell, seed, meta.params, feed, device, control)
            last = reference_late(cell, kept, late_t, late_batch, device, control)
            if control is None:
                ref = (first, last)
                numbers = {**compare.train_numbers(prog, first),
                           **compare.train_numbers(late, last, "late_")}
            else:
                ctl[control] = {**compare.train_numbers(first, ref[0]),
                                **compare.train_numbers(last, ref[1], "late_")}
            session.release(device)
    correct, checks = compare.judge(numbers, cell.workload["limits"])
    n_steps = i - CHECK_STEPS
    return {
        **out,
        "e2e": {"train_tokens_per_s": n_steps * B * S / window_s, "setup_s": setup_s},
        "correct": (correct and failed == 0
                    and all(map(math.isfinite, prog["loss"] + late["loss"]))),
        "attempted": n_steps, "failed": failed, "checks": checks, "numbers": numbers,
        "controls": ctl, "memory_peak_bytes": peak,
    }
