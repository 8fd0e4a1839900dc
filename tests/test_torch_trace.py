"""The port's spans (``repro_torch.trace``) on the CPU, at tiny widths.

Under ``torch.profiler`` a train step with remat gives each span its count
(one ``train_step``, ``loss_and_grad``, ``adamw``, ``head``, ``ce`` and
``head.bwd``; a ``block`` and a ``block.recompute`` a layer), a prefill
and a decode step theirs, and the hybrid's stack a ``block`` a layer and a
shared-block application. The spans change no number: loss, gradients and
the new state are bit-equal with the profiler on and off. With no profiler
no range is entered and the loss's autograd graph holds the nodes it holds
without the spans; under one it holds two more, the marks of ``head.bwd``.
"""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

B, S = 2, 8


def _model(arch, n_layers):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers)
    return build(cfg, RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32,
                                device="cpu", ssd_chunk=8, remat=True, remat_policy="full"))


def _state_and_batch(model):
    state = ta.init_state(model.init(torch.Generator().manual_seed(0)))
    toks = torch.randint(0, model.cfg.vocab_size, (B, S + 1),
                         generator=torch.Generator().manual_seed(1))
    return state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _step(model):
    return ttrain.make_train_step(model, ttrain.TrainRunConfig(opt=ta.OptConfig()))


def _spans(prof) -> collections.Counter:
    return collections.Counter(e.name[len(trace.PREFIX):] for e in prof.events()
                               if e.name.startswith(trace.PREFIX))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module")
def dense():
    model = _model("qwen2-1.5b", 2)
    return model, *_state_and_batch(model)


def test_a_train_step_gives_each_span_its_count(dense):
    model, state, batch = dense
    step = _step(model)
    _, prof = _traced(lambda: step(state, batch))
    L = model.cfg.n_layers
    assert _spans(prof) == {"train_step": 1, "loss_and_grad": 1, "adamw": 1, "head": 1,
                            "ce": 1, "head.bwd": 1, "block": L, "block.recompute": L}
    ev = {e.name: e for e in prof.events()}
    outer, bwd = ev["repro_torch.loss_and_grad"].time_range, ev["repro_torch.head.bwd"]
    assert outer.start <= bwd.time_range.start and bwd.time_range.end <= outer.end
    # the CE's and the head product's backward nodes run inside head.bwd
    under = {c.name for c in bwd.cpu_children}
    assert any("LogsumexpBackward" in n for n in under) and any("MmBackward" in n for n in under)
    recomputes = [e for e in prof.events() if e.name == "repro_torch.block.recompute"]
    assert len(recomputes) == L
    assert all(e.time_range.start >= bwd.time_range.end for e in recomputes)


def test_prefill_and_decode_give_their_spans(dense):
    model, state, batch = dense
    L = model.cfg.n_layers
    (_, cache), prof = _traced(lambda: model.prefill(state.params, batch))
    assert _spans(prof) == {"prefill": 1, "block": L, "head": 1}
    big = model.init_cache(B, S + 1)
    for name in ("k", "v"):
        big[name][:, :, :S] = cache[name]
    big["pos"] = S
    _, prof = _traced(lambda: model.decode(state.params, big, {"tokens": batch["tokens"][:, :1]}))
    assert _spans(prof) == {"decode": 1, "block": L, "head": 1}


def test_the_hybrid_stack_gives_block_its_count():
    model = _model("zamba2-1.2b", 2)
    state, batch = _state_and_batch(model)
    _, prof = _traced(lambda: _step(model)(state, batch))
    cfg = model.cfg
    shared = cfg.n_layers // cfg.attn_every          # full segments only: one
    spans = _spans(prof)
    # the shared block is not rematted: no recompute of it
    assert spans["block"] == cfg.n_layers + shared
    assert spans["block.recompute"] == cfg.n_layers
    assert spans["train_step"] == spans["head.bwd"] == 1


def test_the_profiler_changes_no_number(dense):
    model, state, batch = dense
    step = _step(model)
    loss0, g0 = ttrain.value_and_grad(model.loss, state.params, batch)
    new0, met0 = step(state, batch)
    (loss1, g1), _ = _traced(lambda: ttrain.value_and_grad(model.loss, state.params, batch))
    (new1, met1), _ = _traced(lambda: step(state, batch))
    assert torch.equal(loss0, loss1)
    for a, b in zip(tree_leaves(g0) + tree_leaves(new0), tree_leaves(g1) + tree_leaves(new1)):
        assert torch.equal(a, b)
    assert all(torch.equal(met0[k], met1[k]) for k in met0)


def _graph(loss) -> collections.Counter:
    seen, todo, names = set(), [loss.grad_fn], collections.Counter()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names[type(node).__name__] += 1
        todo.extend(n for n, _ in node.next_functions)
    return names


def test_without_a_profiler_no_span_is_entered(dense, monkeypatch):
    model, state, batch = dense
    assert trace.span("block") is trace.span("head") is trace.recompute()  # one no-op
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", entered.append)
    new, _ = _step(model)(state, batch)          # forward, recompute, backward, AdamW
    model.prefill(state.params, batch)
    assert entered == [] and int(new.step) == 1
    monkeypatch.undo()
    live = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
    bare = _graph(model.loss(live, batch))
    traced, _ = _traced(lambda: _graph(model.loss(live, batch)))
    assert "_MarkBackward" not in bare
    assert traced - bare == {"_MarkBackward": 2} and not bare - traced
