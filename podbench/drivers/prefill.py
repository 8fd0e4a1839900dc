"""A prefill pod: the program's prefill step (``runtime.serve.
build_prefill_step``, no mesh) as a closed loop, one client with a queue
of documents. Each batch of the mix is sent when the last one's first
tokens are on the host; a request's first token is the argmax of its
last-position logits over the vocabulary.

``ttft_p95_ms``: the 95th percentile, over every request of the window,
of the time from when its batch was sent to when its first token is on
the host. ``prefill_tokens_per_s``: every prompt token prefilled in the
window over the window's time. A sample of the window's batches, drawn
from the seed, keeps its logits and the cache it hands to decode; after
the window the reference runs over the same prompts
(``compare.PrefillTally``).
"""
from __future__ import annotations

import math
import random
import time

from podbench import compare, session, traffic, weights
from podbench.reference import common
from podbench.reference import model as ref_model

CONTROLS = ("fp8",)     # what ``run(controls=...)`` can put in the program's place


def cache_leaves(cache, prefix: str = "") -> dict:
    """Every tensor leaf of the program's cache, by its path: "k", "v",
    "ssm/ssd", "ssm/conv_x", ... (a named tuple's fields by name). The
    position counter, a host number, is left out."""
    import torch
    out = {}
    for k, v in cache.items():
        if torch.is_tensor(v):
            out[prefix + k] = v
        elif isinstance(v, dict) or hasattr(v, "_asdict"):
            out.update(cache_leaves(v if isinstance(v, dict) else v._asdict(), f"{prefix}{k}/"))
        elif not isinstance(v, (int, float)):
            raise TypeError(f"cache leaf {prefix + k!r} is a {type(v).__name__}")
    return out


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class Sample:
    """A uniform sample of ``k`` of the window's batches (reservoir sampling
    drawn from the seed): only the kept batches' outputs stay alive."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


def build(cell, device):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.runtime import serve as rs
    rc = session.run_config(cell.config["serve"], device)
    step, meta, *_ = rs.build_prefill_step(ArchConfig(**cell.arch), None,
                                           B=cell.mix["batch"], S=cell.mix["seq_len"], rc=rc)
    return step, meta


def serve_one(step, params, batch, vocab: int):
    """One request batch: (logits (B, Vp), cache, first tokens and finite
    flags on the host (2, B))."""
    import torch
    logits, cache = step(params, batch)
    last = logits[:, -1, :]
    host = torch.stack([last[:, :vocab].argmax(-1),
                        torch.isfinite(last).all(-1).long()]).cpu()
    return last, cache, host


def tally(cell, seed: int, meta, feed, sampled, device, mm) -> compare.PrefillTally:
    """The sampled batches' outputs (batch index, last logits, cache
    leaves, first tokens) against the reference's, run over the same
    prompts from the seed's weights in precision ``mm``."""
    import torch
    t = compare.PrefillTally()
    params = weights.make(meta, cell.config, seed, device)
    with torch.no_grad():
        for i, last, cache, served in sampled:
            tokens = feed.batch(i)["tokens"]
            ref_last, ref_cache = ref_model.prefill(params, cell.arch, tokens, mm,
                                                    cell.config["reference"])
            if set(cache) != set(ref_cache):
                raise KeyError(f"the cache's leaves {sorted(cache)} are not the "
                               f"reference's {sorted(ref_cache)}")
            t.add("logits", last, ref_last)
            for name, got in cache.items():
                t.add(name, got, ref_cache[name])
            t.add_tokens(served, ref_last, cell.arch["vocab_size"])
            del ref_cache
    return t


def control_outputs(cell, seed: int, meta, feed, sampled, device, control: str) -> list:
    """The sampled batches as ``control`` would serve them: the reference
    with fp8 products in the program's place."""
    import torch
    assert control in CONTROLS
    params = weights.make(meta, cell.config, seed, device)
    out = []
    with torch.no_grad():
        for i, *_ in sampled:
            last, cache = ref_model.prefill(params, cell.arch, feed.batch(i)["tokens"],
                                            common.fp8, cell.config["reference"])
            out.append((i, last, cache, last[:, :cell.arch["vocab_size"]].argmax(-1)))
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
        controls=()) -> dict:
    """One run. ``controls`` (of ``CONTROLS``): also read each in the
    program's place against the reference (``outcome["controls"]``)."""
    step, meta = build(cell, device)
    session.mark("build")
    params = weights.make(meta, cell.config, seed, device)
    vocab = cell.arch["vocab_size"]
    feed = traffic.Feed(cell.mix, vocab, seed, device)
    session.sync(device)
    session.mark("weights")
    for k in range(cell.workload["warmup_batches"]):
        serve_one(step, params, feed.batch(k, traffic.Feed.WARMUP), vocab)
    session.mark("warm-up")
    sample = Sample(cell.workload["check"]["batches"], seed)
    B, S = cell.mix["batch"], cell.mix["seq_len"]
    ttft, failed, i, out = [], 0, 0, {}

    def one():
        nonlocal failed, i
        batch = feed.batch(i)
        sent = time.perf_counter()
        last, cache, host = serve_one(step, params, batch, vocab)
        done = time.perf_counter()
        ttft.extend([done - sent] * B)
        failed += B - int(host[1].sum())
        sample.offer((i, last, cache_leaves(cache), host[0]))
        i += 1
        return done

    def batches(n):
        for _ in range(n):
            one()

    session.sync(device)
    start = time.perf_counter()
    setup_s = start - t0
    if trace:
        out["view"] = session.traced(cell, device, batches)
    else:
        while one() - start < seconds:
            pass
    window_s = time.perf_counter() - start
    peak = session.peak_bytes(device)
    del params, step
    session.release(device)

    ctl = {}
    with common.no_tf32():
        numbers = tally(cell, seed, meta, feed, sample.kept, device, common.exact).numbers()
        for control in controls:
            low = control_outputs(cell, seed, meta, feed, sample.kept, device, control)
            ctl[control] = tally(cell, seed, meta, feed, low, device, common.exact).numbers()
            del low
            session.release(device)
    correct, checks = compare.judge(numbers, cell.workload["limits"])
    return {
        **out,
        "e2e": {"ttft_p95_ms": p95(ttft) * 1e3, "prefill_tokens_per_s": i * B * S / window_s,
                "setup_s": setup_s},
        "correct": correct and failed == 0,
        "attempted": i * B, "failed": failed, "checks": checks, "numbers": numbers,
        "controls": ctl, "memory_peak_bytes": peak,
    }
