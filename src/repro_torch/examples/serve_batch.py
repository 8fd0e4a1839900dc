"""Batched serving under the port's KubeAdaptor engine: the torch twin of
``examples/serve_batch.py``.

Prefill a batch of prompts and decode greedy tokens with the KV cache in
a plain loop, then do the same work as a serving workflow (a prefill
pod, then a decode pod) under ``KubeAdaptorEngine`` with
``payload_mode="real"``. Both grow the cache by ``gen`` slots and take
``gen - 1`` decode steps, as the reference does. Unlike the reference,
the workflow's tokens are required to be bit-equal to the plain loop's:
the geometry, the ops and the kernels are the same.

  PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.dag import Task, Workflow
from repro_torch.core.runner import run_experiment
from repro_torch.examples import PodRuns, sync
from repro_torch.models import RunConfig, build
from repro_torch.runtime.serve import grow_cache


def first_token(logits: torch.Tensor) -> torch.Tensor:
    """The greedy token after a prefill: (B, 1)."""
    return logits[:, -1:].argmax(dim=-1)


def decode_loop(model, params, tok, cache, gen: int):
    """The reference's decode: grow the cache by ``gen`` slots, then take
    ``gen - 1`` greedy steps from ``tok``. Returns (tokens (B, gen), cache)."""
    cache = grow_cache(cache, gen)
    toks = [tok]
    for _ in range(gen - 1):
        logits, cache = model.decode(params, cache, {"tokens": toks[-1]})
        toks.append(logits.argmax(dim=-1))
    return torch.cat(toks, dim=1), cache


def run(cfg, params, prompts: torch.Tensor, *, gen: int, rc: RunConfig) -> dict:
    """Serve ``prompts`` (B, P) with a plain loop, then as a workflow.

    Returns the workflow's tokens and the plain loop's (B, gen each),
    the plain loop's seconds, each pod's seconds and K1 launches, and
    the workflow's virtual lifecycle and order consistency. Raises if
    the two token sets differ or the order is not consistent.
    """
    model = build(cfg, rc)
    B, P = prompts.shape

    # ---- plain serving loop ------------------------------------------
    sync(rc.device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompts})
    plain, cache = decode_loop(model, params, first_token(logits), cache, gen)
    sync(rc.device)
    plain_s = time.perf_counter() - t0
    if tuple(plain.shape) != (B, gen) or cache["pos"] != P + gen - 1:
        raise RuntimeError(f"plain loop: tokens {tuple(plain.shape)}, pos {cache['pos']}")
    del logits, cache

    # ---- the same work as a KubeAdaptor serving workflow ----------------
    results = {}
    pods = PodRuns(rc.device)

    def prefill_pod():
        lg, ch = model.prefill(params, {"tokens": prompts})
        results["cache"] = ch
        results["first"] = first_token(lg)
        return {"prefill_tokens": int(B * P)}

    def decode_pod():
        results["gen"], _ = decode_loop(model, params, results.pop("first"),
                                        results.pop("cache"), gen)
        return {"generated": int(B * gen)}

    tasks = {
        "prefill": Task(id="prefill", outputs=["decode"],
                        payload=pods.payload("prefill", prefill_pod), duration_s=1.0),
        "decode": Task(id="decode", inputs=["prefill"],
                       payload=pods.payload("decode", decode_pod), duration_s=2.0),
    }
    wf = Workflow("serve", tasks)
    res = run_experiment("kubeadaptor", wf, repeats=1, payload_mode="real")
    rec = res.metrics.wf_record(wf.with_instance(0))
    ordered = res.metrics.order_consistent(wf.with_instance(0))
    tokens = results["gen"]
    if not torch.equal(tokens, plain):
        differ = int((tokens != plain).sum())
        raise RuntimeError(f"the workflow's tokens differ from the plain loop's in "
                           f"{differ} of {plain.numel()}")
    if not ordered:
        raise RuntimeError("the serving workflow ran out of its DAG's order")
    return {"tokens": tokens, "plain_tokens": plain, "plain_seconds": plain_s,
            "pod_seconds": {k: v[0] for k, v in pods.by_task("seconds").items()},
            "k1_launches": {k: v[0] for k, v in pods.by_task("k1_launches").items()},
            "lifecycle": rec.lifecycle, "order_consistent": ordered}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    rc = RunConfig(device=args.device)
    model = build(cfg, rc)
    params = model.init(torch.Generator(device=args.device).manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))).to(args.device)

    out = run(cfg, params, prompts, gen=args.gen, rc=rc)
    n = args.batch * args.gen
    print(f"generated {args.batch}x{args.gen} tokens in {out['plain_seconds']:.2f}s "
          f"({n / out['plain_seconds']:.1f} tok/s greedy, {args.device})")
    print(f"serving workflow lifecycle (virtual): {out['lifecycle']:.1f}s, "
          f"pods {out['pod_seconds']}, K1 launches {out['k1_launches']}, "
          f"order_consistent={out['order_consistent']}, tokens equal to the plain loop's")
    print("OK")


if __name__ == "__main__":
    main()
