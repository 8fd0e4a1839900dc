"""The numbers that decide ``correct``, each held to its limit.

Training (the first three steps of the timed step, against the reference
following them): ``loss_gap``, the largest gap in nats between the
program's and the reference's loss over the three; ``grad_gap``, the
worst leaf's gap between the norms of the first gradient as the optimizer
takes it (clipped; the program's worked out from its first moment after
one step, m1 / (1 - b1)); ``update_gap``, the worst leaf's gap between the
norms of the parameters' change after three steps. The same numbers with
``late_`` before them hold the step taken after the window, from the
state the window left, against the reference's step from that state (the
gradient from the moments, (m' - b1 m) / (1 - b1); the change of that
step alone). A leaf's gap is taken against the larger of the reference's
norm of that leaf and the median leaf's. ``grad_gap_median`` is the
median leaf's gap: the worst leaf's swings from seed to seed, the median
leaf's moves with the precision of the products. Leaves whose reference
gradient is under a thousandth of the median leaf's move under Adam by
round-off alone and are left out of ``update_gap``.

A prefill (the sampled requests of the window against the reference run
over the same prompts): ``logits_err``, the norm of the difference of the
last-position logits over the norm of the reference's; ``cache_err``, the
same for each leaf of the cache handed to decode, the worst leaf;
``token_gap``, the widest gap by which a served first token's reference
logit lies below the reference's best.
"""
from __future__ import annotations

import math
import statistics
from collections import defaultdict

ROUND_OFF_GRAD = 1e-3


def leaf_gaps(prog: dict, ref: dict, leaves) -> list:
    floor = statistics.median(ref.values())
    return [abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in leaves]


def train_numbers(prog: dict, ref: dict, prefix: str = "") -> dict:
    """``prog`` and ``ref`` each hold "loss" (a float a step), "grad" and
    "update" ({leaf: norm}); each number's name begins with ``prefix``."""
    median_g = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= ROUND_OFF_GRAD * median_g]
    grad = leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    numbers = {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": max(grad),
        "grad_gap_median": statistics.median(grad),
        "update_gap": max(leaf_gaps(prog["update"], ref["update"], moving)),
    }
    return {prefix + k: v for k, v in numbers.items()}


class PrefillTally:
    """Sums of squares of the differences and of the reference, by leaf,
    and the served tokens' gaps, over the sampled requests."""

    def __init__(self):
        self.diff = defaultdict(float)
        self.ref = defaultdict(float)
        self.gaps = []

    def add(self, leaf: str, got, want) -> None:
        got, want = got.float(), want.float()
        self.diff[leaf] += float((got - want).square().sum())
        self.ref[leaf] += float(want.square().sum())

    def add_tokens(self, served, ref_logits, vocab_size: int) -> None:
        """``served`` (B,) first tokens; ``ref_logits`` (B, Vp)."""
        real = ref_logits[:, :vocab_size].float()
        best = real.max(dim=-1).values
        got = real.gather(-1, served.long().to(real.device)[:, None])[:, 0]
        self.gaps += (best - got).tolist()

    def numbers(self) -> dict:
        def rel(leaf):
            return math.sqrt(self.diff[leaf] / max(self.ref[leaf], 1e-30))
        cache = [k for k in self.diff if k != "logits"]
        return {
            "logits_err": rel("logits"),
            "cache_err": max(rel(k) for k in cache),
            "token_gap": max(self.gaps),
        }


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number finite and within its limit; the
    checks as {name: {"value", "limit"}}, in ``limits``' order."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
