"""Streaming accumulators: flat-memory statistics for the stress tier.

At 1000 workflows a run produces tens of thousands of pod records and
resource samples; appending every observation to a Python list makes
metrics memory grow with run length. ``StreamingStat`` keeps O(1)
state — count / mean / min / max via Welford-style online updates —
plus a fixed-size uniform reservoir so percentiles stay answerable
without retaining the stream.

The reservoir RNG is self-seeded and private: it never touches the
cluster's scheduling RNG, so enabling streaming metrics cannot perturb
the seeded disordered-scheduler sequence.

``StepAccumulator`` (ISSUE 3) is the event-driven replacement for the
0.5 s resource-usage sampler: cluster usage is a piecewise-constant
step function that only changes at pod bind/release, so instead of
polling it on a daemon (whose event count scales with *sim time*), the
accumulator is fed each change and keeps the exact per-level residence
times.  Mean, peak, and time-weighted percentiles then come out in
closed form — exact where the sampler was approximate, and at zero
sim-event cost.  Distinct levels are bounded by the workload's request
quantisation (a few hundred values), so memory stays flat.

Sharded control plane (ISSUE 6): both accumulators are *mergeable*.
``StreamingStat.merge`` composes count/mean/variance exactly (Chan's
parallel update), min/max exactly, and unions the percentile
reservoirs (weighted subsample when the union overflows the
capacity — deterministic, driven by the stat's own private RNG).
``StepAccumulator.merge`` composes two recorded windows as if the
second followed the first: per-level residence times add, the peak is
the max of peaks, so a step stream split at any boundary and merged
equals the unsplit accumulation exactly.  Both types pickle cleanly,
so per-shard partials travel over the result pipe and the parent
reconstructs global summaries (see core/shard.py).
"""
from __future__ import annotations

import random
from typing import Dict, List


class StreamingStat:
    """Online count/mean/min/max + reservoir-sampled percentiles."""

    __slots__ = ("count", "mean", "max", "min", "_m2",
                 "_reservoir", "_capacity", "_rng")

    def __init__(self, reservoir: int = 512, seed: int = 0xC0FFEE):
        self.count = 0
        self.mean = 0.0
        self.max = float("-inf")
        self.min = float("inf")
        self._m2 = 0.0
        self._reservoir: List[float] = []
        self._capacity = reservoir
        self._rng = random.Random(seed)

    def add(self, x: float):
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (x - self.mean)
        if x > self.max:
            self.max = x
        if x < self.min:
            self.min = x
        if len(self._reservoir) < self._capacity:
            self._reservoir.append(x)
        else:
            j = self._rng.randrange(self.count)
            if j < self._capacity:
                self._reservoir[j] = x

    def merge(self, other: "StreamingStat") -> "StreamingStat":
        """Fold ``other`` into self (Chan's parallel variance update).

        count / min / max compose exactly; mean and variance compose
        exactly up to float associativity.  Reservoirs are unioned;
        when the union exceeds capacity a weighted subsample is drawn
        with self's private RNG (each parent's entries are kept with
        probability proportional to the stream size they represent),
        so percentile quality is preserved and the result is
        deterministic for a deterministic merge order.
        """
        if other.count == 0:
            return self
        if self.count == 0:
            self.count = other.count
            self.mean = other.mean
            self._m2 = other._m2
            self.max = other.max
            self.min = other.min
            self._reservoir = list(other._reservoir)
            return self
        n_a, n_b = self.count, other.count
        n = n_a + n_b
        delta = other.mean - self.mean
        self.mean += delta * (n_b / n)
        self._m2 += other._m2 + delta * delta * (n_a * n_b / n)
        self.count = n
        if other.max > self.max:
            self.max = other.max
        if other.min < self.min:
            self.min = other.min
        union = self._reservoir + list(other._reservoir)
        if len(union) > self._capacity:
            # Weighted subsample: items from the larger stream should
            # survive proportionally more often.  Each reservoir item
            # stands for count/len(reservoir) observations.
            w_a = n_a / max(1, len(self._reservoir))
            w_b = n_b / max(1, len(other._reservoir))
            weights = ([w_a] * len(self._reservoir)
                       + [w_b] * len(other._reservoir))
            picked = []
            total_w = sum(weights)
            rng = self._rng
            for _ in range(self._capacity):
                r = rng.random() * total_w
                acc = 0.0
                for i, w in enumerate(weights):
                    acc += w
                    if r <= acc:
                        picked.append(union[i])
                        total_w -= w
                        del union[i], weights[i]
                        break
                else:  # float slack: take the last remaining item
                    picked.append(union.pop())
                    total_w -= weights.pop()
            self._reservoir = picked
        else:
            self._reservoir = union
        return self

    @property
    def variance(self) -> float:
        return self._m2 / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (0-100) from the reservoir."""
        if not self._reservoir:
            return float("nan")
        xs = sorted(self._reservoir)
        idx = min(len(xs) - 1, max(0, round(q / 100.0 * (len(xs) - 1))))
        return xs[idx]

    def __repr__(self):
        return (f"StreamingStat(count={self.count}, mean={self.mean:.4g}, "
                f"min={self.min:.4g}, max={self.max:.4g})")


class StepAccumulator:
    """Exact time-weighted statistics of a step function.

    Feed every level change via ``set(t, level)`` (or close the
    current interval with ``close(t)``); the accumulator integrates
    residence time per level.  All reads are closed-form over the
    recorded intervals ``[start_t, last_t]``.
    """

    __slots__ = ("level", "peak", "start_t", "last_t", "level_dur", "changes")

    def __init__(self, t0: float = 0.0, level: float = 0):
        self.level = level
        self.peak = level
        self.start_t = t0
        self.last_t = t0
        self.level_dur: Dict[float, float] = {}
        self.changes = 0

    def set(self, t: float, level: float):
        dt = t - self.last_t
        if dt > 0.0:
            ld = self.level_dur
            cur = self.level
            ld[cur] = ld.get(cur, 0.0) + dt
            self.last_t = t
        if level != self.level:
            self.changes += 1
            self.level = level
            if level > self.peak:
                self.peak = level

    def add(self, t: float, delta: float):
        self.set(t, self.level + delta)

    def close(self, t: float):
        """Integrate the open interval up to ``t`` (idempotent)."""
        self.set(t, self.level)

    def merge(self, other: "StepAccumulator") -> "StepAccumulator":
        """Compose two recorded windows (self, then other).

        Per-level residence times add, ``peak`` is the max of peaks,
        ``changes`` add, and the recorded span extends by the other's
        span — so an accumulation split at any closed boundary and
        merged equals the unsplit accumulation exactly.  Both sides
        should be ``close``d first; the merged ``level`` is the
        other's final level (the later window).
        """
        ld = self.level_dur
        for lv, d in other.level_dur.items():
            ld[lv] = ld.get(lv, 0.0) + d
        if other.peak > self.peak:
            self.peak = other.peak
        self.changes += other.changes
        self.last_t += other.total_time
        self.level = other.level
        return self

    @property
    def total_time(self) -> float:
        return self.last_t - self.start_t

    def mean(self) -> float:
        tot = self.total_time
        if tot <= 0.0:
            return 0.0
        return sum(lv * d for lv, d in self.level_dur.items()) / tot

    def percentile(self, q: float) -> float:
        """Smallest level the function sits at or below for ``q`` % of
        the recorded time (exact, time-weighted)."""
        if not self.level_dur:
            return float(self.level)
        tot = self.total_time
        target = q / 100.0 * tot
        cum = 0.0
        levels = sorted(self.level_dur)
        for lv in levels:
            cum += self.level_dur[lv]
            if cum >= target - 1e-12 * tot:
                return lv
        return levels[-1]

    def __repr__(self):
        return (f"StepAccumulator(level={self.level}, peak={self.peak}, "
                f"changes={self.changes}, total_time={self.total_time:.4g})")
