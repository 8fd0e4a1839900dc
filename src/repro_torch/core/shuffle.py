"""Exact bulk replica of ``random.Random.shuffle`` for hot loops.

The disordered level-2 scheduler (cluster.py) must keep the paper's
"disorderly, scattered" semantics bit-for-bit: the same seeded RNG and
the same draw sequence, so a fixed seed reproduces the same pod->node
binding sequence before and after any optimization. That rules out
fewer draws — but not cheaper ones.

CPython's ``shuffle`` burns one Python-level ``_randbelow`` call per
element: ``k = n.bit_length(); r = getrandbits(k); while r >= n:
r = getrandbits(k)``, and each ``getrandbits(k<=32)`` consumes exactly
one Mersenne-Twister word (``genrand_uint32() >> (32 - k)``).
``ExactShuffler`` consumes the identical word stream, replayed against
a flat buffer of words in genrand order.

Two backends produce that stream:

* native — a small C helper (compiled once with the system cc into
  ``_native/``, loaded via ctypes) carrying its OWN MT19937 core,
  seeded from ``rng.getstate()`` at construction: the exact genrand
  word sequence the wrapped ``random.Random`` would have produced, but
  generated straight into a reusable uint32 buffer (no bignum
  assembly, no ``to_bytes`` copy).  On top of the word stream the
  helper fuses the whole disordered-scheduler cycle
  (``ka_schedule_cycle``): the pending-pod shuffle, the per-pod node
  reshuffle, the first-fit capacity scan and the in-place charging all
  run in one call — only the resulting binds come back to Python.
* python — ``rng.getrandbits(32 * N)`` bulk fetches unpacked into
  tuples (used when no compiler is available, or under
  ``REPRO_SHUFFLE_NO_NATIVE=1``); the pure-Python cycle in cluster.py
  is the semantic reference for the fused native cycle.

Both produce identical permutations and identical word consumption —
pinned against ``random.shuffle`` by tests/test_scale_core.py, and the
fused cycle is pinned transitively by every binding-sequence hash
(tests/test_scale_core.py, tests/test_policy_pipeline.py,
tests/test_informer_views.py), which run on the native path wherever a
compiler exists and on the fallback in CI's no-native job.

Chaos-plane interaction (ISSUE 7): node loss removes capacity from
the fused cycle without touching the word stream.  ``kill_node`` /
``drain_node`` zero the node's slot in the ``ready[]`` array the
native cycle consults (both in its cycle-start free-capacity maxima
and in the first-fit check), exactly as ``fail_node`` always has, and
``restore_node`` writes it back — so a cordoned node is simply never
bound to while every shuffle still consumes its full draw sequence.
That is what keeps a chaos-free run bit-identical to PR 6 and a fixed
chaos seed exactly replayable: chaos draws come from a separate
sha256-spawned stream (core/chaos.py) and the scheduler RNG's
consumption schedule never changes.

The elastic autoscaler (ISSUE 9) rides the exact same contract: the
FULL max roster is materialized at cluster build, so the native
arrays keep their fixed node indices for the whole run, and
``provision_node`` / ``deprovision_node`` only flip the node's
``ready[]`` slot (plus the free-capacity words) through the same
``restore_node`` / ``drain_node`` writes chaos uses.  A deprovisioned
node is never bound to, every shuffle still consumes its full draw
sequence, and the daemon itself draws nothing — an autoscaler-free
run is bit-identical to PR 8 and an autoscaled run is a pure
function of the seed on both backends.

Scored placement (ISSUE 8) follows the same word-stream discipline:
``placement="scored-spread"`` / ``"scored-pack"`` change ONLY which
node the fused cycle picks (an integer least-allocated score over the
per-node alloc arrays), never how many words any shuffle consumes —
so first-fit stays bit-identical to every pinned hash and a scored
run is the same pure function of the seed on both backends.

The wrapped ``random.Random`` must have no other consumers while a
shuffler is attached (the python backend buffers words ahead; the
native backend forks the generator state at construction and never
consumes the Python object again).  The cluster's scheduling RNG
satisfies this — it is consumed exclusively by the scheduler's
shuffles.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import random
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

_WORDS_PER_FETCH = 4096
_UNPACK = struct.Struct(f"<{_WORDS_PER_FETCH}I").unpack

# _SHIFT[n] = 32 - n.bit_length(): getrandbits(k) == word >> _SHIFT[n]
_SHIFT: List[int] = [32, 31]


def _ensure_shift(n: int) -> None:
    while len(_SHIFT) <= n:
        _SHIFT.append(32 - len(_SHIFT).bit_length())


# ---------------------------------------------------------------------------
# native backend: MT19937 word stream + fused Fisher-Yates/scatter cycle
# ---------------------------------------------------------------------------
_C_SRC = r"""
#include <stdint.h>

/* MT19937 core, bit-identical to CPython's _randommodule.c genrand
 * stream.  `state` is the 625-word layout of random.Random.getstate():
 * state[0..623] = mt[], state[624] = mti (624 means "twist before the
 * next draw"). */
#define MT_N 624
#define MT_M 397
#define MATRIX_A   0x9908b0dfU
#define UPPER_MASK 0x80000000U
#define LOWER_MASK 0x7fffffffU

static uint32_t mt_next(uint32_t *state)
{
    uint32_t *mt = state;
    uint32_t mti = state[MT_N];
    uint32_t y;
    if (mti >= MT_N) {
        int kk;
        for (kk = 0; kk < MT_N - MT_M; kk++) {
            y = (mt[kk] & UPPER_MASK) | (mt[kk + 1] & LOWER_MASK);
            mt[kk] = mt[kk + MT_M] ^ (y >> 1) ^ ((y & 1U) ? MATRIX_A : 0U);
        }
        for (; kk < MT_N - 1; kk++) {
            y = (mt[kk] & UPPER_MASK) | (mt[kk + 1] & LOWER_MASK);
            mt[kk] = mt[kk + (MT_M - MT_N)] ^ (y >> 1)
                     ^ ((y & 1U) ? MATRIX_A : 0U);
        }
        y = (mt[MT_N - 1] & UPPER_MASK) | (mt[0] & LOWER_MASK);
        mt[MT_N - 1] = mt[MT_M - 1] ^ (y >> 1) ^ ((y & 1U) ? MATRIX_A : 0U);
        mti = 0;
    }
    y = mt[mti++];
    state[MT_N] = mti;
    y ^= (y >> 11);
    y ^= (y << 7) & 0x9d2c5680U;
    y ^= (y << 15) & 0xefc60000U;
    y ^= (y >> 18);
    return y;
}

/* Refill the shared word buffer from the generator state.  The Python
 * side and the fused cycle below both consume through this buffer, so
 * the global word order is a single stream regardless of which entry
 * point drains it. */
void ka_mt_fill(uint32_t *state, uint32_t *words, long n)
{
    for (long i = 0; i < n; i++)
        words[i] = mt_next(state);
}

static inline uint32_t next_word(uint32_t *state, uint32_t *words,
                                 long n_words, long *pos)
{
    if (*pos >= n_words) {
        ka_mt_fill(state, words, n_words);
        *pos = 0;
    }
    return words[(*pos)++];
}

/* Replay random.shuffle's draw stream for a list of `length`, applying
 * the swaps to `perm`.  Draws flow through the shared buffer; the word
 * cursor is read from and written back to *pos_io. */
void ka_draw_apply(uint32_t *state, uint32_t *words, long n_words,
                   long *pos_io, long length, int32_t *perm)
{
    long pos = *pos_io;
    long top = length - 1;
    for (long j = 0; j < top; j++) {
        uint32_t n = (uint32_t)(length - j);
        int shift = __builtin_clz(n);           /* 32 - bit_length(n) */
        uint32_t r;
        do {
            r = next_word(state, words, n_words, &pos) >> shift;
        } while (r >= n);
        int32_t i = (int32_t)(length - 1 - j);
        int32_t tmp = perm[i];
        perm[i] = perm[r];
        perm[r] = tmp;
    }
    *pos_io = pos;
}

/* Utilization score scale: integer fixed-point so the C kernel and
 * the pure-Python reference agree bit-for-bit (truncating division of
 * non-negative operands == Python //). */
#define KA_SCORE_SCALE (1 << 20)

/* One fused disordered-scheduler cycle, identical to the pure-Python
 * reference in cluster.py:
 *   1. shuffle `pod_perm` (identity-initialized here) with exactly the
 *      draws random.shuffle(pending) would consume;
 *   2. for each pod in that shuffled order: reshuffle the node `perm`
 *      (same continuous stream), then scan it against the
 *      free-capacity arrays — first-fit (score_mode 0) or
 *      least-allocated scored (1 = spread: maximize post-bind free
 *      fraction; 2 = pack: minimize it) — charging the chosen node in
 *      place so later pods of the cycle see earlier binds;
 *   3. record the chosen node index (or -1) in bind_out[j] for the
 *      j-th pod of the SHUFFLED order (its original index is
 *      pod_perm[j]).
 * The scored modes consume the IDENTICAL draw stream as first-fit:
 * only node selection changes, never word consumption.  Ties on the
 * integer score go to the earliest position in the shuffled `perm`
 * (strict comparison), keeping the choice a pure function of the
 * draws + capacities.  The cycle-start free maxima skip the scan
 * (never the draws) for pods that provably fit no node — the same
 * upper-bound argument the Python reference uses. */
void ka_schedule_cycle(uint32_t *state, uint32_t *words, long n_words,
                       long *pos_io, long n_nodes, int32_t *perm,
                       int32_t *free_cpu, int32_t *free_mem,
                       const uint8_t *ready,
                       const int32_t *alloc_cpu, const int32_t *alloc_mem,
                       int32_t score_mode,
                       long n_pods, int32_t *pod_perm,
                       const int32_t *pod_cpu, const int32_t *pod_mem,
                       int32_t *bind_out)
{
    long pos = *pos_io;
    for (long j = 0; j < n_pods; j++)
        pod_perm[j] = (int32_t)j;
    long ptop = n_pods - 1;
    for (long j = 0; j < ptop; j++) {
        uint32_t n = (uint32_t)(n_pods - j);
        int shift = __builtin_clz(n);
        uint32_t r;
        do {
            r = next_word(state, words, n_words, &pos) >> shift;
        } while (r >= n);
        int32_t i = (int32_t)(n_pods - 1 - j);
        int32_t tmp = pod_perm[i];
        pod_perm[i] = pod_perm[r];
        pod_perm[r] = tmp;
    }
    int32_t max_cpu = 0, max_mem = 0;     /* cycle-start upper bounds */
    for (long s = 0; s < n_nodes; s++) {
        if (!ready[s]) continue;
        if (free_cpu[s] > max_cpu) max_cpu = free_cpu[s];
        if (free_mem[s] > max_mem) max_mem = free_mem[s];
    }
    long ntop = n_nodes - 1;
    for (long j = 0; j < n_pods; j++) {
        for (long elem = 0; elem < ntop; elem++) {
            uint32_t n = (uint32_t)(n_nodes - elem);
            int shift = __builtin_clz(n);
            uint32_t r;
            do {
                r = next_word(state, words, n_words, &pos) >> shift;
            } while (r >= n);
            int32_t i = (int32_t)(n_nodes - 1 - elem);
            int32_t tmp = perm[i];
            perm[i] = perm[r];
            perm[r] = tmp;
        }
        long p = pod_perm[j];
        int32_t cpu = pod_cpu[p], mem = pod_mem[p];
        int32_t chosen = -1;
        if (cpu <= max_cpu && mem <= max_mem) {
            if (score_mode == 0) {
                for (long s = 0; s < n_nodes; s++) {
                    int32_t idx = perm[s];
                    if (ready[idx] && free_cpu[idx] >= cpu
                            && free_mem[idx] >= mem) {
                        chosen = idx;
                        break;
                    }
                }
            } else {
                int64_t best_score = 0;
                for (long s = 0; s < n_nodes; s++) {
                    int32_t idx = perm[s];
                    if (!ready[idx] || free_cpu[idx] < cpu
                            || free_mem[idx] < mem)
                        continue;
                    int64_t fc = (int64_t)(free_cpu[idx] - cpu);
                    int64_t fm = (int64_t)(free_mem[idx] - mem);
                    int64_t score = fc * KA_SCORE_SCALE / alloc_cpu[idx]
                                    + fm * KA_SCORE_SCALE / alloc_mem[idx];
                    if (chosen < 0
                            || (score_mode == 1 ? score > best_score
                                                : score < best_score)) {
                        chosen = idx;
                        best_score = score;
                    }
                }
            }
            if (chosen >= 0) {
                free_cpu[chosen] -= cpu;
                free_mem[chosen] -= mem;
            }
        }
        bind_out[j] = chosen;
    }
    *pos_io = pos;
}
"""

_NATIVE_DIR = Path(__file__).resolve().parent / "_native"
_native_lib = None
_native_tried = False

_U32P = ctypes.POINTER(ctypes.c_uint32)
_I32P = ctypes.POINTER(ctypes.c_int32)
_LONGP = ctypes.POINTER(ctypes.c_long)


def _load_native():
    """The native helper's (fill, draw, cycle), built with ``cc`` at first use.

    ``REPRO_SHUFFLE_NO_NATIVE`` (read once) selects the pure-Python
    backend, which is bit-exact with the native one. Otherwise a build
    or load that fails raises ``RuntimeError`` carrying the compiler's
    stderr, on this call and every later one: nothing falls back to the
    Python backend in silence.
    """
    global _native_lib, _native_tried
    if _native_tried:
        return _native_lib
    if os.environ.get("REPRO_SHUFFLE_NO_NATIVE"):
        _native_tried = True
        return None
    tag = hashlib.sha256(_C_SRC.encode()).hexdigest()[:16]
    so_path = _NATIVE_DIR / f"ka_shuffle_{tag}.so"
    if not so_path.exists():
        _NATIVE_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(
                "w", suffix=".c", dir=str(_NATIVE_DIR),
                delete=False) as f:
            f.write(_C_SRC)
            c_path = f.name
        # a per-process output, so that processes building at once (test
        # workers) never replace each other's half-written file
        tmp_path = f"{so_path}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["cc", "-O2", "-shared", "-fPIC", "-o", tmp_path, c_path],
                check=True, capture_output=True, text=True, timeout=60)
            os.replace(tmp_path, so_path)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"cc failed to build the native shuffle helper "
                               f"(exit {e.returncode}):\n{e.stderr}") from e
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"cc could not build the native shuffle "
                               f"helper: {e}") from e
        finally:
            os.unlink(c_path)
            if os.path.exists(tmp_path):    # what a failed build left
                os.unlink(tmp_path)
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError as e:
        raise RuntimeError(f"cannot load the native shuffle helper "
                           f"{so_path}: {e}") from e
    fill = lib.ka_mt_fill
    fill.restype = None
    fill.argtypes = [_U32P, _U32P, ctypes.c_long]
    draw = lib.ka_draw_apply
    draw.restype = None
    draw.argtypes = [_U32P, _U32P, ctypes.c_long, _LONGP,
                     ctypes.c_long, _I32P]
    cycle = lib.ka_schedule_cycle
    cycle.restype = None
    cycle.argtypes = [_U32P, _U32P, ctypes.c_long, _LONGP,
                      ctypes.c_long, _I32P, _I32P, _I32P,
                      ctypes.POINTER(ctypes.c_uint8),
                      _I32P, _I32P, ctypes.c_int32,
                      ctypes.c_long, _I32P, _I32P, _I32P, _I32P]
    _native_lib = (fill, draw, cycle)
    _native_tried = True
    return _native_lib


class ExactShuffler:
    """Drop-in ``shuffle`` with bit-identical draws from a bulk buffer."""

    __slots__ = ("rng", "_raw", "_words", "_pos", "_fill", "_draw",
                 "_native_cycle", "_state", "_buf", "_posbox", "_posref",
                 "_identity", "_perm_pool")

    def __init__(self, rng: random.Random, native: Optional[bool] = None):
        self.rng = rng
        self._raw = b""
        self._words: Optional[Sequence[int]] = ()
        self._pos = _WORDS_PER_FETCH       # empty: first use refills
        fns = _load_native() if native is not False else None
        if native is True and fns is None:
            raise RuntimeError("native shuffle backend unavailable")
        self._fill, self._draw, self._native_cycle = fns if fns else \
            (None, None, None)
        if self._fill is not None:
            # fork the generator: the C core continues the exact word
            # stream from the wrapped rng's current state, and the
            # Python object is never consumed again (see module doc)
            key = rng.getstate()[1]        # 624 mt words + index
            self._state = (ctypes.c_uint32 * 625)(*key)
            self._buf = (ctypes.c_uint32 * _WORDS_PER_FETCH)()
        else:
            self._state = self._buf = None
        self._posbox = ctypes.c_long(_WORDS_PER_FETCH)
        self._posref = ctypes.byref(self._posbox)
        self._identity: dict = {}          # length -> identity perm bytes
        self._perm_pool: dict = {}         # length -> reusable perm buffer

    @property
    def backend(self) -> str:
        return "native" if self._fill is not None else "python"

    # ---- python word buffer ------------------------------------------------
    def _refill(self):
        raw = self.rng.getrandbits(32 * _WORDS_PER_FETCH)
        self._raw = raw.to_bytes(4 * _WORDS_PER_FETCH, "little")
        self._words = None                 # unpacked lazily
        self._pos = 0

    def _word_tuple(self) -> Sequence[int]:
        if self._words is None:
            self._words = _UNPACK(self._raw)
        return self._words or ()

    # ---- permutation API (both backends) ----------------------------------
    def make_perm(self, n: int):
        """An identity permutation draw_apply can mutate: int32 ctypes
        array (native) or plain list (python)."""
        if self._fill is not None:
            arr = (ctypes.c_int32 * n)(*range(n))
            return arr
        return list(range(n))

    def reset_perm(self, perm, n: int):
        if self._fill is not None:
            ident = self._identity.get(n)
            if ident is None:
                ident = self._identity[n] = struct.pack(f"<{n}i", *range(n))
            ctypes.memmove(perm, ident, 4 * n)
        else:
            perm[:] = range(n)

    def draw_apply(self, perm, n: int) -> None:
        """Consume exactly the words ``rng.shuffle`` would for a list of
        ``n`` and apply the identical Fisher-Yates swaps to ``perm``."""
        if n < 2:
            return
        if self._fill is not None:
            self._draw(self._state, self._buf, _WORDS_PER_FETCH,
                       self._posref, n, perm)
        else:
            apply_swaps(perm, self.draw_swaps(n))

    def schedule_cycle(self, perm, n_nodes: int, free_cpu, free_mem, ready,
                       alloc_cpu, alloc_mem, score_mode: int,
                       n_pods: int, pod_perm, pod_cpu, pod_mem,
                       bind_out) -> None:
        """Fused native scatter cycle: shuffle the pending order into
        ``pod_perm`` (identity-initialized C-side), then per pod
        reshuffle ``perm`` and scan the free arrays — first-fit
        (``score_mode=0``) or utilization-scored least-allocated
        (``1`` spread / ``2`` pack, over the per-node ``alloc_*``
        capacities) — charging them in place; ``bind_out[j]`` gets the
        node index (or -1) for the pod originally at index
        ``pod_perm[j]``.  Identical draw stream to ``shuffle(pending)``
        + per-pod ``draw_apply`` in every mode, and identical binds to
        the matching Python scan in cluster.py.  Callers must check
        :attr:`has_native_cycle`."""
        self._native_cycle(self._state, self._buf, _WORDS_PER_FETCH,
                           self._posref, n_nodes, perm, free_cpu, free_mem,
                           ready, alloc_cpu, alloc_mem, score_mode,
                           n_pods, pod_perm, pod_cpu, pod_mem,
                           bind_out)

    @property
    def has_native_cycle(self) -> bool:
        return self._native_cycle is not None

    # ---- python draw path --------------------------------------------------
    def draw_swaps(self, length: int) -> List[int]:
        """Consume exactly the words ``shuffle`` would for a list of
        ``length``, returning the Fisher-Yates targets ``[r_{L-1} ..
        r_1]`` without applying them.  Python backend only — the native
        backend's word stream lives in the C state."""
        if length < 2:
            return []
        if length >= len(_SHIFT):
            _ensure_shift(length)
        shift_tab = _SHIFT
        words = self._word_tuple()
        pos = self._pos
        end = len(words)
        out = []
        append = out.append
        for i in range(length - 1, 0, -1):
            n = i + 1
            shift = shift_tab[n]
            while True:
                if pos >= end:
                    self._refill()
                    words = self._word_tuple()
                    pos = 0
                    end = len(words)
                r = words[pos] >> shift
                pos += 1
                if r < n:
                    break
            append(r)
        self._pos = pos
        return out

    def shuffle(self, x: list) -> None:
        """Identical permutation to ``self.rng.shuffle(x)`` (same seed,
        same consumed word stream), minus the per-draw call overhead."""
        n = len(x)
        if n < 2:
            return
        if self._fill is not None:
            perm = self._perm_pool.get(n)
            if perm is None:
                perm = self._perm_pool[n] = self.make_perm(n)
            else:
                self.reset_perm(perm, n)
            self.draw_apply(perm, n)
            x[:] = [x[i] for i in perm]
        else:
            apply_swaps(x, self.draw_swaps(n))


def apply_swaps(x, swaps: Sequence[int]) -> None:
    """Apply Fisher-Yates targets from :meth:`ExactShuffler.draw_swaps`
    (equivalent to the shuffle those draws encode)."""
    i = len(x) - 1
    for r in swaps:
        x[i], x[r] = x[r], x[i]
        i -= 1
