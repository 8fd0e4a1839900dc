"""The port's data pipeline against the JAX package's.

``SyntheticLM`` is re-created in the port (the JAX module imports jax):
it must make the same ``np.random.default_rng`` calls in the same order,
so its batches are held bit-equal to the reference's, for every
frontend. ``to_device`` replaces ``shard_batch(batch, None)``.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as jp  # noqa: E402
from repro_torch.data import pipeline as tp  # noqa: E402


@pytest.mark.parametrize("frontend", [None, "audio", "vision"])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_lm_is_bit_equal_to_jax(frontend, seed):
    kw = dict(frontend=frontend, d_model=16, n_img_tokens=5)
    ref = jp.SyntheticLM(jp.DataConfig(3, 24, 1000, seed=seed), **kw)
    got = tp.SyntheticLM(tp.DataConfig(3, 24, 1000, seed=seed), **kw)
    np.testing.assert_array_equal(got.p, ref.p)
    for _ in range(3):
        a, b = next(ref), next(got)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_lm_labels_are_the_next_tokens():
    batch = next(tp.SyntheticLM(tp.DataConfig(2, 10, 50)))
    assert batch["tokens"].dtype == batch["labels"].dtype == np.int32
    np.testing.assert_array_equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    assert batch["tokens"].min() >= 0 and batch["labels"].max() < 50


def test_prefetcher_keeps_order_and_ends():
    items = [{"i": np.full((2,), i)} for i in range(23)]
    pf = tp.Prefetcher(iter(items), depth=3)
    got = [int(b["i"][0]) for b in pf]
    assert got == list(range(23))
    pf.t.join(timeout=10)
    assert not pf.t.is_alive()


def test_prefetcher_over_synthetic_lm_matches_the_stream():
    cfg = tp.DataConfig(2, 8, 100, seed=3)
    direct = tp.SyntheticLM(cfg)
    pf = tp.Prefetcher(tp.SyntheticLM(cfg), depth=2)
    for _ in range(4):
        a, b = next(direct), next(pf)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    pf.close()
    assert isinstance(pf._stop, threading.Event) and pf._stop.is_set()


def test_to_device_keeps_dtypes_and_values():
    batch = next(tp.SyntheticLM(tp.DataConfig(2, 8, 100), frontend="vision",
                                d_model=4, n_img_tokens=3))
    out = tp.to_device(batch, "cpu")
    assert sorted(out) == sorted(batch)
    for k, v in out.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu" and v.is_contiguous()
        assert str(v.dtype).removeprefix("torch.") == str(batch[k].dtype), k
        np.testing.assert_array_equal(v.numpy(), batch[k])
    assert out["tokens"].dtype == out["labels"].dtype == torch.int32
    assert out["img_embeds"].dtype == torch.float32
