"""The port on a CUDA card: K1 itself and the reduced model's cache path.

Every test here is marked ``cuda`` and skips without a card. This file
imports no JAX (the machine with the card has none); run it there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

f32 comparisons are made with TF32 off; K1's tolerances are those of
chip_smoke.py (f32 1e-5, bf16 2e-2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,hd", [(2, 200, 200, 14, 64), (1, 128, 96, 4, 32),
                                        (2, 64, 64, 2, 128), (1, 1, 1, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_k1_matches_plain(card, B, S, T, H, hd, dtype, causal):
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn((B, n, H, hd), generator=gen, device=card)
               .to(TORCH_DTYPE[dtype]) for n in (S, T, T))
    before = ops.attention.launches
    out = ops.attention(q, k, v, causal=causal)
    assert ops.attention.launches == before + 1
    expect = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), expect.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_k1_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 8, 2, 64), device=card)
    for bad in (q.half(), q[..., :48].contiguous(), q.transpose(1, 2),
                torch.zeros((1, 8, 2, 96), device=card)):
        with pytest.raises(ValueError):
            ops.attention(bad, bad, bad)


@pytest.mark.cuda
def test_reduced_model_decode_matches_forward_on_card(card):
    cfg = get_config("qwen2-0.5b").reduced()
    model = build(cfg, RunConfig(param_dtype=torch.float32,
                                 compute_dtype=torch.float32, device="cuda"))
    params = model.init(torch.Generator(device=card).manual_seed(0))
    B, S = 2, 12
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(card)
    before = ops.attention.launches
    full, _, _ = model.apply(params, {"tokens": tokens})
    assert ops.attention.launches == before + cfg.n_layers
    cache = model.init_cache(B, S)
    outs = []
    for t in range(S):
        logits, cache = model.decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        outs.append(logits)
    err = (torch.cat(outs, dim=1) - full).abs().max()
    assert float(err) < 2e-3, float(err)
