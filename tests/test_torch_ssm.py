"""Parity of the port's Mamba2 layers, and of K2's plain versions, with the JAX package.

The same numpy inputs go through ``repro.models.ssm`` / ``repro.kernels``
(JAX on the CPU; the Pallas SSD kernel in interpret mode, as
``tests/test_kernels.py`` runs it) and through ``repro_torch`` with
device="cpu", where ``ops.ssd`` takes K2's plain version,
``models.ssm.ssd_chunked``. Weights are made by the JAX package and moved
with ``convert.params_from_jax``.

Tolerances (absolute and relative). f32: 1e-5 for the layers and the
sequential recurrence, 1e-4 for ``apply_mamba``; against the Pallas
kernel, 2e-4 (f32) and 5e-2 (bf16), the JAX kernel tests' own. bf16: the
causal conv is bit for bit equal (measured over seeds 0-4); the
recurrence's y differs by at most one bf16 ulp (9.8e-4 at |y| < 0.5);
``apply_mamba`` outputs differed by at most 8.8e-3 at |out| < 1.4 (one
or two bf16 ulps) and its f32 state by 3.3e-4, so its bf16 tolerance is
2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models import ssm as js  # noqa: E402
from repro.models.layers import RunConfig as JaxRunConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import ssm as ts  # noqa: E402
from repro_torch.models.layers import RunConfig  # noqa: E402

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = 1e-5
MAMBA_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
KEEP_F32 = ("A_log", "dt_bias", "D_skip", "gate")

# (b, s, h, p, n, chunk): tests/test_kernels.py's SSD_SHAPES
SSD_SHAPES = [
    (1, 64, 2, 8, 16, 16),
    (2, 128, 4, 16, 32, 32),
    (1, 128, 8, 32, 64, 64),
    (2, 96, 2, 16, 16, 32),   # s not a multiple of chunk -> chunk 48, as there
]


def _pair(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(TORCH_DTYPE[dtype])


def _close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               atol=tol, rtol=tol)


def _ssd_inputs(rng, b, s, h, p, n, dtype):
    """x in ``dtype``; dt = softplus(N(0,1)), A = -exp(0.3 N(0,1)) and
    B, C = 0.5 N(0,1) in f32 (the JAX kernel tests' distributions).
    Returns (jax arrays, torch tensors)."""
    xj, xt = _pair(rng, (b, s, h, p), dtype)
    f32 = [np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32),
           -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32),
           (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32),
           (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)]
    return ([xj] + [jnp.asarray(a) for a in f32],
            [xt] + [torch.from_numpy(a) for a in f32])


def _mamba_params(dtype, seed):
    """One reduced mamba2 layer's params, cast as the model casts them."""
    jc = jax_config("mamba2-2.7b").reduced()
    p = js.init_mamba(jax.random.PRNGKey(seed), jc, jnp.float32)
    p = {k: v if any(s in k for s in KEEP_F32) else v.astype(jnp.dtype(dtype))
         for k, v in p.items()}
    return jc, get_config("mamba2-2.7b").reduced(), p, params_from_jax(
        jax.tree.map(np.asarray, p), device="cpu")


def _close_state(sj, st, tol):
    assert st._fields == sj._fields
    for f in sj._fields:
        _close(getattr(sj, f), getattr(st, f), tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv(dtype, with_tail):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 9, 24), dtype)
    wj, wt = _pair(rng, (4, 24), dtype, scale=0.5)
    tj, tt = _pair(rng, (2, 3, 24), dtype)
    yj, nj = js.causal_conv(xj, wj, tj if with_tail else None)
    yt, nt = ts.causal_conv(xt, wt, tt if with_tail else None)
    assert yt.dtype == xt.dtype and nt.shape == (2, 3, 24)
    _close(yj, yt, 0)              # same adds in the same order: bit for bit
    _close(nj, nt, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_ref_matches_reference(dtype):
    rng = np.random.default_rng(1)
    j, t = _ssd_inputs(rng, 2, 24, 3, 8, 16, dtype)
    yj, sj = jref.ssd_ref(*j)
    yt, st = tref.ssd_ref(*t)
    assert yt.dtype == t[0].dtype and st.dtype == torch.float32
    _close(yj, yt, F32_TOL if dtype == "float32" else 2e-3)   # one bf16 ulp of y
    _close(sj, st, F32_TOL)


def test_ssd_ref_continues_from_an_initial_state():
    """The port's oracle takes an initial state (the JAX one starts at
    zero): two halves chained through the state equal one whole run."""
    rng = np.random.default_rng(2)
    _, (x, dt, A, B, C) = _ssd_inputs(rng, 2, 20, 3, 8, 16, "float32")
    y, s = tref.ssd_ref(x, dt, A, B, C)
    y1, s1 = tref.ssd_ref(x[:, :7], dt[:, :7], A, B[:, :7], C[:, :7])
    y2, s2 = tref.ssd_ref(x[:, 7:], dt[:, 7:], A, B[:, 7:], C[:, 7:], init_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(s2, s, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("chunk", [16, 12, 1])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_reference(with_init, chunk):
    rng = np.random.default_rng(3)
    j, t = _ssd_inputs(rng, 2, 48, 6, 8, 16, "float32")
    init = (rng.standard_normal((2, 6, 8, 16)) * 0.5).astype(np.float32) if with_init else None
    yj, sj = js.ssd_chunked(*j, chunk, init_state=None if init is None else jnp.asarray(init))
    yt, st = ts.ssd_chunked(*t, chunk, init_state=None if init is None else torch.from_numpy(init))
    _close(yj, yt, F32_TOL)
    _close(sj, st, F32_TOL)
    with pytest.raises(ValueError, match="divide"):
        ts.ssd_chunked(*t, 20)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_ssd_on_cpu_matches_pallas_interpret(b, s, h, p, n, chunk, dtype):
    if s % chunk != 0:
        chunk = s // 2 if s % (s // 2) == 0 else s
    rng = np.random.default_rng(b * 1000 + s + h * 10 + p)
    j, t = _ssd_inputs(rng, b, s, h, p, n, dtype)
    before = ops.ssd.launches
    y, st = ops.ssd(*t, chunk=chunk)
    assert ops.ssd.launches == before                      # the CPU runs the plain version
    assert y.dtype == t[0].dtype and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    y_plain, st_plain = ts.ssd_chunked(*t, chunk)
    assert torch.equal(y, y_plain) and torch.equal(st, st_plain)
    yj, sj = jax_ssd_scan(*j, chunk=chunk, interpret=True)
    _close(yj, y, KERNEL_TOL[dtype])
    _close(sj, st, KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step(dtype):
    rng = np.random.default_rng(4)
    j, t = _ssd_inputs(rng, 2, 1, 3, 8, 16, dtype)
    state = (rng.standard_normal((2, 3, 8, 16)) * 0.5).astype(np.float32)
    yj, sj = js.ssd_decode_step(jnp.asarray(state), j[0][:, 0], j[1][:, 0], j[2],
                                j[3][:, 0], j[4][:, 0])
    yt, st = ts.ssd_decode_step(torch.from_numpy(state), t[0][:, 0], t[1][:, 0], t[2],
                                t[3][:, 0], t[4][:, 0])
    assert yt.dtype == t[0].dtype
    _close(yj, yt, F32_TOL if dtype == "float32" else 2e-3)
    _close(sj, st, F32_TOL)


def test_pick_chunk_follows_the_reference_loop():
    cfg = get_config("mamba2-2.7b")
    red = cfg.reduced()
    rc = RunConfig(device="cpu")
    assert [ts.pick_chunk(S, cfg, rc) for S in (512, 96, 1, 200, 131)] == [128, 96, 1, 100, 1]
    assert [ts.pick_chunk(S, red, rc) for S in (24, 16, 17, 8)] == [12, 16, 1, 8]
    assert ts.pick_chunk(96, cfg, rc.replace(ssd_chunk=32)) == 32


def test_kernel_chunk_is_the_largest_divisor_within_k2s_limit():
    cases = ((512, 256), (512, 128), (512, 96), (96, 256), (200, 256), (131, 256),
             (1, 256), (768, 512), (24, 12), (7, 1))
    assert [tssd.kernel_chunk(S, c) for S, c in cases] == \
        [128, 128, 64, 96, 100, 1, 1, 128, 12, 1]
    for S in range(1, 300):
        for c in (1, 5, 64, 128, 129, 256, 1024):
            k = tssd.kernel_chunk(S, c)
            assert S % k == 0 and k <= min(c, tssd.MAX_CHUNK)
            assert not any(S % j == 0 for j in range(k + 1, min(c, tssd.MAX_CHUNK, S) + 1))
    for bad in ((0, 128), (16, 0)):
        with pytest.raises(ValueError):
            tssd.kernel_chunk(*bad)


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_at_chunk_256_matches_chunk_128(with_init):
    """The chunked scan computes one function at any chunk: at S=512 its
    chunk-256 result (the JAX package's, under RunConfig(ssd_chunk=256))
    and its chunk-128 one (what K2 runs there) agree in f32 within 2e-4
    (abs and rel), the JAX tests' tolerance for the chunked path. So does
    the JAX ``ssd_chunked`` at 256: a 256-long chunk's f32 cumsums and
    exps round more than the 1e-5 of the short chunks above allows (over
    seeds 0-4, |y| < 30, the two frameworks' chunk-256 y differed by at
    most 2.1e-4, 7e-6 of |y|; chunk 256 against 128 by 1.1e-4)."""
    rng = np.random.default_rng(9)
    xs, (x, dt, A, B, C) = _ssd_inputs(rng, 2, 512, 4, 16, 32, "float32")
    init = (rng.standard_normal((2, 4, 16, 32)) * 0.5).astype(np.float32) if with_init \
        else None
    tinit = None if init is None else torch.from_numpy(init)
    y256, s256 = ts.ssd_chunked(x, dt, A, B, C, 256, init_state=tinit)
    y128, s128 = ts.ssd_chunked(x, dt, A, B, C, 128, init_state=tinit)
    _close(y128.numpy(), y256, KERNEL_TOL["float32"])
    _close(s128.numpy(), s256, KERNEL_TOL["float32"])
    yj, sj = js.ssd_chunked(*xs, 256, init_state=None if init is None else jnp.asarray(init))
    _close(yj, y256, KERNEL_TOL["float32"])
    _close(sj, s256, KERNEL_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_at_chunk_256_matches_reference(dtype):
    """RunConfig(ssd_chunk=256) on the CPU keeps pick_chunk's chunk, 256,
    as the JAX package does (the card runs K2 at 128: test_torch_cuda.py)."""
    jc, tc, pj, pt = _mamba_params(dtype, seed=10)
    rng = np.random.default_rng(10)
    xj, xt = _pair(rng, (1, 512, jc.d_model), dtype)
    assert ts.pick_chunk(512, tc, RunConfig(device="cpu", ssd_chunk=256)) == 256
    oj, sj = js.apply_mamba(pj, xj, jc, JaxRunConfig(compute_dtype=dtype, ssd_chunk=256),
                            return_state=True)
    ot, st = ts.apply_mamba(pt, xt, tc, RunConfig(compute_dtype=TORCH_DTYPE[dtype],
                                                  device="cpu", ssd_chunk=256),
                            return_state=True)
    _close(oj, ot, MAMBA_TOL[dtype])
    _close_state(sj, st, MAMBA_TOL[dtype])


# ---------------------------------------------------------------------------
# apply_mamba: prefill (through ops.ssd), decode, continuing a state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_prefill_and_decode(dtype):
    jc, tc, pj, pt = _mamba_params(dtype, seed=5)
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng, (2, 24, jc.d_model), dtype)        # S=24 -> chunk 12
    jrc = JaxRunConfig(compute_dtype=dtype)
    trc = RunConfig(compute_dtype=TORCH_DTYPE[dtype], device="cpu")
    before = ops.ssd.launches
    oj, sj = js.apply_mamba(pj, xj, jc, jrc, return_state=True)
    ot, st = ts.apply_mamba(pt, xt, tc, trc, return_state=True)
    assert ops.ssd.launches == before
    assert ot.dtype == TORCH_DTYPE[dtype] and st.ssd.dtype == torch.float32
    _close(oj, ot, MAMBA_TOL[dtype])
    _close_state(sj, st, MAMBA_TOL[dtype])
    _, none = ts.apply_mamba(pt, xt, tc, trc)
    assert none is None

    x1j, x1t = _pair(rng, (2, 1, jc.d_model), dtype)      # one decode step
    oj, sj = js.apply_mamba(pj, x1j, jc, jrc, state=sj)
    ot, st = ts.apply_mamba(pt, x1t, tc, trc, state=st)
    _close(oj, ot, MAMBA_TOL[dtype])
    _close_state(sj, st, MAMBA_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_continues_a_state(dtype):
    """S > 1 with a state: the scan starts from it (ssd_chunked's init_state)."""
    jc, tc, pj, pt = _mamba_params(dtype, seed=6)
    rng = np.random.default_rng(6)
    jrc = JaxRunConfig(compute_dtype=dtype)
    trc = RunConfig(compute_dtype=TORCH_DTYPE[dtype], device="cpu")
    xj, xt = _pair(rng, (2, 10, jc.d_model), dtype)
    _, sj = js.apply_mamba(pj, xj, jc, jrc, return_state=True)
    _, st = ts.apply_mamba(pt, xt, tc, trc, return_state=True)
    xj, xt = _pair(rng, (2, 8, jc.d_model), dtype)
    oj, sj = js.apply_mamba(pj, xj, jc, jrc, state=sj, return_state=True)
    ot, st = ts.apply_mamba(pt, xt, tc, trc, state=st, return_state=True)
    _close(oj, ot, MAMBA_TOL[dtype])
    _close_state(sj, st, MAMBA_TOL[dtype])


def test_init_mamba_tree_and_distributions():
    cfg = get_config("mamba2-2.7b").reduced()
    jp = js.init_mamba(jax.random.PRNGKey(0), jax_config("mamba2-2.7b").reduced(),
                       jnp.bfloat16)
    tp = ts.init_mamba(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert tuple(v.shape) == tuple(jp[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == str(jp[k].dtype), k
    for k in ("A_log", "D_skip", "conv_B", "conv_C", "gate_norm"):   # deterministic leaves
        _close(jp[k], tp[k], F32_TOL)      # A_log = log(1..H): one f32 ulp apart
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert abs(float(tp["conv_x"].float().std()) - 0.1) < 0.02
    cfg_full = get_config("mamba2-2.7b")
    big = ts.init_mamba(torch.Generator().manual_seed(0), cfg_full, torch.float32, "cpu")
    # truncated-normal fan-in: std 0.8796 / sqrt(d_model)
    assert abs(float(big["in_x"].std()) * cfg_full.d_model ** 0.5 - 0.8796) < 0.01


def test_init_ssm_state_allocates_every_layer():
    cfg = get_config("mamba2-2.7b").reduced()
    st = ts.init_ssm_state(cfg, 2, torch.bfloat16, "cpu", layers=3)
    assert st.ssd.shape == (3, 2, 16, 16, 16) and st.ssd.dtype == torch.float32
    assert st.conv_x.shape == (3, 2, 3, 256) and st.conv_x.dtype == torch.bfloat16
    for t in st:
        assert t.stride(0) != 0 and t.is_contiguous()
    st.ssd[0].fill_(1.0)
    assert float(st.ssd[1].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the K2 launcher refuses what the kernel does not take (checked before
# any build, so these run on the CPU too)
# ---------------------------------------------------------------------------
def test_k2_launcher_refusals():
    rng = np.random.default_rng(7)
    _, (x, dt, A, B, C) = _ssd_inputs(rng, 1, 16, 2, 8, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan(x, dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_scan(x, dt, A, B, C, chunk=256)
    with pytest.raises(ValueError, match="divide"):
        tssd.ssd_scan(x, dt, A, B, C, chunk=6)
    with pytest.raises(ValueError, match="head_dim"):
        tssd.ssd_scan(x[..., :6], dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="state size"):
        tssd.ssd_scan(x, dt, A, B[..., :6], C[..., :6], chunk=16)
    # the operator of the launch has no CPU implementation
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.k2_fwd(x, dt, A, B, C, 16, None)
    # a meta tensor takes the kernel's way and is only shaped: no launch
    before = ops.ssd.launches
    y, st = ops.ssd(*(t.to("meta") for t in (x, dt, A, B, C)), chunk=16)
    assert y.device.type == st.device.type == "meta"
    assert y.shape == x.shape and st.shape == (1, 2, 8, 16) and st.dtype == torch.float32
    assert ops.ssd.launches == before
