"""The port's SSD ops on the CPU (their plain versions) against the JAX
package: the Pallas ``ssd_intra_chunk`` kernel in interpret mode, its
``ssd_scan`` glue and the model's ``ssd_chunked``.

Tolerances are the JAX package's own for its kernel
(``tests/test_kernels.py``): 1e-5 in f32 and 5e-2 in bf16, absolute and
relative.  Inputs are drawn with numpy from fixed seeds and handed to
both packages, with A = -exp(linspace(0, 1, H)) as the JAX test draws it,
in two dt regimes: the JAX test's softplus(N(0, 1)), whose chunk decays
exp(cum_last) are all below 1e-3 (so a chunk's state reaches only the
first rows of the next chunk, and a wrong ``dec`` shows nowhere), and
Mamba-2's own log-uniform [1e-3, 1e-1] (arXiv:2405.21060), where states
carry across chunks.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd.kernel import ssd_intra_chunk as pallas_ssd  # noqa: E402
from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd import ops, ref  # noqa: E402
from repro_torch.models import ssm as TSsm  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
SHAPES = [(64, 2, 16, 8, 16), (128, 4, 32, 16, 32), (80, 2, 16, 8, 32)]
REGIMES = ["softplus", "log-uniform"]
BZ = 2


def draw_dt(rng, shape, regime):
    if regime == "softplus":
        return np.log1p(np.exp(rng.standard_normal(shape))).astype(np.float32)
    return np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape)
                  ).astype(np.float32)


def scan_inputs(S, H, hd, N, regime, seed):
    """x (B, S, H, hd), dt (B, S, H), A (H,), Bm, Cm (B, S, N) in f32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((BZ, S, H, hd)) * 0.5).astype(np.float32)
    dt = draw_dt(rng, (BZ, S, H), regime)
    A = -np.exp(np.linspace(0.0, 1.0, H)).astype(np.float32)
    Bm = (rng.standard_normal((BZ, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((BZ, S, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def chunk_inputs(S, H, hd, N, Q, regime, seed):
    """The intra-chunk contract: a, dt (B, H, nc, Q, 1); Bm, Cm (B, nc,
    Q, N); x (B, H, nc, Q, hd); S padded to whole chunks with zeros."""
    x, dt, A, Bm, Cm = scan_inputs(S, H, hd, N, regime, seed)
    pad = (-S) % Q
    x, dt, Bm, Cm = (np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
                     for t in (x, dt, Bm, Cm))
    nc = x.shape[1] // Q
    xk = x.reshape(BZ, nc, Q, H, hd).transpose(0, 3, 1, 2, 4)
    dtk = dt.reshape(BZ, nc, Q, H).transpose(0, 3, 1, 2)[..., None]
    ak = (dtk[..., 0] * A[None, :, None, None])[..., None]
    return (np.ascontiguousarray(t) for t in
            (ak, dtk, Bm.reshape(BZ, nc, Q, N), Cm.reshape(BZ, nc, Q, N), xk))


def _j(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def max_chunk_decay(a):
    return float(np.exp(np.cumsum(a[..., 0], axis=-1)[..., -1]).max())


@pytest.mark.parametrize("S,H,hd,N,Q", SHAPES)
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(S, H, hd, N, Q, regime, dtype):
    a, dt, Bm, Cm, x = chunk_inputs(S, H, hd, N, Q, regime, S + H)
    pallas = pallas_ssd(_j(a, "float32"), _j(dt, "float32"), _j(Bm, dtype),
                        _j(Cm, dtype), _j(x, dtype), interpret=True)
    got = ops.ssd_intra_chunk(_t(a, "float32"), _t(dt, "float32"),
                              _t(Bm, dtype), _t(Cm, dtype), _t(x, dtype))
    assert got[0].dtype == getattr(torch, dtype)
    assert got[1].dtype == got[2].dtype == torch.float32
    for g, w in zip(got, pallas):
        assert tuple(g.shape) == w.shape
        _close(g.float().numpy(), w.astype(jnp.float32), dtype)
    if regime == "log-uniform":      # the inter-chunk path carries signal
        assert max_chunk_decay(a) > 1e-2
    else:                            # ... and in the JAX test's regime, not
        assert max_chunk_decay(a) < 1e-3


@pytest.mark.parametrize("S,H,hd,N,Q", SHAPES)
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_jax_scan_and_ssd_chunked(S, H, hd, N, Q, regime,
                                                   dtype):
    """The glue (padding, the inter-chunk recurrence, y_inter) around the
    plain intra-chunk version, and the model's CPU twin, against the JAX
    package's kernel glue (Pallas in interpret mode) and its XLA twin;
    the final state too.  S 80 with Q 32 is ragged."""
    x, dt, A, Bm, Cm = scan_inputs(S, H, hd, N, regime, S)
    jargs = (_j(x, dtype), _j(dt, "float32"), _j(A, "float32"),
             _j(Bm, dtype), _j(Cm, dtype))
    targs = (_t(x, dtype), _t(dt, "float32"), _t(A, "float32"),
             _t(Bm, dtype), _t(Cm, dtype))
    jy, js = jax_ssd_scan(*jargs, chunk=Q, force_kernel=True, interpret=True)
    cy, cs = jax_ssd_chunked(*jargs, chunk=Q)
    for y, s in (ops.ssd_scan(*targs, chunk=Q),
                 TSsm.ssd_chunked(*targs, chunk=Q)):
        assert tuple(y.shape) == (BZ, S, H, hd) and y.dtype == targs[0].dtype
        assert tuple(s.shape) == (BZ, H, N, hd) and s.dtype == torch.float32
        for want_y, want_s in ((jy, js), (cy, cs)):
            _close(y.float().numpy(), want_y.astype(jnp.float32), dtype)
            _close(s.numpy(), want_s, dtype)


# -- the check itself ---------------------------------------------------------


def _faults(a, dt, Bm, Cm, x):
    """Two planted faults of the intra-chunk outputs: the causal mask
    moved by one (the diagonal term dropped from y), and S_loc of chunk 1
    computed without its decay to the chunk's end."""
    y, s_loc, dec = ref.ssd_intra_chunk_ref(a, dt, Bm, Cm, x)
    Q = x.shape[3]
    Lw = ref.ssd_intra_chunk_ref(a, dt, Bm, Cm, torch.eye(Q, dtype=x.dtype)
                                 .expand(*x.shape[:3], Q, Q).contiguous())[0]
    diag = torch.diagonal(Lw.float(), dim1=-2, dim2=-1)[..., None]  # w_ii
    y_mask = (y.float() - diag * x.float()).to(y.dtype)
    s_bad = s_loc.clone()
    s_bad[:, :, 1] = torch.einsum("bjn,bhjd->bhnd", Bm[:, 1].float(),
                                  x[:, :, 1].float() * dt[:, :, 1].float())
    return y_mask, s_bad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checks_reject_planted_faults(dtype):
    """What the card's check holds the CUDA kernel to rejects both planted
    faults, in the regime where the chunk decays carry signal; the plain
    version against the Pallas kernel passes it."""
    a, dt, Bm, Cm, x = (_t(t, d) for t, d in zip(
        chunk_inputs(128, 4, 32, 16, 32, "log-uniform", 11),
        ("float32", "float32", dtype, dtype, dtype)))
    y, s_loc, _ = ops.ssd_intra_chunk(a, dt, Bm, Cm, x)
    pallas = pallas_ssd(*(_j(t.float().numpy(), d) for t, d in zip(
        (a, dt, Bm, Cm, x), ("float32", "float32", dtype, dtype, dtype))),
        interpret=True)
    rtols = (ref.ROW_RTOL[getattr(torch, dtype)],
             ref.STATE_ROW_RTOL[getattr(torch, dtype)])
    for got, want, rtol in zip((y, s_loc), pallas[:2], rtols):
        rows = ref.row_errors(got, torch.from_numpy(
            np.array(want.astype(jnp.float32))))
        assert float(rows.max()) <= rtol
    y_mask, s_bad = _faults(a, dt, Bm, Cm, x)
    assert float(ref.row_errors(y_mask, y).max()) > 10 * rtols[0]
    assert float(ref.row_errors(s_bad, s_loc).max()) > 10 * rtols[1]
    with pytest.raises(AssertionError):
        _close(s_bad.numpy(), s_loc.numpy(), dtype)


def test_decay_fault_reaches_the_scan_output_only_where_decays_carry():
    """The trap of the reference's dt regime: a chunk decay ``dec`` of
    zero (a kernel that lost it) barely moves the scan's y under
    softplus(N(0, 1)) dt, where every true decay is already below 1e-3,
    and moves it far past the f32 tolerance under Mamba-2's dt range."""
    moved = {}
    real = ops.ssd_intra_chunk

    def faulty(*args):
        y_, s_loc_, dec_ = real(*args)
        dec_ = dec_.clone()
        dec_[:, :, 1] = 0.0
        return y_, s_loc_, dec_

    for regime in REGIMES:
        x, dt, A, Bm, Cm = (torch.from_numpy(t) for t in
                            scan_inputs(128, 4, 16, 8, regime, 5))
        y, _ = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
        ops.ssd_intra_chunk = faulty
        try:
            y_bad, _ = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
        finally:
            ops.ssd_intra_chunk = real
        moved[regime] = float((y_bad - y).abs().max())
    assert moved["log-uniform"] > 100 * TOL["float32"]
    assert moved["softplus"] < TOL["float32"]


# -- the wrapper --------------------------------------------------------------


def test_bf16_bodies_are_the_kernels():
    """``ops.BF16_BODIES`` names the bf16 body the CUDA source builds for
    each (Q, N, hd) (``Bf16Body<Q, N, hd>``: ``Wgmma<heads a block>`` or
    ``MmaSync``), and the wrapper takes exactly those sizes."""
    from repro_torch.kernels.ssd import build
    built = {}
    for q, n, hd, body in re.findall(
            r"struct Bf16Body<(\d+), (\d+), (\d+)> : (Wgmma<\d+>|MmaSync) \{\};",
            build.SOURCE.read_text()):
        g = re.fullmatch(r"Wgmma<(\d+)>", body)
        built[(int(q), int(n), int(hd))] = (
            ("wgmma", int(g.group(1))) if g else ("mma.sync", 1))
    assert built == ops.BF16_BODIES
    assert ops.KERNEL_SIZES == tuple(ops.BF16_BODIES)
    # the serving chunk of mamba2-1.3b takes the wgmma body
    assert ops.BF16_BODIES[(256, 128, 64)][0] == "wgmma"



def test_cpu_calls_count_no_launch():
    a, dt, Bm, Cm, x = (_t(t, "float32") for t in
                        chunk_inputs(64, 2, 16, 8, 16, "log-uniform", 1))
    ops.reset_launches()
    ops.ssd_intra_chunk(a, dt, Bm, Cm, x)
    ops.ssd_scan(torch.zeros(1, 40, 2, 16), torch.ones(1, 40, 2),
                 -torch.ones(2), torch.zeros(1, 40, 8), torch.zeros(1, 40, 8),
                 chunk=16)
    assert ops.LAUNCHES == {"ssd_intra_chunk": 0}


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a, dt, Bm, Cm, x = (_t(t, "float32") for t in
                        chunk_inputs(64, 2, 16, 8, 16, "log-uniform", 1))
    with pytest.raises(TypeError, match="share"):
        ops.ssd_intra_chunk(a, dt, Bm.bfloat16(), Cm, x)
    with pytest.raises(TypeError, match="share"):
        ops.ssd_intra_chunk(a, dt, Bm.half(), Cm.half(), x.half())
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_intra_chunk(a.double(), dt, Bm, Cm, x)
    with pytest.raises(ValueError, match="a, dt"):
        ops.ssd_intra_chunk(a[..., :8, :], dt, Bm, Cm, x)
    with pytest.raises(ValueError, match="Bm, Cm"):
        ops.ssd_intra_chunk(a, dt, Bm[..., :4, :], Cm, x)
    with pytest.raises(ValueError, match="one device"):
        ops.ssd_intra_chunk(a, dt, Bm, Cm, x.to("meta"))


def test_scan_inputs_and_chunks_stand_alone():
    """``ref.ssd_inputs`` and ``ref.ssd_chunks``, the inputs ``chip_smoke.py``
    and ``compare.py`` check and time the kernel on (``compare.py`` takes
    them from here, not from the script): one seed, one draw, Mamba-2's
    dt, and chunks that are views in the kernel's contract, whose plain
    intra-chunk output is the twin's y where the whole scan has one chunk."""
    import inspect

    from repro_torch.kernels.ssd import compare
    assert "chip_smoke" not in inspect.getsource(compare)
    B, S, H, hd, N, Q = 2, 32, 3, 16, 16, 32
    x, dt, A, Bm, Cm = args = ref.ssd_inputs(B, S, torch.float32, 4, H, hd,
                                             N, device="cpu")
    again = ref.ssd_inputs(B, S, torch.float32, 4, H, hd, N, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(args, again))
    assert x.shape == (B, S, H, hd) and dt.shape == (B, S, H)
    assert Bm.shape == Cm.shape == (B, S, N) and A.shape == (H,)
    assert float(dt.min()) > 0 and float(A.max()) < 0
    a, d, b, c, xk = chunks = ref.ssd_chunks(*args, Q)
    assert a.shape == d.shape == (B, H, 1, Q, 1)
    assert xk.shape == (B, H, 1, Q, hd) and xk.data_ptr() == x.data_ptr()
    y, _, _ = ref.ssd_intra_chunk_ref(*chunks)
    want, _ = TSsm.ssd_twin(*args, chunk=Q)
    torch.testing.assert_close(y.permute(0, 2, 3, 1, 4).reshape(want.shape),
                               want, rtol=1e-5, atol=1e-5)
