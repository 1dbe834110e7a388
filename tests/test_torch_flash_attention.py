"""The port's flash-attention op on the CPU (its plain version) against
the JAX package: the Pallas kernel in interpret mode, ``attention_ref``
and the model's ``chunked_attention``; and the port's attention routing.

Tolerances are the JAX package's own for its kernel
(``tests/test_kernels.py``): 2e-6 in f32, 2e-2 in bf16, absolute and
relative; and the per-row relative limit (``ref.row_errors``,
``ref.ROW_RTOL``) that the card check holds the CUDA kernel to, which
still sees a skipped key tile at S 32,768 where the element-wise limit
does not.  Inputs are drawn with numpy from fixed seeds and handed to
both packages.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.models import attention as JAtt  # noqa: E402
from repro_torch.kernels.flash_attention import build, ops, ref  # noqa: E402
from repro_torch.models import attention as TAtt  # noqa: E402

TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(S, hd, causal, dtype):
    q, k, v = _draw(S + hd, (2, S, hd), (2, S, hd), (2, S, hd))
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    pallas = flash_attention_fwd(jq, jk, jv, causal=causal, interpret=True)
    oracle = attention_ref(jq, jk, jv, causal=causal)
    # the port's (B, H, S, hd) with B = 1 holds the TPU kernel's (BH, S, hd)
    got = ops.flash_attention(*(_torch(a, dtype)[None] for a in (q, k, v)),
                              causal=causal)[0]
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), pallas.astype(jnp.float32), dtype)
    _close(got.float().numpy(), oracle.astype(jnp.float32), dtype)
    # the per-row limit the card check holds the CUDA kernel to, met by
    # the Pallas kernel (which rounds p to bf16 as the CUDA kernel does)
    rows = ref.row_errors(
        torch.tensor(np.asarray(pallas.astype(jnp.float32)))[None], got)
    assert float(rows.max()) <= ref.ROW_RTOL[got.dtype]


def _band(S, band, *, dropped_tile=None, q_scale=1.0):
    """The last ``band`` query rows of a causal bf16 attention at length
    S (2 query heads over 1 kv head, hd 64), optionally with the 64-key
    tile starting at ``dropped_tile`` skipped or the scores scaled; and
    the correct rows."""
    q, k, v = (_torch(a, "bfloat16") for a in
               _draw(S, (1, 2, band, 64), (1, 1, S, 64), (1, 1, S, 64)))
    off = S - band
    want = ref.flash_attention_ref(q, k, v, q_offset=off)
    if dropped_tile is not None:
        t0 = dropped_tile
        k, v = (torch.cat([t[:, :, :t0], t[:, :, t0 + 64:]], 2) for t in (k, v))
        off -= 64
    got = ref.flash_attention_ref(q * q_scale, k, v, q_offset=off)
    return got, want


@pytest.mark.parametrize("fault", [
    {"dropped_tile": 0}, {"dropped_tile": 16384}, {"dropped_tile": 32640},
    {"q_scale": 1.02}])
def test_row_check_rejects_faults_the_elementwise_tolerance_passes(fault):
    """At S 32,768 the band's outputs are about 0.01, so the element-wise
    2e-2 passes a kernel that skips one of 512 key tiles or mis-scales
    the scores by 2 %; the per-row relative limit rejects both."""
    got, want = _band(32768, 64, **fault)
    _close(got.float().numpy(), want.float().numpy(), "bfloat16")
    assert float(ref.row_errors(got, want).max()) > ref.ROW_RTOL[
        torch.bfloat16]


@pytest.mark.parametrize("S", [4096, 32768])
def test_row_check_passes_the_kernels_rounding(S):
    """The CUDA kernel's arithmetic in bf16 (p rounded to bf16 before
    p @ v, f32 everything else, bf16 output) stays well inside the per-row
    limit at the serving path's lengths."""
    _, want = _band(S, 64)
    q, k, v = (_torch(a, "bfloat16") for a in
               _draw(S, (1, 2, 64, 64), (1, 1, S, 64), (1, 1, S, 64)))
    s = (q.float() @ k.float().transpose(-1, -2)) / 8
    s = s.masked_fill(torch.arange(S) > torch.arange(S - 64, S)[:, None],
                      ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    kernel_like = ((p.bfloat16().float() @ v.float())
                   / p.sum(-1, keepdim=True)).bfloat16()
    assert float(ref.row_errors(kernel_like, want).max()) < 0.5 * ref.ROW_RTOL[
        torch.bfloat16]


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_head_map_matches_attention_ref_per_head(causal):
    B, H, Hkv, S, hd = 2, 8, 2, 128, 64
    q, k, v = _draw(3, (B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal).numpy()
    # query head h reads kv head h // (H / Hkv)
    rep = H // Hkv
    kr, vr = (np.repeat(a, rep, axis=1).reshape(B * H, S, hd) for a in (k, v))
    want = attention_ref(jnp.asarray(q.reshape(B * H, S, hd)), jnp.asarray(kr),
                         jnp.asarray(vr), causal=causal)
    _close(got.reshape(B * H, S, hd), want, "float32")


@pytest.mark.parametrize("S", [300, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_gqa_matches_chunked_attention(S, causal, dtype):
    """A ragged S (not a multiple of any tile) with 4 query heads per kv
    head, in the model's (B, S, H, hd) layout."""
    B, H, Hkv, hd = 1, 8, 2, 64
    q, k, v = _draw(S, (B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))
    want = JAtt.chunked_attention(*(_jax(a, dtype) for a in (q, k, v)),
                                  causal=causal, chunk=128)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    got = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=causal)
    _close(got.transpose(1, 2).float().numpy(), want.astype(jnp.float32),
           dtype)


def _kernel_model(q, k, v, *, causal):
    """The bf16 CUDA kernel's arithmetic in plain torch, in its order:
    blocks of BQ query rows, each BQ / 64 consumers of 64 rows (3 at hd
    32 and 64, 2 at hd 128); key tiles of
    BK keys (zero past S, as TMA fills them), causal tiles wholly above
    a block's last row skipped; f32 scores; the mask only on tiles that
    cross S or, causal, the consumer's first row; p = exp2(s c - m c)
    with c = log2(e) / sqrt(hd); p rounded to v's type before p v; the
    row sum in four per-thread parts of BK / 8 keys each, summed at the
    end; out = acc / max(l, 1e-30) in q's type."""
    B, H, S, hd = q.shape
    BQ, BK, _ = ops.BF16_TILES[hd]
    c = math.log2(math.e) / math.sqrt(hd)
    kv_head = torch.arange(H) // (H // k.shape[1])
    n_all = -(-S // BK)
    pad = n_all * BK - S
    kf, vf = (torch.nn.functional.pad(t[:, kv_head].float(), (0, 0, 0, pad))
              for t in (k, v))
    cols = torch.arange(n_all * BK)
    out = torch.empty(B, H, S, hd)
    for r0 in range(0, S, 64):            # one consumer's rows
        q0 = r0 - r0 % BQ
        rows = torch.arange(r0, r0 + 64)
        qr = torch.nn.functional.pad(q[:, :, r0:r0 + 64].float(),
                                     (0, 0, 0, 64 - min(64, S - r0)))
        n_tiles = n_all
        if causal:
            n_tiles = min(n_tiles, (q0 + BQ - 1) // BK + 1)
        m = torch.full((B, H, 64), ref.NEG_INF)
        l_parts = torch.zeros(B, H, 64, 4)
        o = torch.zeros(B, H, 64, hd)
        for n in range(n_tiles):
            k0 = n * BK
            s = qr @ kf[:, :, k0:k0 + BK].transpose(-1, -2)
            if k0 + BK > S or (causal and k0 + BK - 1 > r0):
                col = cols[k0:k0 + BK]
                mask = col[None, :] >= S
                if causal:
                    mask = mask | (col[None, :] > rows[:, None])
                s = s.masked_fill(mask, ref.NEG_INF)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - mx) * c)
            m = mx
            p = torch.exp2(s * c - (mx * c)[..., None])
            # a thread holds keys 8j + 2t, 8j + 2t + 1 of its rows
            parts = p.reshape(B, H, 64, BK // 8, 4, 2).sum((-3, -1))
            l_parts = l_parts * alpha[..., None] + parts
            o = o * alpha[..., None] + p.to(v.dtype).float() @ vf[:, :, k0:k0 + BK]
        l = l_parts.sum(-1).clamp_min(1e-30)
        out[:, :, r0:r0 + 64] = (o / l[..., None])[:, :, :min(64, S - r0)]
    return out.to(q.dtype)


@pytest.mark.parametrize("S", [1, 127, 129, 333, 515])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_tiling_keeps_the_reference_numbers(S, hd, causal, dtype):
    """The bf16 kernel's tiles, masks, exp2 with the folded scale and
    reordered accumulation agree with the plain version and with the
    Pallas kernel (interpret mode, one block of S rows, heads repeated
    as the CUDA kernel's head map reads them) at the JAX package's
    tolerances and the per-row limit; S is ragged against BQ and BK, and
    2 query heads share one kv head."""
    q, k, v = _draw(S * hd, (1, 2, S, hd), (1, 1, S, hd), (1, 1, S, hd))
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    got = _kernel_model(tq, tk, tv, causal=causal)
    want = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    _close(got.float().numpy(), want.float().numpy(), dtype)
    assert float(ref.row_errors(got, want).max()) <= ref.ROW_RTOL[got.dtype]
    pallas = flash_attention_fwd(
        _jax(q[0], dtype), *(_jax(np.repeat(a[0], 2, axis=0), dtype)
                             for a in (k, v)),
        causal=causal, block_q=S, block_k=S, interpret=True)
    _close(got[0].float().numpy(), pallas.astype(jnp.float32), dtype)


def test_bf16_tiles_are_the_kernels():
    """``ops.BF16_TILES`` names the one bf16 instance the CUDA source
    builds for each head dim (``Bf16Tiles<hd>``: Tiles<hd, keys, stages,
    consumer warpgroups of 64 rows>)."""
    built = {int(hd): (64 * int(c), int(bk), int(st)) for hd, hd2, bk, st, c
             in re.findall(r"struct Bf16Tiles<(\d+)> \{\s*using T = "
                           r"Tiles<(\d+), (\d+), (\d+), (\d+)>;",
                           build.SOURCE.read_text())
             if hd == hd2}
    assert built == ops.BF16_TILES
    assert sorted(built) == sorted(ops.HEAD_DIMS)


def test_band_of_rows_equals_the_full_computation():
    """``q_offset`` computes a band of query rows alone (how the card
    check holds the kernel at S = 32,768)."""
    q, k, v = (torch.from_numpy(a) for a in
               _draw(5, (1, 4, 200, 32), (1, 2, 200, 32), (1, 2, 200, 32)))
    full = ref.flash_attention_ref(q, k, v, causal=True)
    band = ref.flash_attention_ref(q[:, :, 150:], k, v, causal=True,
                                   q_offset=150)
    torch.testing.assert_close(band, full[:, :, 150:], atol=1e-6, rtol=1e-6)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    q = torch.zeros((1, 2, 8, 32))
    ops.reset_launches()
    out = ops.flash_attention(q, q, q)
    assert out.shape == q.shape and ops.LAUNCHES == {"flash_attention": 0}


@pytest.mark.parametrize("shapes,dtypes,err", [
    (((1, 4, 8, 32), (1, 3, 8, 32)), (torch.float32,) * 2, ValueError),
    (((1, 4, 8, 32), (1, 2, 9, 32)), (torch.float32,) * 2, ValueError),
    (((4, 8, 32), (4, 8, 32)), (torch.float32,) * 2, ValueError),
    (((1, 4, 8, 32), (1, 2, 8, 32)), (torch.float32, torch.bfloat16), TypeError),
    (((1, 4, 8, 32), (1, 2, 8, 32)), (torch.float16,) * 2, TypeError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(shapes, dtypes, err):
    q = torch.zeros(shapes[0], dtype=dtypes[0])
    k = torch.zeros(shapes[1], dtype=dtypes[1])
    with pytest.raises(err):
        ops.flash_attention(q, k, k)


@pytest.mark.parametrize("window", [0, 300])
def test_port_chunked_attention_matches_jax(window):
    B, S, H, Hkv, hd = 1, 700, 4, 2, 32
    q, k, v = _draw(window, (B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))
    want = JAtt.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=True, window=window, chunk=256)
    got = TAtt.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=True, window=window, chunk=256)
    _close(got.numpy(), want, "float32")


@pytest.mark.parametrize("S,window,route", [
    (2100, 0, "flash"), (2100, 64, "chunked"), (2048, 0, "plain"),
    (64, 0, "plain")])
def test_attention_any_routes_like_the_reference(monkeypatch, S, window,
                                                 route):
    calls = []
    for name in ("flash_attention", "chunked_attention", "plain_attention"):
        real = getattr(TAtt, name)
        monkeypatch.setattr(TAtt, name, lambda *a, _n=name, _f=real, **kw: (
            calls.append(_n.split("_")[0]), _f(*a, **kw))[1])
    q, k, v = (torch.from_numpy(a) for a in
               _draw(S, (1, S, 2, 32), (1, S, 1, 32), (1, S, 1, 32)))
    got = TAtt.attention_any(q, k, v, causal=True, window=window)
    assert calls == [route]
    want = JAtt.attention_any(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                              causal=True, window=window)
    _close(got.numpy(), want, "float32")
