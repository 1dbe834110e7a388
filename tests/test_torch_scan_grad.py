"""The scans' gradients on the CPU: the selective scan's plain backward
(``kernels/selective_scan/ref.py::selective_scan_bwd_ref``) against
autograd through its step loop, one Mamba-1 sublayer's gradients through
``SelectiveScan`` against ``jax.grad`` of the JAX package's
``mamba1_forward``, and ``SSDScan`` (its forward ``ssd_scan`` over the
intra-chunk kernel's plain version, its backward ``ssd_twin``
recomputed) against autograd through the twin and ``jax.grad`` of the
reference's ``ssd_chunked``.

Each runs in two dt regimes (``ROADMAP.md`` §3, "The dt regime"):
Mamba's own init, dt log-uniform in [1e-3, 1e-1], where the state
carries over many steps and a wrong carry shows; and the reference's,
dt = softplus of a standard normal draw (softplus of the zero
``dt_bias`` and a unit-scale projection), where it decays within a few.

Tolerances, each gradient relative to its largest |value|: 1e-5 where
both sides compute in f32 in another order, 1e-4 against the JAX
package (``_torch_train.GRAD_RTOL``).
"""

import collections
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import B, DT_RANGE, cfgs, mamba1_mixer, one_thread  # noqa: E402
from _torch_train import GRAD_RTOL  # noqa: E402

from repro.models import ssm as JSsm  # noqa: E402
from repro_torch.interop import F32_LEAVES  # noqa: E402
from repro_torch.kernels.selective_scan import build, ops, ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models import ssm as TSsm  # noqa: E402

REGIMES = ["mamba", "reference"]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield

#: the plain backward against autograd through the plain forward
BWD_RTOL = 1e-5


def _dt(rng, shape, regime) -> np.ndarray:
    if regime == "mamba":
        return np.exp(rng.uniform(*np.log(DT_RANGE), shape)).astype(
            np.float32)
    return np.log1p(np.exp(rng.standard_normal(shape))).astype(np.float32)


def _rel(got, want) -> float:
    got, want = (a.detach().float().numpy() if
                 isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
                 for a in (got, want))
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _scan_case(regime, dtype, S=45, D=40, N=16, seed=0):
    """(x, dt, A, Bm, Cm) as the port takes them (x, B and C in
    ``dtype``, B and C column slices of one projection), and a
    cotangent of y and of the final state."""
    rng = np.random.default_rng(seed)
    tt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(
        np.float32)).to(tt)
    dbc = torch.from_numpy(rng.standard_normal((B, S, 3 + 2 * N)).astype(
        np.float32)).to(tt)
    _, Bm, Cm = dbc.split([3, N, N], dim=-1)
    dt = torch.from_numpy(_dt(rng, (B, S, D), regime))
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(D, N).contiguous()
    gy = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    gh = torch.from_numpy(rng.standard_normal((B, D, N)).astype(np.float32))
    return (x, dt, A, Bm, Cm), gy, gh


@pytest.mark.parametrize("with_gh", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regime", REGIMES)
def test_plain_backward_is_autograd_through_the_loop(regime, dtype, with_gh):
    """``selective_scan_bwd_ref`` (and the wrapper, which takes it on a
    CPU tensor without a launch) against autograd through
    ``selective_scan_ref`` on f32 copies of the same inputs (bf16 x, B
    and C widen exactly)."""
    args, gy, gh = _scan_case(regime, dtype)
    gh = gh if with_gh else None
    leaves = [a.float().detach().requires_grad_(True) for a in args]
    y, h = ref.selective_scan_ref(*leaves)
    total = (y * gy).sum() + ((h * gh).sum() if with_gh else 0)
    want = torch.autograd.grad(total, leaves)
    got = ref.selective_scan_bwd_ref(*args, gy, gh)
    ops.reset_launches()
    assert all(torch.equal(a, b) for a, b in zip(
        ops.selective_scan_bwd(*args, gy, gh), got))
    assert ops.LAUNCHES == {"selective_scan": 0, "selective_scan_bwd": 0}
    order = (0, 1, 2, 3, 4)       # dx, ddt, dA, dB, dC as the inputs
    for i in order:
        assert got[i].dtype == torch.float32
        assert _rel(got[i], want[i]) <= BWD_RTOL, i
    if regime == "mamba":         # the state carries: some step keeps it
        assert float(torch.exp(args[1].min() * args[2].max())) > 0.5


def test_plain_backward_at_one_step_and_the_wrapper_checks():
    """One step (no carry) against the closed form, and the wrapper's
    refusals of a wrong cotangent."""
    args, gy, gh = _scan_case("mamba", "float32", S=1, D=8)
    x, dt, A, Bm, Cm = args
    dx, ddt, dA, dB, dC = ref.selective_scan_bwd_ref(*args, gy, None)
    g = gy[:, 0, :, None] * Cm[:, 0, None, :]                 # (B, D, N)
    torch.testing.assert_close(dx[:, 0], dt[:, 0] * (g * Bm[:, 0, None]).sum(-1))
    torch.testing.assert_close(dC[:, 0], torch.einsum(
        "bd,bdn->bn", gy[:, 0], dt[:, 0, :, None] * Bm[:, 0, None] *
        x[:, 0, :, None]))
    torch.testing.assert_close(dA, torch.zeros_like(dA))      # h_{-1} = 0
    with pytest.raises(ValueError, match="gy must be float32"):
        ops.selective_scan_bwd(*args, gy.double())
    with pytest.raises(ValueError, match="gh must be float32"):
        ops.selective_scan_bwd(*args, gy, gh[:, :4])


@pytest.mark.parametrize("regime", REGIMES)
def test_mamba1_sublayer_gradients_match_jax(regime):
    """Reduced jamba's Mamba-1 sublayer in f32 (d_model 128, d_inner 256,
    N 16, S 40): the gradient of ⟨out, w⟩ in the input and in every
    mixer weight, through ``SelectiveScan`` on CPU tensors, against
    ``jax.grad`` of the reference's ``mamba1_forward``; the reference's
    regime takes its own zero ``dt_bias``."""
    jcfg, tcfg = cfgs("jamba-1.5-large-398b", "float32")
    rng = np.random.default_rng(7)
    tree = mamba1_mixer(tcfg, rng)
    if regime == "reference":
        tree["dt_bias"] = np.zeros_like(tree["dt_bias"])
    x = rng.standard_normal((B, 40, tcfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xin):
        out, _ = JSsm.mamba1_forward(p, jcfg, xin)
        return jnp.sum(out * w)

    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in tree.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = TSsm.mamba1_forward(tp, tcfg, tx)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              [tx, *tp.values()])
    assert _rel(got[0], want_x) <= GRAD_RTOL
    for (k, _), g in zip(tp.items(), got[1:]):
        assert g.dtype == (torch.float32 if k in F32_LEAVES else
                           tcfg.param_dtype())
        assert _rel(g, want_p[k]) <= GRAD_RTOL, k


def test_mamba1_prefill_goes_through_the_function():
    """The prefill's scan is ``SelectiveScan``: its node stands in the
    graph of the sublayer's output."""
    _, tcfg = cfgs("jamba-1.5-large-398b", "float32")
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in mamba1_mixer(tcfg, np.random.default_rng(1)).items()}
    out, _ = TSsm.mamba1_forward(tp, tcfg, torch.randn(1, 6, tcfg.d_model))
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [f for f, _ in fn.next_functions]
    assert "SelectiveScanBackward" in {type(f).__name__ for f in seen}


def _ssd_case(regime, dtype, S=80, H=4, hd=16, N=16, seed=3):
    """SSD inputs as ``mamba2_forward`` hands them over (x (B, S, H, hd),
    dt (B, S, H) f32, A (H,), B and C (B, S, N)), and cotangents of y and
    of the final state."""
    rng = np.random.default_rng(seed)
    tt = getattr(torch, dtype)

    def n(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(
            np.float32))

    x = n(B, S, H, hd, std=0.5).to(tt)
    dt = torch.from_numpy(_dt(rng, (B, S, H), regime))
    A = -torch.exp(torch.linspace(0.0, 1.0, H))
    Bm, Cm = n(B, S, N, std=0.3).to(tt), n(B, S, N, std=0.3).to(tt)
    return (x, dt, A, Bm, Cm), n(B, S, H, hd), n(B, H, N, hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regime", REGIMES)
def test_ssd_function_gradients_are_the_twins(regime, dtype):
    """``SSDScan`` on CPU tensors (S 80, Q 32: a padded last chunk): its
    y within the twin's limit, its gradients in x, dt, A, B and C, with
    and without the final state's cotangent, equal to autograd through
    ``ssd_twin`` bit for bit (the backward is that recompute), in each
    input's type; with no launch of the kernel.  In f32 they are also
    held against ``jax.grad`` of the reference's ``ssd_chunked``.  In
    Mamba-2's regime some chunk's decay exceeds 1e-2, so the carried
    state shows."""
    args, gy, gs = _ssd_case(regime, dtype)
    Q = 32
    if regime == "mamba":
        cum = (args[1][:, :2 * Q] * args[2]).reshape(B, 2, Q, -1).sum(2)
        assert float(torch.exp(cum).max()) > 1e-2
    for with_gs in (False, True):
        def run(fn, with_gs=with_gs):
            leaves = [a.detach().requires_grad_(True) for a in args]
            y, state = fn(*leaves)
            total = (y.float() * gy).sum()
            if with_gs:
                total = total + (state * gs).sum()
            return y, torch.autograd.grad(total, leaves)

        ssd_ops.reset_launches()
        y, got = run(lambda *a: TSsm.SSDScan.apply(*a, Q))
        assert ssd_ops.LAUNCHES == {"ssd_intra_chunk": 0}
        y_twin, want = run(lambda *a: TSsm.ssd_twin(*a, chunk=Q))
        assert _rel(y, y_twin) <= (1e-5 if dtype == "float32" else 5e-2)
        for a, g, w in zip(args, got, want):
            assert g.dtype == a.dtype
            assert torch.equal(g, w)
        if dtype == "float32":
            def jloss(*t, with_gs=with_gs):
                y, state = JSsm.ssd_chunked(*t, chunk=Q)
                total = jnp.sum(y * gy.numpy())
                return total + jnp.sum(state * gs.numpy()) if with_gs \
                    else total
            jgrads = jax.grad(jloss, argnums=tuple(range(5)))(
                *(jnp.asarray(a.numpy()) for a in args))
            for g, w in zip(got, jgrads):
                assert _rel(g, w) <= GRAD_RTOL


def test_backward_constants_are_the_sources():
    """``ops.BWD_TILE_STEPS``, ``ops.BWD_SUB_STEPS``,
    ``ops.BWD_BLOCK_CHANNELS`` and ``ops.BWD_CLUSTER_BLOCKS`` are the
    source's ``BWD_TILE``, ``SUB``, ``BWD_CHANNELS`` and ``BWD_CLUSTER``
    (the CPU model of the algorithm follows them); the backward sums across
    threads and blocks with no atomics (two runs agree bit for bit),
    rounds the replayed update as the forward does, takes the walk's
    a_t h_{t-1} as that rounded product again, and calls ``expf`` in one
    place besides the forward's (the replays'; the walk takes none)."""
    text = build.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert (int(consts["BWD_TILE"]), int(consts["SUB"]),
            int(consts["BWD_CHANNELS"]), int(consts["BWD_CLUSTER"])) == \
        (ops.BWD_TILE_STEPS, ops.BWD_SUB_STEPS, ops.BWD_BLOCK_CHANNELS,
         ops.BWD_CLUSTER_BLOCKS)
    assert re.search(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.global", text) is None
    assert text.count("h[n] = __fadd_rn(__fmul_rn(dA, h[n]), dBx);") == 2
    assert text.count("expf(") == 2
    assert "const float ah = __fmul_rn(an[n], hp[n]);" in text


def _in_order(t: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis, first term to last."""
    out = t[..., 0]
    for i in range(1, t.shape[-1]):
        out = out + t[..., i]
    return out


def _channel_sum(v: torch.Tensor) -> torch.Tensor:
    """Σ over channels (the last axis) in the backward kernel's order: a
    warp's 16 channels by ``pair_sum8``'s exchanges (channel i with i + 8,
    then i + 4, i + 2, i + 1), a block's warps in order, a cluster's blocks
    in rank order, then the clusters' partials in order; channels past D
    add zeros."""
    D = v.shape[-1]
    warps = ops.BWD_BLOCK_CHANNELS // 16
    per = ops.BWD_BLOCK_CHANNELS * ops.BWD_CLUSTER_BLOCKS
    n = -(-D // per)
    w = torch.nn.functional.pad(v, (0, n * per - D)).unflatten(
        -1, (n, ops.BWD_CLUSTER_BLOCKS, warps, 16))
    for half in (8, 4, 2, 1):
        w = w[..., :half] + w[..., half:2 * half]
    return _in_order(_in_order(_in_order(w[..., 0])))


def _kernel_model(x, dt, A, Bm, Cm, gy, gh=None):
    """``selective_scan.cu``'s backward algorithm in torch ops: phase 1
    saves the state before every ``BWD_TILE_STEPS``-step tile, scanning
    from 0 with the forward's rounding; phase 2 walks the tiles last
    first, replays the starts of a tile's ``BWD_SUB_STEPS``-step
    sub-tiles from its saved state, then each sub-tile (last first) with
    every step's h_t and a_t kept, and walks it back with no exponential
    of its own.  A channel's 16 states lie on two lanes of 8, so dx's
    and ddt's sums over states add the two halves; dB and dC sum over
    channels in ``_channel_sum``'s order, dA over batch rows in order."""
    Bsz, S, D = x.shape
    N = A.shape[1]
    K, SUB, H = ops.BWD_TILE_STEPS, ops.BWD_SUB_STEPS, N // 2
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()

    def forward(h, t):
        exps.append(t)
        d = dt[:, t, :, None]
        a = torch.exp(d * A)
        return a * h + d * Bf[:, t, None, :] * xf[:, t, :, None], a

    def halves(v):                          # a lane's 8 states, then the pair
        return v[..., :H].sum(-1) + v[..., H:].sum(-1)

    tiles = -(-S // K)
    exps = []                               # steps a state's exp was taken
    saved, h = [], torch.zeros(Bsz, D, N)
    for k in range(tiles):
        saved.append(h)
        if k + 1 < tiles:
            for t in range(k * K, (k + 1) * K):
                h, _ = forward(h, t)
    g = torch.zeros(Bsz, D, N) if gh is None else gh.clone()
    dA = torch.zeros(Bsz, D, N)
    dx, ddt = torch.empty(Bsz, S, D), torch.empty(Bsz, S, D)
    vB, vC = torch.empty(Bsz, S, N, D), torch.empty(Bsz, S, N, D)
    for k in reversed(range(tiles)):
        T0, steps = k * K, min(K, S - k * K)
        starts = [saved[k]]
        for s in range(1, -(-steps // SUB)):
            h = starts[-1]
            for t in range(T0 + (s - 1) * SUB, T0 + s * SUB):
                h, _ = forward(h, t)
            starts.append(h)
        for s in reversed(range(len(starts))):
            r0 = T0 + s * SUB
            kept, h = [], starts[s]
            for t in range(r0, min(r0 + SUB, T0 + steps)):
                h, a = forward(h, t)
                kept.append((h, a))
            for j in reversed(range(len(kept))):
                t = r0 + j
                h, a = kept[j]
                ah = a * (kept[j - 1][0] if j else starts[s])
                d, xv, gv = (v[:, t, :, None] for v in (dt, xf, gy))
                g = g + gv * Cf[:, t, None, :]
                gd = g * d
                vB[:, t] = (gd * xv).transpose(1, 2)
                vC[:, t] = (gv * h).transpose(1, 2)
                dx[:, t] = dt[:, t] * halves(g * Bf[:, t, None, :])
                ddt[:, t] = halves(g * (A * ah + Bf[:, t, None, :] * xv))
                dA = dA + gd * ah
                g = a * g
    # a step's exponentials: phase 1's, the replay of its sub-tile's start
    # and its own sub-tile's replay; the walk takes none
    assert max(collections.Counter(exps).values()) <= 3
    assert len(exps) <= (3 - SUB / K) * S
    return (dx, ddt, _in_order(dA.movedim(0, -1)), _channel_sum(vB),
            _channel_sum(vC))


@pytest.mark.parametrize("with_gh", [False, True])
@pytest.mark.parametrize("S,D,dtype", [(1, 40, "float32"),
                                       (7, 300, "bfloat16"),
                                       (31, 40, "bfloat16"),
                                       (33, 300, "float32"),
                                       (75, 300, "bfloat16")])
def test_kernel_algorithm_matches_plain_backward(S, D, dtype, with_gh):
    """``_kernel_model`` against ``selective_scan_bwd_ref`` within
    ``ref.BWD_RTOL`` (dx and ddt row by row, dA, dB and dC relative to
    their largest |value|, as the card's gate holds the kernel): one
    step, a tile and a sub-tile cut short (S 7, 31), a last tile of one
    step (S 33) and of a ragged sub-tile (S 75); D that cuts a block
    (40) and a second cluster (300); with and without the final state's
    cotangent."""
    args, gy, gh = _scan_case("mamba", dtype, S=S, D=D, seed=S + D)
    gh = gh if with_gh else None
    got = _kernel_model(*args, gy, gh)
    want = ref.selective_scan_bwd_ref(*args, gy, gh)
    for name, g, w in zip(("dx", "ddt"), got, want):
        assert float(ref.row_errors(g, w).max()) <= ref.BWD_RTOL, name
    for name, g, w in zip(("dA", "dB", "dC"), got[2:], want[2:]):
        assert g.shape == w.shape
        if S == 1 and name == "dA":       # h_{-1} = 0: no term
            assert not g.any() and not w.any()
        else:
            assert _rel(g, w) <= ref.BWD_RTOL, name
