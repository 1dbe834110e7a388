"""The port's collective extraction (``core/hlo_flows.py``) and LLM
schedule emitters (``core/llm_workload.py``) against the JAX package's.

Both are host data: the same HLO text must give equal ``CollectiveOp``s,
multipliers, summaries and flows, and the same ``LlmJobSpec`` equal
ops, flows (every field, labels included), edge statistics, workload
pairs and schedules, in both schedule modes — compared field by field
with ``==``.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import hlo_flows as RH  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import hlo_flows as TH  # noqa: E402
from _propcheck import given, settings, strategies as st  # noqa: E402
from test_hlo_flows import AR_BYTES, AG_OUT, HLO  # noqa: E402

MODES = ["sequential", "dp-overlap"]
SPECS = {
    "paper-testbed": dict(num_hosts=16, hosts_per_pod=None),
    "multipod-16": dict(num_hosts=16, chips_per_host=4, hosts_per_pod=8,
                        ep_group_hosts=16),
    "multipod-128": dict(num_hosts=128, chips_per_host=4, hosts_per_pod=8,
                         ep_group_hosts=16, param_bytes=20_000_000_000),
}


def _flow(f):
    t = f.tuple5
    return (f.flow_id, f.src, f.dst, t.src_ip, t.dst_ip, t.src_port,
            t.dst_port, t.protocol, f.bytes, f.label)


def _flows(flows):
    return [_flow(f) for f in flows]


def _ops(ops):
    return [dataclasses.astuple(o) for o in ops]


def _steps(sched):
    return [dataclasses.astuple(s) for s in sched]


# ---------------------------------------------------------------------------
# hlo_flows: tests/test_hlo_flows.py's cases on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["bf16[128,256]{1,0}", "f32[10]",
                                   "(f32[2,2], bf16[4])", "pred[]",
                                   "token[]", "(s32[], u8[3,0])"])
def test_shape_bytes(shape):
    assert TH.shape_bytes(shape) == RH.shape_bytes(shape)


def test_extract_and_trip_counts():
    ops = TH.extract_collectives(HLO)
    assert _ops(ops) == _ops(RH.extract_collectives(HLO))
    by_kind = {o.kind: o for o in ops}
    ar = by_kind["all-reduce"]
    assert ar.multiplier == 12
    assert ar.groups == ((0, 1, 2, 3), (4, 5, 6, 7))
    assert ar.wire_bytes == int(2 * 3 / 4 * AR_BYTES)
    assert by_kind["all-gather"].wire_bytes == int(3 / 4 * AG_OUT)
    assert by_kind["collective-permute"].pairs == ((0, 1), (1, 2), (2, 3),
                                                   (3, 0))


def test_multipliers_and_computations():
    assert TH.computation_multipliers(HLO) == \
        RH.computation_multipliers(HLO)
    assert TH.op_computations(HLO) == RH.op_computations(HLO)


def test_summary_scales_by_multiplier():
    got = TH.summarize(TH.extract_collectives(HLO))
    want = RH.summarize(RH.extract_collectives(HLO))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_count == want.total_count


def test_iota_transpose_groups():
    txt = ("ENTRY %m (a: f32[8]) -> f32[8] {\n"
           "  ROOT %ar = f32[8] all-reduce(%a), channel_id=1, "
           "replica_groups=[2,2]<=[2,2]T(1,0), to_apply=%add\n}")
    ops = TH.extract_collectives(txt)
    assert ops[0].groups == ((0, 2), (1, 3))
    assert _ops(ops) == _ops(RH.extract_collectives(txt))


@pytest.mark.parametrize("layout", ["one-pod", "pod-per-host"])
def test_flow_decomposition_classes(layout):
    coords = ({d: (0, d // 4, d % 4) for d in range(8)}
              if layout == "one-pod" else
              {d: (d // 4, d // 4, d % 4) for d in range(8)})
    flows, stats = TH.collectives_to_flows(TH.extract_collectives(HLO),
                                           coords)
    rflows, rstats = RH.collectives_to_flows(RH.extract_collectives(HLO),
                                             coords)
    assert _flows(flows) == _flows(rflows)
    assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
    assert len(flows) == stats.inter_pod_dcn
    assert all(f.tuple5.dst_port == 4791 for f in flows)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute",
                                  "collective-broadcast"])
@pytest.mark.parametrize("n", [1, 2, 7])
def test_wire_and_operand(kind, n):
    assert TH.wire_and_operand(kind, 12_345, n) == \
        RH.wire_and_operand(kind, 12_345, n)


def test_wire_and_operand_rejects_unknown_kind():
    with pytest.raises(ValueError):
        TH.wire_and_operand("all-shuffle", 1, 2)


@given(st.integers(2, 16), st.integers(1, 64))
@settings(max_examples=50, deadline=None)
def test_ring_conservation(n, kb):
    bytes_ = kb * 1024
    group = ",".join(str(i) for i in range(n))
    txt = (f"ENTRY %m (a: u8[{bytes_}]) -> u8[{bytes_}] {{\n"
           f"  ROOT %ar = u8[{bytes_}] all-reduce(%a), channel_id=1, "
           f"replica_groups={{{{{group}}}}}, to_apply=%add\n}}")
    ops = TH.extract_collectives(txt)
    coords = {i: (i, i, 0) for i in range(n)}
    flows, _ = TH.collectives_to_flows(ops, coords)
    assert len(flows) == n
    per_edge = int(2 * (n - 1) / n * bytes_)
    assert all(f.bytes == per_edge for f in flows)
    assert _flows(flows) == _flows(
        RH.collectives_to_flows(RH.extract_collectives(txt), coords)[0])


# ---------------------------------------------------------------------------
# llm_workload: ops, flows and schedules equal at every committed shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_llm_collective_ops_and_flows(spec):
    kw = SPECS[spec]
    host = T.server_name if kw["hosts_per_pod"] is None else None
    rhost = R.server_name if kw["hosts_per_pod"] is None else None
    got = T.LlmJobSpec(**kw)
    want = R.LlmJobSpec(**kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert _ops(T.llm_collective_ops(got)) == \
        _ops(R.llm_collective_ops(want))
    flows, stats = T.llm_flows(got, host_name=host)
    rflows, rstats = R.llm_flows(want, host_name=rhost)
    assert _flows(flows) == _flows(rflows)
    assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
    wl, flows2, _ = T.llm_workload(got, host_name=host)
    rwl, _, _ = R.llm_workload(want, host_name=rhost)
    assert _flows(flows2) == _flows(flows)
    assert [dataclasses.astuple(p) for p in wl.pairs] == \
        [dataclasses.astuple(p) for p in rwl.pairs]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_llm_schedule(spec, mode):
    kw = SPECS[spec]
    if kw["hosts_per_pod"] is None:
        got = T.paper_testbed_llm_schedule(mode)
        want = R.paper_testbed_llm_schedule(mode)
    else:
        extra = {k: v for k, v in kw.items()
                 if k not in ("num_hosts", "chips_per_host",
                              "hosts_per_pod", "ep_group_hosts")}
        if kw["num_hosts"] != 16:
            extra["num_hosts"] = kw["num_hosts"]
        got = T.multipod_llm_schedule(mode, **extra)
        want = R.multipod_llm_schedule(mode, **extra)
    _, flows, stats, sched = got
    _, rflows, rstats, rsched = want
    assert _flows(flows) == _flows(rflows)
    assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
    assert _steps(sched) == _steps(rsched)
    ops, phases = T.llm_collective_phases(T.LlmJobSpec(**kw), mode)
    rops, rphases = R.llm_collective_phases(R.LlmJobSpec(**kw), mode)
    assert _ops(ops) == _ops(rops) and _steps(phases) == _steps(rphases)
    # the schedule covers exactly the channels the flows carry
    assert {T.flow_channel(f) for f in flows} == \
        {c for s in sched for c in s.channels}
    assert T.step_byte_totals(flows, sched).tolist() == \
        R.step_byte_totals(rflows, rsched).tolist()


def test_full_width_multipod_schedule_shape():
    """The 128-host job ``chip_smoke.py`` drives: 4,304 DCN flows over
    the five sequential steps."""
    _, flows, _, sched = T.multipod_llm_schedule(
        num_hosts=128, param_bytes=20_000_000_000)
    assert len(flows) == 4_304
    assert [s.name for s in sched] == [
        "fwd-all-gather", "moe-all-to-all", "bwd-reduce-scatter",
        "grad-all-reduce", "barrier"]


def test_paper_and_multipod_workload_variants():
    for fn in ("paper_testbed_llm_workload", "multipod_llm_workload"):
        _, flows, stats = getattr(T, fn)(moe_layers=2)
        _, rflows, rstats = getattr(R, fn)(moe_layers=2)
        assert _flows(flows) == _flows(rflows)
        assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
