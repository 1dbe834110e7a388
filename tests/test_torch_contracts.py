"""The port's runtime contracts (``FLOWTRACER_CONTRACTS=1``) against the
JAX package's: the cases of ``tests/test_flowcheck.py``'s contract
section on the port, each broken input raising in the port where it
raises in the reference, and the three seams (``resolve_spec``,
``simulate_paths``, ``throughput_from_result``) armed only while the
variable is set."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import contracts as RC  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import contracts as TC  # noqa: E402
from repro_torch.core import strategies as TS  # noqa: E402
from repro_torch.core.vector_sim import resolve_spec  # noqa: E402

CPU = "cpu"


@pytest.fixture
def contracts_on(monkeypatch):
    monkeypatch.setenv("FLOWTRACER_CONTRACTS", "1")


def _routed(pkg, strategy=None, **kw):
    comp = pkg.compile_fabric(pkg.build_paper_testbed())
    wl = pkg.bipartite_pairs([pkg.server_name(i) for i in range(4)],
                             [pkg.server_name(8 + i) for i in range(4)],
                             flows_per_pair=2)
    flows = pkg.synthesize_flows(wl, nic_ip=pkg.nic_ip, nics_per_server=2)
    if pkg is T:
        kw["device"] = CPU
    return pkg.simulate_paths(comp, flows, [0, 1], strategy=strategy, **kw)


def test_contracts_off_by_default(monkeypatch):
    monkeypatch.delenv("FLOWTRACER_CONTRACTS", raising=False)
    assert not T.contracts_enabled()
    for off in ("0", "false", "off", "", "No"):
        monkeypatch.setenv("FLOWTRACER_CONTRACTS", off)
        assert not T.contracts_enabled() and not R.contracts_enabled()
    monkeypatch.setenv("FLOWTRACER_CONTRACTS", "yes")
    assert T.contracts_enabled() and R.contracts_enabled()
    assert T.CONTRACTS_ENV == R.CONTRACTS_ENV


@pytest.mark.parametrize("strategy", [None, "prime-spray",
                                      "adaptive-spray-elephant",
                                      "wave-congestion-aware"])
def test_contracts_pass_on_healthy_pipeline(contracts_on, strategy):
    assert T.contracts_enabled()
    res = _routed(T, strategy=strategy, demand_mode="bytes")
    tp = T.throughput_from_result(res, transport="roce-nack")
    assert bool(torch.isfinite(tp.goodput).all())
    _, flows, _, sched = T.paper_testbed_llm_schedule()
    tl = T.simulate_timeline(T.build_paper_testbed(), flows, sched, [0],
                             strategy=strategy, demand_mode="bytes",
                             transport="roce-nack", timing="event",
                             device=CPU)
    assert bool(torch.isfinite(tl.job_completion).all())


def _break_trace(pkg, res, how):
    if how == "demand":
        res.demand = res.demand * 2.0       # fractions must sum to 1
    elif how == "link range":
        res.link_ids = res.link_ids + res.compiled.num_links
    elif how == "flow_index":
        res.flow_index = res.flow_index + res.num_flows
    elif how == "flow_demand":
        res.flow_demand = -res.flow_demand
    elif how == "extra_exposure":
        n, s = res.num_flows, res.num_seeds
        res.extra_exposure = (np.full((n, s), -1.0) if pkg is R else
                              torch.full((n, s), -1.0, dtype=torch.float64))
    elif how == "float ids":
        res.link_ids = (res.link_ids.astype(np.float64) if pkg is R
                        else res.link_ids.to(torch.float64))
    return res


@pytest.mark.parametrize("how,match", [
    ("demand", "sum to 1"), ("link range", "link ids"),
    ("flow_index", "flow_index"), ("flow_demand", "flow_demand"),
    ("extra_exposure", "extra_exposure"), ("float ids", "integer"),
])
def test_contract_catches_bad_trace_result(contracts_on, how, match):
    for pkg, checks in ((R, RC), (T, TC)):
        res = _break_trace(pkg, _routed(pkg, strategy="prime-spray"), how)
        with pytest.raises(pkg.ContractViolation, match=match):
            checks.check_trace_result(res)
    # and a healthy result passes both
    RC.check_trace_result(_routed(R))
    TC.check_trace_result(_routed(T))


@pytest.mark.parametrize("field,scale,match", [
    ("goodput", 2.0, "goodput"), ("rates", -1.0, "rates"),
    ("efficiency", 2.0, "efficiency"), ("exposure", -1.0, "exposure"),
])
def test_contract_catches_bad_throughput(contracts_on, field, scale, match):
    for pkg, checks in ((R, RC), (T, TC)):
        tp = pkg.throughput_from_result(_routed(pkg, strategy="prime-spray"),
                                        transport="roce-nack")
        setattr(tp, field, getattr(tp, field) * scale)
        with pytest.raises(pkg.ContractViolation, match=match):
            checks.check_throughput(tp)


@pytest.mark.parametrize("field,value,match", [
    ("strategy", "prime-spray", "name string"),
    ("transport", "roce-nack", "name string"),
    ("hash_backend", None, "hash_backend"),
    ("max_hops", 0, "max_hops"),
])
def test_contract_checks_resolved_spec(contracts_on, field, value, match):
    for pkg, checks in ((R, RC), (T, TC)):
        s = (pkg.SimSpec(strategy="prime-spray").resolve() if pkg is R
             else pkg.SimSpec(strategy="prime-spray", device=CPU).resolve())
        checks.check_spec(s)                  # a healthy resolve passes
        with pytest.raises(pkg.ContractViolation, match=match):
            checks.check_spec(dataclasses.replace(s, **{field: value}))


def test_contract_checks_the_resolved_device(contracts_on):
    s = T.SimSpec(device=CPU).resolve()
    with pytest.raises(T.ContractViolation, match="device"):
        TC.check_spec(dataclasses.replace(s, device="cpu"))


# ---------------------------------------------------------------------------
# the seams are armed under FLOWTRACER_CONTRACTS=1 and only then
# ---------------------------------------------------------------------------


class _BadDemand(TS.PrimeSpraying):
    """A strategy whose routed result breaks the flowlet-demand contract."""

    def route(self, *args, **kw):
        res = super().route(*args, **kw)
        res.demand = res.demand * 2.0
        return res


def test_simulate_paths_seam(monkeypatch):
    monkeypatch.delenv("FLOWTRACER_CONTRACTS", raising=False)
    _routed(T, strategy=_BadDemand())      # off: nothing checks it
    monkeypatch.setenv("FLOWTRACER_CONTRACTS", "1")
    with pytest.raises(T.ContractViolation, match=r"simulate_paths.*sum"):
        _routed(T, strategy=_BadDemand())


def test_resolve_spec_seam(monkeypatch):
    real = T.SimSpec.resolve

    def unresolved(self):
        return dataclasses.replace(real(self), hash_backend=None)

    monkeypatch.setattr(T.SimSpec, "resolve", unresolved)
    monkeypatch.delenv("FLOWTRACER_CONTRACTS", raising=False)
    resolve_spec(None, {"device": CPU})
    monkeypatch.setenv("FLOWTRACER_CONTRACTS", "1")
    with pytest.raises(T.ContractViolation, match="resolve_spec"):
        _routed(T)


def test_throughput_from_result_seam(monkeypatch):
    from repro_torch.core import vector_throughput as TT

    res = _routed(T, strategy="prime-spray")
    real = TT.reordering_efficiency
    monkeypatch.setattr(TT, "reordering_efficiency",
                        lambda e, p: real(e, p) * 2.0)
    monkeypatch.delenv("FLOWTRACER_CONTRACTS", raising=False)
    T.throughput_from_result(res, transport="roce-nack")
    monkeypatch.setenv("FLOWTRACER_CONTRACTS", "1")
    with pytest.raises(T.ContractViolation, match="throughput_from_result"):
        T.throughput_from_result(res, transport="roce-nack")
