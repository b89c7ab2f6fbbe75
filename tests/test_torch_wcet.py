"""The reference's line-rate certification cases (``tests/test_wcet.py``)
replayed on the port, on the CPU (``device="cpu"`` passed to every
endpoint).  The reference's four cases built on ``benchmarks/bench_wcet``
(``test_mp_cycles_equals_step_bound``, ``test_soundness_seeded_corpus``,
``test_soundness_property_hypothesis``,
``test_stock_operators_within_default_budget``) wait for the port's own
benchmark helpers; ``_failfast_op`` is copied here from there.

Line-rate certification (``core/wcet``): registration-time WCET /
traffic / occupancy certificates and their three enforcement points.

The invariants under test:

1. Every successful registration carries a ``LineRateCertificate``; it
   survives a JSON round-trip, and the registry surfaces it through
   ``describe_analysis()`` / ``dump()``.
2. The certificate is *enforced*: an over-budget operator is rejected
   at registration with a diagnostic naming the hottest pc and the
   violated resource; a statically-infeasible deadline retires
   ``STATUS_TIMEOUT`` at admission without ever launching (and the
   check can be disabled); the dispatch cost model's learned wave
   estimate clamps to the summed certified bound.
"""

import json

import pytest

from repro_torch.core import isa, memory, wcet
from repro_torch.core.costmodel import DispatchCostModel
from repro_torch.core.endpoint import TiaraEndpoint
from repro_torch.core.isa import Alu
from repro_torch.core.memory import Grant
from repro_torch.core.program import OperatorBuilder
from repro_torch.core.registry import OperatorRegistry, RegistrationError
from repro_torch.core.serving_loop import (ServingConfig, ServingLoop,
                                           VirtualClock)
from repro_torch.core.verifier import verify


def _table():
    return memory.packed_table([("src", 1024), ("dst", 1024)])


def _failfast_op():
    """A bulk gather whose certified WCET (~hundred microseconds)
    dwarfs any per-wave delay, so a deadline below it is statically
    infeasible."""
    rt = memory.packed_table([("src", 4096), ("dst", 4096)])
    b = OperatorBuilder("gather32", n_params=1, regions=rt)
    off = b.reg()
    b.alu(off, b.param(0), Alu.AND, 1023)
    with b.loop(32):
        b.memcpy(dst_region="dst", dst_off=off, src_region="src",
                 src_off=off, n_words=2048, src_dev=0)
        b.alu(off, off, Alu.ADD, 7)
        b.alu(off, off, Alu.AND, 1023)
    b.ret()
    return b.build(), rt


def _hog(rt):
    """~2.5M certified cycles (4096 iterations x 4 local loads) — over
    the default 2^21-cycle budget while staying under the verifier's
    step cap."""
    b = OperatorBuilder("hog", n_params=1, regions=rt)
    z = b.const(0)
    r = b.reg()
    with b.loop(4096):
        for _ in range(4):
            b.load(r, "src", z)
    b.ret(r)
    return b.build()


# ---------------------------------------------------------------------------
# 1. attachment + reporting
# ---------------------------------------------------------------------------

def test_certificate_attached_at_registration():
    rt = _table()
    reg = OperatorRegistry(rt)
    reg.add_tenant(Grant.all_of(rt, "t"))
    b = OperatorBuilder("probe", n_params=1, regions=rt)
    off = b.reg()
    b.alu(off, b.param(0), Alu.AND, 1023)
    b.load(b.reg(), "src", off, dev=0)
    b.ret()
    op_id = reg.register("t", b.build())
    cert = reg[op_id].certificate
    assert cert is not None
    assert cert.wcet_cycles > 0 and cert.wcet_latency_us > 0
    assert cert.words_read >= 1
    assert cert.bottleneck in ("mp", "dma_channel", "wire", "slots")
    assert cert.per_pc        # per-site attribution is never empty


def test_certificate_json_roundtrip_and_dump():
    rt = _table()
    reg = OperatorRegistry(rt)
    reg.add_tenant(Grant.all_of(rt, "t"))
    b = OperatorBuilder("rep", n_params=1, regions=rt)
    off = b.reg()
    b.alu(off, b.param(0), Alu.AND, 511)
    with b.loop(8):
        b.memcpy(dst_region="dst", dst_off=off, src_region="src",
                 src_off=off, n_words=64, src_dev=0)
    b.ret()
    op_id = reg.register("t", b.build())
    cert = reg[op_id].certificate
    blob = json.loads(json.dumps(cert.to_json()))
    assert blob["wcet_cycles"] == pytest.approx(cert.wcet_cycles)
    assert blob["memcpy_bytes"] == cert.memcpy_bytes
    assert blob["bottleneck"] == cert.bottleneck
    pcs = {e["pc"] for e in blob["per_pc"]}
    assert all(isinstance(e["op"], str) for e in blob["per_pc"])
    assert pcs == {e.pc for e in cert.per_pc}
    # the registry surfaces the certificate in its analysis reporting
    assert "certificate:" in reg[op_id].describe_analysis()
    assert "certificate:" in reg.dump()


def test_hottest_site_attribution():
    rt = _table()
    vop = verify(_hog(rt), regions=rt)
    hot = vop.certificate.hottest("cycles")
    assert hot.count == 4096 * 4 or hot.count == 4096
    assert hot.op == "LOAD"


# ---------------------------------------------------------------------------
# 2. enforcement
# ---------------------------------------------------------------------------

def test_over_budget_rejected_names_pc_and_resource():
    rt = _table()
    reg = OperatorRegistry(rt)       # wcet.DEFAULT_BUDGET
    reg.add_tenant(Grant.all_of(rt, "t"))
    with pytest.raises(RegistrationError) as ei:
        reg.register("t", _hog(rt))
    msg = str(ei.value)
    assert "hog" in msg
    assert "cycles" in msg           # the violated resource
    assert "pc" in msg               # the hottest site
    assert "LOAD" in msg


def test_budget_none_admits_and_tight_budget_rejects_traffic():
    rt = _table()
    reg = OperatorRegistry(rt, budget=None)
    reg.add_tenant(Grant.all_of(rt, "t"))
    reg.register("t", _hog(rt))      # no budget, no gate
    tight = OperatorRegistry(
        rt, budget=wcet.Budget(max_memcpy_bytes=128))
    tight.add_tenant(Grant.all_of(rt, "t"))
    b = OperatorBuilder("mover", n_params=0, regions=rt)
    z = b.const(0)
    b.memcpy(dst_region="dst", dst_off=z, src_region="src", src_off=z,
             n_words=64, src_dev=0)
    b.ret()
    with pytest.raises(RegistrationError) as ei:
        tight.register("t", b.build())
    assert "memcpy" in str(ei.value).lower()


def test_admission_failfast_retires_timeout_without_launch():
    prog, rt = _failfast_op()
    clk = VirtualClock()
    ep, sessions = TiaraEndpoint.for_tenants(
        [("t", rt)], n_devices=1, clock=clk, sleep=clk.sleep,
        device="cpu")
    sessions["t"].register(prog)
    loop = ServingLoop(ep, ServingConfig(ring_size=2, ring_age_s=0.0))
    op_id, _ = sessions["t"]._resolve("gather32")
    cert = ep.registry[op_id].certificate
    wcet_s = cert.wcet_latency_us * 1e-6
    # infeasible: in the future, but below the certified WCET
    c = loop.submit("t", "gather32", [0], deadline_s=0.25 * wcet_s)
    assert c.done and c.status == isa.STATUS_TIMEOUT
    assert c.event is not None and c.event.wave == -1   # never launched
    assert loop.stats.launched == 0
    assert loop.stats.timed_out == 1
    # a feasible post on the same loop still executes
    c2 = loop.submit("t", "gather32", [1], deadline_s=10.0)
    loop.drain()
    assert c2.status == isa.STATUS_OK and c2.event.wave >= 0
    st = loop.stats
    assert st.submitted == (st.executed + st.flushed + st.timed_out
                            + st.rejected + st.shed)


def test_admission_failfast_disabled_launches():
    prog, rt = _failfast_op()
    clk = VirtualClock()
    ep, sessions = TiaraEndpoint.for_tenants(
        [("t", rt)], n_devices=1, clock=clk, sleep=clk.sleep,
        device="cpu")
    sessions["t"].register(prog)
    loop = ServingLoop(ep, ServingConfig(
        ring_size=1, ring_age_s=0.0, admission_wcet=False))
    op_id, _ = sessions["t"]._resolve("gather32")
    wcet_s = ep.registry[op_id].certificate.wcet_latency_us * 1e-6
    c = loop.submit("t", "gather32", [0], deadline_s=0.25 * wcet_s)
    loop.drain()
    # without the certificate check the post launches normally (the
    # virtual clock never passes the deadline here, so it completes)
    assert c.event is not None and c.event.wave >= 0
    assert loop.stats.launched == 1


def test_wave_us_clamps_to_certified_ceiling():
    m = DispatchCostModel()
    free = m.wave_us(batch=8, step_bound=4096, key=1)
    assert m.wave_us(batch=8, step_bound=4096, key=1,
                     cert_ceiling_us=free * 0.5) <= free * 0.5
    # a ceiling above the estimate changes nothing
    assert m.wave_us(batch=8, step_bound=4096, key=1,
                     cert_ceiling_us=free * 10) == pytest.approx(free)
