"""Quickstart on the PyTorch port: write a Tiara operator, register it on
an endpoint, post work to your queue pair, ring the doorbell, poll the
completion — then time it, shard it, pipeline it, break it and overload
it.

    PYTHONPATH=src python examples/quickstart_torch.py              # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The surface mirrors an RNIC: a ``TiaraEndpoint`` owns the memory pool
(a tensor on the device) and the dispatch table; ``connect()`` gives each
tenant a ``Session`` (queue pair) with its regions and grant wired
automatically; ``Session.post`` enqueues pre-registered operator
invocations; one ``doorbell()`` drains every session's posts as a single
batched wave.  It runs on the CUDA card unless ``--device`` names another
device, and raises when there is no card and none is named.
"""

import argparse
import time
from typing import Optional, Sequence

from repro_torch.core import costmodel as cm
from repro_torch.core import faults
from repro_torch.core import operators as ops
from repro_torch.core import serving_loop as serving
from repro_torch.core import simulator as sim
from repro_torch.core.endpoint import EndpointError, TiaraEndpoint
from repro_torch.core.frontend import compile_source
from repro_torch.core.vm import resolve_device
from repro_torch.distributed.mesh import make_device_mesh

WALK_SRC = '''
def walk(start, depth):
    cur = start
    for _ in bounded(depth, 64):
        cur = load("graph", cur + 1)     # the loaded value IS the next
    memcpy("reply", 0, "graph", cur, 8)  # address: register-chained loads
    return load("graph", cur)
'''

#: Device rows of the pool; step 6 shards them over this many mesh
#: shards, all on the one device the example runs on.
N_SHARDS = 4


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    walls = {}

    # A disaggregated memory node: a graph region and a reply region.
    w = ops.GraphWalk(n_nodes=4096, max_depth=64)

    # 1. Stand up the endpoint (it owns the pool, on `dev`) and connect:
    #    the tenant's regions, view, and grant are wired in one call.
    #    The pool has N_SHARDS device rows; step 6 shards them over a
    #    mesh of that many shards on this one device.
    mesh = make_device_mesh(N_SHARDS, devices=[dev] * N_SHARDS)
    ep, sessions = TiaraEndpoint.for_tenants(
        [("quickstart", w.regions())], n_devices=N_SHARDS, device=dev,
        mesh=mesh)
    sess = sessions["quickstart"]
    print(f"endpoint on {ep.device}: {N_SHARDS} x "
          f"{ep.regions.pool_words} words")

    # 2. Write the operator in the restricted source subset (paper §3.3).
    program = compile_source(WALK_SRC, regions=sess.view)
    print("compiled operator:")
    print(program.disassemble(), "\n")

    # 3. Register it: compile -> static verification against the
    #    session's grant -> op_id in the endpoint's dispatch table.  The
    #    registry also derives the operator's symbolic access footprint
    #    (core/access.py) and its line-rate certificate (core/wcet.py):
    #    sound upper bounds on cycles, traffic and occupancy, enforced at
    #    registration (Budget), admission (deadline fail-fast, step 9)
    #    and pricing (the cost model's wave ceiling).
    op_id = sess.register(program)
    vop = ep.registry[op_id].verified
    print(f"registered as op {op_id}; proven step bound = "
          f"{vop.step_bound}, loop depth = {vop.max_loop_depth}")
    print("access analysis:", ep.registry[op_id].describe_analysis())
    cert = ep.registry[op_id].certificate
    print("line-rate certificate:", cert.describe())
    hot = cert.hottest("cycles")
    print(f"hottest site: pc {hot.pc} {hot.op} x{hot.count} "
          f"({hot.cycles:.0f} worst-case cycles)\n")

    # 4. Populate the memory node and post work to the queue pair.  The
    #    doorbell drains the send queue as one wave; completions land in
    #    the session's completion queue.
    order = w.populate(sess.pool, sess.view)
    start, depth = int(order[0]) * 8, 24
    completion = sess.post("walk", [start, depth])
    t0 = time.perf_counter()
    ep.doorbell()
    walls["doorbell_ms"] = (time.perf_counter() - t0) * 1e3
    (done,) = sess.poll_cq()
    assert done is completion and completion.done
    expect = w.reference(order, int(order[0]), depth)
    print(f"walk(depth={depth}) -> {completion.result()} "
          f"(reference {expect}, steps {completion.steps}, engine "
          f"{ep.last_decision.mode if ep.last_decision else 'batched'})")
    assert completion.result() == expect
    # ... or let the handle flush for you: result() rings the doorbell
    # if the post is still outstanding.
    assert sess.post("walk", [start, 12]).result() == \
        w.reference(order, int(order[0]), 12)

    # 5. What did it cost?  Cycle-level NIC timing vs one-sided RDMA
    #    (Session.trace replays the invocation on the pyvm oracle).
    trace = sess.trace("walk", [start, depth]).trace
    ts = sim.simulate_task(vop, trace)
    rdma = cm.rdma_chain_latency_us(depth)
    print(f"\nTiara:  {ts.latency_us:6.2f} us  (1 round trip + "
          f"{depth} local DMA hops, simulated)")
    print(f"RDMA:   {rdma:6.2f} us  ({depth} dependent round trips)")
    print(f"speedup: {rdma / ts.latency_us:.2f}x  (paper: 2.85x at "
          f"depth 10)")
    assert ts.latency_us < rdma

    # 6. Sharded placement: the pool's device rows shard over the mesh
    #    and each shard executes the posts whose `home` it owns —
    #    placement is a doorbell concern, the posts don't change.  Every
    #    wave is bit-identical to single-device execution.
    orders = [w.populate(sess.pool, sess.view, device=d, seed=d)
              for d in range(N_SHARDS)]
    wave = [sess.post("walk", [int(orders[d][0]) * 8, 12], home=d)
            for d in range(N_SHARDS)]
    t0 = time.perf_counter()
    ep.doorbell(placement="sharded")
    walls["sharded_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"\nsharded wave over {N_SHARDS} shards on {dev}:")
    for d, c in enumerate(wave):
        assert c.result() == w.reference(orders[d], int(orders[d][0]), 12)
        print(f"  home {d}: walk(depth=12) -> {c.ret}  (reference ok)")

    # 7. Split-phase pipelining: doorbell(wait=False) *launches* a wave
    #    and returns an in-flight WaveHandle — post the next wave while
    #    the first is still computing (the pool dependency chains through
    #    the device stream), then retire both with one wait_all().
    wave1 = [sess.post("walk", [start, d]) for d in (6, 18)]
    h1 = ep.doorbell(wait=False)              # launched, NOT retired
    wave2 = [sess.post("walk", [start, d]) for d in (30, 42)]
    ep.doorbell(wait=False)                   # pipelined behind wave 1
    assert not wave1[0].done and ep.in_flight == 4
    n = ep.wait_all()                         # retires both, wave order
    print(f"\npipelined two-wave step: {n} completions retired "
          f"(wave {h1.wave_id} first)")
    for c, d in zip(wave1 + wave2, (6, 18, 30, 42)):
        assert c.result() == w.reference(orders[0], int(orders[0][0]), d)
        print(f"  walk(depth={d}) -> {c.ret}  (wave {c.event.wave})")

    # 8. Fault model (RNIC semantics): a wild pointer, out-of-region
    #    window, or access to a failed device halts JUST that lane with
    #    STATUS_PROT_FAULT, suppresses its writes, and the CQE carries
    #    FaultInfo(pc, opcode, addr, device).  The owning session enters
    #    an error state — later posts retire STATUS_FLUSHED without
    #    executing — until reset().  Tear one next-pointer through the
    #    fault-injection harness (core/faults.py):
    ep.inject(faults.corrupt_words(
        [(0, sess.view["graph"].base + start + 1, -999_999)]))
    torn = sess.post("walk", [start, 4])
    ep.doorbell()
    assert torn.faulted and sess.in_error
    print(f"\ntorn pointer -> {torn.fault}")
    flushed = sess.post("walk", [start, 4])     # QP in error: flushed
    assert flushed.flushed and flushed.event.wave == -1
    try:
        torn.result()                           # result() surfaces it
    except EndpointError as e:
        print(f"result() raised: {e}")
    sess.reset()                                # error state is sticky
    w.populate(sess.pool, sess.view, device=0, seed=0)   # heal the ring
    healed = sess.post("walk", [start, 12])
    ep.doorbell()
    assert healed.ok
    print(f"after reset + repair: walk(depth=12) -> {healed.result()}")

    # 9. Overload-safe serving: ServingLoop wraps the split-phase surface
    #    with admission control (token buckets + weighted fair
    #    queueing), a continuous batcher, bounded in-flight waves,
    #    deadlines and load shedding.  Every submitted post retires
    #    exactly one CQE.  On a VirtualClock the whole run — including
    #    the injected overload — is deterministic.
    vc = serving.VirtualClock()
    ep2, tenants = TiaraEndpoint.for_tenants(
        [("gold", w.regions()), ("econ", w.regions())],
        clock=vc, sleep=vc.sleep, device=dev)
    starts, refs = {}, {}
    for name, s in tenants.items():
        s.register(compile_source(WALK_SRC, regions=s.view))
        torder = w.populate(s.pool, s.view)
        starts[name] = int(torder[0]) * 8
        refs[name] = torder
    loop = serving.ServingLoop(
        ep2,
        serving.ServingConfig(ring_size=4, ring_age_s=0.002,
                              max_inflight_waves=2, max_pending=8,
                              shed_watermark=12,
                              default_deadline_s=0.05,
                              opportunistic_poll=False),
        qos={"gold": serving.TenantQoS(weight=2.0),
             "econ": serving.TenantQoS(weight=1.0, rate=300.0,
                                       burst=2)})
    # the injected overload: every wave is slowed by 20 ms of NIC delay
    # and "econ" is stalled outright for 60 ms — longer than the 50 ms
    # deadline, so its queued posts age out deterministically
    ep2.inject(faults.delay_waves(0.02) + faults.stall_tenant("econ", 0.06))
    posts = []
    t0 = time.perf_counter()
    for i in range(24):
        tenant = "gold" if i % 3 else "econ"
        d = 6 + (i % 4)
        posts.append((tenant, d, loop.submit(tenant, "walk",
                                             [starts[tenant], d])))
        loop.pump()
    loop.drain()
    walls["serving_ms"] = (time.perf_counter() - t0) * 1e3
    ep2.clear_faults()
    st = loop.stats
    print(f"\nserving under injected overload ({st.submitted} posts):")
    print(f"  executed {st.executed} (ok {st.ok}), timed out "
          f"{st.timed_out}, rejected {st.rejected}, shed {st.shed}")
    assert st.submitted == (st.executed + st.flushed + st.timed_out
                            + st.rejected + st.shed)
    assert st.executed > 0 and st.timed_out + st.rejected + st.shed > 0
    for tenant, d, c in posts:
        if c.ok:
            assert c.ret == w.reference(refs[tenant],
                                        int(refs[tenant][0]), d)
    return dict(walls=walls, stats={
        k: getattr(st, k) for k in ("submitted", "executed", "ok",
                                    "timed_out", "rejected", "shed")})


if __name__ == "__main__":
    main()
