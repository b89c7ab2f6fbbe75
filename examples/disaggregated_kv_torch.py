"""Disaggregated KV over a simulated multi-node pool on the PyTorch port:
the paper's §4.6 PagedAttention workload end to end, functional + timed.

A 4-node memory pool holds a paged KV cache; a compute node resolves
logical block ids through each node's Block Table with ONE Tiara
invocation per node, and the blocks stream straight back to the client
(remote-reply Memcpy).  Compare against stop-and-wait RDMA and optimally
batched RDMA.

    PYTHONPATH=src python examples/disaggregated_kv_torch.py
    PYTHONPATH=src python examples/disaggregated_kv_torch.py --device cpu

The endpoint's pool lives on the device; each invocation is resolved
through ``Session.trace`` (the ``pyvm`` oracle, then the cycle
simulator), so the figures are the simulated NIC's and do not depend on
the device.  The blocks each reply delivers to the compute node are held
to the blocks the node's pool holds at the requested ids.  It runs on the CUDA card unless ``--device`` names another
device, and raises when there is no card and none is named.
"""

import argparse
import hashlib
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.core import operators as ops
from repro_torch.core import simulator as sim
from repro_torch.core.endpoint import TiaraEndpoint
from repro_torch.core.vm import resolve_device

N_NODES = 4
BLOCK_BYTES = 8192
BLOCKS_PER_NODE = 64
REQ_BLOCKS = 160          # the paper's LLaMA3-70B request: 160 blocks


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    k = ops.PagedKVFetch(n_blocks_pool=BLOCKS_PER_NODE,
                         block_bytes=BLOCK_BYTES,
                         max_req_blocks=REQ_BLOCKS)

    # devices 0..N-1 = memory nodes, device N = the compute node
    # (client); one endpoint owns the whole multi-node pool
    ep, sessions = TiaraEndpoint.for_tenants([("kv", k.regions())],
                                             n_devices=N_NODES + 1,
                                             device=dev)
    sess = sessions["kv"]
    op_id = sess.register(k.build(sess.view, remote_reply=True))
    vop = ep.registry[op_id].verified
    tables = [k.populate(sess.pool, sess.view, device=d, seed=d)
              for d in range(N_NODES)]

    rng = np.random.default_rng(0)
    want = rng.integers(0, N_NODES * BLOCKS_PER_NODE, REQ_BLOCKS)
    total_us = 0.0
    fetched = 0
    nodes = []
    delivered = hashlib.sha256()
    for node in range(N_NODES):
        ids = [int(b % BLOCKS_PER_NODE) for b in want
               if b // BLOCKS_PER_NODE == node][:REQ_BLOCKS]
        if not ids:
            continue
        k.make_request(sess.pool, sess.view, ids, device=node)
        res = sess.trace(op_id, [len(ids), N_NODES], home=node)
        if res.status != 0 or res.ret != len(ids):
            raise AssertionError(f"node {node}: status {res.status}, ret "
                                 f"{res.ret} for {len(ids)} blocks")
        got = sess.read_region("reply", device=N_NODES,
                               count=len(ids) * k.block_words)
        if not np.array_equal(got, k.reference(sess.pool, sess.view,
                                                tables[node], ids,
                                                device=node)):
            raise AssertionError(f"node {node}: the reply's blocks differ "
                                 f"from the pool's at the requested ids")
        delivered.update(got.tobytes())
        ts = sim.simulate_task(vop, res.trace, pipelined=True,
                               serial_chain=False)
        total_us = max(total_us, ts.latency_us)   # nodes work in parallel
        fetched += len(ids)
        nodes.append(dict(node=node, blocks=len(ids),
                          latency_us=ts.latency_us,
                          wire_bytes=ts.wire_bytes))
        print(f"node {node}: {len(ids):3d} blocks in one invocation "
              f"({ts.latency_us:7.1f} us, "
              f"wire {ts.wire_bytes / 1e6:.2f} MB)")

    payload = fetched * BLOCK_BYTES
    saw = 160 * cm.DEFAULT_HW.rtt_us + payload / cm.DEFAULT_HW.wire_bytes_per_us
    batched = payload / cm.batched_rdma_gather_gbs(payload, BLOCK_BYTES) / 1e3
    print(f"\nfetched {fetched} blocks = {payload / 2**20:.1f} MiB")
    print(f"  tiara (parallel nodes, 1 invocation each): {total_us:9.1f} us")
    print(f"  stop-and-wait RDMA (as deployed, Table 1): {saw:9.1f} us")
    print(f"  optimally batched RDMA (2 RTTs + WR build): {batched:9.1f} us")
    print(f"  -> {saw / total_us:.1f}x over stop-and-wait, "
          f"{batched / total_us:.2f}x over batched")
    return dict(device=str(ep.device), nodes=nodes, fetched=fetched,
                payload_bytes=payload, delivered_sha256=delivered.hexdigest(),
                tiara_us=total_us,
                stop_and_wait_us=saw, batched_us=batched,
                over_stop_and_wait=saw / total_us,
                over_batched=batched / total_us)


if __name__ == "__main__":
    main()
