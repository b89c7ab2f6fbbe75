"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths and holds every hand-written CUDA
kernel against its plain PyTorch version on the card:

* the Tiara endpoint — register operators, post on sessions, ring the
  doorbell, retire CQEs, then the serving loop — at a real deployment
  size (a 1 GiB paged-KV pool of 8 KiB blocks plus a one-million-node
  graph);
* paged-KV decode serving of tiny-lm at full width (12 layers, d_model
  768, random weights from a seed): ``ServingEngine`` answers 16 requests
  under ``resolver="host"`` and again under ``resolver="tiara"``, where
  every decode step resolves the block tables through the endpoint;
* the same serving of Llama-4 Scout 17B-A16E at its published widths
  (d_model 5120, 40/8 heads of 128, 16 experts top-1 plus the shared
  expert, vocab 202048, bf16, page 128) with the depth cut to 4 of 48
  layers: 21.8 GB of random bf16 weights drawn on the card from seed 0;
  under ``resolver="tiara"`` every decode step also resolves each slot's
  expert route through ``MoEExpertGather``;
* the recurrent families through the model's own entry points
  (``tf.init_caches``, ``tf.prefill``, ``tf.decode_step``; the serving
  engine, like the reference's, serves attention-only decoders): Jamba
  v0.1 at its published widths (d_model 4096, 32/8 heads of 128, no RoPE,
  Mamba d_inner 8192, 16 experts top-2 of 14336 at capacity factor 1.25,
  vocab 65536, bf16, page 128) cut to one period, 8 of 32 layers (26.6 GB
  of weights drawn on the card from seed 0), and RWKV-6 1.6B whole; their
  recurrences run as one ``selective_scan`` or ``wkv6`` launch per layer
  call;
* the multimodal families whole at their published widths, through the
  same entry points: Qwen2-VL-7B (28 layers, d_model 3584, 28/4 heads of
  128, M-RoPE over distinct t/h/w streams, an image prefix of 256 vision
  tokens through the ``embeds`` stub; 15.23 GB) and SeamlessM4T-medium
  (12 encoder and 12 decoder layers, d_model 1024, 16/16 heads of 64, an
  encoder over ragged frames and the decoder's cross attention; 1.75 GB);
* training: tiny-lm at full width (12 layers, d_model 768, f32) through
  ``Trainer`` on the synthetic stream of the reference's pipeline, with
  checkpoints and a restart, and SeamlessM4T-medium whole in bf16 through
  ``make_train_step``; on the card every attention forward and backward
  runs as a CUDA kernel (``flash_attention``'s backward kernel);
* the sharded pool and the distributed layer on meshes of 4 shards that
  all name this card (the port's single-controller mesh runs n shards on
  one card as the reference's tests run n shards on one CPU; one card
  measures the routing, not an interconnect): the endpoint with
  ``placement="sharded"`` at a 4 x 2.13 GiB pool (each wave one
  ``lockstep_vm`` launch over the shards' rows, held to the sharded host
  loop), tiny-lm served over four homes, and ``tiara_fetch``, the
  sharded paged decode, the expert-parallel MoE and the int8 gradient
  all-reduce at full width;
* the dry-run of every production cell on the meta device and its
  roofline with the H100's constants, held against InternLM2-1.8B's
  train, prefill and decode steps run for real on this card.

Phases:

1. device and build: the card's name and power limit; every CUDA kernel
   of the port built from the checkout's sources with ``nvcc``;
2. each kernel against its plain version at the main paths' shapes
   (``tiara_gather`` exactly, also at unaligned and wrapping windows, in
   both regimes (one thread a word up to 32 words, the persistent
   bulk-copy stream past that) with and without ids, the same bits twice,
   one launch a call, its kernels' registers and spills from the
   ``-Xptxas -v`` log (a spill fails), at the path shape in both forms
   timed and by the profiler's kernel duration, with its host wall per
   call and ``index_select``; after phase 13, at every shape the
   resolvers and the sharded engine gave it, beside the launch floor plus
   its latency bound and, for one-word windows under one mask,
   ``index_select`` at the windows' word offsets.  Every kernel time
   in the run is the median of calls each timed alone with CUDA events
   after a read of a 256 MiB buffer (the L2 flushed without dirty lines)
   and a GPU spin that lets the host enqueue the call before the start
   event, and is printed beside the launch floor, the library's empty
   kernel between the same events, measured once here;
   ``paged_attention`` and ``flash_attention`` within 3e-5 in f32, plus
   small bf16, empty-row, G = 7, head-dim and ragged cases within 0.05 /
   3e-5, the sequence split's edge cases, and two calls on the same
   inputs giving the same bits), with its time, the plain version's time,
   the least time the card could take for the same work and, for flash,
   the time of PyTorch's ``scaled_dot_product_attention`` on the same
   inputs; the attention kernels also at a short shape (flash at S = 256,
   paged with every length <= 256), paged at partitions of 128 and 256
   tokens, and flash's error against f64 at larger logits;
3. the endpoint at real size: a compiled and a double-buffered compiled
   paged-KV wave (which must launch the kernel once and once per chunk),
   a mixed auto wave, the same wave forced onto the lockstep engine (one
   ``lockstep_vm`` launch for 512 posts, in place on the endpoint's
   resident pool: the same ``data_ptr`` after the wave and no allocation
   the size of the pool; replayed after on the kernel and on the host
   loop side by side, bit-equal), a split-phase pair,
   and a pyvm replay against a downloaded copy of the pool, every result
   checked; each wave prints the engine its doorbell ran and its kernel
   launches;
16. (run here, after phase 3) ``lockstep_vm``, the lockstep engine as
   one kernel per wave, against its plain version, the host loop, on the
   card, bit for bit (mem, ret, status, steps, regs, fault), over the
   seeded corpus of ``core/lockstep_corpus.py``: every stock operator
   (``PagedKVFetch`` and ``MoEExpertGather`` with remote replies among
   them), a contended CAS lock, the fault-table rows under interp,
   batched and mixed, fuel below the verified bound, zero-trip and
   nested loops, and random verified operators, at B of 1, 7, 64, 1024
   and 1500; per wave the macro-steps, both routes' walls and the
   launches (one ``lockstep_vm``, no ``tiara_gather``).  Then the card's
   load-to-use latency for a cold word (one thread chasing pointers
   through 1 GiB) and the kernel's per-phase counters (the clocks build,
   ``csrc/lockstep_vm_clocks.cu``: cycles per macro-step in (a) live and
   footprints, (b) the sweep, (c) the free lanes, (d) the copies, (e) the
   serial lanes) at the serving resolver's wave at Scout's lane count and
   at tiny-lm's geometry, phase 3's forced wave and every stock operator
   at 1024 and 1500 lanes: each with its wall beside the previous
   kernel's recorded one, and its bound, the larger of the bytes it moves at 3.35 TB/s and
   its longest lane's dependent pool accesses (LOAD, CAS, CAA, MEMCPY)
   times that latency;
4. the serving loop on a virtual clock with its exactly-one-CQE
   identity;
15. (run here, after phase 4) the main path's contracts on the card, on
   phase 3's layout at real size over two device rows (4.25 GiB): a
   wild device register, an out-of-region offset and a word op on a
   failed device through the interp, batched, compiled, mixed,
   segmented and serial engines; an out-of-region translation in the
   middle of a block table through the compiled and double-buffered
   gather chains (``tiara_gather`` launched once and once per chunk,
   exactly the iterations before the fault committed); MEMCPY to and
   from a failed device, sync and async (``ERR_REG``, no copy); a
   session's flush until ``reset()`` and the healed post after;
   ``doorbell(wait=False)`` pairs, a poisoned materialization and lost
   doorbells; the serving loop's EAGAIN (token bucket, admitted queue,
   bounded SQ), shedding, TIMEOUT at admission, pump and drain and at a
   statically infeasible deadline; the certificates at registration and
   in ``wave_us`` on the card's measured ``EngineCost``.  Every wave's
   posts are held to pyvm replayed on a host mirror, the whole pool to
   the mirror bit for bit, and every post to exactly one CQE; one line
   per row with the engine, the ``tiara_gather`` and ``lockstep_vm``
   launches and the wave's wall; the interp, batched and mixed rows (one
   ``lockstep_vm`` launch each) are replayed after on both routes side
   by side.  Then ``examples/quickstart_torch.py`` on the card;
5. tiny-lm serving under both resolvers: identical tokens, every handle
   ok, ``flash_attention`` launched 12 times per prefill and
   ``paged_attention`` 12 times per decode step, ``tiara_gather`` at
   least once in every tiara decode step; prefill time per bucket,
   decode-step time and tokens/s (a tiara kernel in every tiara step:
   ``tiara_gather`` for the compiled traces the cost model picks, or
   ``lockstep_vm`` for a lockstep wave); then the port on the card against the
   port on the CPU, same weights, on a 64-token prompt and 8
   teacher-forced decode steps;
6. Scout: both attention kernels at its exact bf16 path shapes against
   their plain versions (within ``SCOUT_ATTN_TOL``, two bf16 ulps, the
   same bits twice), timed with
   their bounds and PyTorch's SDPA; bf16 flash's own kernel
   (FLASH_BF16_SOURCE) without a spill in the ``-Xptxas=-v`` log and
   within SCOUT_ATTN_TOL at logits of standard deviation 1, 4 and 16
   (LOGIT_STDS); 8 requests (prompts 16..1536, the
   buckets 128..2048) under both resolvers: identical tokens,
   ``flash_attention`` 4 times per prefill, ``paged_attention`` 4 times
   per decode step, a tiara kernel in every tiara decode step (its
   16-tenant waves run as one ``lockstep_vm`` launch) and never under
   host, expert gathers executed; the tiara run again with its lockstep
   waves on the host loop, the kernel's plain version (the same tokens,
   its step walls beside the kernel's); the prefill logits of the CUDA
   kernels against the plain versions on the card, position by position,
   the plain run on the kernel run's expert choices (see
   ``SCOUT_LOGIT_TOL``); then ``tiara_gather`` timed at the shapes
   the two serving resolvers gave it, and ``lockstep_vm`` at Scout's
   resolver wave (the launch alone, the whole call, the host loop, the
   wave's byte bound, its latency bound, its per-phase counters, the
   time of a one-lane wave and the build's registers and spills);
7. Jamba, after Scout's weights are freed: both attention kernels at its
   bf16 path shapes against their plain versions (within
   ``SCOUT_ATTN_TOL``), timed with their bounds and SDPA; ``selective_scan``
   at its prefill (8 x 1024 x 8192, 16 states, ``valid`` from the prompts'
   lengths) and decode (S = 1) shapes against its plain version within
   ``SCAN_TOL``, the same bits twice, timed with the plain version's
   time, a decode call's host wall and its bound (the
   larger of bytes, f32 flops and exps at the SFU rate); 8 greedy
   requests (prompts 16..1024) right-padded into one ``tf.prefill`` with
   ``lengths``, then 16 ``tf.decode_step``s: prefill wall, decode-step
   times, tokens/s, ``flash_attention`` once per prefill and
   ``paged_attention`` once per decode step (one attention layer in
   eight), ``selective_scan`` once per Mamba layer (7) in the prefill and
   in every decode step, the real tokens the capacity factor dropped, one
   profiled decode step, peak memory, the scans' device time in one more
   prefill and step; check (a), the decode logits against the full
   forward over prompt plus token, and check (b), the prefill logits of
   the CUDA kernels (attention and scans) against the plain versions,
   both per position within ``RECURRENT_LOGIT_TOL`` with the MoE's expert
   choices pinned from one run into the other;
8. RWKV-6 1.6B whole: ``wkv6`` at its prefill (8 x 1024 x 32 heads of
   64) and decode shapes as phase 7 holds ``selective_scan``; the same
   requests and steps, ``wkv6`` once per layer (24) in the prefill and in
   every decode step and no attention kernel; check (a); check (b) on the
   same weights drawn in f32, within ``RWKV_F32_LOGIT_TOL``;
9. Qwen2-VL-7B whole: both attention kernels at its bf16 path shapes (G =
   7, D = 128) against their plain versions within ``SCOUT_ATTN_TOL``,
   the same bits twice, timed with their bounds and SDPA; 8 requests of
   an image of 16 x 16 patches then text (prompts 300..1024) with their
   M-RoPE ids, right-padded into one ``tf.prefill``, then 16
   ``tf.decode_step``s: the numbers and checks of phase 7 (28
   ``flash_attention`` per prefill, 28 ``paged_attention`` per step);
10. SeamlessM4T-medium whole, the same for an encoder-decoder: encoder
   frames (8, 1024, 1024) with ragged ``enc_lengths`` 256..1024, decoder
   prompts 16..1024; the kernels at G = 1, D = 64: paged decode, flash
   non-causal over the encoder, causal over the decoder, and cross
   attention at Sq != Sk in prefill and at Sq = 1 in decode (also with an
   encoder length of 0); 36 ``flash_attention`` per prefill, then 12
   ``paged_attention`` and 12 ``flash_attention`` per step;
11. the cycle simulator over ``Session.trace`` of a depth-10 graph walk
   registered on a card endpoint: simulated cycles of the paper's machine
   model, not card numbers;
12. training, after SeamlessM4T's weights are freed: the flash_attention
   backward kernel against its plain version at BWD_CASES (tiny-lm's
   training shape in f32, Qwen2-VL's and SeamlessM4T's encoder, decoder
   and cross attention in bf16, a short ragged case, phase 17's training
   example's shape in f32; f32 within
   BWD_F32_TOL of the largest gradient, bf16 within SCOUT_ATTN_TOL), the
   same bits twice, the forward's output the same bits with and without
   ``lse``, timed with its plain version, PyTorch's SDPA backward, its
   bound and its design's floor (BWD_PASSES), its kernels' registers and
   spills read from the build log (a spill fails); tiny-lm at full width
   through ``Trainer`` for TRAIN_STEPS steps of 8 x 1024 tokens (the loss
   falls; per step 12 forward ``flash_attention`` launches, 12 more under
   the remat recompute, 12 backward), a restart from the step-10 checkpoint that ends on the same
   parameters bit for bit, TRAIN_Q8_STEPS steps with 8-bit AdamW state
   tracking the f32 run, the step wall, tokens/s, peak memory and one
   profiled step with the backward kernel's share; one train step on the
   card against the CPU (loss and gradients within CARD_VS_CPU_TOL);
   SeamlessM4T-medium whole in bf16, SEAMLESS_TRAIN_STEPS steps through
   ``make_train_step`` (finite loss, finite and changed parameters, 36
   forward launches, 24 recomputed, 36 backward per step);
13. the sharded paths (SHARDS shards of this card, the mesh printed):
   (a) phase 3's region table on a pool of SHARDS rows plus the
   reference's acceptance tenants, SHARDED_POSTS mixed posts over all
   homes with cross-home MEMCPYs and contended STORE/CAS through
   ``doorbell(placement="sharded")`` — on a mesh of one card the sharded
   engine's wave is ONE ``lockstep_vm`` launch over the shards' rows (no
   collective, no ``tiara_gather``) — then the same wave through the
   sharded engine's host loop (``impl="torch"``: ``shard_map``,
   collectives, ``tiara_gather`` owner reads), the two bit for bit (every
   row, every CQE field in arrival order), the kernel timed alone on the
   wave's operands beside the launch floor, its byte and latency bounds
   and the host loop's wall; and again ``"auto"``; each wave
   bit-identical to the dense mixed engine (the whole pool, on the card)
   and to a pyvm replay, with its wall, collectives, bytes and launches;
   then a failed device under ``"auto"`` (the wave runs single, word ops
   homed there fault, ``revive()`` + ``reset()`` recover); (b) tiny-lm at
   full width through ``ServingEngine(resolver="tiara",
   n_homes=SHARDS, placement="sharded")``: SHARDED_PLENS prompts,
   SHARDED_NEW new tokens, the host resolver's tokens, a region rehomed
   mid-run, one ``lockstep_vm`` launch or more in every decode step, the
   decode-step wall beside phase 5's; (c) ``tiara_fetch`` over a 1 GiB
   pool (bit-equal, exactly 2 ``all_to_all``s, the client-side rounds
   beside it), tiny-lm's decode with ``cfg.paged_attn_fn`` on a 2 x 2
   mesh (both layouts) within DECODE_TOL of the unsharded step,
   ``make_moe_ep`` at Scout's widths in
   f32 within MOE_REL_TOL of ``moe_apply`` and Scout's 4-layer cut in bf16
   with ``cfg.moe_fn`` held as SCOUT_LOGIT_TOL holds the kernels, and
   tiny-lm's gradients through ``make_grad_compressor`` within
   INT8_REL_TOL;
14. the dry-run and an H100 roofline (``launch/{cells,dryrun}.py``,
   ``roofline/analysis.py``): (a) the production cells on the single
   16 x 16 mesh of meta shards, one line per record and the ok and skip
   counts (each arch's decode_32k and long_500k, and train_4k and
   prefill_32k of every arch but Jamba and RWKV-6, whose long cells the
   CLI runs: their per-token scans take minutes each on meta), in
   subprocesses after (b): InternLM2-1.8B in bf16 through ``make_cell``
   on a 1 x 1 mesh of this card at CROSS_SHAPES, where the dry-run's
   argument bytes and FLOPs equal the card step's exactly, its argument
   + temp bytes are within 10% of the step's peak, and its roofline
   floor is at most 1.05 x the median step wall on the plain route and
   on the kernels' (``dryrun.card_check``).
17. the reference's last entry points on the port, each through its
   ``main(argv)`` in process on ``cuda:0``: ``examples/serve_paged_torch.py
   --full-size`` (tiny-lm at full width, ENTRY_REQUESTS requests of
   ENTRY_NEW tokens) under ``--resolver host`` then ``tiara`` (every
   handle ok, no page leaked, the same tokens, the launches by kernel,
   wall and tok/s); ``examples/train_tiny_lm_torch.py`` for
   ENTRY_TRAIN_STEPS[0] steps and again to ENTRY_TRAIN_STEPS[1] on one
   checkpoint directory (the loss falls, the second call resumes from the
   first's newest checkpoint, the launches per step);
   ``examples/disaggregated_kv_torch.py`` with its pool on the card and on
   the CPU (the same figures); ``tools/check_budgets_torch.py`` (returns
   0); and the phase's own wall.

Any failure raises and the script exits non-zero.  It prints, before the
last line, the card's name and power limit and one JSON object with each
kernel's numbers; the last line is ``{"ok": true, "device": ...}``.
Detailed numbers go to ``chiprun_out/chip_smoke.json``.  It needs one
CUDA card and refuses to run without one.

    python3 chip_smoke.py --attention-only [--src DIR] [--label NAME]

times only the attention kernels at phase 2's timed shapes, with flash's
error at larger logits, bf16 flash at FLASH_BF16_CASES with its error at
larger logits at Scout's shape, and the forward with ``lse`` and the
backward kernel at BWD_CASES, for the ``repro_torch`` under ``DIR``
(default: this checkout's), one JSON line per shape: run it on two trees
in turns (parent, change, change, parent) in one call to compare them on
one card.

    python3 chip_smoke.py --dryrun-only

runs phase 14 alone and prints its numbers as one JSON line.

    python3 chip_smoke.py --decode-only [--src DIR] [--label NAME]

does the same for the decode steps that run no tiara: tiny-lm's
host-resolved serving run, and Jamba's and RWKV-6's main paths (phases 7
and 8: the prefill and decode-step walls, peak memory, launches and the
scans' device time), one JSON line each.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
TF32_FLOPS_PER_S = 495e12       # H100 SXM TF32 on the tensor cores
#                                 (NVIDIA data sheet, dense)
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 on the tensor cores
#                                 (NVIDIA data sheet, dense)
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
#                                 (NVIDIA data sheet)
# exps a second: one MUFU.EX2 each, 16 a clock per SM (the CUDA C
# programming guide's throughput table, compute capability 9.0) on 132
# SMs at the H100 SXM's 1980 MHz boost clock
SFU_EXPS_PER_S = 16 * 132 * 1.98e9
# tests/test_kernels.py's attention tolerances, as (atol, rtol)
ATTN_TOL = {torch.float32: (3e-5, 3e-5), torch.bfloat16: (0.05, 0.05)}
# The attention kernels at Scout's bf16 path shapes, whose outputs have an
# rms of 0.1-0.2, down to about 0.04 in the rows over 1000-2000 keys
# (random unit-normal q, k and v), so 0.05 would admit a kernel that drops
# a tile of keys.  Both kernels and their
# plain versions compute in f32 (errors about 1e-6, PERF.md) and round the
# output to bf16 once, so they may differ by one bf16 ulp, at most 2**-7
# of the value: rtol = two ulps, atol for values near 0.  Dropping 32 of
# 1000 keys moves a row by about a fifth of its size.
SCOUT_ATTN_TOL = (1e-4, 2 ** -6)
# The attention kernels' timed shapes, tiny-lm's heads (12 q / 4 kv of
# 64): paged_attention over 8 decode slots with 128-page tables (page 16)
# out of the engine's 1025 pages, at the decode path's lengths (12043 live
# tokens, up to the 2048-token context) and at short ones (every length
# <= 256); flash_attention on one causal prompt at the largest prefill
# bucket and at a short one.
ATTN_HEADS = (12, 4, 64)
PAGED_SLOTS, PAGE, PAGED_MAXP, PAGED_POOL = 8, 16, 128, 1025
PAGED_LENGTHS = {"path": (686, 1209, 1242, 1314, 1685, 1925, 1934, 2048),
                 "short": (16, 71, 92, 98, 108, 151, 225, 256)}
FLASH_SEQ = {"path": 2048, "short": 256}
# flash's error against f64 is also taken with q scaled so that the
# logits' standard deviation is each of these (random tiny-lm's is 1)
LOGIT_STDS = (1, 4, 16)
# Both serving runs: ServingEngine(max_slots=8, max_seq=2048)
SERVE_SLOTS, SERVE_MAX_SEQ = 8, 2048
SERVE_NEW = 32                  # tiny-lm's new tokens per request
# Card against CPU, tiny-lm logits: both f32 (no TF32), but cuBLAS and the
# CPU BLAS sum in other orders, and the kernels' online softmax against the
# plain two-pass one, through 12 layers; logits are O(1).
CARD_VS_CPU_TOL = 1e-3
# Llama-4 Scout at its published widths (d_model 5120, 40 q / 8 kv heads of
# 128, 16 experts top-1 of 8192 plus the shared expert, vocab 202048, bf16,
# page 128), depth cut to 4 of 48 layers, random weights from seed 0:
# ServingEngine(max_slots=8, max_seq=2048) answers 8 greedy requests whose
# prompts cover the buckets 128..2048.
SCOUT_ARCH, SCOUT_LAYERS, SCOUT_NEW = "llama4-scout-17b-a16e", 4, 16
SCOUT_PLENS = tuple(int(n) for n in np.round(np.geomspace(16, 1536, 8)))
# Scout's prefill logits with the CUDA attention kernels against the same
# model with their plain versions, on the card.  bf16 keeps 8 significant
# bits: every product and residual add rounds at 2**-9 relative, and the
# logits (O(1), at most about 6 with random weights) are bf16 values
# themselves, 2**-5 apart in [4, 8).  The kernels and the plain versions
# round their f32 sums to bf16 at different points, so the 4 layers carry a
# few ulps of difference to the logits; and where the router's top two
# experts of a token are within an ulp, such a difference can flip the
# top-1 route, which makes that token's FFN a different function, and
# through the later layers' attention moves the positions after it.  So
# the plain run takes the kernel run's expert choices (``_Routes``), both
# compute the same function, and every position holds |kernel - plain| <=
# tol (1 + |plain|) with tol = 2**-3; the positions whose own route in the
# plain run differed in some layer are counted and may be at most 5% of
# the prompt.
SCOUT_LOGIT_TOL = 2 ** -3
SCOUT_MAX_FLIP_SHARE = 0.05
# Jamba v0.1 at its published widths (d_model 4096, 32/8 heads of 128, no
# RoPE, Mamba d_inner 8192 / d_state 16 / d_conv 4, 16 experts top-2 of
# 14336 at capacity factor 1.25 on every second layer, vocab 65536, bf16,
# page 128), depth cut to one period, 8 of 32 layers (13.295 G params,
# 26.59 GB); RWKV-6 1.6B whole (24 layers, d_model 2048, 32 heads of 64,
# d_ff 7168, vocab 65536, bf16; 1.584 G params).  Each runs 8 greedy
# requests with prompts of 16..1024 tokens, right-padded in one tf.prefill
# with lengths, then RECURRENT_STEPS tf.decode_steps.
JAMBA_ARCH, JAMBA_LAYERS, RWKV_ARCH = "jamba-v0.1-52b", 8, "rwkv6-1.6b"
RECURRENT_PLENS = tuple(int(n) for n in np.round(np.geomspace(16, 1024, 8)))
RECURRENT_STEPS = 16
# Checks (a) and (b) of both models hold each position's logit vector in
# norm: ||got - want|| <= RECURRENT_LOGIT_TOL ||want||.  bf16 keeps 8
# significant bits: every product, cast and residual add rounds at 2**-9
# relative, and once two correct runs differ anywhere (cuBLAS picks its
# algorithm by shape; a kernel and its plain version differ by an ulp of
# their bf16 output) each later rounding may differ by an ulp too — a
# random walk over the twenty-odd rounding points of each of 8 (Jamba) or
# 24 (RWKV-6) layers, which the Mamba and RWKV states then mix across
# positions.  Its size was 2.3% of the logits' norm over Jamba's 2266
# prefill positions (PERF.md, PR 15).  An elementwise bound like
# SCOUT_LOGIT_TOL's would sit in the tail of that noise: over 148 M
# logits its largest value, 0.21 at a logit of 0.17, is six standard
# deviations out.  The norm averages a position's 65536 logits, and a
# lost state, a misplaced cache row or a dropped key tile moves the
# positions it touches by O(1) of it.  Where a token's second and third
# router logits are within such a difference its top-2 route may differ,
# which makes its FFN another function: the MoE checks pin one run's
# expert choices in the other (see ``_Routes``) and count how many it
# changed, so no position is excused.
RECURRENT_LOGIT_TOL = 2 ** -3
# Check (a) compares a prefill of 8 x 1024 tokens (padding included) with a
# full forward of 8 x 1025: at capacity factor 1.25 the two batches fill
# the experts' capacity in another flat order and drop other tokens, so a
# dropped prompt token would differ for that reason alone.  The check
# runs, as the reference's test_prefill_decode_matches_full_forward does
# (its reduce_config sets capacity factor 8), at capacity factor
# n_experts / top_k = 8, where the capacity is every token; the timed run
# and check (b) keep the published 1.25.
JAMBA_CHECK_CF = 8.0
# The recurrent scans' kernels (one launch per layer call) against their
# plain versions on the card, in f32 as (atol, rtol): both run the same
# arithmetic per step, and only the order of y's sums and the fusing of
# multiply-adds differ (errors about 1e-6 at the path shapes); a state
# read after its update or a lost mask is O(0.1).
SCAN_TOL = (1e-5, 1e-5)
# RWKV-6's check (b) runs on f32 weights, and holds each position's logit
# vector within RWKV_F32_LOGIT_TOL of its norm.  In bf16 the comparison
# has no floor to hold it to: moving every scan's y by one unit in its
# last place moves RWKV-6's random-weight logits by about a fifth of
# their norm (measured on an H100, see PERF.md), bf16 roundings flipping
# and compounding over 24 recurrent layers, as a wrong scan would.  In
# f32 the same move gives about 6e-5; a state read after its update or a
# lost mask gives O(0.1).
RWKV_F32_LOGIT_TOL = 1e-3
SELECTIVE_SCAN_SOURCE = ("src/repro_torch/kernels/selective_scan/csrc/"
                         "selective_scan.cu")
SELECTIVE_SCAN_REPLACES = "src/repro/models/mamba.py:150"
WKV6_SOURCE = "src/repro_torch/kernels/wkv6/csrc/wkv6.cu"
WKV6_REPLACES = "src/repro/models/rwkv.py:142"
# The multimodal families whole, at their published widths, through the
# model's entry points like Jamba's (the reference's ServingEngine refuses
# an encoder-decoder and passes no M-RoPE ids), with RECURRENT_STEPS decode
# steps.  Qwen2-VL-7B (arXiv:2409.12191; 28 layers, d_model 3584, 28/4
# heads of 128, d_ff 18944, vocab 152064, M-RoPE, bf16, page 128): 8
# requests, each an image of 16 x 16 patches (256 vision tokens at
# Qwen2-VL's <|image_pad|> id, the embeds stub) then text, prompts of
# 300..1024 tokens.  SeamlessM4T-medium (arXiv:2308.11596; 12 encoder and
# 12 decoder layers, d_model 1024, 16/16 heads of 64, d_ff 4096 gelu,
# layernorm, vocab 256206, bf16): encoder frames (8, 1024, 1024) with
# ragged enc_lengths 256..1024, decoder prompts of 16..1024 tokens.  Each
# model's parameter count is held to the published configuration's.
QWEN_ARCH, SEAMLESS_ARCH = "qwen2-vl-7b", "seamless-m4t-medium"
QWEN_PARAMS, SEAMLESS_PARAMS = 7_615_487_488, 877_260_800
QWEN_GRID, QWEN_IMAGE_PAD = (16, 16), 151655
QWEN_PLENS = tuple(int(n) for n in np.round(np.geomspace(300, 1024, 8)))
SEAMLESS_S_ENC = 1024
SEAMLESS_ENC_LENS = tuple(int(n) for n in
                          np.round(np.geomspace(256, 1024, 8)))
FLASH_BF16_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention_bf16.cu")
# flash_attention in bf16 (FLASH_BF16_SOURCE) takes one bf16
# pass for S = Q K^T and two for P V (P split hi + lo): 1.5 passes of the
# function's flops at the bf16 tensor-core rate, the design's own floor,
# printed beside the function's bound, which it does not replace
FLASH_BF16_PASSES = (1 + 2) / 2
# bf16 flash_attention's forward at the main paths' shapes (PERF.md's
# kernel table, row 3), timed by --attention-only on any tree: (label, (B,
# QH, KVH, Sq, Sk, D), causal, lengths)
FLASH_BF16_CASES = (
    ("Jamba", (8, 32, 8, 1024, 1024, 128), True, None),
    ("Qwen2-VL", (8, 28, 4, 1024, 1024, 128), True, None),
    ("Scout", (1, 40, 8, 2048, 2048, 128), True, None),
    ("SeamlessM4T encoder", (8, 16, 16, 1024, 1024, 64), False, None),
    ("SeamlessM4T decoder self", (8, 16, 16, 1024, 1024, 64), True, None),
    ("SeamlessM4T cross, prefill", (8, 16, 16, 1024, 1024, 64), False,
     SEAMLESS_ENC_LENS),
    ("SeamlessM4T cross, decode", (8, 16, 16, 1, 1024, 64), False,
     SEAMLESS_ENC_LENS),
)
# The backward's passes of 2 Sq Sk D flops (csrc/flash_attention_bwd.cu):
# S and dP in both of its kernels, one bf16 pass each or three TF32 ones;
# dV, dK and dQ with P and dS split in two bf16 parts, or in 3xTF32.  The
# design's own floor, printed beside the bound (5 bf16 passes, or 15 TF32
# ones for f32 at f32 accuracy), which it does not replace.
BWD_PASSES = {torch.bfloat16: 4 * 1 + 3 * 2, torch.float32: 4 * 3 + 3 * 3}
# Phase 12, training.  The flash_attention backward kernel's shapes: the
# train steps' own (tiny-lm's 8 x 1024 batch; SeamlessM4T's encoder, its
# decoder over 256 targets and their cross attention over 1024 ragged
# frames, here with one request of no frame), Qwen2-VL's prefill shape
# (bf16, D = 128, G = 7) and a short ragged one.  Each is (label, (B, QH,
# KVH, Sq, Sk, D), causal, lengths, dtype).
BWD_CASES = (
    ("tiny-lm training", (8, 12, 4, 1024, 1024, 64), True, None,
     torch.float32),
    ("Qwen2-VL", (8, 28, 4, 1024, 1024, 128), True, None, torch.bfloat16),
    ("SeamlessM4T encoder", (8, 16, 16, 1024, 1024, 64), False, None,
     torch.bfloat16),
    ("SeamlessM4T decoder self", (8, 16, 16, 256, 256, 64), True, None,
     torch.bfloat16),
    ("SeamlessM4T cross", (8, 16, 16, 256, 1024, 64), False,
     SEAMLESS_ENC_LENS[:7] + (0,), torch.bfloat16),
    ("short ragged", (2, 6, 2, 200, 200, 64), True, (200, 137),
     torch.float32),
    # phase 17's training example: 16 x 256 tokens a step
    ("tiny-lm, the training example", (16, 12, 4, 256, 256, 64), True,
     None, torch.float32),
)
# The backward kernel against its plain version: in f32 within 1e-4 of
# the largest gradient (both sum in f32, in other orders, over up to 1024
# rows); in bf16 within SCOUT_ATTN_TOL of the f32 plain result (two bf16
# ulps: both compute in f32 and round once).
BWD_F32_TOL = 1e-4
# The forward's lse against its plain version at those shapes, (atol,
# rtol): both sum in f32 in other orders, the kernel's products in 3xTF32
# (errors about 1e-6 on rows whose lse is about 5-8).
LSE_TOL = (1e-5, 1e-5)
# tiny-lm trained at full width through Trainer (f32, TF32 off, remat
# "full", AdamW f32 state): the reference pipeline's synthetic stream of
# 8 x 1024 tokens, TRAIN_STEPS steps with a checkpoint every
# TRAIN_CKPT_EVERY, a restart from the first checkpoint, TRAIN_Q8_STEPS
# steps with 8-bit state whose loss stays within TRAIN_Q8_TOL (relative)
# of the f32 run's (the 8-bit moments move each update by about 1/127 of
# a block's largest moment).
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "tiny-lm", 8, 1024
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_Q8_STEPS = 20, 10, 5
TRAIN_LR, TRAIN_WARMUP, TRAIN_Q8_TOL = 1e-3, 2, 0.05
# One train step at tiny-lm's full width on the card and on the CPU from
# the same state, batch 2 x 128: the loss and every gradient within
# CARD_VS_CPU_TOL of the leaf's largest entry (f32 both, TF32 off; cuBLAS,
# the kernels and the CPU sum in other orders through forward and
# backward).
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 128
# SeamlessM4T-medium whole in bf16 through make_train_step: encoder frames
# (8, SEAMLESS_S_ENC, 1024) with enc_lengths SEAMLESS_ENC_LENS, decoder
# targets of SEAMLESS_TRAIN_TOKENS tokens, SEAMLESS_TRAIN_STEPS steps.
SEAMLESS_TRAIN_TOKENS, SEAMLESS_TRAIN_STEPS = 256, 3
# Phase 13: the sharded pool and the distributed layer, every mesh of
# SHARDS shards on this one card (the port's single-controller mesh runs n
# shards on one card as the reference's tests run n shards on forced host
# devices of one CPU).  One card measures the software routing — the
# collectives as device copies — not an interconnect.
# (a) the reference's acceptance wave (tests/test_sharded.py:491):
# SHARDED_POSTS posts of 4 tenants over all SHARDS homes; (b) tiny-lm at
# full width, prompts SHARDED_PLENS, SHARDED_NEW new tokens each, its block
# tables resolved over SHARDS homes; (c) tiara_fetch over a 1 GiB f32 pool
# of FETCH_ROWS rows of FETCH_ROW_FLOATS floats (8 KiB) with FETCH_IDS ids
# per shard and a quota that drops nothing at these sizes; tiny-lm's
# decode, DECODE_STEPS steps of batch 4 at DECODE_LENGTHS over
# DECODE_PAGES pages each, within DECODE_TOL of the unsharded step (the
# reference's tolerance, tests/test_distributed.py:205); one Scout MoE
# layer in f32 on MOE_TOKENS tokens within MOE_REL_TOL (relative to the
# largest output) of moe_apply, then Scout's 4-layer cut in bf16 on
# prompts MOE_PLENS and MOE_DECODE decode steps, held as SCOUT_LOGIT_TOL
# holds the kernels; tiny-lm's gradients through the int8 all-reduce
# within INT8_REL_TOL (tests/test_distributed.py:71-85).
SHARDS, SHARDED_POSTS, SHARDED_NEW = 4, 1024, 8
SHARDED_PLENS = tuple(int(n) for n in np.round(np.geomspace(16, 1024, 8)))
FETCH_ROWS, FETCH_ROW_FLOATS, FETCH_IDS, FETCH_QUOTA = 131072, 2048, 4096, \
    2048
DECODE_PAGES, DECODE_LENGTHS, DECODE_STEPS = 64, (600, 17, 1000, 5), 4
DECODE_TOL = 2e-4
MOE_TOKENS, MOE_REL_TOL = (2, 512), 1e-4
MOE_PLENS, MOE_DECODE = (96, 200, 350, 512), 4
INT8_REL_TOL = 0.02
# Phase 14: the dry-run (launch/dryrun.py) and its cross-check on this
# card.  (a) The cells on the single production mesh (16 x 16 shards on
# the meta device): each arch's decode_32k and long_500k (run or skipped
# by cell_applicable), and train_4k and prefill_32k of every arch but
# DRYRUN_LONG_LEFT, whose recurrent scans run per token and take minutes
# each on meta (the CLI runs them, experiments/dryrun_torch/); one
# process per arch, DRYRUN_PROCS at a time, after (b).
# (b) CROSS_ARCH in bf16 through make_cell on a 1 x 1 mesh of this card,
# at CROSS_SHAPES cut to one card: the dry-run's argument bytes and FLOPs
# equal the card step's exactly, its argument + temp bytes within
# dryrun.MEM_TOL of the step's peak memory, and the roofline floor at most
# dryrun.MAX_SHARE of the median wall of CROSS_REPS steps, on the plain
# route and on the kernels'.
DRYRUN_LONG_LEFT = ("jamba-v0.1-52b", "rwkv6-1.6b")
DRYRUN_PROCS, DRYRUN_PROC_TIMEOUT_S = 7, 600
CROSS_ARCH = "internlm2-1.8b"
CROSS_SHAPES = (("train_1k", "train", 1024, 8),
                ("prefill_4k", "prefill", 4096, 4),
                ("decode_4k", "decode", 4096, 16))
CROSS_REPS = 5
# Phase 17: the reference's last entry points on the port, each through
# its ``main(argv)`` in process on the card: the serving example at full
# tiny-lm width (its own 128-token context) under both resolvers, and the
# training example twice on one checkpoint directory, the second call
# with more steps resuming from the first's newest checkpoint (the
# trainer writes one every ENTRY_CKPT_EVERY steps and one at the end).
ENTRY_REQUESTS, ENTRY_SLOTS, ENTRY_NEW = 4, 4, 8
ENTRY_TRAIN_ARGS = ("--batch", "16", "--seq", "256")
ENTRY_TRAIN_STEPS, ENTRY_CKPT_EVERY = (60, 70), 50


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def flush_l2(scratch: torch.Tensor) -> None:
    """Read a buffer larger than the 50 MB L2 so the next launch finds its
    rows cold, as the gather chain does.  A read, not a write: a write
    would leave dirty lines that the timed kernel writes back to HBM
    while it runs."""
    scratch.max()


# GPU clock cycles that ``time_cuda`` spins between its flush and its
# start event (about 1 ms on an H100), touching no memory: the host has
# enqueued the timed call before the start event fires, so a slow or busy
# host adds no idle gap to the kernel's time.  Without it the read flush
# hides less host work than some wrappers take (lockstep_vm's, say), and
# their host time would show as kernel time.
SPIN_CYCLES = 1 << 21


def time_cuda(fn, scratch, reps: int = 20, warmup: int = 3,
              setup=None) -> float:
    """Median milliseconds of one call, each call timed alone with CUDA
    events after a read flush of the L2 (``flush_l2``) and a spin of
    SPIN_CYCLES.  Every kernel time the smoke prints comes from here,
    beside the launch floor (``launch_floor_ms``).  ``setup``, when
    given, runs before each call's flush, outside the events (a wave
    that writes its own inputs puts them back there)."""
    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        flush_l2(scratch)
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def launch_floor_ms(scratch) -> float:
    """The launch floor: the library's empty kernel between
    ``time_cuda``'s events.  Phase 2 (or ``--attention-only``) measures
    it once and passes the number to every phase that prints a time."""
    from repro_torch.kernels.tiara_gather import kernel as tk
    return time_cuda(tk.launch_empty, scratch)


def floor_note(floor_ms: float) -> str:
    """``launch floor x us``, printed beside a kernel time."""
    return f"launch floor {floor_ms * 1e3:.2f} us"


def profiled_kernel_ms(fn, scratch, reps: int = 10):
    """The device time of the kernels one call of ``fn`` runs, start to end
    of each as ``torch.profiler`` (CUPTI) records it, without the launch
    and the events' own cost; the median over ``reps`` calls, each after a
    read flush of the L2 (``flush_l2``) outside the profiled window.  None
    when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush_l2(scratch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        times.append(sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == DeviceType.CUDA) / 1e3)
    ms = float(np.median(times))
    return ms if ms > 0 else None


def host_wall_ms(fn, reps: int = 500, rounds: int = 5) -> float:
    """Host wall of one call, launch included: after 50 warm-up calls,
    ``rounds`` rounds of ``reps`` calls back to back, each ended by one
    synchronise (the device keeps up, so the host's time per call is what
    shows); the median round."""
    for _ in range(50):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) / reps * 1e3)
    return float(np.median(times))


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    dt = time.perf_counter() - t0
    log(f"[build] {lib.name}: {len(_build.sources())} sources built for "
        f"sm_90a in {dt:.1f} s")
    for line in _build.log_path().read_text().splitlines():
        if "registers" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")
    return dt


def _ptxas_rows(pattern):
    """Registers and spills of every kernel whose mangled name matches
    ``pattern`` (groups: kernel, dtype as ``f`` or ``13__nv_bfloat16``, D),
    from the ``-Xptxas=-v`` build log, one dict per kernel."""
    from repro_torch.kernels import _build
    rows, name, spill = [], None, None
    for line in _build.log_path().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(pattern, m.group(1))
            spill = None
        elif name and spill is None and "spill stores" in line:
            spill = [int(x) for x in
                     re.findall(r"(\d+) bytes spill (?:stores|loads)", line)]
        elif name and "Used" in line and "registers" in line:
            rows.append(dict(
                kernel=name.group(1),
                dtype="float32" if name.group(2) == "f" else "bfloat16",
                head_dim=int(name.group(3)),
                registers=int(re.search(r"Used (\d+) registers",
                                        line).group(1)),
                spill_stores=spill[0], spill_loads=spill[1]))
            name = None
    return rows


def flash_bf16_registers():
    """The bf16 forward kernel's registers and spills at each D (its
    consumers raise their own to 240 with setmaxnreg; ptxas reports the
    launch's 168); fails on a spill."""
    rows = _ptxas_rows(r"(flash_bf16)_kernelI()Li(\d+)E")
    if not rows:
        raise AssertionError("the build log names no bf16 forward kernel")
    log("[kernel] flash_attention bf16 forward kernels: " + ", ".join(
        f"D = {r['head_dim']} {r['registers']} registers, spills "
        f"{r['spill_stores']}/{r['spill_loads']} bytes" for r in rows))
    spilled = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"the bf16 forward kernels spill: {spilled}")
    for r in rows:
        r["dtype"] = "bfloat16"
    return rows


def bwd_registers():
    """The backward kernels' registers and spills, one dict per kernel
    (name, dtype, D) from the ``-Xptxas=-v`` build log; fails on a
    spill."""
    rows = _ptxas_rows(r"flash_attention_bwd_(dkdv|dq|delta)_kernelI"
                       r"(f|13__nv_bfloat16)Li(\d+)E")
    if not rows:
        raise AssertionError("the build log names no backward kernel")
    for key in sorted({(r["dtype"], r["head_dim"]) for r in rows}):
        log(f"[train] flash_attention backward kernels, {key[0]}, D = "
            f"{key[1]}: " + ", ".join(
                f"{r['kernel']} {r['registers']} registers, spills "
                f"{r['spill_stores']}/{r['spill_loads']} bytes"
                for r in rows if (r["dtype"], r["head_dim"]) == key))
    spilled = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"backward kernels spill: {spilled}")
    return rows


def gather_registers():
    """``tiara_gather``'s kernels (the small and the stream regime, per
    element and table type) from the ``-Xptxas=-v`` build log: registers,
    spills, and the stream regime's shared memory a block (dynamic, from
    the library's constants); fails on a spill."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.tiara_gather import kernel as tk
    rows, name, spill = [], None, None
    for line in _build.log_path().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"tiara_gather_(small|stream)_kernelI(\w)(\w)E",
                             m.group(1))
            spill = None
        elif name and spill is None and "spill stores" in line:
            spill = [int(x) for x in
                     re.findall(r"(\d+) bytes spill (?:stores|loads)", line)]
        elif name and "Used" in line and "registers" in line:
            rows.append(dict(
                kernel=f"{name.group(1)}<{name.group(2)},{name.group(3)}>",
                registers=int(re.search(r"Used (\d+) registers",
                                        line).group(1)),
                spill_stores=spill[0], spill_loads=spill[1]))
            name = None
    if not rows:
        raise AssertionError("the build log names no tiara_gather kernel")
    cfg = tk.config()
    log(f"[kernel] tiara_gather kernels (-Xptxas -v; element type t/j/m = "
        f"2/4/8 bytes, table i/l = int32/int64): " + ", ".join(
            f"{r['kernel']} {r['registers']} registers, spills "
            f"{r['spill_stores']}/{r['spill_loads']} B" for r in rows)
        + f"; a stream block: {cfg['threads']} threads, "
        f"{cfg['smem_bytes']} B of shared memory ({cfg['ring_slots']} ring "
        f"slots of {cfg['unit_bytes']} B), {cfg['blocks_per_sm']} blocks an "
        f"SM; the small regime up to {cfg['small_max_width']} words")
    spilled = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"tiara_gather kernels spill: {spilled}")
    return dict(kernels=rows, **cfg)


def phase_kernel(dev, scratch):
    """tiara_gather against its plain version on the card: both regimes
    and forms, the path shape's times, bounds and launch floor.  The
    launch floor is measured here, once, before any other time."""
    from repro_torch.kernels.tiara_gather.ops import tiara_gather
    from repro_torch.kernels.tiara_gather.ref import tiara_gather_ref

    floor_ms = launch_floor_ms(scratch)
    log(f"[kernel] {floor_note(floor_ms)} (the library's empty kernel "
        f"between time_cuda's events, after a read flush of the L2), printed "
        f"beside every kernel time below")

    rng = np.random.default_rng(0)
    # small dtype sweep, including a row width that takes the 4-byte path
    for dtype, rows, r in [(torch.float32, 64, 256), (torch.bfloat16, 64, 128),
                           (torch.int32, 64, 96), (torch.int32, 32, 3),
                           (torch.int64, 16, 5)]:
        pool = torch.from_numpy(rng.standard_normal((rows, r))) \
            .to(dev, dtype) if dtype.is_floating_point else \
            torch.from_numpy(rng.integers(0, 1 << 30, (rows, r))).to(dev, dtype)
        table = torch.from_numpy(rng.permutation(rows).astype(np.int32)).to(dev)
        ids = torch.from_numpy(rng.integers(0, rows, 9).astype(np.int32)).to(dev)
        out = tiara_gather(pool, table, ids)
        torch.cuda.synchronize()
        if not torch.equal(out, tiara_gather_ref(pool, table, ids)):
            raise AssertionError(f"tiara_gather != plain for {dtype} "
                                 f"({rows}x{r})")
    log("[kernel] tiara_gather == plain version for f32, bf16, int32, "
        "int64 small cases")

    # window form, unaligned offsets and windows that wrap in the region
    from repro_torch.kernels.tiara_gather.ops import tiara_gather_window
    from repro_torch.kernels.tiara_gather.ref import tiara_gather_window_ref
    for dtype, width, mask in [(torch.int64, 1024, 4095), (torch.int64, 5, 63),
                               (torch.float32, 64, 63),
                               (torch.bfloat16, 9, 31)]:
        flat = torch.from_numpy(rng.integers(0, 1 << 30, 2 * (mask + 1) + 1)) \
            .to(dev, dtype)
        table = torch.from_numpy(
            rng.integers(0, mask + 1, 12).astype(np.int32)).to(dev)
        table[0] = mask
        bases = torch.from_numpy(rng.integers(0, 2, 12) * (mask + 1)).to(dev)
        ids = torch.from_numpy(rng.integers(0, 12, 9).astype(np.int32)).to(dev)
        ids[0] = 0
        out = tiara_gather_window(flat, table, bases, ids, width=width,
                                  mask=mask)
        want = tiara_gather_window_ref(flat, table, bases, ids, width=width,
                                       mask=mask)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"tiara_gather_window != plain for {dtype} "
                                 f"width {width} mask {mask}")
    log("[kernel] tiara_gather_window == plain version for unaligned and "
        "wrapping windows (int64, f32, bf16)")

    # each regime and copy path of the redesigned kernel: the small
    # regime (width <= SMALL_MAX_WIDTH, one thread a word) and the stream
    # regime (bulk interiors, vectors, element by element, wrapping), with
    # and without ids, one mask and per-entry masks; two calls the same
    # bits, one launch each
    from repro_torch import kernels
    from repro_torch.kernels.tiara_gather import kernel as tk
    for dtype, width in [(torch.int64, 1), (torch.int64, 32),
                         (torch.bfloat16, 33), (torch.int64, 1024),
                         (torch.float32, 3000)]:
        region = 1 << 13
        n = 300
        flat = torch.from_numpy(rng.integers(0, 1 << 30, 3 * region + 3)) \
            .to(dev, dtype)
        table = torch.from_numpy(rng.integers(0, region, n + 2)).to(dev)
        table[::3] = region - 1                  # wrapping windows
        bases = torch.from_numpy(rng.integers(0, 3, n + 2) * region).to(dev)
        masks = torch.full((n + 2,), region - 1, device=dev)
        masks[1::2] = region // 4 - 1
        ids = torch.from_numpy(rng.integers(0, n + 2, n).astype(np.int32)) \
            .to(dev)
        for i in (ids, None):
            for m in (region - 1, masks):
                before = kernels.launch_counts()["tiara_gather"]
                out = tiara_gather_window(flat, table, bases, i, width=width,
                                          mask=m)
                again = tiara_gather_window(flat, table, bases, i,
                                            width=width, mask=m)
                want = tiara_gather_window_ref(flat, table, bases, i,
                                               width=width, mask=m)
                torch.cuda.synchronize()
                if not (torch.equal(out, want) and torch.equal(again, out)):
                    raise AssertionError(
                        f"tiara_gather_window != plain (or not the same "
                        f"bits twice) for {dtype} width {width}, ids "
                        f"{i is not None}, per-entry masks "
                        f"{isinstance(m, torch.Tensor)}")
                if kernels.launch_counts()["tiara_gather"] != before + 2:
                    raise AssertionError("tiara_gather did not count one "
                                         "launch a call")
    log(f"[kernel] tiara_gather_window == plain version in both regimes "
        f"(small up to {tk.SMALL_MAX_WIDTH} words, stream past it), with "
        f"and without ids, shared and per-entry masks, the same bits "
        f"twice")
    registers = gather_registers()

    # The main path's shape.  The compiled gather chain of a 256-post
    # paged-KV wave calls the window form over the engine's flat pool:
    # 4096 entries (256 posts x 16 blocks), 1024-word rows (8 KiB
    # blocks), offsets into the 1 GiB kvpool region (mask 2**27 - 1) at
    # the block-aligned translations the stock table holds, no ids (entry
    # i is id i, as the engines call it).  The row form runs on the same
    # bytes as a (131072, 1024) view, with ids.
    n_rows, R, n = 131072, 1024, 4096
    mask = n_rows * R - 1
    flat = torch.randint(-(1 << 62), 1 << 62, (n_rows * R + 1,),
                         dtype=torch.int64, device=dev)
    blocks = rng.choice(n_rows, n, replace=False)
    offs = torch.from_numpy((blocks * R).astype(np.int32)).to(dev)
    bases = torch.zeros(n, dtype=torch.int64, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)

    def win():
        return tiara_gather_window(flat, offs, bases, width=R, mask=mask)

    def win_plain():
        return tiara_gather_window_ref(flat, offs, bases, width=R, mask=mask)

    out, ref, again = win(), win_plain(), win()
    torch.cuda.synchronize()
    if not torch.equal(out, ref) or not torch.equal(again, out):
        raise AssertionError("tiara_gather_window != plain (or not the same "
                             "bits twice) at the path shape")
    del again
    max_abs_err = int((out - ref).abs().max().item())
    ms = time_cuda(win, scratch)
    plain_ms = time_cuda(win_plain, scratch)
    # bytes the function must move: each distinct requested row read
    # once, each output row written once, the offsets and bases read once
    uniq = int(np.unique(blocks).size)
    moved = uniq * R * 8 + n * R * 8 + n * (4 + 8)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    host_ms = host_wall_ms(win)
    # the kernel's own duration from the profiler (no launch or event
    # cost)
    kernel_ms = profiled_kernel_ms(win, scratch)

    pool2d = flat[:n_rows * R].view(n_rows, R)
    table = torch.from_numpy(blocks.astype(np.int32)).to(dev)
    out_r = tiara_gather(pool2d, table, ids)
    torch.cuda.synchronize()
    if not torch.equal(out_r, tiara_gather_ref(pool2d, table, ids)) \
            or not torch.equal(out_r, out):
        raise AssertionError("tiara_gather != plain at the path shape")
    row_ms = time_cuda(lambda: tiara_gather(pool2d, table, ids), scratch)
    row_host_ms = host_wall_ms(lambda: tiara_gather(pool2d, table, ids))
    same = tiara_gather(pool2d, table, ids)
    torch.cuda.synchronize()
    if not torch.equal(same, out_r):
        raise AssertionError("the row form gave other bits the second time")
    del same
    # the row form's bytes: the rows, the ids and the table entries
    row_bound_ms = (uniq * R * 8 + n * R * 8 + n * (4 + 4)) \
        / HBM_BYTES_PER_S * 1e3
    row_plain_ms = time_cuda(lambda: tiara_gather_ref(pool2d, table, ids),
                             scratch)
    # the library's row gather on the same inputs: index_select over the
    # pointers the table gives (the row form's function)

    def library():
        return pool2d.index_select(0, table[ids])

    if not torch.equal(library(), out_r):
        raise AssertionError("index_select != tiara_gather at the path "
                             "shape")
    library_ms = time_cuda(library, scratch)
    row_kernel_ms = profiled_kernel_ms(
        lambda: tiara_gather(pool2d, table, ids), scratch)
    library_kernel_ms = profiled_kernel_ms(library, scratch)

    def us(x):
        return "not measured" if x is None else f"{x * 1e3:.2f} us"
    log(f"[kernel] path shape: flat int64 pool {flat.numel() * 8 >> 20} MiB, "
        f"n={n} rows of {R} words: equal; window kernel (no ids) "
        f"{ms * 1e3:.2f} us ({moved / ms / 1e6:.0f} GB/s), "
        f"{host_ms * 1e3:.2f} us of host wall per call, plain "
        f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us (bytes); "
        f"row form kernel {row_ms * 1e3:.2f} us, {row_host_ms * 1e3:.2f} us "
        f"of host wall, plain {row_plain_ms * 1e3:.2f} us, bound "
        f"{row_bound_ms * 1e3:.2f} us, library (pool.index_select(0, "
        f"table[ids])) {library_ms * 1e3:.2f} us; launch floor (an empty "
        f"kernel of the library) {floor_ms * 1e3:.2f} us; {card_line()}")
    log(f"[kernel] path shape, the kernels' own durations (torch.profiler, "
        f"read flush): window {us(kernel_ms)}, row form "
        f"{us(row_kernel_ms)}, index_select (with its table[ids]) "
        f"{us(library_kernel_ms)}; byte bound {bound_ms * 1e3:.2f} us")
    if not (row_ms < library_ms):
        log("[kernel] NOTE: the row form is not faster than index_select "
            "at the path shape in this run")
    del flat, out, ref, out_r, pool2d
    torch.cuda.empty_cache()
    return dict(name="tiara_gather", route="cuda",
                source="src/repro_torch/kernels/tiara_gather/csrc/"
                       "tiara_gather.cu",
                replaces="src/repro/kernels/tiara_gather/kernel.py:28",
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                bytes_moved=moved, shape=[n_rows, R, n],
                host_ms_per_call=host_ms, launch_floor_ms=floor_ms,
                row_form_ms=row_ms, row_form_plain_ms=row_plain_ms,
                row_form_host_ms_per_call=row_host_ms,
                row_form_bound_ms=row_bound_ms, registers=registers,
                kernel_only_ms=kernel_ms,
                row_form_kernel_only_ms=row_kernel_ms,
                library_kernel_only_ms=library_kernel_ms)


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev, dtype)


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def _check_close(name, got, want, dtype, tol=None):
    """max |got - want|, after checking |got - want| <= atol + rtol |want|
    elementwise (``assert_allclose``); ``tol = (atol, rtol)``, by default
    ``ATTN_TOL[dtype]``."""
    atol, rtol = ATTN_TOL[dtype] if tol is None else tol
    err = _max_err(got, want)
    ok = ((got.float() - want.float()).abs()
          <= atol + rtol * want.float().abs()).all()
    if not bool(torch.isfinite(got.float()).all()) or not bool(ok):
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3g} "
                             f"over the tolerance atol {atol:.3g} + rtol "
                             f"{rtol:.3g} |plain| ({dtype})")
    return err


def _limit_share(got, want, tol) -> float:
    """The largest |got - want| / (atol + rtol |want|): 1 is the limit."""
    atol, rtol = tol
    w = want.float()
    return float(((got.float() - w).abs() / (atol + rtol * w.abs()))
                 .max().item())


def _check_same_bits(name, fn):
    """Two calls on the same inputs give the same bits (no atomics, a fixed
    order of every sum)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two calls differ")


def _paged_bytes(lengths, kvh, head_dim, q) -> int:
    """Bytes paged attention must move: the live tokens' K and V rows, q
    read and out written once (f32)."""
    return int(np.sum(lengths)) * kvh * head_dim * 4 * 2 + 2 * q.numel() * 4


def _paged_plain(q, k, v, bt, ln):
    """paged_attention_ref on the serving path's (B, QH, D) layout."""
    from repro_torch.kernels.paged_attention import paged_attention_ref
    b, qh, d = q.shape
    kvh = k.shape[2]
    return paged_attention_ref(q.view(b, kvh, qh // kvh, d), k, v, bt,
                               ln).view(b, qh, d)


def _causal_f64(q, k, v):
    """Causal attention in f64, the reference of the error at larger
    logits."""
    g = q.shape[1] // k.shape[1]
    q = q.double()
    k = k.double().repeat_interleave(g, dim=1)
    v = v.double().repeat_interleave(g, dim=1)
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril()
    return torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1) @ v


def attention_inputs(dev):
    """The timed shapes' inputs, from fixed seeds: ``{("paged", shape): (q,
    k_pages, v_pages, tables, lengths), ("flash", shape): (q, k, v)}``."""
    qh, kvh, d = ATTN_HEADS
    rng = np.random.default_rng(7)
    q = _randn(rng, (PAGED_SLOTS, qh, d), torch.float32, dev)
    k = _randn(rng, (PAGED_POOL, PAGE, kvh, d), torch.float32, dev)
    v = _randn(rng, (PAGED_POOL, PAGE, kvh, d), torch.float32, dev)
    bt = torch.from_numpy(rng.permutation(PAGED_SLOTS * PAGED_MAXP)
                          .reshape(PAGED_SLOTS, PAGED_MAXP)
                          .astype(np.int32)).to(dev)
    inputs = {("paged", name): (q, k, v, bt, torch.tensor(
        lens, dtype=torch.int32, device=dev))
        for name, lens in PAGED_LENGTHS.items()}
    for name, s in FLASH_SEQ.items():
        rng = np.random.default_rng(s)
        inputs[("flash", name)] = tuple(
            _randn(rng, (1, h, s, d), torch.float32, dev)
            for h in (qh, kvh, kvh))
    return inputs


def measure_attention(dev, scratch):
    """Both attention ops against their plain versions at the timed shapes
    (max error, two calls giving the same bits, median times), and
    flash's error against an f64 reference with q scaled so that the
    logits' standard deviation is each of LOGIT_STDS, beside the plain f32
    version's.  Uses whichever ``repro_torch`` is on ``sys.path``."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.paged_attention import paged_attention

    inputs = attention_inputs(dev)
    res = {}
    for (kernel, shape), args in inputs.items():
        fn, plain = ((paged_attention, _paged_plain) if kernel == "paged"
                     else (flash_attention, flash_attention_ref))
        name = f"{kernel}_attention ({shape} shape)"
        out, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        err = _check_close(name, out, ref, torch.float32)
        _check_same_bits(name, lambda: fn(*args))
        res[(kernel, shape)] = dict(
            err=err, ms=time_cuda(lambda: fn(*args), scratch),
            plain_ms=time_cuda(lambda: plain(*args), scratch))
    q, k, v = inputs[("flash", "path")]
    res["flash_logit_err"] = {}
    for std in LOGIT_STDS:
        qs = q * std
        want = _causal_f64(qs, k, v)
        res["flash_logit_err"][std] = dict(
            kernel=_max_err(flash_attention(qs, k, v), want),
            plain=_max_err(flash_attention_ref(qs, k, v), want))
        del want
    torch.cuda.empty_cache()
    return res, inputs


def phase_attention(dev, scratch, floor_ms):
    """paged_attention and flash_attention against their plain versions
    on the card: small edge cases, then the timed shapes, with times and
    bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.paged_attention import (kernel as pk,
                                                     paged_attention,
                                                     paged_attention_kernel,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_partitioned_ref)

    def at_partition(T, fn):
        """fn() with the kernel's partition size set to T tokens."""
        saved, pk.PARTITION_TOKENS = pk.PARTITION_TOKENS, T
        try:
            return fn()
        finally:
            pk.PARTITION_TOKENS = saved

    rng = np.random.default_rng(7)
    # small cases: bf16, an empty row, lengths that are no multiple of the
    # page, G = 7, head dims 16 / 32 / 128
    for dtype, (b, qh, kvh, d, pages, page, maxp) in [
            (torch.float32, (3, 7, 1, 16, 12, 4, 5)),
            (torch.bfloat16, (3, 12, 4, 64, 40, 16, 9)),
            (torch.float32, (2, 8, 2, 32, 16, 8, 6)),
            (torch.bfloat16, (2, 4, 2, 128, 8, 16, 4))]:
        q = _randn(rng, (b, qh, d), dtype, dev)
        k = _randn(rng, (pages, page, kvh, d), dtype, dev)
        v = _randn(rng, (pages, page, kvh, d), dtype, dev)
        bt = torch.from_numpy(rng.integers(0, pages, (b, maxp))
                              .astype(np.int32)).to(dev)
        ln = torch.tensor([0, maxp * page - 3] + [5] * (b - 2),
                          dtype=torch.int32, device=dev)
        out = paged_attention(q, k, v, bt, ln)
        torch.cuda.synchronize()
        _check_close("paged_attention", out, _paged_plain(q, k, v, bt, ln),
                     dtype)
        if not bool((out[0] == 0).all()):
            raise AssertionError("paged_attention: a length-0 row is not 0")
    for dtype, causal, (b, qh, kvh, s, d) in [
            (torch.float32, True, (2, 7, 1, 37, 16)),
            (torch.bfloat16, True, (1, 12, 4, 200, 64)),
            (torch.float32, False, (2, 4, 2, 96, 32)),
            (torch.bfloat16, False, (1, 4, 2, 130, 128))]:
        q = _randn(rng, (b, qh, s, d), dtype, dev)
        k = _randn(rng, (b, kvh, s, d), dtype, dev)
        v = _randn(rng, (b, kvh, s, d), dtype, dev)
        ln = torch.tensor([0, s - 5][:b] if b > 1 else [s - 5],
                          dtype=torch.int32, device=dev)
        for lens in (ln, None):
            out = flash_attention(q, k, v, lens, causal=causal)
            torch.cuda.synchronize()
            _check_close("flash_attention", out,
                         flash_attention_ref(q, k, v, lens, causal=causal),
                         dtype)
    log("[kernel] paged_attention and flash_attention == plain versions for "
        "f32/bf16, empty rows, G = 7, D in {16, 32, 64, 128}, ragged S and "
        "lengths that are no multiple of the page")

    # the sequence split's edge cases, at both partition sizes: a length
    # 0, one shorter than a partition, exact multiples of T, one past a
    # multiple, and a whole table of 21 pages x 16 = 336 tokens, which is
    # no multiple of T
    erng = np.random.default_rng(17)
    b, kvh, g, d, pages, page, maxp = 6, 4, 3, 64, 160, 16, 21
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn(erng, (b, kvh, g, d), dtype, dev)
        k = _randn(erng, (pages, page, kvh, d), dtype, dev)
        v = _randn(erng, (pages, page, kvh, d), dtype, dev)
        bt = torch.from_numpy(erng.permutation(pages)[:b * maxp]
                              .reshape(b, maxp).astype(np.int32)).to(dev)
        for T in (128, 256):
            ln = torch.tensor([0, 5, T, min(2 * T, maxp * page), T + 1,
                               maxp * page], dtype=torch.int32, device=dev)
            out = at_partition(T, lambda: paged_attention_kernel(
                q, k, v, bt, ln))
            torch.cuda.synchronize()
            _check_close(f"paged_attention T={T}", out,
                         paged_attention_ref(q, k, v, bt, ln), dtype)
            _check_close(f"paged_attention T={T} (split plain)", out,
                         paged_attention_partitioned_ref(
                             q, k, v, bt, ln, partition_tokens=T), dtype)
            if not bool((out[0] == 0).all()):
                raise AssertionError("paged_attention: a length-0 row is "
                                     "not 0")
    log("[kernel] paged_attention's split at T = 128 and 256 == plain "
        "versions (f32, bf16): length 0, shorter than a partition, exact "
        "multiples of T, a table of 336 tokens (no multiple of T)")

    res, inputs = measure_attention(dev, scratch)
    qh, kvh, d = ATTN_HEADS
    for shape in PAGED_LENGTHS:
        q, k, v, bt, ln = inputs[("paged", shape)]
        r = res[("paged", shape)]
        r["bytes"] = _paged_bytes(PAGED_LENGTHS[shape], kvh, d, q)
        r["bound"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        qg = q.view(PAGED_SLOTS, kvh, qh // kvh, d)
        r["ms_by_T"] = {T: at_partition(T, lambda: time_cuda(
            lambda: paged_attention_kernel(qg, k, v, bt, ln), scratch))
            for T in (128, 256)}
        log(f"[kernel] paged_attention, {shape} shape q {tuple(q.shape)} "
            f"pages {tuple(k.shape)} tables {tuple(bt.shape)} lengths "
            f"{list(PAGED_LENGTHS[shape])}: max err {r['err']:.3g}, two "
            f"calls same bits; kernel {r['ms'] * 1e3:.2f} us "
            f"({r['bytes'] / r['ms'] / 1e6:.0f} GB/s), plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound'] * 1e3:.2f} us "
            f"(bytes); at T = 128 / 256: {r['ms_by_T'][128] * 1e3:.2f} / "
            f"{r['ms_by_T'][256] * 1e3:.2f} us; "
            f"{floor_note(floor_ms)}")
    p, sh = res[("paged", "path")], res[("paged", "short")]
    q, k = inputs[("paged", "path")][:2]
    paged = dict(name="paged_attention", route="cuda",
                 source="src/repro_torch/kernels/paged_attention/csrc/"
                        "paged_attention.cu",
                 replaces="src/repro/kernels/paged_attention/kernel.py:79",
                 max_abs_err=p["err"], ms=p["ms"], plain_ms=p["plain_ms"],
                 bound_ms=p["bound"], bound_by="bytes", library_ms=None,
                 bytes_moved=p["bytes"], shape=list(q.shape) + list(k.shape),
                 lengths=list(PAGED_LENGTHS["path"]),
                 ms_t128=p["ms_by_T"][128], ms_t256=p["ms_by_T"][256],
                 short_lengths=list(PAGED_LENGTHS["short"]),
                 short_ms=sh["ms"], short_plain_ms=sh["plain_ms"],
                 short_bound_ms=sh["bound"], short_max_abs_err=sh["err"],
                 short_ms_t128=sh["ms_by_T"][128],
                 short_ms_t256=sh["ms_by_T"][256])

    for shape, s in FLASH_SEQ.items():
        q, k, v = inputs[("flash", shape)]
        r = res[("flash", shape)]
        lib = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             enable_gqa=True)
        r["lib_err"] = _max_err(lib, flash_attention_ref(q, k, v))
        del lib
        r["lib"] = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), scratch)
        pairs = s * (s + 1) // 2            # causal (query, key) pairs
        r["flops"] = 2 * 2 * pairs * d * qh  # q.k and p.v, 2 flops per FMA
        moved = (2 * q.numel() + 2 * k.numel()) * 4
        # three TF32 passes per product on the tensor cores
        r["bound"] = max(3 * r["flops"] / TF32_FLOPS_PER_S,
                         moved / HBM_BYTES_PER_S) * 1e3
        r["shape"] = list(q.shape) + list(k.shape)
        log(f"[kernel] flash_attention, {shape} shape q {tuple(q.shape)} "
            f"k/v {tuple(k.shape)} causal: max err {r['err']:.3g} (sdpa "
            f"{r['lib_err']:.3g}), two calls same bits; kernel "
            f"{r['ms'] * 1e3:.1f} us ({r['flops'] / r['ms'] / 1e9:.2f} "
            f"TFLOP/s), plain {r['plain_ms'] * 1e3:.1f} us, sdpa "
            f"{r['lib'] * 1e3:.1f} us, bound {r['bound'] * 1e3:.1f} us "
            f"(operations, 3xTF32 on tensor cores); "
            f"{floor_note(floor_ms)}")
    le = res["flash_logit_err"]
    log("[kernel] flash_attention, path shape, max |out - f64| by logit "
        "std: " + "; ".join(f"{std}: kernel {e['kernel']:.3g}, plain f32 "
                            f"{e['plain']:.3g}" for std, e in le.items()))
    p, sh = res[("flash", "path")], res[("flash", "short")]
    flash = dict(name="flash_attention", route="cuda",
                 source="src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention/kernel.py:73",
                 max_abs_err=p["err"], ms=p["ms"], plain_ms=p["plain_ms"],
                 bound_ms=p["bound"], bound_by="operations",
                 bound_rate="3xTF32 on tensor cores, 3 x flops over "
                            "495 TFLOP/s", library_ms=p["lib"],
                 flops=p["flops"], shape=p["shape"],
                 library_max_abs_err=p["lib_err"], short_shape=sh["shape"],
                 short_ms=sh["ms"], short_plain_ms=sh["plain_ms"],
                 short_bound_ms=sh["bound"], short_library_ms=sh["lib"],
                 short_max_abs_err=sh["err"],
                 f64_err_by_logit_std=le)
    del inputs, res
    torch.cuda.empty_cache()
    return paged, flash


def flash_bf16_logit_shares(dev, fail=True):
    """bf16 flash_attention at Scout's prefill shape (1 x 40/8 x 2048 x
    128, causal) with q scaled so that the logits' standard deviation is
    each of LOGIT_STDS (unit-normal q and k give 1; the factors are powers
    of two, exact in bf16): the kernel's largest error against its plain
    version as a share of SCOUT_ATTN_TOL, by std.  With ``fail``, a share
    above 1 fails the run."""
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_ref)
    bf = torch.bfloat16
    rng = np.random.default_rng(35)
    b, qh, kvh, s, d = 1, 40, 8, SERVE_MAX_SEQ, 128
    q = _randn(rng, (b, qh, s, d), bf, dev)
    k, v = (_randn(rng, (b, kvh, s, d), bf, dev) for _ in range(2))
    shares = {}
    for std in LOGIT_STDS:
        qs = q * std
        shares[std] = _limit_share(flash_attention_kernel(qs, k, v),
                                   flash_attention_ref(qs, k, v),
                                   SCOUT_ATTN_TOL)
    log("[kernel] flash_attention bf16 at Scout's shape, max |kernel - "
        "plain| as a share of SCOUT_ATTN_TOL by logit std: " + "; ".join(
            f"{std}: {x:.3f}" for std, x in shares.items()))
    if fail and max(shares.values()) > 1:
        raise AssertionError(f"flash_attention bf16 misses two ulps at "
                             f"larger logits: {shares}")
    del q, k, v
    torch.cuda.empty_cache()
    return shares


def flash_bf16_rows(dev, scratch, floor_ms):
    """bf16 flash_attention's forward at each of FLASH_BF16_CASES through
    ``attention_cases`` (within SCOUT_ATTN_TOL, the same bits twice, its
    time, the plain version's, SDPA's, its bound over the live keys and
    the design's floor); one dict per case."""
    rng = np.random.default_rng(36)
    cases = []
    for label, (b, qh, kvh, sq, sk, d), causal, lens in FLASH_BF16_CASES:
        q = _randn(rng, (b, qh, sq, d), torch.bfloat16, dev)
        k, v = (_randn(rng, (b, kvh, sk, d), torch.bfloat16, dev)
                for _ in range(2))
        kw = dict(causal=causal)
        if lens is not None:
            kw["lengths"] = torch.tensor(lens, dtype=torch.int32, device=dev)
        cases.append((label, "flash", (q, k, v), kw))
    return attention_cases("flash bf16", cases, dev, scratch, floor_ms)


def attention_only(dev, label):
    """``--attention-only``: the timed attention shapes and flash's error
    at larger logits, then the backward kernel's time at each of
    BWD_CASES, for the kernels of whichever tree ``--src`` named; one JSON
    line per shape."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    card = card_line()
    phase_build()
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)
    floor_ms = launch_floor_ms(scratch)
    floor = dict(launch_floor_ms=floor_ms)
    res, _ = measure_attention(dev, scratch)
    for key, r in res.items():
        if key == "flash_logit_err":
            row = dict(kernel="flash", f64_err_by_logit_std=r)
        else:
            row = dict(kernel=key[0], shape=key[1], **r, **floor)
        log(json.dumps(dict(label=label, card=card, **row)))
    for case, r in flash_bf16_rows(dev, scratch, floor_ms).items():
        log(json.dumps(dict(label=label, card=card, kernel="flash_bf16",
                            case=case, **r, **floor)))
    log(json.dumps(dict(label=label, card=card, kernel="flash_bf16",
                        limit_share_by_logit_std=flash_bf16_logit_shares(
                            dev, fail=False))))
    for case, shape, causal, lens, dtype in BWD_CASES:
        q, k, v, do, ln = _bwd_inputs(dev, shape, lens, dtype)
        out, lse = flash_attention_kernel(q, k, v, ln, causal=causal,
                                          return_lse=True)
        fwd_ms = time_cuda(lambda: flash_attention_kernel(
            q, k, v, ln, causal=causal, return_lse=True), scratch)
        ms = time_cuda(lambda: flash_attention_bwd_kernel(
            q, k, v, out, lse, do, ln, causal=causal), scratch)
        log(json.dumps(dict(label=label, card=card, kernel="flash_bwd",
                            shape=case, ms=ms, fwd_with_lse_ms=fwd_ms,
                            **floor)))
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return 0


def decode_only(dev, label):
    """``--decode-only``: the decode steps that run no tiara, for the
    ``repro_torch`` that ``--src`` named: tiny-lm's host-resolved serving
    run (phase 5's weights and requests), and Jamba's and RWKV-6's main
    paths (phases 7 and 8, through ``model_run``: prefill and decode-step
    walls, peak memory, launches, the scans' device time in one more
    prefill and step); one JSON line each."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    card = card_line()
    phase_build()
    cfg = get_config("tiny-lm")
    params = tf.init_params(cfg, seed=0, device=dev)
    eng = ServingEngine(cfg, params, max_slots=SERVE_SLOTS,
                        max_seq=SERVE_MAX_SEQ, eos_id=-1, temperature=0.0,
                        resolver="host", device=dev)
    timed = _Timed(eng)
    t = time.perf_counter()
    for p in _tiny_prompts(cfg):
        eng.submit(p, max_new=SERVE_NEW)
    out = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    tokens = sum(len(v) for v in out.values())
    log(json.dumps(dict(
        label=label, card=card, path="tiny-lm, host-resolved serving",
        step_ms_median=float(np.median(timed.step_ms)),
        step_ms=timed.step_ms, prefill_ms=sum(
            sum(v) for v in timed.prefill_ms.values()),
        wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall)))
    del eng, params
    torch.cuda.empty_cache()
    for tag, arch, layers, seed in (("jamba", JAMBA_ARCH, JAMBA_LAYERS, 15),
                                    ("rwkv", RWKV_ARCH, None, 16)):
        full = get_config(arch)
        cfg = full if layers is None else full.replace(n_layers=layers)
        params, _, _ = _draw_model(tag, cfg, full, dev)
        run = model_run(tag, cfg, params, _recurrent_prompts(cfg, seed), dev)
        log(json.dumps(dict(
            label=label, card=card, path=f"{tag}, tf.prefill + "
            f"{RECURRENT_STEPS} tf.decode_steps",
            step_ms_median=float(np.median(run["step_ms"])),
            step_ms=run["step_ms"], prefill_ms=run["prefill_ms"],
            tokens=run["tokens"], tokens_per_s=run["tokens_per_s"],
            max_memory_allocated=run["max_memory_allocated"],
            scans=run["scans"], prefill_counts=run["prefill_counts"],
            step_counts=run["step_counts"],
            step_kernels=run["profile"]["kernel_launches"],
            step_device_busy_ms=run["profile"]["device_busy_ms"])))
        del params, run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


class _Timed:
    """Wall time of an engine's prefills (by bucket) and decode steps,
    each ended by ``torch.cuda.synchronize()``, and the tiara_gather and
    lockstep_vm launches of every decode step."""

    def __init__(self, eng):
        from repro_torch import kernels
        self.prefill_ms, self.step_ms, self.step_gathers = {}, [], []
        self.step_waves = []
        self._in_prefill = 0.0
        prefill, step = eng._prefill, eng.step

        def timed_prefill(seq):
            bucket = min(max(eng.cfg.page_size,
                             1 << int(np.ceil(np.log2(max(len(seq.prompt),
                                                          1))))),
                         eng.max_seq)
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill(seq)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t) * 1e3
            self.prefill_ms.setdefault(bucket, []).append(dt)
            self._in_prefill += dt

        def timed_step():
            decoding = bool(eng.waiting) or any(eng.active)
            torch.cuda.synchronize()
            self._in_prefill = 0.0
            c0 = kernels.launch_counts()
            t = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            if decoding:
                self.step_ms.append((time.perf_counter() - t) * 1e3
                                    - self._in_prefill)
                c1 = kernels.launch_counts()
                self.step_gathers.append(c1["tiara_gather"]
                                         - c0["tiara_gather"])
                # (.get: a parent tree timed by --decode-only may have no
                # lockstep_vm)
                self.step_waves.append(c1.get("lockstep_vm", 0)
                                       - c0.get("lockstep_vm", 0))
            return out
        eng._prefill, eng.step = timed_prefill, timed_step


def serve_both(tag, cfg, params, prompts, max_new, dev, *,
               profile_prompts=None):
    """``prompts`` through ServingEngine(max_slots=SERVE_SLOTS,
    max_seq=SERVE_MAX_SEQ), greedy, under resolver="host" then "tiara".
    Fails unless every sequence finishes ok with ``max_new`` tokens,
    ``flash_attention`` launched ``n_layers`` times per prefill and
    ``paged_attention`` ``n_layers`` times per decode step, a tiara
    kernel (``tiara_gather`` for the compiled trace's waves, one
    ``lockstep_vm`` launch for a lockstep wave) in every tiara decode step
    and neither under host, an MoE model's tiara run executed expert
    gathers, and both runs gave the same tokens.  The launch counts are
    set to 0 just before each run and read just after it.  With
    ``profile_prompts``, one decode step of those prompts is profiled
    after each run.  Returns the runs, the tiara run's first window
    gather of each engine and its first lockstep wave (None if it ran
    none)."""
    from repro_torch import kernels
    from repro_torch.serving import ServingEngine
    runs, gathers, first_wave = {}, None, None
    for resolver in ("host", "tiara"):
        eng = ServingEngine(cfg, params, max_slots=SERVE_SLOTS,
                            max_seq=SERVE_MAX_SEQ, eos_id=-1,
                            temperature=0.0, resolver=resolver, device=dev)
        timed = _Timed(eng)
        expert_gathers = [0]
        if resolver == "tiara" and eng.resolver.moe is not None:
            resolve = eng.resolver.resolve_step

            def counted(slots, reqs=None, _resolve=resolve):
                kv, ex = _resolve(slots, reqs)
                expert_gathers[0] += sum(e is None for e in ex.values())
                return kv, ex
            eng.resolver.resolve_step = counted
        rec = _GatherCalls()
        waves = _LockstepWaves(keep_first=True)
        with rec, waves:
            kernels.reset_launch_counts()    # the serving path starts here
            t = time.perf_counter()
            handles = [eng.submit(p, max_new=max_new) for p in prompts]
            out = eng.run_to_completion()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = kernels.launch_counts()  # ... and ends here
        if not all(h.ok for h in handles) \
                or any(len(out[h.sid]) != max_new for h in handles):
            raise AssertionError(f"{tag} {resolver}: a sequence did not "
                                 f"finish ok")
        n_prefill = sum(len(v) for v in timed.prefill_ms.values())
        n_steps = len(timed.step_ms)
        if n_prefill != len(prompts) \
                or counts["flash_attention"] != cfg.n_layers * n_prefill:
            raise AssertionError(
                f"{tag} {resolver}: flash_attention launched "
                f"{counts['flash_attention']} times for {n_prefill} "
                f"prefills, expected {cfg.n_layers} per prefill")
        if counts["paged_attention"] != cfg.n_layers * n_steps:
            raise AssertionError(
                f"{tag} {resolver}: paged_attention launched "
                f"{counts['paged_attention']} times in {n_steps} decode "
                f"steps, expected {cfg.n_layers} per step")
        if resolver == "host" and (counts["tiara_gather"]
                                   or counts["lockstep_vm"]):
            raise AssertionError(f"{tag} host: a tiara kernel launched")
        # copies: a profiled step below would add to the live lists
        run = dict(out=out, counts=counts, wall_s=wall,
                   tokens=sum(len(v) for v in out.values()),
                   prefill_ms={int(k): list(v)
                               for k, v in sorted(timed.prefill_ms.items())},
                   step_ms=list(timed.step_ms),
                   step_gathers=list(timed.step_gathers),
                   step_waves=list(timed.step_waves))
        plens = [len(p) for p in prompts]
        log(f"[{tag}] resolver={resolver}: {len(prompts)} requests "
            f"(prompts {min(plens)}-{max(plens)} tokens), {run['tokens']} "
            f"tokens in {wall:.2f} s = {run['tokens'] / wall:.1f} tokens/s; "
            f"{n_prefill} prefills, {n_steps} decode steps; launches "
            f"{counts}")
        log(f"[{tag}] resolver={resolver}: prefill ms by bucket "
            + ", ".join(f"{k}: {np.median(v):.1f} (x{len(v)})"
                        for k, v in sorted(timed.prefill_ms.items()))
            + f"; decode step ms median {np.median(timed.step_ms):.2f}, "
            f"min {min(timed.step_ms):.2f}, max {max(timed.step_ms):.2f}")
        if resolver == "tiara":
            st = eng.resolver.loop.stats
            if min(g + w for g, w in zip(timed.step_gathers,
                                         timed.step_waves)) < 1:
                raise AssertionError(f"{tag} tiara: a decode step launched "
                                     f"no tiara kernel")
            if eng.resolver.moe is not None and expert_gathers[0] < 1:
                raise AssertionError(f"{tag} tiara: no expert gather")
            run.update(executed=st.executed, expert_gathers=expert_gathers[0],
                       gather_calls=rec.counts)
            gathers, first_wave = rec.first, waves.first
            log(f"[{tag}] resolver=tiara: per decode step median "
                f"{int(np.median(timed.step_gathers))} tiara_gather (by "
                f"engine: {rec.counts}) and "
                f"{int(np.median(timed.step_waves))} lockstep_vm launches; "
                f"resolver.loop.stats.executed {st.executed}, expert "
                f"gathers checked {expert_gathers[0]}")
        if profile_prompts is not None:
            prof = run["profile"] = profile_step(eng, profile_prompts)
            # the profiled step's wall carries the profiler's host cost
            prof["busy_share_of_median_step"] = \
                prof["device_busy_ms"] / float(np.median(run["step_ms"]))
            log(f"[{tag}] resolver={resolver}: one profiled decode step of "
                f"{len(profile_prompts)} slots: {prof['wall_ms']:.2f} ms "
                f"wall, device busy {prof['device_busy_ms']:.2f} ms "
                f"({prof['busy_share']:.1%}; "
                f"{prof['busy_share_of_median_step']:.1%} of the run's "
                f"median step) in {prof['kernel_launches']} kernels; top: "
                + "; ".join(f"{r['kernel']} {r['ms']:.3f} ms x{r['count']}"
                            for r in prof["top"]))
        runs[resolver] = run
        del eng
        torch.cuda.empty_cache()
    if runs["tiara"]["out"] != runs["host"]["out"]:
        raise AssertionError(f"{tag}: resolver='tiara' tokens differ from "
                             f"'host'")
    log(f"[{tag}] tiara tokens == host tokens for all {len(prompts)} "
        f"requests")
    return runs, gathers, first_wave


def tiara_on_host_loop(tag, cfg, params, prompts, max_new, dev, want):
    """The tiara run again with every lockstep wave on the kernel's plain
    version, the host loop, on the card (``_Engine.run_kernel`` swapped
    for ``run_host_loop`` for this run only): its decode-step walls
    beside the kernel's, and the same tokens.  A comparison, not the main
    path: its launches are taken back out of the counts."""
    from repro_torch import kernels
    from repro_torch.core import vm
    from repro_torch.serving import ServingEngine
    saved = kernels.launch_counts()
    kernel = vm._Engine.run_kernel
    vm._Engine.run_kernel = vm._Engine.run_host_loop
    calls = _GatherCalls()
    try:
        calls.__enter__()
        eng = ServingEngine(cfg, params, max_slots=SERVE_SLOTS,
                            max_seq=SERVE_MAX_SEQ, eos_id=-1,
                            temperature=0.0, resolver="tiara", device=dev)
        timed = _Timed(eng)
        for p in prompts:
            eng.submit(p, max_new=max_new)
        out = eng.run_to_completion()
        torch.cuda.synchronize()
        waves = kernels.launch_counts()["lockstep_vm"] \
            - saved["lockstep_vm"]
    finally:
        calls.__exit__()
        vm._Engine.run_kernel = kernel
        _restore_counts(saved)
    if out != want:
        raise AssertionError(f"{tag} tiara on the host loop: tokens differ")
    if waves:
        raise AssertionError(f"{tag} tiara on the host loop launched "
                             f"lockstep_vm")
    r = dict(step_ms=list(timed.step_ms),
             step_ms_median=float(np.median(timed.step_ms)),
             step_gathers_median=float(np.median(timed.step_gathers)))
    del eng
    torch.cuda.empty_cache()
    log(f"[{tag}] resolver=tiara with its lockstep waves on the host loop "
        f"(the kernel's plain version): decode step ms median "
        f"{r['step_ms_median']:.2f}, min {min(timed.step_ms):.2f}, max "
        f"{max(timed.step_ms):.2f}; {r['step_gathers_median']:.0f} "
        f"tiara_gather launches a step; the same tokens")
    return r, calls.first.get("lockstep")


def _tiny_prompts(cfg):
    """tiny-lm's 16 serving requests, prompts of 16..1536 tokens."""
    rng = np.random.default_rng(11)
    plens = rng.permutation(np.round(np.geomspace(16, 1536, 16))
                            .astype(int))
    return [list(map(int, rng.integers(1, cfg.vocab, n))) for n in plens]


def phase_serving(dev):
    """tiny-lm at full width through ServingEngine, host then tiara."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import count_params

    cfg = get_config("tiny-lm")
    t = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = count_params(params)
    log(f"[serving] tiny-lm: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab}, {n_params / 1e6:.1f}M f32 params from seed 0 "
        f"({time.perf_counter() - t:.1f} s)")
    runs, gathers, wave = serve_both("serving", cfg, params,
                                     _tiny_prompts(cfg), SERVE_NEW, dev)
    cpu_err = card_vs_cpu(cfg, params, dev)
    return runs, cpu_err, gathers, wave


def card_vs_cpu(cfg, params, dev) -> float:
    """The port on the card against the port on the CPU, same weights: a
    64-token prompt, then 8 teacher-forced decode steps; logits agree
    within CARD_VS_CPU_TOL."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import tree_map
    rng = np.random.default_rng(12)
    toks = rng.integers(1, cfg.vocab, 64 + 8).astype(np.int64)
    maxp = (64 + 8 + cfg.page_size - 1) // cfg.page_size
    logits = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        p = tree_map(lambda a: a.to(d), params)
        caches = tf.init_caches(cfg, 1, maxp, device=d)
        bt = tf.default_block_tables(cfg, 1, maxp, device=d)
        with torch.no_grad():
            out = tf.apply_model(p, cfg, {
                "tokens": torch.from_numpy(toks[None, :64]).to(d),
                "caches": caches, "block_tables": bt,
                "lengths": torch.tensor([64], dtype=torch.int32, device=d)},
                mode="prefill")
            got = [out.logits[0, -1]]
            for i in range(8):
                out = tf.apply_model(p, cfg, {
                    "tokens": torch.from_numpy(toks[None, 64 + i:65 + i])
                    .to(d), "caches": caches, "block_tables": bt,
                    "lengths": torch.tensor([64 + i], dtype=torch.int32,
                                            device=d)}, mode="decode")
                got.append(out.logits[0, 0])
        logits[where] = torch.stack(got).cpu()
    err = _max_err(logits["cuda"], logits["cpu"])
    if not bool(torch.isfinite(logits["cuda"]).all()) \
            or err > CARD_VS_CPU_TOL:
        raise AssertionError(f"card vs CPU logits differ by {err:.3g} "
                             f"(tolerance {CARD_VS_CPU_TOL})")
    log(f"[serving] card vs CPU, 64-token prompt + 8 teacher-forced decode "
        f"steps: max |logit diff| {err:.3g} (tolerance {CARD_VS_CPU_TOL}, "
        f"max |logit| {float(logits['cpu'].abs().max()):.2f})")
    return err


class _GatherCalls:
    """Records the window gathers a run issues through the lockstep engine
    (``core.vm``) and the compiled trace (``core.compile``): how many, and
    the arguments of the first of each, to time the kernel afterwards at
    exactly the shape the serving resolver gives it.  Every call is
    forwarded unchanged."""

    def __init__(self):
        self.first, self.counts = {}, {}

    def __enter__(self):
        from repro_torch.core import compile as tc
        from repro_torch.core import vm
        self._saved = []
        for name, mod in (("lockstep", vm), ("compiled", tc)):
            fn = mod.tiara_gather_window
            self._saved.append((mod, fn))

            def rec(pool, table, bases, ids=None, *, width, mask,
                    impl="auto", _fn=fn, _name=name):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                if _name not in self.first:
                    self.first[_name] = dict(
                        pool=pool.clone(), table=table.clone(),
                        bases=bases.clone(),
                        ids=None if ids is None else ids.clone(), width=width,
                        mask=mask.clone() if isinstance(mask, torch.Tensor)
                        else mask)
                return _fn(pool, table, bases, ids, width=width, mask=mask,
                           impl=impl)
            mod.tiara_gather_window = rec
        return self

    def __exit__(self, *exc):
        for mod, fn in self._saved:
            mod.tiara_gather_window = fn


def time_gather_call(call, scratch, latency_ns, floor_ms):
    """``tiara_gather``'s window form at one recorded serving call: equal
    to its plain version, the same bits twice; device time (CUDA events,
    L2 flushed); the host wall of one call, launch included
    (``host_wall_ms``); the byte bound, and the latency
    bound: the window's dependent global loads (ids when given, then the
    table, bases and masks side by side, then the pool) times the card's
    cold-word latency, beside the launch floor.  For one-word windows
    under one shared mask, the library's time too: one ``index_select``
    of the flat pool at the word offsets the windows name, computed
    beforehand (per-lane masks have no such call: none applies them)."""
    from repro_torch.kernels.tiara_gather.ops import tiara_gather_window
    from repro_torch.kernels.tiara_gather.ref import tiara_gather_window_ref
    args = (call["pool"], call["table"], call["bases"], call["ids"])
    kw = dict(width=call["width"], mask=call["mask"])

    def fn():
        return tiara_gather_window(*args, **kw)
    out, ref, again = fn(), tiara_gather_window_ref(*args, **kw), fn()
    torch.cuda.synchronize()
    if not torch.equal(out, ref) or not torch.equal(again, out):
        raise AssertionError("tiara_gather_window != plain (or not the same "
                             "bits twice) at a serving shape")
    ms = time_cuda(fn, scratch)
    plain_ms = time_cuda(lambda: tiara_gather_window_ref(*args, **kw),
                         scratch)
    host_ms = host_wall_ms(fn)
    ids = call["ids"]
    library_ms = None
    if call["width"] == 1 and not isinstance(call["mask"], torch.Tensor):
        table, bases = call["table"].long(), call["bases"]
        if ids is not None:
            table, bases = table[ids.long()], bases[ids.long()]
        offsets = bases + (table & call["mask"])
        flat = call["pool"].reshape(-1)

        def library():
            return flat.index_select(0, offsets)
        if not torch.equal(library(), out.reshape(-1)):
            raise AssertionError("index_select at the windows' offsets != "
                                 "tiara_gather_window at a serving shape")
        library_ms = time_cuda(library, scratch)
    n = int(call["table"].numel() if ids is None else ids.numel())
    width = int(call["width"])
    elem = call["pool"].element_size()
    # each window element read once and written once; ids (when given),
    # offsets, bases (and per-lane masks) read once
    per_id = (0 if ids is None else 4) + call["table"].element_size() + 8 \
        + (8 if isinstance(call["mask"], torch.Tensor) else 0)
    moved = 2 * n * width * elem + n * per_id
    loads = 2 if ids is None else 3
    return dict(n=n, width=width, pool_words=int(call["pool"].numel()),
                ids=ids is not None,
                per_lane_masks=isinstance(call["mask"], torch.Tensor),
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                host_ms_per_call=host_ms, bytes_moved=moved,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                dependent_loads=loads,
                latency_bound_ms=loads * latency_ns * 1e-6,
                launch_floor_ms=floor_ms)


def _profiled(fn, top: int = 6, names=()):
    """Device time by kernel over one call of ``fn`` from
    ``torch.profiler``: the call's host wall, the device time of every
    kernel it ran (busy share = their sum over the wall), the ``top``
    kernels by time and, for each of ``names``, the device time of the
    kernels whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kern = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kern)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms,
                kernel_launches=sum(n for _, _, n in kern),
                top=[dict(kernel=k[:90], ms=ms, count=n)
                     for k, ms, n in kern[:top]],
                named_ms={n: sum(ms for k, ms, _ in kern if n in k)
                          for n in names})


def profile_step(eng, prompts):
    """One decode step of ``eng`` with every slot busy, under
    ``_profiled``.  The requests are admitted and prefilled by an
    unprofiled step first and drained afterwards."""
    for p in prompts:
        eng.submit(p, max_new=3)
    eng.step()
    prof = _profiled(eng.step)
    eng.run_to_completion()
    return prof


def scout_kernels(cfg, dev, scratch, floor_ms):
    """paged_attention and flash_attention at Scout's exact path shapes in
    bf16 (8 decode slots of 16 pages of 128 tokens out of the engine's 129
    pages; one 2048-token causal prefill), against their plain versions:
    within SCOUT_ATTN_TOL, two calls giving the same bits; times and
    bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.paged_attention import paged_attention
    bf = torch.bfloat16
    qh, kvh, d, page = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.page_size
    maxp = SERVE_MAX_SEQ // page
    pool = SERVE_SLOTS * maxp + 1
    rng = np.random.default_rng(31)
    # each request at its last decode step: prompt + SCOUT_NEW - 1 tokens
    lens = [n + SCOUT_NEW - 1 for n in SCOUT_PLENS]
    q = _randn(rng, (SERVE_SLOTS, qh, d), bf, dev)
    k = _randn(rng, (pool, page, kvh, d), bf, dev)
    v = _randn(rng, (pool, page, kvh, d), bf, dev)
    bt = torch.from_numpy(rng.permutation(SERVE_SLOTS * maxp)
                          .reshape(SERVE_SLOTS, maxp).astype(np.int32)) \
        .to(dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    res = {}
    for kernel, fn, plain, args in (
            ("paged", paged_attention, _paged_plain, (q, k, v, bt, ln)),
            ("flash", flash_attention, flash_attention_ref, tuple(
                _randn(rng, (1, h, SERVE_MAX_SEQ, d), bf, dev)
                for h in (qh, kvh, kvh)))):
        name = f"{kernel}_attention (Scout path shape, bf16)"
        out, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        err = _check_close(name, out, ref, bf, SCOUT_ATTN_TOL)
        share = _limit_share(out, ref, SCOUT_ATTN_TOL)
        _check_same_bits(name, lambda: fn(*args))
        r = dict(max_abs_err=err, limit_share=share,
                 tol=dict(zip(("atol", "rtol"), SCOUT_ATTN_TOL)),
                 out_rms=float(ref.float().pow(2).mean().sqrt().item()),
                 ms=time_cuda(lambda: fn(*args), scratch),
                 plain_ms=time_cuda(lambda: plain(*args), scratch))
        checked = (f"max err {err:.3g} = {share:.3f} of the limit "
                   f"{SCOUT_ATTN_TOL[0]:g} + {SCOUT_ATTN_TOL[1]:g} |plain| "
                   f"(output rms {r['out_rms']:.3g}), two calls same bits")
        if kernel == "paged":
            r["bytes_moved"] = sum(lens) * kvh * d * 2 * 2 \
                + 2 * q.numel() * 2
            r["bound_ms"] = r["bytes_moved"] / HBM_BYTES_PER_S * 1e3
            r["bound_by"], r["library_ms"] = "bytes", None
            r.update(shape=list(q.shape) + list(k.shape), lengths=lens)
            log(f"[scout] paged_attention, q {tuple(q.shape)} pages "
                f"{tuple(k.shape)} tables {tuple(bt.shape)} lengths {lens} "
                f"bf16: {checked}; kernel "
                f"{r['ms'] * 1e3:.2f} us "
                f"({r['bytes_moved'] / r['ms'] / 1e6:.0f} GB/s), plain "
                f"{r['plain_ms'] * 1e3:.2f} us, bound "
                f"{r['bound_ms'] * 1e3:.2f} us (bytes); "
                f"{floor_note(floor_ms)}")
        else:
            fq, fk, fv = args
            r["library_ms"] = time_cuda(lambda: F.scaled_dot_product_attention(
                fq, fk, fv, is_causal=True, enable_gqa=True), scratch)
            s = SERVE_MAX_SEQ
            r["flops"] = 2 * 2 * (s * (s + 1) // 2) * d * qh
            moved = (2 * fq.numel() + 2 * fk.numel()) * 2
            # the function's bound: its bf16 products at the card's bf16
            # tensor-core rate; the design's passes only beside it
            r["bound_ms"] = max(r["flops"] / BF16_FLOPS_PER_S,
                                moved / HBM_BYTES_PER_S) * 1e3
            r["design_floor_ms"] = \
                FLASH_BF16_PASSES * r["flops"] / BF16_FLOPS_PER_S * 1e3
            r["bound_by"] = "operations"
            r["shape"] = list(fq.shape) + list(fk.shape)
            log(f"[scout] flash_attention, q {tuple(fq.shape)} k/v "
                f"{tuple(fk.shape)} causal bf16: {checked}; kernel "
                f"{r['ms'] * 1e3:.1f} us "
                f"({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s), plain "
                f"{r['plain_ms'] * 1e3:.1f} us, sdpa "
                f"{r['library_ms'] * 1e3:.1f} us, bound "
                f"{r['bound_ms'] * 1e3:.1f} us (operations, "
                f"{r['flops'] / 1e9:.2f} GFLOP at the bf16 tensor-core "
                f"rate; the design's {FLASH_BF16_PASSES:g} bf16 passes "
                f"alone take {r['design_floor_ms'] * 1e3:.1f} us); "
                f"{floor_note(floor_ms)}")
        res[kernel] = r
        del out, ref, args
    torch.cuda.empty_cache()
    res["flash"]["registers"] = flash_bf16_registers()
    res["flash"]["limit_share_by_logit_std"] = flash_bf16_logit_shares(dev)
    return res


def scout_logits(cfg, params, dev):
    """Scout's prefill logits with the CUDA attention kernels
    (``attn_impl="cuda"``) against the same model with the plain versions
    on the card, the plain run on the kernel run's expert choices
    (``_Routes``; the positions whose own route differed are counted); see
    SCOUT_LOGIT_TOL.  ``attn_impl="torch"`` takes CPU tensors only, so the
    plain run swaps the attention module's kernel entry point for the
    plain function."""
    from repro_torch.kernels.flash_attention import (flash_attention_chunked,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ops import CHUNKED_FROM
    from repro_torch.models import attention as am
    from repro_torch.models import transformer as tf

    def plain_flash(q, k, v, lengths=None, *, causal=True, impl="auto"):
        fn = flash_attention_chunked if q.shape[2] >= CHUNKED_FROM \
            else flash_attention_ref
        return fn(q, k, v, lengths, causal=causal)

    kcfg = cfg.replace(attn_impl="cuda")
    rng = np.random.default_rng(14)
    res = []
    saved_flash = am.flash_attention
    try:
        for plen in (100, 1536):
            bucket = max(cfg.page_size, 1 << int(np.ceil(np.log2(plen))))
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :plen] = rng.integers(1, cfg.vocab, plen)
            maxp = bucket // cfg.page_size
            got = {}
            with torch.no_grad(), _Routes() as routes:
                for name in ("cuda", "plain"):
                    am.flash_attention = saved_flash if name == "cuda" \
                        else plain_flash
                    if name == "plain":
                        n = len(routes.own)
                        routes.pin = lambda i, own, n=n: routes.own[i - n]
                    out = tf.apply_model(params, kcfg, {
                        "tokens": torch.from_numpy(toks).to(dev),
                        "caches": tf.init_caches(cfg, 1, maxp, device=dev),
                        "block_tables": tf.default_block_tables(
                            cfg, 1, maxp, device=dev),
                        "lengths": torch.tensor([plen], dtype=torch.int32,
                                                device=dev)},
                        mode="prefill")
                    got[name] = out.logits[0, :plen, :cfg.vocab]
            n = len(routes.own) // 2
            flip = torch.zeros(plen, dtype=torch.bool, device=dev)
            for i in range(n):
                flip |= (_route_sets(routes.own[i])
                         != _route_sets(routes.own[n + i])).any(-1)[:plen]
            a, b = got["cuda"], got["plain"]
            diff = (a - b).abs()
            ok = (diff <= SCOUT_LOGIT_TOL * (1 + b.abs())).all(-1)
            n_flip, n_bad = int(flip.sum()), int((~ok).sum())
            r = dict(prompt=plen, bucket=bucket, routes_pinned=n_flip,
                     max_abs_err=float(diff.max()),
                     rel_l2_all=float((a - b).norm() / b.norm()),
                     max_abs_logit=float(b.abs().max()))
            res.append(r)
            log(f"[scout] prefill logits, {plen}-token prompt (bucket "
                f"{bucket}), CUDA kernels vs plain versions on the card, "
                f"the plain run on the kernel run's routes: {n_flip} of "
                f"{plen} positions whose own route differed in some layer; "
                f"max |diff| {r['max_abs_err']:.4g} (tolerance "
                f"{SCOUT_LOGIT_TOL} (1 + |plain|), max |logit| "
                f"{r['max_abs_logit']:.2f}); relative L2 over all "
                f"{r['rel_l2_all']:.3g}")
            if not bool(torch.isfinite(a).all()) or n_bad \
                    or n_flip > SCOUT_MAX_FLIP_SHARE * plen:
                raise AssertionError(
                    f"scout logits, {plen}-token prompt: {n_bad} positions "
                    f"over the tolerance, {n_flip} routes pinned (at most "
                    f"{SCOUT_MAX_FLIP_SHARE:.0%})")
            del got, a, b
    finally:
        am.flash_attention = saved_flash
    torch.cuda.empty_cache()
    return res


def phase_scout(dev, floor_ms):
    """Llama-4 Scout at full width, 4 of 48 layers: the attention kernels
    at its shapes, serving under both resolvers, prefill logits of the
    kernels against the plain versions, and tiara_gather at the serving
    resolvers' own shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import count_params, tree_leaves
    full = get_config(SCOUT_ARCH)
    cfg = full.replace(n_layers=SCOUT_LAYERS)
    moe = cfg.pattern[0].moe
    log(f"[scout] reduction: {cfg.n_layers} of {full.n_layers} layers "
        f"(depth only, every width published), random weights from seed 0")
    t = time.perf_counter()
    params = tf.init_params(cfg, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = count_params(params)
    n_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    log(f"[scout] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, {moe.n_experts} experts "
        f"top-{moe.top_k} of {moe.d_ff_expert} + shared, vocab {cfg.vocab} "
        f"(padded {cfg.vocab_padded}), {cfg.dtype}, page {cfg.page_size}: "
        f"{n_params / 1e9:.3f} G params = {n_bytes / 1e9:.2f} GB on the "
        f"card, drawn there in {time.perf_counter() - t:.1f} s")
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)
    kern = scout_kernels(cfg, dev, scratch, floor_ms)
    del scratch
    torch.cuda.empty_cache()
    rng = np.random.default_rng(13)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, n)))
               for n in rng.permutation(SCOUT_PLENS)]
    runs, gathers, wave = serve_both("scout", cfg, params, prompts,
                                     SCOUT_NEW, dev,
                                     profile_prompts=[p[:100]
                                                      for p in prompts])
    host_loop, loop_call = tiara_on_host_loop(
        "scout", cfg, params, prompts, SCOUT_NEW, dev, runs["tiara"]["out"])
    gathers = dict(gathers or {})
    if loop_call is not None:
        gathers["lockstep host loop"] = loop_call
    logits = scout_logits(cfg, params, dev)
    return dict(n_params=n_params, weight_bytes=n_bytes, kernels=kern,
                runs=runs, host_loop=host_loop, logits=logits), gathers, \
        wave


class _Routes:
    """Records the expert choice (``moe_route``'s ``eidx``) of every MoE
    call in order; with ``pin`` set — ``pin(call index, own eidx) ->
    eidx`` — each call takes the given experts instead, its gates the
    router's own probabilities at them renormalised, as ``moe_route``
    computes them.  In bf16 two correct runs may round a token's second
    and third router logits into another order; pinning one run's choices
    in the other makes the two compute the same function, so their
    logits differ by rounding only.  The calls a pinned run would have
    routed otherwise are counted (``flipped``)."""

    def __init__(self):
        self.own, self.pin = [], None

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._orig = moe, moe.moe_route
        orig = self._orig

        def route(params, xf, spec):
            r = orig(params, xf, spec)
            self.own.append(r.eidx)
            if self.pin is not None:
                e = self.pin(len(self.own) - 1, r.eidx)
                g = r.probs.gather(1, e)
                g = g / g.sum(-1, keepdim=True).clamp_min(1e-9)
                r = moe.Route(r.logits, r.probs, g, e)
            return r
        moe.moe_route = route
        return self

    def __exit__(self, *exc):
        self._moe.moe_route = self._orig


def _attention_shape(kernel, args, kw) -> str:
    """The shape key of one attention call: the kernel, q's and k's
    shapes (paged: a page's), causal, and whether keys are masked past
    ``lengths``; a path's launches and the timed cases meet on it."""
    if kernel == "paged":
        q, kp = args[:2]
        return f"paged q {list(q.shape)} page {list(kp.shape[1:])}"
    q, k = args[:2]
    lengths = args[3] if len(args) > 3 else kw.get("lengths")
    return (f"flash q {list(q.shape)} k {list(k.shape)} causal "
            f"{bool(kw.get('causal', True))} lengths "
            f"{lengths is not None}")


class _AttentionCalls:
    """The model's attention launches by shape: wraps
    ``models/attention.py``'s ``flash_attention`` and ``paged_attention``
    and adds to ``launches[shape key]`` (``_attention_shape``) what each
    call added to its kernel's launch count."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import kernel as fa
        from repro_torch.kernels.paged_attention import kernel as pa
        from repro_torch.models import attention as am
        self.launches = {}
        self._am = am
        self._saved = am.flash_attention, am.paged_attention

        def counted(kernel, mod, fn):
            name = f"{kernel}_attention"

            def call(*args, **kw):
                n0 = mod.COUNTS[name]
                out = fn(*args, **kw)
                key = _attention_shape(kernel, args, kw)
                self.launches[key] = self.launches.get(key, 0) \
                    + mod.COUNTS[name] - n0
                return out
            return call
        am.flash_attention = counted("flash", fa, self._saved[0])
        am.paged_attention = counted("paged", pa, self._saved[1])
        return self

    def __exit__(self, *exc):
        self._am.flash_attention, self._am.paged_attention = self._saved

    def total(self, kernel) -> int:
        return sum(n for k, n in self.launches.items()
                   if k.startswith(kernel))


def _route_sets(eidx):
    """(T, K) expert ids as sorted rows: the same experts in another
    order are the same choice."""
    return eidx.sort(-1).values


def _dropped_real(eidx, cap, real):
    """Assignments past ``cap`` in the reference's flat (token, k) order
    (``models/moe.py``), counted at the real (unpadded) tokens."""
    e = eidx.reshape(-1)
    oh = torch.nn.functional.one_hot(e, int(e.max()) + 1)
    pos = ((oh.cumsum(0) - oh) * oh).sum(-1).reshape(eidx.shape)
    return int(((pos >= cap) & real[:, None]).sum())


def _pad(prompts, width, dev):
    toks = np.zeros((len(prompts), width), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return torch.from_numpy(toks).to(dev)


class _ScanTimer:
    """Device time of the recurrent scans (``models/mamba.py`` and
    ``models/rwkv.py``'s ``_scan``): CUDA events around every call, read
    after the run, so the timing adds no sync inside it."""

    def __enter__(self):
        from repro_torch.models import mamba, rwkv
        self.events, self._saved = [], []
        for mod in (mamba, rwkv):
            fn = mod._scan
            self._saved.append((mod, fn))

            def timed(*args, _fn=fn):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = _fn(*args)
                b.record()
                self.events.append((a, b))
                return out
            mod._scan = timed
        return self

    def __exit__(self, *exc):
        for mod, fn in self._saved:
            mod._scan = fn

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


class _Extra:
    """The inputs of a model's entry points beside the tokens, lengths,
    caches and block tables: none for the decoder-only families.  The
    multimodal families subclass it (``_VisionInputs``,
    ``_AudioInputs``)."""

    def cache_kw(self):
        return {}                   # init_caches keywords

    def prefill(self, s):
        return {}                   # batch keys of a prefill of width s

    def decode(self, i):
        return {}                   # of decode step i (from 0)

    def full(self, s):
        return {}                   # of the full forward over prompt +
        #                             token, width s


NO_EXTRA = _Extra()


def scan_cost(cfg, params, prompts, dev):
    """The scans' share of one more prefill and decode step (outside the
    counted main path): their device time from ``_ScanTimer`` beside the
    wall of the same prefill and step."""
    from repro_torch.models import transformer as tf
    b, plens = len(prompts), [len(p) for p in prompts]
    s = max(plens)
    maxp = -(-(s + 1) // cfg.page_size)
    caches = tf.init_caches(cfg, b, maxp, device=dev)
    bt = tf.default_block_tables(cfg, b, maxp, device=dev)
    lengths = torch.tensor(plens, dtype=torch.int32, device=dev)
    r = {}
    with torch.no_grad():
        for mode, batch in (
                ("prefill", dict(tokens=_pad(prompts, s, dev))),
                ("decode", dict(tokens=torch.tensor(
                    [[p[-1]] for p in prompts], device=dev)))):
            torch.cuda.synchronize()
            with _ScanTimer() as timer:
                t = time.perf_counter()
                tf.apply_model(params, cfg, dict(
                    batch, caches=caches, block_tables=bt, lengths=lengths),
                    mode=mode)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
            r[mode] = dict(wall_ms=wall, scan_ms=timer.ms(),
                           scan_calls=len(timer.events))
    return r


def model_run(tag, cfg, params, prompts, dev, extra=NO_EXTRA):
    """The model's main path as a user drives it: ``tf.init_caches``, the
    prompts right-padded into one ``tf.prefill`` with ``lengths`` (and
    ``extra``'s inputs), then RECURRENT_STEPS greedy ``tf.decode_step``s,
    each ended by ``torch.cuda.synchronize()``.  Fails unless every logit
    is finite, ``flash_attention`` launched once per attention layer in
    the prefill (an encoder-decoder's: its encoder layers, then each
    decoder layer's self and cross attention) and ``paged_attention`` once
    per attention layer in every decode step (plus, in an
    encoder-decoder, one cross-attention ``flash_attention`` per decoder
    layer), and ``selective_scan`` once per Mamba layer and ``wkv6`` once
    per RWKV layer in the prefill and in every decode step, the counts set
    to 0 just before the prefill and read after the last step.  Then one
    more decode step under ``torch.profiler``, and, for a recurrent model,
    the scans' share of one more prefill and step (``scan_cost``)."""
    from repro_torch import kernels
    from repro_torch.models import transformer as tf
    from repro_torch.models.moe import _capacity
    n_attn = sum(s.kind == "attn" for s in cfg.pattern) * cfg.n_repeat
    n_scan = {k: sum(s.kind == kind for s in cfg.pattern) * cfg.n_repeat
              for k, kind in (("selective_scan", "mamba"), ("wkv6", "rwkv"))}
    n_cross = cfg.n_layers if cfg.enc_dec else 0
    want_prefill = n_attn + n_cross + (cfg.n_enc_layers if cfg.enc_dec
                                       else 0)
    b, plens = len(prompts), [len(p) for p in prompts]
    s = max(plens)
    maxp = -(-(s + RECURRENT_STEPS + 1) // cfg.page_size)
    caches = tf.init_caches(cfg, b, maxp, device=dev, **extra.cache_kw())
    bt = tf.default_block_tables(cfg, b, maxp, device=dev)
    lengths = torch.tensor(plens, dtype=torch.int32, device=dev)
    toks = _pad(prompts, s, dev)
    rows = torch.arange(b, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_counts, finite = [], [], []
    with torch.no_grad(), _Routes() as routes, _AttentionCalls() as calls:
        kernels.reset_launch_counts()         # the main path starts here
        t = time.perf_counter()
        out = tf.prefill(params, cfg, dict(
            extra.prefill(s), tokens=toks, caches=caches, block_tables=bt,
            lengths=lengths))
        logits = out.logits[rows, lengths.long() - 1, :cfg.vocab]
        nxt = logits.argmax(-1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        prefill_counts = kernels.launch_counts()
        finite.append(bool(torch.isfinite(out.logits[:, :, :cfg.vocab])
                           .all()))
        n_prefill_routes = len(routes.own)
        del out
        for i in range(RECURRENT_STEPS):
            c0 = kernels.launch_counts()
            t = time.perf_counter()
            out = tf.decode_step(params, cfg, dict(
                extra.decode(i), tokens=nxt[:, None], caches=caches,
                block_tables=bt, lengths=lengths + i))
            nxt = out.logits[:, 0, :cfg.vocab].argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            c1 = kernels.launch_counts()
            step_counts.append({k: c1[k] - c0[k] for k in c1})
            finite.append(bool(torch.isfinite(out.logits).all()))
        counts = kernels.launch_counts()       # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    if not all(finite):
        raise AssertionError(f"{tag}: non-finite logits")
    if prefill_counts["flash_attention"] != want_prefill \
            or prefill_counts["paged_attention"] \
            or any(c["paged_attention"] != n_attn
                   or c["flash_attention"] != n_cross for c in step_counts) \
            or any(c[k] != n for c in [prefill_counts] + step_counts
                   for k, n in n_scan.items()) \
            or counts["tiara_gather"]:
        raise AssertionError(
            f"{tag}: launches prefill {prefill_counts}, decode steps "
            f"{step_counts}; expected flash_attention {want_prefill} per "
            f"prefill, and paged_attention {n_attn} and flash_attention "
            f"{n_cross} per decode step, and {n_scan} in the prefill and "
            f"in every decode step")
    for k in ("flash", "paged"):
        if calls.total(k) != counts[f"{k}_attention"]:
            raise AssertionError(
                f"{tag}: {counts[f'{k}_attention']} {k}_attention launches, "
                f"{calls.total(k)} of them from the model's attention "
                f"calls ({calls.launches})")
    dropped = 0
    moe = [sp.moe for sp in cfg.pattern if sp.moe is not None]
    if moe:
        real = (torch.arange(s, device=dev)[None] < lengths[:, None]) \
            .reshape(-1)
        cap = _capacity(b * s, moe[0])
        dropped = sum(_dropped_real(e, cap, real)
                      for e in routes.own[:n_prefill_routes])
    total_s = prefill_s + sum(step_ms) / 1e3
    tokens = b * (1 + RECURRENT_STEPS)
    with torch.no_grad():
        prof = _profiled(lambda: tf.decode_step(params, cfg, dict(
            extra.decode(RECURRENT_STEPS), tokens=nxt[:, None],
            caches=caches, block_tables=bt,
            lengths=lengths + RECURRENT_STEPS)))
    prof["busy_share_of_median_step"] = \
        prof["device_busy_ms"] / float(np.median(step_ms))
    del caches
    recurrent = any(sp.kind != "attn" for sp in cfg.pattern)
    scans = scan_cost(cfg, params, prompts, dev) if recurrent else None
    run = dict(prompts=plens, prefill_ms=prefill_s * 1e3, step_ms=step_ms,
               tokens=tokens, tokens_per_s=tokens / total_s,
               decode_tokens_per_s=b / (float(np.median(step_ms)) / 1e3),
               prefill_counts=prefill_counts,
               step_counts=step_counts[0], counts=counts,
               attention_launches=calls.launches,
               max_memory_allocated=peak, profile=prof, scans=scans)
    if moe:
        run.update(moe_capacity=cap, dropped_real_assignments=dropped,
                   real_assignments=int(real.sum()) * moe[0].top_k
                   * len(routes.own[:n_prefill_routes]))
    log(f"[{tag}] {b} requests (prompts {min(plens)}-{s} tokens, "
        f"right-padded to {s} in one prefill), {RECURRENT_STEPS} decode "
        f"steps: prefill {prefill_s * 1e3:.1f} ms; decode step ms median "
        f"{np.median(step_ms):.2f}, min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}; {tokens} tokens in {total_s:.2f} s = "
        f"{run['tokens_per_s']:.1f} tokens/s (decode "
        f"{run['decode_tokens_per_s']:.1f} tokens/s); peak "
        f"max_memory_allocated {peak / 1e9:.2f} GB")
    log(f"[{tag}] launches: prefill {prefill_counts}, each decode step "
        f"{step_counts[0]}; by shape over the run: {calls.launches}")
    if moe:
        log(f"[{tag}] MoE at capacity factor {moe[0].capacity_factor} "
            f"(capacity {cap} of {b * s} prefill tokens, padding included): "
            f"{dropped} of {run['real_assignments']} expert assignments of "
            f"real tokens dropped in the prefill's {n_prefill_routes} MoE "
            f"layers")
    if scans is not None:
        log(f"[{tag}] the recurrent scans (one more prefill and decode "
            f"step, CUDA events around each of "
            f"{scans['prefill']['scan_calls']} scan calls): prefill "
            f"{scans['prefill']['scan_ms']:.1f} of "
            f"{scans['prefill']['wall_ms']:.1f} ms, decode step "
            f"{scans['decode']['scan_ms']:.2f} of "
            f"{scans['decode']['wall_ms']:.2f} ms")
    log(f"[{tag}] one profiled decode step: {prof['wall_ms']:.2f} ms wall, "
        f"device busy {prof['device_busy_ms']:.2f} ms "
        f"({prof['busy_share']:.1%}; {prof['busy_share_of_median_step']:.1%} "
        f"of the run's median step) in {prof['kernel_launches']} kernels; "
        f"top: " + "; ".join(f"{r['kernel']} {r['ms']:.3f} ms x{r['count']}"
                             for r in prof["top"]))
    return run


def hold_logits(tag, check, got, want, tol=RECURRENT_LOGIT_TOL):
    """``got`` against ``want`` ((positions, vocab) f32 logits), each
    position's vector within ``tol`` of ``want``'s norm; returns the
    per-position relative errors and the elementwise differences, for the
    record."""
    diff = (got - want).float()
    rel = diff.norm(dim=-1) / want.float().norm(dim=-1)
    r = dict(positions=int(want.shape[0]),
             max_rel_l2=float(rel.max()), mean_rel_l2=float(rel.mean()),
             rel_l2_all=float(diff.norm() / want.float().norm()),
             limit_share=float(rel.max()) / tol,
             max_abs_err=float(diff.abs().max()),
             max_abs_logit=float(want.abs().max()),
             same_argmax=int((got.argmax(-1) == want.argmax(-1)).sum()))
    log(f"[{tag}] {check}: {r['positions']} positions, per-position "
        f"||diff|| / ||logits|| max {r['max_rel_l2']:.4g} = "
        f"{r['limit_share']:.3f} of the limit {tol}, mean "
        f"{r['mean_rel_l2']:.4g} (over all {r['rel_l2_all']:.4g}); max "
        f"|diff| {r['max_abs_err']:.4g} (max |logit| "
        f"{r['max_abs_logit']:.2f}); same argmax {r['same_argmax']}/"
        f"{r['positions']}")
    if not bool(torch.isfinite(got).all()) or r["max_rel_l2"] > tol:
        raise AssertionError(f"{tag} {check}: a position's logits differ "
                             f"by {r['max_rel_l2']:.4g} of their norm")
    return r


def check_full_forward(tag, cfg, params, prompts, dev, extra=NO_EXTRA):
    """Check (a), the chip's analogue of
    ``test_prefill_decode_matches_full_forward``: prefill (right-padded,
    ``lengths``) then one decode step of each prompt's greedy token; the
    decode logits equal the full forward (``mode="train"``) over prompt
    plus token at that token's position (``hold_logits``).  In a MoE
    model the full forward
    takes the prefill's and the decode step's expert choices (see
    ``_Routes``); the positions it would have routed otherwise are
    counted."""
    from repro_torch.models import transformer as tf
    b, plens = len(prompts), [len(p) for p in prompts]
    s = max(plens)
    maxp = -(-(s + 1) // cfg.page_size)
    caches = tf.init_caches(cfg, b, maxp, device=dev, **extra.cache_kw())
    bt = tf.default_block_tables(cfg, b, maxp, device=dev)
    lengths = torch.tensor(plens, dtype=torch.int32, device=dev)
    toks = _pad(prompts, s + 1, dev)
    rows = torch.arange(b, device=dev)
    with torch.no_grad(), _Routes() as routes:
        out = tf.prefill(params, cfg, dict(
            extra.prefill(s), tokens=toks[:, :s], caches=caches,
            block_tables=bt, lengths=lengths))
        nxt = out.logits[rows, lengths.long() - 1, :cfg.vocab].argmax(-1)
        del out
        n_moe = len(routes.own)               # MoE calls per forward
        dec = tf.decode_step(params, cfg, dict(
            extra.decode(0), tokens=nxt[:, None], caches=caches,
            block_tables=bt, lengths=lengths)).logits[:, 0, :cfg.vocab]
        # the full forward's expert choices: the prefill's at the prompt,
        # the decode step's at the token (its own past the token)
        pinned = []
        for i in range(n_moe):
            e = routes.own[i].reshape(b, s, -1)
            e = torch.cat([e, e[:, -1:]], dim=1)
            e[rows, lengths.long()] = routes.own[n_moe + i]
            pinned.append(e.reshape(b * (s + 1), -1))
        real = _real_mask(b, s + 1, lengths + 1, dev)
        routes.pin = lambda i, own: torch.where(
            real[:, None], pinned[i - 2 * n_moe], own)
        toks[rows, lengths.long()] = nxt
        full = tf.apply_model(params, cfg, dict(extra.full(s + 1),
                                                tokens=toks),
                              mode="train").logits[rows, lengths.long(),
                                                    :cfg.vocab]
        flipped = sum(
            int(((_route_sets(routes.own[2 * n_moe + i])
                  != _route_sets(pinned[i])).any(-1) & real).sum())
            for i in range(n_moe))
    del caches
    r = hold_logits(tag, "check (a), decode logits after prefill vs the "
                    "full forward over prompt + token", dec, full)
    r["routes_pinned"] = flipped
    if routes.own:
        log(f"[{tag}] check (a): {flipped} token-layer routes of the full "
            f"forward pinned to the prefill's and decode step's where its "
            f"own differed")
    return r


def _real_mask(b, s, lengths, dev):
    """(b * s,) True at the positions before each row's length."""
    return (torch.arange(s, device=dev)[None] < lengths.to(dev)[:, None]) \
        .reshape(-1)


def kernel_logits(tag, cfg, params, prompts, dev, extra=NO_EXTRA,
                  tol=RECURRENT_LOGIT_TOL):
    """Check (b): the prefill logits with the CUDA kernels (attention and
    the recurrent scans) against the same model with the plain versions,
    on the card, at every real position of the 8 right-padded prompts,
    within ``tol`` (``hold_logits``); the plain run takes the kernel run's
    expert choices (``_Routes``; the positions whose own route differed
    are counted), so every position is held."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.selective_scan import selective_scan_plain
    from repro_torch.kernels.wkv6 import wkv6_plain
    from repro_torch.models import attention as am
    from repro_torch.models import mamba, rwkv
    from repro_torch.models import transformer as tf

    def plain_flash(q, k, v, lengths=None, *, causal=True, impl="auto"):
        return flash_attention_ref(q, k, v, lengths, causal=causal)

    b, plens = len(prompts), [len(p) for p in prompts]
    s = max(plens)
    maxp = -(-s // cfg.page_size)
    lengths = torch.tensor(plens, dtype=torch.int32, device=dev)
    real = _real_mask(b, s, lengths, dev)
    kcfg = cfg.replace(attn_impl="cuda")
    saved = am.flash_attention, mamba._scan, rwkv._scan
    route = {"cuda": saved,
             "plain": (plain_flash, selective_scan_plain, wkv6_plain)}
    got = {}
    try:
        with torch.no_grad(), _Routes() as routes:
            for i, name in enumerate(("cuda", "plain")):
                am.flash_attention, mamba._scan, rwkv._scan = route[name]
                if i == 1:
                    n = len(routes.own)
                    routes.pin = lambda i, own: routes.own[i - n]
                got[name] = tf.prefill(params, kcfg, dict(
                    extra.prefill(s), tokens=_pad(prompts, s, dev),
                    caches=tf.init_caches(cfg, b, maxp, device=dev,
                                          **extra.cache_kw()),
                    block_tables=tf.default_block_tables(cfg, b, maxp,
                                                         device=dev),
                    lengths=lengths)).logits[..., :cfg.vocab] \
                    .reshape(b * s, -1)[real]
            n = len(routes.own) // 2
            flipped = torch.zeros_like(real)
            for i in range(n):
                flipped |= (_route_sets(routes.own[i])
                            != _route_sets(routes.own[n + i])).any(-1)
            n_flip = int((flipped & real).sum())
    finally:
        am.flash_attention, mamba._scan, rwkv._scan = saved
    r = hold_logits(tag, "check (b), prefill logits with the CUDA "
                    f"kernels vs the plain versions on the card, "
                    f"{cfg.dtype}", got["cuda"], got["plain"], tol)
    r["routes_pinned"] = n_flip
    if n:
        log(f"[{tag}] check (b): {n_flip} positions whose own route in the "
            f"plain run differed in some layer (pinned to the kernel "
            f"run's)")
    del got
    torch.cuda.empty_cache()
    return r


def attention_cases(tag, cases, dev, scratch, floor_ms):
    """Each ``(label, kernel, args, kw)`` in ``cases`` — paged (q, pages,
    tables, lengths) or flash (q, k, v) with ``kw`` its ``lengths`` and
    ``causal`` — launched on the card against its plain version within
    SCOUT_ATTN_TOL (two bf16 ulps: kernel and plain version compute in
    f32 and round once), two calls giving the same bits; then its time,
    the plain version's, its bound over this data (the live keys only)
    and, for flash, PyTorch's ``scaled_dot_product_attention`` on the
    same inputs (a boolean mask when keys are masked past ``lengths``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.paged_attention import paged_attention
    bf = torch.bfloat16
    res = {}
    for label, kernel, args, kw in cases:
        name = f"{kernel}_attention ({tag}, {label}, bf16)"
        if kernel == "paged":
            q, kp, _, _, ln = args
            b, qh, d = q.shape
            kvh = kp.shape[2]

            def fn(args=args):
                return paged_attention(*args)

            def plain(args=args):
                return _paged_plain(*args)
            live = int(ln.sum())
            r = dict(shape=list(q.shape) + list(kp.shape),
                     lengths=ln.tolist(), library_ms=None)
            moved = live * kvh * d * 2 * 2 + 2 * q.numel() * 2
            flops = 4 * live * d * qh
        else:
            q, k, v = args
            ln, causal = kw.get("lengths"), kw["causal"]
            b, qh, sq, d = q.shape
            kvh, sk = k.shape[1], k.shape[2]

            def fn(args=args, kw=kw):
                return flash_attention(*args, **kw)

            def plain(args=args, kw=kw):
                return flash_attention_ref(*args, **kw)
            mask = None
            if ln is not None:
                mask = (torch.arange(sk, device=dev)[None]
                        < ln[:, None])[:, None, None, :]
            keys = b * sk if ln is None else int(ln.clamp(max=sk).sum())
            pairs = b * sq * (sq + 1) // 2 if causal else sq * keys
            flops = 4 * pairs * d * qh
            moved = 2 * q.numel() * 2 + keys * kvh * d * 2 * 2
            r = dict(shape=list(q.shape) + list(k.shape), causal=causal,
                     lengths=None if ln is None else ln.tolist())

            def sdpa(q=q, k=k, v=v, mask=mask, causal=causal):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=causal,
                    enable_gqa=q.shape[1] != k.shape[1])
            r["library_ms"] = time_cuda(sdpa, scratch)
        r["key"] = _attention_shape(kernel, args, kw)
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        err = _check_close(name, out, ref, bf, SCOUT_ATTN_TOL)
        share = _limit_share(out, ref, SCOUT_ATTN_TOL)
        _check_same_bits(name, fn)
        del out, ref
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, moved / HBM_BYTES_PER_S
        r.update(max_abs_err=err, limit_share=share,
                 ms=time_cuda(fn, scratch), plain_ms=time_cuda(plain, scratch),
                 flops=flops, bytes_moved=moved,
                 bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops > t_bytes else "bytes")
        if kernel == "flash":
            r["design_floor_ms"] = FLASH_BF16_PASSES * t_ops * 1e3
        lib = "" if r["library_ms"] is None else \
            f", sdpa {r['library_ms'] * 1e3:.2f} us"
        log(f"[{tag}] {kernel}_attention, {label}: shapes {r['shape']}"
            + ("" if kernel == "paged" else f", causal {r['causal']}")
            + (f", lengths {r['lengths']}" if r["lengths"] else "")
            + f": max err {err:.3g} = {share:.3f} of the limit, two calls "
            f"same bits; kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us{lib}, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}: "
            f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB)"
            + ("" if kernel == "paged" else f", the design's floor "
               f"{r['design_floor_ms'] * 1e3:.2f} us")
            + f"; {floor_note(floor_ms)}")
        res[label] = r
    torch.cuda.empty_cache()
    return res


def _paged_case(cfg, lens, dev, rng):
    """paged_attention's inputs at the last decode step of requests with
    ``lens`` live tokens: q (b, QH, D) and a pool of pages of the model's
    page size in a shuffled identity table, bf16."""
    b, page = len(lens), cfg.page_size
    maxp = -(-(max(lens) + 1) // page)
    shape = (b * maxp, page, cfg.n_kv_heads, cfg.head_dim)
    return (_randn(rng, (b, cfg.n_heads, cfg.head_dim), torch.bfloat16, dev),
            _randn(rng, shape, torch.bfloat16, dev),
            _randn(rng, shape, torch.bfloat16, dev),
            torch.from_numpy(rng.permutation(b * maxp).reshape(b, maxp)
                             .astype(np.int32)).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _flash_case(cfg, b, sq, sk, dev, rng):
    """flash_attention's q (b, QH, sq, D) and k/v (b, KVH, sk, D), bf16."""
    return tuple(_randn(rng, (b, h, n, cfg.head_dim), torch.bfloat16, dev)
                 for h, n in ((cfg.n_heads, sq), (cfg.n_kv_heads, sk),
                              (cfg.n_kv_heads, sk)))


def jamba_kernels(cfg, plens, dev, scratch, floor_ms):
    """paged_attention and flash_attention at Jamba's path shapes in bf16
    (the last decode step of the 8 requests over pages of 128; the
    8-request causal prefill at the longest prompt) through
    ``attention_cases``."""
    rng = np.random.default_rng(32)
    b, s = len(plens), max(plens)
    return attention_cases("jamba", [
        ("paged", "paged", _paged_case(
            cfg, [n + RECURRENT_STEPS for n in plens], dev, rng), {}),
        ("flash", "flash", _flash_case(cfg, b, s, s, dev, rng),
         {"causal": True})], dev, scratch, floor_ms)


def _scan_inputs(kind, cfg, plens, s, dev, seed):
    """The arguments of ``kind``'s kernel (``selective_scan`` or ``wkv6``)
    at the model's path shape, f32 on the card, drawn there from ``seed``:
    the prefill of the right-padded prompts of ``plens`` (``s`` the
    longest, ``valid`` from their lengths) or one decode step (``s`` = 1,
    no mask).  Values in the path's ranges: dt > 0, A < 0, decays in (0,
    1)."""
    g = torch.Generator(dev).manual_seed(seed)
    b = len(plens)

    def u(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo
    valid = None if s == 1 else \
        torch.arange(s, device=dev)[None] < torch.tensor(plens,
                                                         device=dev)[:, None]
    if kind == "selective_scan":
        d, n = cfg.mamba.dims(cfg.d_model)[0], cfg.mamba.d_state
        return (u(b, d, n), u(b, s, d, lo=0.0, hi=2.0), u(b, s, d),
                u(b, s, n), u(b, s, n), -u(d, n, lo=0.1, hi=3.0), valid)
    hs = cfg.rwkv.head_size
    nh = cfg.d_model // hs
    return (u(b, nh, hs, hs), u(b, s, nh, hs), u(b, s, nh, hs),
            u(b, s, nh, hs), u(b, s, nh, hs, lo=0.3, hi=0.999), u(nh, hs),
            valid)


def scan_work(kind, args):
    """(bytes moved, f32 flops, exps) of one call of ``kind``'s scan on
    ``args``: what this data needs, each input read once and each output
    written once.  A padded step updates nothing, so only the valid steps
    need the update's inputs (the selective scan's dt, x and B, wkv6's w)
    and operations; every step writes y, so every step needs the inputs y
    reads (C; r, k and v, since a padded step's y still adds u k v)."""
    valid = args[-1]
    if kind == "selective_scan":
        h, dt = args[:2]
        b, s, d = dt.shape
        n = h.shape[-1]
        live = b * s if valid is None else int(valid.sum())
        moved = 4 * (2 * h.numel() + b * s * d + 2 * live * d
                     + (b * s + live) * n + d * n) \
            + (0 if valid is None else valid.numel())
        return moved, live * d * (1 + 4 * n) + b * s * d * 2 * n, \
            live * d * n
    state, rh = args[:2]
    b, s, nh, hs = rh.shape
    live = b * s if valid is None else int(valid.sum())
    moved = 4 * (2 * state.numel() + 4 * rh.numel() + live * nh * hs
                 + nh * hs) + (0 if valid is None else valid.numel())
    return moved, b * s * nh * hs * (4 * hs + 1) + live * nh * hs * hs * 3, 0


def scan_cases(tag, kind, cfg, plens, dev, scratch, floor_ms):
    """``kind``'s kernel (``selective_scan`` or ``wkv6``) at the model's
    prefill shape (the 8 right-padded prompts, ``valid`` from their
    lengths) and decode shape (S = 1) against its plain version on the
    card within SCAN_TOL, two calls giving the same bits; then its time
    (``time_cuda``), the plain version's time, the host wall of a decode
    call, and its bound: the larger of the bytes at 3.35 TB/s, the f32
    flops at 67 TFLOP/s and, for the selective scan, its exps at the SFU
    rate (SFU_EXPS_PER_S).  No single PyTorch call computes either
    recurrence (``library_ms`` None)."""
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_plain)
    from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
    kernel, plain = (selective_scan, selective_scan_plain) \
        if kind == "selective_scan" else (wkv6, wkv6_plain)
    res = {}
    for i, (label, s) in enumerate((("prefill", max(plens)), ("decode", 1))):
        args = _scan_inputs(kind, cfg, plens, s, dev, 40 + i)
        name = f"{kind} ({tag}, {label})"

        def fn(args=args):
            return kernel(*args)

        def ref(args=args):
            return plain(*args)
        out, want = fn(), ref()
        torch.cuda.synchronize()
        err = max(_check_close(name, o, w, torch.float32, SCAN_TOL)
                  for o, w in zip(out, want))
        share = max(_limit_share(o, w, SCAN_TOL) for o, w in zip(out, want))
        again = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, o) for a, o in zip(again, out)):
            raise AssertionError(f"{name}: two calls differ")
        del out, want, again
        moved, flops, exps = scan_work(kind, args)
        t_bytes, t_flops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        t_ops = max(t_flops, exps / SFU_EXPS_PER_S)
        r = dict(shape=[list(a.shape) for a in args[:6]],
                 valid=args[-1] is not None, max_abs_err=err,
                 limit_share=share, ms=time_cuda(fn, scratch),
                 plain_ms=time_cuda(ref, scratch, reps=5 if s > 1 else 20),
                 bytes_moved=moved, flops=flops, exps=exps,
                 bound_ms=max(t_bytes, t_ops) * 1e3,
                 bound_by="operations" if t_ops > t_bytes else "bytes",
                 library_ms=None)
        if s == 1:
            r["host_ms_per_call"] = host_wall_ms(fn, reps=200, rounds=3)
        log(f"[{tag}] {name}: shapes {r['shape']}"
            + (f", lengths {list(plens)}" if r["valid"] else "")
            + f": max err {err:.3g} = {share:.3f} of the limit {SCAN_TOL}, "
            f"two calls same bits; kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}: "
            f"{moved / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP f32, "
            f"{exps / 1e9:.3f} G exps)"
            + (f", host wall {r['host_ms_per_call'] * 1e3:.2f} us a call"
               if s == 1 else "")
            + f"; {floor_note(floor_ms)}; library none")
        res[label] = r
        del args
    torch.cuda.empty_cache()
    return res


def _draw_model(tag, cfg, full, dev):
    """Random bf16 weights from seed 0, drawn on the card."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import count_params, tree_leaves
    t = time.perf_counter()
    params = tf.init_params(cfg, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = count_params(params)
    n_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}: "
        f"{n_params / 1e9:.3f} G params = {n_bytes / 1e9:.2f} GB on the "
        f"card, drawn there in {time.perf_counter() - t:.1f} s")
    return params, n_params, n_bytes


def _recurrent_prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, cfg.vocab, n)))
            for n in rng.permutation(RECURRENT_PLENS)]


def phase_jamba(dev, floor_ms):
    """Jamba v0.1 at its published widths, one period (8 of 32 layers):
    the attention kernels at its shapes, the main path (prefill + decode),
    check (a) and check (b)."""
    from repro_torch.configs import get_config
    full = get_config(JAMBA_ARCH)
    cfg = full.replace(n_layers=JAMBA_LAYERS)
    moe = cfg.pattern[1].moe
    log(f"[jamba] reduction: {cfg.n_layers} of {full.n_layers} layers (one "
        f"period: 1 attention + 7 Mamba layers, MoE on 4; depth only, every "
        f"width published: {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, no RoPE, Mamba d_inner "
        f"{cfg.mamba.dims(cfg.d_model)[0]} d_state {cfg.mamba.d_state} "
        f"d_conv {cfg.mamba.d_conv}, {moe.n_experts} experts top-"
        f"{moe.top_k} of {moe.d_ff_expert} at capacity factor "
        f"{moe.capacity_factor}, page {cfg.page_size})")
    params, n_params, n_bytes = _draw_model("jamba", cfg, full, dev)
    prompts = _recurrent_prompts(cfg, 15)
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)
    kern = jamba_kernels(cfg, [len(p) for p in prompts], dev, scratch,
                         floor_ms)
    scans = scan_cases("jamba", "selective_scan", cfg,
                       [len(p) for p in prompts], dev, scratch, floor_ms)
    del scratch
    torch.cuda.empty_cache()
    run = model_run("jamba", cfg, params, prompts, dev)
    torch.cuda.empty_cache()
    check_cfg = cfg.replace(pattern=tuple(
        sp if sp.moe is None else dataclasses.replace(
            sp, moe=dataclasses.replace(sp.moe,
                                        capacity_factor=JAMBA_CHECK_CF))
        for sp in cfg.pattern))
    full_fwd = check_full_forward("jamba", check_cfg, params, prompts, dev)
    torch.cuda.empty_cache()
    logits = kernel_logits("jamba", cfg, params, prompts, dev)
    return dict(n_params=n_params, weight_bytes=n_bytes, kernels=kern,
                scans=scans, run=run, check_a=full_fwd, check_b=logits)


def phase_rwkv(dev, floor_ms):
    """RWKV-6 1.6B whole: ``wkv6`` at its path shapes, the main path (one
    ``wkv6`` launch per layer in the prefill and in every decode step, no
    attention kernel: ``model_run`` checks both), check (a), and check (b)
    on the same weights in f32 (see RWKV_F32_LOGIT_TOL)."""
    from repro_torch.configs import get_config
    cfg = get_config(RWKV_ARCH)
    log(f"[rwkv] {cfg.name} whole: {cfg.n_layers} layers, "
        f"{cfg.d_model // cfg.rwkv.head_size} heads of "
        f"{cfg.rwkv.head_size}, decay LoRA {cfg.rwkv.decay_lora}, d_ff "
        f"{cfg.d_ff}, {cfg.norm}; no reduction")
    params, n_params, n_bytes = _draw_model("rwkv", cfg, cfg, dev)
    prompts = _recurrent_prompts(cfg, 16)
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)
    scans = scan_cases("rwkv", "wkv6", cfg, [len(p) for p in prompts], dev,
                       scratch, floor_ms)
    del scratch
    torch.cuda.empty_cache()
    run = model_run("rwkv", cfg, params, prompts, dev)
    torch.cuda.empty_cache()
    full_fwd = check_full_forward("rwkv", cfg, params, prompts, dev)
    torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    params, _, _ = _draw_model("rwkv", f32, cfg, dev)
    logits = kernel_logits("rwkv", f32, params, prompts, dev,
                           tol=RWKV_F32_LOGIT_TOL)
    return dict(n_params=n_params, weight_bytes=n_bytes, scans=scans,
                run=run, check_a=full_fwd, check_b=logits)


class _VisionInputs(_Extra):
    """Qwen2-VL's inputs beside the tokens: each request's image of
    QWEN_GRID patches, its first tokens, as precomputed embeddings (the
    vision stub's ``embeds``, random from a seed, 0 on text), and the
    M-RoPE ids by the Qwen2-VL rule (``get_rope_index`` in the public
    Qwen2-VL code): (t, h, w) = (0, row, col) on the image, then the text
    from the largest id + 1 on all three streams; decode continues each
    request from its own next id."""

    def __init__(self, cfg, plens, dev, seed):
        gh, gw = QWEN_GRID
        nv = gh * gw
        b, s = len(plens), max(plens)
        width = s + RECURRENT_STEPS + 2
        i = np.arange(nv)
        pos = np.empty((3, b, width), np.int64)
        pos[:, :, :nv] = np.stack([0 * i, i // gw, i % gw])[:, None]
        pos[:, :, nv:] = max(gh, gw) + np.arange(width - nv)
        self.pos = torch.from_numpy(pos).to(dev)
        self.lengths = torch.tensor(plens, device=dev)
        self.rows = torch.arange(b, device=dev)
        gen = torch.Generator(dev).manual_seed(seed)
        self.emb = torch.zeros((b, s, cfg.d_model), dtype=torch.bfloat16,
                               device=dev)
        self.emb[:, :nv] = torch.randn((b, nv, cfg.d_model), generator=gen,
                                       device=dev).to(torch.bfloat16)

    def prefill(self, s):
        return {"positions3": self.pos[:, :, :s], "embeds": self.emb[:, :s]}

    def decode(self, i):
        return {"positions3": self.pos[:, self.rows, self.lengths + i]
                [:, :, None]}

    def full(self, s):
        e = self.emb.new_zeros(self.emb.shape[:1] + (s,)
                               + self.emb.shape[2:])
        e[:, :self.emb.shape[1]] = self.emb
        return {"positions3": self.pos[:, :, :s], "embeds": e}


class _AudioInputs(_Extra):
    """SeamlessM4T's inputs beside the tokens: the audio stub's encoder
    frames ``enc_embeds`` (b, SEAMLESS_S_ENC, d_model), random from a
    seed, right-padded to ragged ``enc_lengths``; the decoder's caches hold
    SEAMLESS_S_ENC positions of cross KV."""

    def __init__(self, cfg, b, dev, seed):
        gen = torch.Generator(dev).manual_seed(seed)
        self.enc = torch.randn((b, SEAMLESS_S_ENC, cfg.d_model),
                               generator=gen, device=dev) \
            .to(torch.bfloat16)
        rng = np.random.default_rng(seed)
        self.enc_lengths = torch.tensor(rng.permutation(SEAMLESS_ENC_LENS),
                                        dtype=torch.int32, device=dev)

    def cache_kw(self):
        return {"cross_len": SEAMLESS_S_ENC}

    def prefill(self, s):
        return {"enc_embeds": self.enc, "enc_lengths": self.enc_lengths}

    def decode(self, i):
        return {"enc_lengths": self.enc_lengths}

    def full(self, s):
        return self.prefill(s)


def multimodal_phase(tag, cfg, prompts, extra, kernel_cases, dev,
                     n_params_published, floor_ms):
    """One multimodal model whole at its published widths: its weights
    drawn on the card (their count held to the published one), the
    attention kernels at its path shapes (``attention_cases``), the main
    path (``model_run``), check (a) (``check_full_forward``) and check
    (b) (``kernel_logits``)."""
    params, n_params, n_bytes = _draw_model(tag, cfg, cfg, dev)
    if n_params != n_params_published:
        raise AssertionError(f"{tag}: {n_params} parameters, expected "
                             f"{n_params_published}")
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)
    kern = attention_cases(tag, kernel_cases, dev, scratch, floor_ms)
    del scratch
    torch.cuda.empty_cache()
    run = model_run(tag, cfg, params, prompts, dev, extra)
    torch.cuda.empty_cache()
    full_fwd = check_full_forward(tag, cfg, params, prompts, dev, extra)
    torch.cuda.empty_cache()
    logits = kernel_logits(tag, cfg, params, prompts, dev, extra)
    return dict(n_params=n_params, weight_bytes=n_bytes, kernels=kern,
                run=run, check_a=full_fwd, check_b=logits)


def phase_qwen(dev, floor_ms):
    """Qwen2-VL-7B whole: 8 requests, each an image prefix of 256 vision
    tokens (the embeds stub) then text, prompts of 300..1024 tokens, with
    M-RoPE over distinct t/h/w streams (``_VisionInputs``)."""
    from repro_torch.configs import get_config
    cfg = get_config(QWEN_ARCH)
    log(f"[qwen] {cfg.name} whole: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, M-RoPE "
        f"sections {cfg.mrope_sections} theta {cfg.rope_theta:g}, page "
        f"{cfg.page_size}; no reduction; images of {QWEN_GRID[0]} x "
        f"{QWEN_GRID[1]} patches")
    rng = np.random.default_rng(17)
    nv = QWEN_GRID[0] * QWEN_GRID[1]
    prompts = [[QWEN_IMAGE_PAD] * nv
               + list(map(int, rng.integers(1, cfg.vocab, n - nv)))
               for n in rng.permutation(QWEN_PLENS)]
    plens = [len(p) for p in prompts]
    extra = _VisionInputs(cfg, plens, dev, 17)
    s, b = max(plens), len(plens)
    rng = np.random.default_rng(33)
    cases = [
        ("decode self attention", "paged",
         _paged_case(cfg, [n + RECURRENT_STEPS for n in plens], dev, rng),
         {}),
        ("prefill self attention", "flash",
         _flash_case(cfg, b, s, s, dev, rng), {"causal": True})]
    return multimodal_phase("qwen", cfg, prompts, extra, cases, dev,
                            QWEN_PARAMS, floor_ms)


def phase_seamless(dev, floor_ms):
    """SeamlessM4T-medium whole: encoder frames of SEAMLESS_S_ENC with
    ragged ``enc_lengths`` (``_AudioInputs``), decoder prompts of 16..1024
    tokens."""
    from repro_torch.configs import get_config
    cfg = get_config(SEAMLESS_ARCH)
    log(f"[seamless] {cfg.name} whole: {cfg.n_enc_layers} encoder and "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff} {cfg.pattern[0].mlp}, {cfg.norm}, vocab {cfg.vocab} "
        f"(padded {cfg.vocab_padded}), page {cfg.page_size}; no "
        f"reduction; {SEAMLESS_S_ENC} encoder frames, enc_lengths "
        f"{min(SEAMLESS_ENC_LENS)}..{max(SEAMLESS_ENC_LENS)}")
    prompts = _recurrent_prompts(cfg, 18)
    plens = [len(p) for p in prompts]
    s, b = max(plens), len(plens)
    extra = _AudioInputs(cfg, b, dev, 18)
    enc_len = extra.enc_lengths
    with_0 = enc_len.clone()
    with_0[1] = 0
    rng = np.random.default_rng(34)
    cross = _flash_case(cfg, b, s, SEAMLESS_S_ENC, dev, rng)
    cross_1 = (cross[0][:, :, :1].contiguous(),) + cross[1:]
    cases = [
        ("decode self attention", "paged",
         _paged_case(cfg, [n + RECURRENT_STEPS for n in plens], dev, rng),
         {}),
        ("encoder self attention", "flash",
         _flash_case(cfg, b, SEAMLESS_S_ENC, SEAMLESS_S_ENC, dev, rng),
         {"causal": False}),
        ("prefill self attention", "flash",
         _flash_case(cfg, b, s, s, dev, rng), {"causal": True}),
        ("prefill cross attention", "flash", cross,
         {"causal": False, "lengths": enc_len}),
        ("decode cross attention", "flash", cross_1,
         {"causal": False, "lengths": enc_len}),
        ("decode cross attention, an encoder length of 0", "flash", cross_1,
         {"causal": False, "lengths": with_0})]
    return multimodal_phase("seamless", cfg, prompts, extra, cases, dev,
                            SEAMLESS_PARAMS, floor_ms)


def multimodal_rows(qwen, seamless, paged, flash):
    """The kernels line's rows of the multimodal paths' shapes: one for
    each shape that a path's main run launched, with the launches counted
    there (``_AttentionCalls``) and the times of the timed case of the
    same shape.  Fails if a path launched a shape that no case timed."""
    rows = []
    for tag, ph in (("qwen", qwen), ("seamless", seamless)):
        cases = {}
        for label, r in ph["kernels"].items():
            cases.setdefault(r["key"], (label, r))
        for key, n in ph["run"]["attention_launches"].items():
            if key not in cases:
                raise AssertionError(f"{tag}: the main path launched {key}, "
                                     f"which no timed case covers")
            label, r = cases[key]
            base = paged if key.startswith("paged") else flash
            rows.append(dict(
                name=base["name"], route=base["route"],
                source=base["source"] if base is paged else
                FLASH_BF16_SOURCE, replaces=base["replaces"],
                launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                shape=f"{tag} {label}: {key}"))
    return rows


def _live_pairs(b, sq, sk, causal, lengths) -> int:
    """(query, key) pairs with a live key over the batch, for one head."""
    total = 0
    for i in range(b):
        klen = sk if lengths is None else min(max(int(lengths[i]), 0), sk)
        total += int(np.minimum(np.arange(sq) + 1, klen).sum()) if causal \
            else sq * klen
    return total


def _attention_mask(sq, sk, causal, ln, dev):
    """SDPA's arguments for the kernel's masking: ``(attn_mask,
    is_causal)``, a boolean mask (B, 1, Sq, Sk) when keys are masked past
    ``ln``."""
    if ln is None:
        return None, causal
    keep = (torch.arange(sk, device=dev)[None] < ln[:, None])[:, None, None]
    if causal:
        keep = keep & torch.ones(sq, sk, dtype=torch.bool,
                                 device=dev).tril()
    return keep, False


def _lse_errors(name, got, want):
    """The forward's ``lse`` against the plain log-sum-exp: +inf on the
    same rows (no live key), the rest within LSE_TOL; returns the largest
    error and its share of the limit."""
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError(f"{name}: lse is +inf on other rows than the "
                             f"plain version's")
    live = torch.isfinite(want)
    g, w = got[live].double(), want[live].double()
    err = (g - w).abs()
    limit = LSE_TOL[0] + LSE_TOL[1] * w.abs()
    share = float((err / limit).max()) if err.numel() else 0.0
    if share > 1:
        raise AssertionError(f"{name}: lse {float(err.max()):.3g} from the "
                             f"plain version, over LSE_TOL {LSE_TOL}")
    return (float(err.max()) if err.numel() else 0.0), share


def _bwd_inputs(dev, shape, lens, dtype):
    """A BWD_CASES case's q, k, v, dO and lengths on the card, from a seed
    of its shape."""
    b, qh, kvh, sq, sk, d = shape
    rng = np.random.default_rng(sq + sk + d + qh)
    q, do = (_randn(rng, (b, qh, sq, d), dtype, dev) for _ in range(2))
    k, v = (_randn(rng, (b, kvh, sk, d), dtype, dev) for _ in range(2))
    ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    return q, k, v, do, ln


def bwd_cases(dev, scratch, floor_ms):
    """flash_attention's forward and backward kernels at each of
    BWD_CASES on the card.  The forward, launched with ``lse`` as
    training launches it: its output against ``flash_attention_ref``
    (f32 within ATTN_TOL, bf16 within SCOUT_ATTN_TOL), the same bits
    without ``lse``, and ``lse`` against ``flash_attention_lse_ref``
    (LSE_TOL).  The backward against ``flash_attention_bwd_ref`` fed the
    plain lse and the kernel's output (f32 within BWD_F32_TOL of the
    largest gradient, bf16 within SCOUT_ATTN_TOL), two calls giving the
    same bits: the plain lse so that a wrong lse cannot pass on both
    sides, the kernel's output because the backward's rowsum(dO o)
    carries o's bf16 rounding, and the plain forward's output, an ulp
    away, moves the gradients by more than two ulps (0.0039 at Qwen2-VL's
    dq).
    Then each one's time, its plain version's, PyTorch's SDPA on the same
    inputs (the backward's: forward and backward less the forward) and
    the bound over this data: the forward's two products and the
    backward's five over the live pairs at the inputs' type's peak (f32:
    three TF32 passes on the tensor cores, the forward's route), against
    each operand read and each result written once."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_bwd_ref,
        flash_attention_kernel, flash_attention_lse_ref, flash_attention_ref)
    res = {}
    for label, (b, qh, kvh, sq, sk, d), causal, lens, dtype in BWD_CASES:
        name = f"flash_attention backward ({label}, {dtype})"
        fname = f"flash_attention forward ({label}, {dtype})"
        q, k, v, do, ln = _bwd_inputs(dev, (b, qh, kvh, sq, sk, d), lens,
                                      dtype)
        key = _attention_shape("flash", (q, k), dict(causal=causal,
                                                      lengths=ln))
        out0 = flash_attention_kernel(q, k, v, ln, causal=causal)
        out, lse = flash_attention_kernel(q, k, v, ln, causal=causal,
                                          return_lse=True)
        torch.cuda.synchronize()
        if not torch.equal(out0, out):
            raise AssertionError(f"{name}: the forward's output changed "
                                 f"when it also wrote lse")
        del out0
        out_ref = flash_attention_ref(q, k, v, ln, causal=causal)
        lse_ref = flash_attention_lse_ref(q, k, ln, causal=causal)
        ftol = SCOUT_ATTN_TOL if dtype == torch.bfloat16 else ATTN_TOL[dtype]
        fwd_err = _check_close(fname, out, out_ref, dtype, ftol)
        fwd_share = _limit_share(out, out_ref, ftol)
        lse_err, lse_share = _lse_errors(fname, lse, lse_ref)
        del out_ref

        def fwd():
            return flash_attention_kernel(q, k, v, ln, causal=causal,
                                          return_lse=True)
        _check_same_bits(fname, lambda: fwd()[0])

        def fn():
            return flash_attention_bwd_kernel(q, k, v, out, lse, do, ln,
                                              causal=causal)

        def plain():
            return flash_attention_bwd_ref(q, k, v, out, lse_ref, do, ln,
                                           causal=causal)
        got, want = fn(), plain()
        again = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"{name}: two calls differ")
        errs, shares = {}, {}
        for g, w, gname in zip(got, want, ("dq", "dk", "dv")):
            tol = SCOUT_ATTN_TOL if dtype == torch.bfloat16 else \
                (BWD_F32_TOL * float(w.float().abs().max()), 0.0)
            errs[gname] = _check_close(f"{name} {gname}", g, w, dtype, tol)
            shares[gname] = _limit_share(g, w, tol)
        del got, want, again
        torch.cuda.empty_cache()

        mask, is_causal = _attention_mask(sq, sk, causal, ln, dev)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=is_causal,
                enable_gqa=qh != kvh)
        fwd_library_ms = time_cuda(sdpa_fwd, scratch)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def sdpa():
            with torch.enable_grad():
                return F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=mask, is_causal=is_causal,
                    enable_gqa=qh != kvh)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), (ql, kl, vl), do)
        library_ms = time_cuda(sdpa_fwd_bwd, scratch) \
            - time_cuda(sdpa, scratch)
        del ql, kl, vl
        fwd_ms = time_cuda(fwd, scratch)
        fwd_plain_ms = time_cuda(
            lambda: (flash_attention_ref(q, k, v, ln, causal=causal),
                     flash_attention_lse_ref(q, k, ln, causal=causal)),
            scratch)
        ms = time_cuda(fn, scratch)
        plain_ms = time_cuda(plain, scratch)
        torch.cuda.empty_cache()

        pairs = _live_pairs(b, sq, sk, causal, lens) * qh
        keys = b * sk if lens is None else int(ln.clamp(0, sk).sum())
        el = q.element_size()
        live_kv = 2 * keys * kvh * d * el
        # f32 at f32 accuracy on the tensor cores: three TF32 passes
        passes, rate = (1, BF16_FLOPS_PER_S) if dtype == torch.bfloat16 \
            else (3, TF32_FLOPS_PER_S)

        def bound(flops, moved):
            t_ops, t_bytes = passes * flops / rate, moved / HBM_BYTES_PER_S
            return (max(t_ops, t_bytes) * 1e3,
                    "operations" if t_ops > t_bytes else "bytes")
        flops = 5 * 2 * pairs * d
        moved = (4 * q.numel() + 2 * k.numel()) * el + live_kv \
            + lse.numel() * 4
        fwd_flops = 2 * 2 * pairs * d
        fwd_moved = 2 * q.numel() * el + live_kv + lse.numel() * 4
        r = dict(shape=[b, qh, kvh, sq, sk, d], causal=causal,
                 lengths=None if lens is None else list(lens),
                 dtype=str(dtype).replace("torch.", ""), key=key,
                 max_abs_err=max(errs.values()), errs=errs,
                 limit_share=max(shares.values()), ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, flops=flops, bytes_moved=moved,
                 floor_ms=BWD_PASSES[dtype] * 2 * pairs * d / rate * 1e3)
        r["bound_ms"], r["bound_by"] = bound(flops, moved)
        r["fwd"] = dict(max_abs_err=fwd_err, limit_share=fwd_share,
                        lse_max_abs_err=lse_err, lse_limit_share=lse_share,
                        ms=fwd_ms, plain_ms=fwd_plain_ms,
                        library_ms=fwd_library_ms, flops=fwd_flops,
                        bytes_moved=fwd_moved)
        r["fwd"]["bound_ms"], r["fwd"]["bound_by"] = bound(fwd_flops,
                                                          fwd_moved)
        res[label] = r
        f = r["fwd"]
        log(f"[train] flash_attention forward with lse, {label}: (B, QH, "
            f"KVH, Sq, Sk, D) {tuple(r['shape'])}, causal {causal}, "
            f"{r['dtype']}" + (f", lengths {lens}" if lens else "")
            + f": out max err {fwd_err:.3g} = {fwd_share:.3f} of the limit, "
            f"lse max err {lse_err:.3g} = {lse_share:.3f} of LSE_TOL, two "
            f"calls same bits, out unchanged by lse; kernel "
            f"{fwd_ms:.3f} ms, plain {fwd_plain_ms:.3f} ms, SDPA "
            f"{fwd_library_ms:.3f} ms, bound {f['bound_ms']:.4f} ms "
            f"({f['bound_by']}: {fwd_flops / 1e9:.2f} GFLOP, "
            f"{fwd_moved / 1e6:.1f} MB); {floor_note(floor_ms)}")
        log(f"[train] flash_attention backward, {label}: max err "
            f"{r['max_abs_err']:.3g} = {r['limit_share']:.3f} of the limit "
            f"(against the plain backward of the kernel's out and the "
            f"plain lse), two calls same bits; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, SDPA backward {library_ms:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {flops / 1e9:.2f} "
            f"GFLOP, {moved / 1e6:.1f} MB), the design's floor "
            f"{r['floor_ms']:.4f} ms ({BWD_PASSES[dtype]} "
            f"{'bf16' if dtype == torch.bfloat16 else 'TF32'} passes); "
            f"{floor_note(floor_ms)}")
    return res


class _TrainShapes:
    """Counts flash_attention's forward and backward launches by shape
    while active: it wraps the two kernel names that ``ops.py`` calls
    (``FlashAttentionFn`` and the no-gradient path) and adds each call's
    launch-count delta under its ``_attention_shape`` key, in ``fwd`` and
    ``bwd``."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import kernel as fa
        from repro_torch.kernels.flash_attention import ops
        self.ops, self.fwd, self.bwd = ops, {}, {}
        self.saved = ops.flash_attention_kernel, ops.flash_attention_bwd_kernel

        def counted(fn, counter, into, n_in):
            def call(*args, **kw):
                n0 = fa.COUNTS[counter]
                out = fn(*args, **kw)
                lengths = args[n_in] if len(args) > n_in \
                    else kw.get("lengths")
                key = _attention_shape("flash", args[:2],
                                       dict(kw, lengths=lengths))
                into[key] = into.get(key, 0) + fa.COUNTS[counter] - n0
                return out
            return call
        ops.flash_attention_kernel = counted(self.saved[0], "flash_attention",
                                             self.fwd, 3)
        ops.flash_attention_bwd_kernel = counted(
            self.saved[1], "flash_attention_bwd", self.bwd, 6)
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention_kernel, \
            self.ops.flash_attention_bwd_kernel = self.saved


def _launch_delta(c0, c1):
    return {k: c1[k] - c0[k] for k in c1}


def _leaf_paths(tree, prefix=""):
    """The paths of a parameter tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [p for i, t in enumerate(tree)
                for p in _leaf_paths(t, f"{prefix}[{i}]")]
    return [prefix]


def train_tiny(dev, root):
    """tiny-lm at full width through Trainer: TRAIN_STEPS steps of the
    synthetic stream with checkpoints, the main path whose launches are
    counted; a restart from the first checkpoint that must end on the same
    parameters, bit for bit; TRAIN_Q8_STEPS steps with 8-bit state; one
    profiled step."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models.param import count_params, tree_leaves
    from repro_torch.training import Trainer, TrainerConfig
    cfg = get_config(TRAIN_ARCH)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)

    def trainer(d, steps=TRAIN_STEPS, bits=32):
        return Trainer(cfg, TrainerConfig(
            total_steps=steps, log_every=1, ckpt_every=TRAIN_CKPT_EVERY,
            ckpt_dir=d, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
            state_bits=bits), dcfg, device=dev)
    log(f"[train] {cfg.name} at full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab}, {cfg.dtype}, TF32 off, remat "
        f"{cfg.remat} per {cfg.remat_unit}; {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens a step, AdamW f32 state, peak lr {TRAIN_LR}")
    tr = trainer(os.path.join(root, "a"))
    state = tr.init_or_restore()
    n_params = count_params(state.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _TrainShapes() as shapes:
        kernels.reset_launch_counts()        # the training path starts here
        t = time.perf_counter()
        state = tr.run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = kernels.launch_counts()      # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in tr.metrics_log]
    want = dict(flash_attention=2 * cfg.n_layers * TRAIN_STEPS,
                flash_attention_bwd=cfg.n_layers * TRAIN_STEPS,
                paged_attention=0, tiara_gather=0, lockstep_vm=0,
                selective_scan=0, wkv6=0)
    if counts != want:
        raise AssertionError(f"tiny-lm training launches {counts}, expected "
                             f"{want}: per step 12 forward, 12 under the "
                             f"remat recompute, 12 backward")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"tiny-lm training: the loss did not fall: "
                             f"{losses}")
    step_ms = [dt * 1e3 for dt in tr.step_times]
    med = float(np.median(step_ms))
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
    log(f"[train] tiny-lm: {n_params / 1e6:.1f} M params; {TRAIN_STEPS} "
        f"steps in {wall:.2f} s (checkpoints at {TRAIN_CKPT_EVERY} and "
        f"{TRAIN_STEPS} included); loss {losses[0]:.4f} at step 0 -> "
        f"{losses[-1]:.4f} at step {TRAIN_STEPS - 1}; step wall median "
        f"{med:.2f} ms (min {min(step_ms):.2f}, first {step_ms[0]:.2f}), "
        f"{tokens_s:.0f} tokens/s; peak max_memory_allocated "
        f"{peak / 1e9:.2f} GB; launches {counts}")

    b_dir = os.path.join(root, "b")
    os.makedirs(b_dir)
    first = f"step_{TRAIN_CKPT_EVERY:08d}"
    shutil.copytree(os.path.join(root, "a", first),
                    os.path.join(b_dir, first))
    tr2 = trainer(b_dir)
    resumed = tr2.init_or_restore()
    if int(resumed.step) != TRAIN_CKPT_EVERY:
        raise AssertionError(f"restart began at step {int(resumed.step)}")
    resumed = tr2.run(resumed)
    pairs = list(zip(tree_leaves(state.params), tree_leaves(resumed.params)))
    if not all(torch.equal(a, c) for a, c in pairs):
        diff = max(_max_err(a, c) for a, c in pairs)
        raise AssertionError(f"the restart from step {TRAIN_CKPT_EVERY} "
                             f"ended {diff:.3g} away from the "
                             f"uninterrupted run")
    log(f"[train] restart from the step-{TRAIN_CKPT_EVERY} checkpoint to "
        f"step {TRAIN_STEPS}: every parameter equal to the uninterrupted "
        f"run's, bit for bit; losses "
        f"{[round(m['loss'], 4) for m in tr2.metrics_log]}")
    del tr2, resumed, pairs

    tr8 = trainer(None, TRAIN_Q8_STEPS, 8)
    tr8.run()
    losses8 = [m["loss"] for m in tr8.metrics_log]
    gaps = [abs(a - b) / b for a, b in zip(losses8, losses)]
    if not all(np.isfinite(losses8)) or max(gaps) > TRAIN_Q8_TOL:
        raise AssertionError(f"8-bit state: losses {losses8} against the "
                             f"f32 run's {losses[:TRAIN_Q8_STEPS]}")
    log(f"[train] 8-bit AdamW state, {TRAIN_Q8_STEPS} steps: losses "
        f"{[round(x, 4) for x in losses8]} against f32 "
        f"{[round(x, 4) for x in losses[:TRAIN_Q8_STEPS]]} (largest gap "
        f"{max(gaps):.4f} of the loss, limit {TRAIN_Q8_TOL})")
    del tr8

    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in tr.pipeline.batch(TRAIN_STEPS).items()}
    names = ("flash_attention_bwd", "flash_attention_kernel")
    prof = _profiled(lambda: tr.train_step(state, batch), top=8,
                     names=names)
    share = prof["named_ms"]["flash_attention_bwd"] / prof["device_busy_ms"]
    log(f"[train] one profiled tiny-lm step: {prof['device_busy_ms']:.2f} ms "
        f"of kernels in {prof['kernel_launches']} launches over a "
        f"{prof['wall_ms']:.2f} ms wall ({prof['busy_share']:.1%} busy); "
        f"flash_attention backward {prof['named_ms'][names[0]]:.2f} ms = "
        f"{share:.1%} of the device time, forward "
        f"{prof['named_ms'][names[1]]:.2f} ms; top "
        + "; ".join(f"{r['kernel'][:60]} {r['ms']:.2f} ms x{r['count']}"
                    for r in prof["top"][:5]))
    return dict(n_params=n_params, losses=losses, losses_q8=losses8,
                step_ms=step_ms, step_ms_median=med, tokens_s=tokens_s,
                wall_s=wall, peak_bytes=peak, counts=counts,
                fwd_by_shape=shapes.fwd, bwd_by_shape=shapes.bwd,
                restart_bit_equal=True, profile=prof, bwd_share=share)


def train_card_vs_cpu(dev):
    """One train step of tiny-lm at full width, batch TRAIN_CPU_BATCH x
    TRAIN_CPU_SEQ, on the card and on the CPU from the same state: the
    loss and every gradient within CARD_VS_CPU_TOL of the leaf's largest
    entry."""
    from repro_torch.configs import get_config
    from repro_torch.convert import (train_state_from_numpy,
                                     train_state_to_numpy)
    from repro_torch.data import DataConfig, LMPipeline
    from repro_torch.models.param import tree_leaves
    from repro_torch.training.optimizer import AdamWConfig, warmup_cosine
    from repro_torch.training.train_step import make_train_step
    cfg = get_config(TRAIN_ARCH)
    opt = AdamWConfig(lr=warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    np_state = train_state_to_numpy(
        make_train_step(cfg, opt)[0](1, device="cpu"))
    batch = LMPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_CPU_SEQ,
                                  global_batch=TRAIN_CPU_BATCH)).batch(0)
    got = []                                  # the card's, then the CPU's
    for d in (dev, torch.device("cpu")):
        caught = {}

        def catch(g, caught=caught):
            caught["g"] = g
            return g
        _, step = make_train_step(cfg, opt, grad_compressor=catch)
        _, m = step(train_state_from_numpy(np_state, device=d),
                    {k: torch.from_numpy(v).to(d) for k, v in batch.items()})
        got.append((float(m["loss"]),
                    [g.cpu() for g in tree_leaves(caught["g"])]))
    (lc, gc_), (lh, gh) = got
    loss_err = abs(lc - lh) / abs(lh)
    grad_err = max(_max_err(a, c) / float(c.abs().max())
                   for a, c in zip(gc_, gh))
    if loss_err > CARD_VS_CPU_TOL or grad_err > CARD_VS_CPU_TOL:
        raise AssertionError(f"train step card vs CPU: loss {loss_err:.3g}, "
                             f"gradients {grad_err:.3g} of the leaf's "
                             f"largest (tolerance {CARD_VS_CPU_TOL})")
    log(f"[train] tiny-lm train step on the card against the CPU, "
        f"{TRAIN_CPU_BATCH} x {TRAIN_CPU_SEQ} tokens from the same state: "
        f"loss {lc:.6f} / {lh:.6f} ({loss_err:.3g} apart), every gradient "
        f"within {grad_err:.3g} of its leaf's largest entry (tolerance "
        f"{CARD_VS_CPU_TOL})")
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_err)


def train_seamless(dev):
    """SeamlessM4T-medium whole in bf16 through ``make_train_step``:
    SEAMLESS_TRAIN_STEPS steps over encoder frames with ragged lengths and
    decoder targets, launches per step and by shape, finite loss, finite
    and changed parameters."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.param import count_params, tree_leaves
    from repro_torch.training.optimizer import AdamWConfig, warmup_cosine
    from repro_torch.training.train_step import make_train_step
    cfg = get_config(SEAMLESS_ARCH)
    init, step = make_train_step(cfg, AdamWConfig(
        lr=warmup_cosine(1e-4, 1, SEAMLESS_TRAIN_STEPS)))
    state = init(device=dev, generator=torch.Generator(dev).manual_seed(0))
    n_params = count_params(state.params)
    if n_params != SEAMLESS_PARAMS:
        raise AssertionError(f"seamless: {n_params} parameters")
    b = len(SEAMLESS_ENC_LENS)
    extra = _AudioInputs(cfg, b, dev, 19)
    rng = np.random.default_rng(19)
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab, (b, SEAMLESS_TRAIN_TOKENS))).to(dev),
        "labels": torch.from_numpy(rng.integers(
            1, cfg.vocab, (b, SEAMLESS_TRAIN_TOKENS))).to(dev),
        **extra.prefill(SEAMLESS_TRAIN_TOKENS)}
    before = [p.detach().clone() for p in tree_leaves(state.params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_counts, losses = [], [], []
    with _TrainShapes() as shapes:
        kernels.reset_launch_counts()    # the SeamlessM4T path starts here
        for _ in range(SEAMLESS_TRAIN_STEPS):
            c0 = kernels.launch_counts()
            t = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            step_counts.append(_launch_delta(c0, kernels.launch_counts()))
        counts = kernels.launch_counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    want = dict(flash_attention=n_attn + 2 * cfg.n_layers,
                flash_attention_bwd=n_attn, paged_attention=0,
                tiara_gather=0, lockstep_vm=0, selective_scan=0, wkv6=0)
    if any(c != want for c in step_counts):
        raise AssertionError(f"seamless training launches per step "
                             f"{step_counts}, expected {want}")
    after = tree_leaves(state.params)
    if not all(np.isfinite(losses)) \
            or not all(bool(torch.isfinite(p).all()) for p in after):
        raise AssertionError(f"seamless training: losses {losses}, or "
                             f"non-finite parameters")
    # Every leaf got a gradient (its AdamW first moment is nonzero) and
    # every leaf moved, except the norms' scales: they start at 1.0, where
    # bf16 values lie 2**-7 apart, and an update of about the learning rate
    # (1e-4) rounds back to 1.0.
    paths = _leaf_paths(state.params)
    moved = {path: float((a != c).float().mean())
             for path, a, c in zip(paths, before, after)}
    no_grad = [p for p, mu in zip(paths, tree_leaves(state.opt.mu))
               if not bool(mu.any())]
    unchanged = [p for p, share in moved.items()
                 if share == 0.0 and not p.endswith("/scale")]
    if no_grad or unchanged:
        raise AssertionError(f"seamless training: no gradient for "
                             f"{no_grad}; unchanged {unchanged}")
    del before
    log(f"[train] {cfg.name} whole in bf16 ({n_params / 1e9:.3f} G params), "
        f"{SEAMLESS_TRAIN_STEPS} steps of {b} x {SEAMLESS_S_ENC} encoder "
        f"frames (enc_lengths {sorted(SEAMLESS_ENC_LENS)}) and {b} x "
        f"{SEAMLESS_TRAIN_TOKENS} decoder targets: losses "
        f"{[round(x, 4) for x in losses]}, every parameter finite, every "
        f"leaf with a gradient, every leaf but the norms' scales changed "
        f"({sum(moved.values()) / len(moved):.1%} of the elements on "
        f"average); step wall {[round(x, 2) for x in step_ms]} ms; peak "
        f"max_memory_allocated {peak / 1e9:.2f} GB; launches per step "
        f"{step_counts[0]}; forward launches by shape {shapes.fwd}, "
        f"backward {shapes.bwd}")
    return dict(n_params=n_params, losses=losses, step_ms=step_ms,
                peak_bytes=peak, counts=counts, step_counts=step_counts,
                fwd_by_shape=shapes.fwd, bwd_by_shape=shapes.bwd,
                moved_share=moved)


def phase_training(dev, floor_ms):
    """Phase 12: the flash_attention backward kernel at BWD_CASES, tiny-lm
    trained at full width through Trainer (with a restart and 8-bit
    state), a train step on the card against the CPU, and SeamlessM4T-
    medium trained whole in bf16.  Checkpoints go to a git-ignored
    directory of the checkout and are removed at the end."""
    regs = bwd_registers()
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)
    kern = bwd_cases(dev, scratch, floor_ms)
    del scratch
    torch.cuda.empty_cache()
    root = os.path.join(HERE, "build", "chip", "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    try:
        tiny = train_tiny(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    cpu = train_card_vs_cpu(dev)
    gc.collect()
    torch.cuda.empty_cache()
    seamless = train_seamless(dev)
    return dict(kernels=kern, registers=regs, tiny=tiny, card_vs_cpu=cpu,
                seamless=seamless)


def training_rows(train):
    """The kernels line's rows of the training paths: for each shape that
    tiny-lm's or SeamlessM4T's run or the training example (phase 17,
    ``train["entry"]``) launched the forward at, a forward row
    with those launches (``_TrainShapes``) and the times of the
    BWD_CASES case of that shape; and a backward row for every case, with
    the launches the runs made at its shape (0 for the shapes only held
    and timed here).  Fails if a run launched a shape that no case checked
    and timed, or if the shapes' launches do not add up to the counts."""
    cases = {r["key"]: (label, r) for label, r in train["kernels"].items()}
    fa_src = "src/repro_torch/kernels/flash_attention/csrc/"
    rows, launched = [], {}
    for kind, counter in (("fwd", "flash_attention"),
                          ("bwd", "flash_attention_bwd")):
        launched[kind] = {}
        for path in ("tiny", "seamless", "entry"):
            by_shape = train[path][f"{kind}_by_shape"]
            if sum(by_shape.values()) != train[path]["counts"][counter]:
                raise AssertionError(f"{path} training: {counter} launches "
                                     f"by shape {by_shape} do not add up to "
                                     f"{train[path]['counts'][counter]}")
            for key, n in by_shape.items():
                if key not in cases:
                    raise AssertionError(f"{path} training launched "
                                         f"{counter} at {key}, which no "
                                         f"case checked and timed")
                launched[kind][key] = launched[kind].get(key, 0) + n
    for key, n in launched["fwd"].items():
        label, r = cases[key]
        f = r["fwd"]
        rows.append(dict(
            name="flash_attention", route="cuda",
            source=fa_src + ("flash_attention_bf16.cu"
                             if r["dtype"] == "bfloat16" else
                             "flash_attention.cu"),
            replaces="src/repro/kernels/flash_attention/kernel.py:73",
            launches=n, max_abs_err=f["max_abs_err"], ms=f["ms"],
            plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
            bound_by=f["bound_by"], library_ms=f["library_ms"],
            shape=f"training, {label}, with lse: {key} {r['dtype']}"))
    for label, r in train["kernels"].items():
        rows.append(dict(
            name="flash_attention_bwd", route="cuda",
            source=fa_src + "flash_attention_bwd.cu",
            replaces="no TPU kernel: the reference differentiates the "
                     "plain route of flash_attention_kernel "
                     "(src/repro/kernels/flash_attention/kernel.py:73)",
            launches=launched["bwd"].get(r["key"], 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            shape=f"training, {label}: {r['key']} {r['dtype']}"))
    return rows


def phase_simulator(dev):
    """The paper's cycle simulator over the port's endpoint: the stock graph
    walk at depth 10, registered on a card-resident endpoint, traced on
    the pyvm oracle by ``Session.trace`` and replayed by
    ``simulate_task``.  Simulated cycles of the paper's machine model (a
    5 ns clock, PCIe DMA and RDMA round trips), not card numbers."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core import operators as ops
    from repro_torch.core import simulator as sim
    from repro_torch.core.endpoint import TiaraEndpoint
    gw = ops.GraphWalk(n_nodes=4096, max_depth=16)
    ep, ss = TiaraEndpoint.for_tenants([("gw", gw.regions())], device=dev)
    sess = ss["gw"]
    order = gw.populate(sess.pool, sess.view, seed=5)
    op = sess.register(gw.build(sess.view))
    depth, start = 10, int(order[0])
    res = sess.trace("graph_walk", [start * 8, depth])
    if res.ret != gw.reference(order, start, depth):
        raise AssertionError("simulator: traced walk returned the wrong node")
    ts = sim.simulate_task(ep.registry[op].verified, res.trace)
    rdma = cm.rdma_chain_latency_us(depth)
    r = dict(depth=depth, latency_us=ts.latency_us,
             nic_resident_cycles=ts.nic_resident_us * 1e3
             / cm.DEFAULT_HW.clk_ns,
             mp_cycles=ts.mp_cycles, dma_channel_cycles=ts.dma_channel_cycles,
             instructions=ts.n_instr_executed,
             saturated_mops=sim.saturated_throughput_mops(ts),
             bottleneck=sim.bottleneck(ts), rdma_chain_us=rdma,
             speedup_over_rdma=rdma / ts.latency_us,
             pool_device=str(ep.mem.device))
    log(f"[simulator] graph walk, depth {depth}, on the port's endpoint "
        f"(pool on {r['pool_device']}), traced by Session.trace: SIMULATED "
        f"on the paper's machine model, not measured on the card: "
        f"{r['nic_resident_cycles']:.0f} NIC cycles "
        f"({ts.mp_cycles} MP cycles, {ts.dma_channel_cycles} DMA-channel "
        f"cycles, {ts.n_instr_executed} instructions), latency "
        f"{ts.latency_us:.2f} us against {rdma:.2f} us for {depth} "
        f"dependent RDMA round trips ({r['speedup_over_rdma']:.2f}x; the "
        f"paper: 2.85x at depth 10), saturated throughput "
        f"{r['saturated_mops']:.2f} Mops, bottleneck {r['bottleneck']}")
    return r


def check_kv_slots(kvs, kv, host0, table, blocks, slots, slot_words):
    expect = kv.reference(host0, kvs.view, table, blocks)
    got = kvs.read_region("reply", count=slots * slot_words) \
        .reshape(slots, slot_words)
    bad = [i for i in range(slots) if not np.array_equal(got[i], expect)]
    if bad:
        raise AssertionError(f"kv reply slots wrong: {bad[:8]}")


def phase_endpoint(dev):
    from repro_torch.core import isa, pyvm
    from repro_torch.core import operators as ops
    from repro_torch.core.endpoint import TiaraEndpoint
    from repro_torch.core.serving_loop import (ServingConfig, ServingLoop,
                                               VirtualClock)

    walls = {}
    kv = ops.PagedKVFetch(n_blocks_pool=131072, block_bytes=8192,
                          max_req_blocks=16, reply_slots=256)
    gw = ops.GraphWalk(n_nodes=1 << 20, reply_words=8 * 256)
    vc = VirtualClock()
    t0 = time.perf_counter()
    ep, ss = TiaraEndpoint.for_tenants(
        [("kv", kv.regions()), ("gw", gw.regions())], device=dev,
        clock=vc, sleep=vc.sleep)
    kvs, gws = ss["kv"], ss["gw"]
    host0 = kvs.pool                        # host copy, authoritative
    table = kv.populate(host0, kvs.view, seed=1)
    order = gw.populate(host0, gws.view, seed=2)
    kvs.register(kv.build(kvs.view, reply_param=True))
    gws.register(gw.build(gws.view, reply_param=True))
    blocks = np.random.default_rng(3).choice(kv.n_blocks_pool, 16,
                                             replace=False)
    kvs.write_region("req", blocks)
    pool = ep.mem                           # upload once
    torch.cuda.synchronize()
    log(f"[endpoint] pool {tuple(pool.shape)} int64 = "
        f"{pool.numel() * 8 / 2**30:.2f} GiB resident on {pool.device}; "
        f"set-up {time.perf_counter() - t0:.1f} s")
    slot = 16 * kv.block_words

    from repro_torch.core import compile as tc
    from repro_torch.kernels.lockstep_vm import kernel as lv
    from repro_torch.kernels.tiara_gather import kernel as tg
    launches, ran, lockstep = {}, {}, {}

    def picked(asked, before):
        d = ep.last_decision
        if d is None or d is before:
            return f"{asked} (forced: no cost-model decision)"
        return f"{d.mode} {d.costs}"

    def wave(name, asked, fn):
        """Run one wave; record its wall time, the engine the doorbell
        picked and the kernel launches it made."""
        torch.cuda.synchronize()
        d0, n0 = ep.last_decision, tg.COUNTS["tiara_gather"]
        l0 = lv.COUNTS["lockstep_vm"]
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        launches[name] = tg.COUNTS["tiara_gather"] - n0
        lockstep[name] = lv.COUNTS["lockstep_vm"] - l0
        ran[name] = picked(asked, d0)
        log(f"[wave] {name}: mode={asked} -> {ran[name]}; tiara_gather "
            f"launches {launches[name]}, lockstep_vm {lockstep[name]}; "
            f"{walls[name] * 1e3:.1f} ms")
        return out

    # 1. compiled paged-KV wave: the gather chain through the kernel, once
    #    monolithic (one launch) and once double-buffered (one launch per
    #    chunk of DBUF_CHUNK blocks)
    chunks = -(-16 // tc.DBUF_CHUNK)
    for mode, want_launches in (("compiled", 1), ("compiled_dbuf", chunks)):
        kvs.write_region("reply", np.zeros(256 * slot, dtype=np.int64))
        cs = [kvs.post("paged_kv_fetch", [16, i * slot]) for i in range(256)]
        wave(f"kv_{mode}", mode, lambda: ep.doorbell(mode=mode))
        if launches[f"kv_{mode}"] != want_launches:
            raise AssertionError(f"kv wave mode={mode} launched tiara_gather "
                                 f"{launches[f'kv_{mode}']} times, expected "
                                 f"{want_launches}")
        if any(c.status != isa.STATUS_OK or c.ret != 16 for c in cs):
            raise AssertionError(f"kv wave mode={mode}: statuses/rets wrong")
        check_kv_slots(kvs, kv, host0, table, blocks, 256, slot)
        log(f"[endpoint] kv wave (256 posts, {mode}): all 256 reply slots "
            f"== reference")

    # 2. mixed auto wave: 256 kv + 256 graph walks of depth 10
    starts = [int(order[i]) for i in range(256)]
    kc = [kvs.post("paged_kv_fetch", [16, i * slot]) for i in range(256)]
    gc = [gws.post("graph_walk", [s * 8, 10, 8 * i])
          for i, s in enumerate(starts)]
    wave("mixed_auto", "auto", lambda: ep.doorbell(mode="auto"))
    if any(c.ret != 16 or not c.ok for c in kc):
        raise AssertionError("mixed wave: kv rets wrong")
    want = [gw.reference(order, s, 10) for s in starts]
    if [c.ret for c in gc] != want or not all(c.ok for c in gc):
        raise AssertionError("mixed wave: graph-walk rets wrong")
    check_kv_slots(kvs, kv, host0, table, blocks, 256, slot)
    log("[endpoint] mixed wave (256 kv + 256 graph walk): every ret == "
        "reference")

    # 2b. the same wave forced onto the lockstep engine: one lockstep_vm
    #     launch runs all 512 posts (32 MiB of 8 KiB blocks copied inside
    #     the wave); replayed after on both routes, side by side
    #     on the endpoint's resident pool, in place: the pool keeps its
    #     storage and the wave allocates nothing the pool's size
    kvs.write_region("reply", np.zeros(256 * slot, dtype=np.int64))
    kc = [kvs.post("paged_kv_fetch", [16, i * slot]) for i in range(256)]
    gc = [gws.post("graph_walk", [s * 8, 10, 8 * i])
          for i, s in enumerate(starts)]
    pool = ep.mem
    ptr, pool_bytes = pool.data_ptr(), pool.numel() * 8
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with _LockstepWaves() as rec:
        wave("mixed_lockstep", "mixed", lambda: ep.doorbell(mode="mixed"))
    grew = torch.cuda.max_memory_allocated() - base
    if lockstep["mixed_lockstep"] != 1 or launches["mixed_lockstep"]:
        raise AssertionError("the mixed wave did not run as one "
                             "lockstep_vm launch")
    if ep.mem.data_ptr() != ptr or grew >= pool_bytes // 16:
        raise AssertionError(f"the lockstep wave did not run in place: "
                             f"data_ptr {ep.mem.data_ptr():#x} (was "
                             f"{ptr:#x}), peak grew {grew} bytes")
    log(f"[endpoint] the forced lockstep wave ran in place: the pool's "
        f"data_ptr unchanged, peak allocation +{grew / 2**20:.2f} MiB "
        f"(the pool is {pool_bytes / 2**30:.2f} GiB)")
    if any(c.ret != 16 or not c.ok for c in kc) or \
            [c.ret for c in gc] != want or not all(c.ok for c in gc):
        raise AssertionError("lockstep mixed wave: rets wrong")
    check_kv_slots(kvs, kv, host0, table, blocks, 256, slot)
    forced = rec.take()
    sides = {"mixed_lockstep": side_by_side(
        "phase 3's mixed wave (256 kv + 256 graph walk)", forced)}
    sides["mixed_lockstep"].update(in_place=True, peak_growth_bytes=grew,
                                   pool_bytes=pool_bytes)

    # 3. split-phase pair
    def split():
        a = [gws.post("graph_walk", [s * 8, 5, 8 * i])
             for i, s in enumerate(starts[:64])]
        d0 = ep.last_decision
        h1 = ep.doorbell(wait=False)
        ran["split_phase_1"] = picked("auto", d0)
        b = [kvs.post("paged_kv_fetch", [8, i * slot]) for i in range(64)]
        d0 = ep.last_decision
        h2 = ep.doorbell(wait=False)
        ran["split_phase_2"] = picked("auto", d0)
        n = ep.wait_all()
        return a, b, h1, h2, n
    a, b, h1, h2, n = wave("split_phase", "auto", split)
    if n != 128 or not (h1.done and h2.done):
        raise AssertionError("split-phase pair did not retire")
    if [c.ret for c in a] != [gw.reference(order, s, 5) for s in starts[:64]] \
            or any(c.ret != 8 or not c.ok for c in b):
        raise AssertionError("split-phase rets wrong")
    log(f"[endpoint] split-phase pair (64 + 64, wait=False then wait_all): "
        f"graph-walk doorbell -> {ran['split_phase_1']}; kv doorbell -> "
        f"{ran['split_phase_2']}; every ret == reference")

    # 4. pyvm replay of 8 posts against a downloaded copy of the pool
    pre = ep._host_view().copy()
    posts = [(kvs, "paged_kv_fetch", [16, i * slot]) for i in range(4)] + \
        [(gws, "graph_walk", [starts[i] * 8, 10, 8 * i]) for i in range(4)]
    cs = [s.post(op, p) for s, op, p in posts]
    wave("replay8", "auto", lambda: ep.doorbell(mode="auto"))
    vops = ep.registry.store_ops()
    mem = pre
    for c in cs:
        r = pyvm.run(vops[c.op_id], ep.regions, mem, list(c.params),
                     home=c.home)
        if (r.ret, r.status, r.steps) != (c.ret, c.status, c.steps):
            raise AssertionError(f"pyvm replay differs for seq {c.seq}")
    if not np.array_equal(ep._host_view(), mem):
        raise AssertionError("pyvm replay: pool differs")
    log("[endpoint] 8 posts == pyvm replay bit for bit (ret, status, "
        "steps, whole pool)")

    # 5. the serving loop on a virtual clock
    n0 = tg.COUNTS["tiara_gather"]
    t = time.perf_counter()
    loop = ServingLoop(ep, ServingConfig(ring_size=16, max_inflight_waves=2))
    subs = []
    for i in range(64):
        if i % 2:
            subs.append(("gw", loop.submit("gw", "graph_walk",
                                           [starts[i] * 8, 7, 8 * i]), i))
        else:
            subs.append(("kv", loop.submit("kv", "paged_kv_fetch",
                                           [4, i * slot]), i))
        loop.pump()
    st = loop.drain()
    ep.wait_all()
    walls["serving_64"] = time.perf_counter() - t
    launches["serving_64"] = tg.COUNTS["tiara_gather"] - n0
    total = st.executed + st.flushed + st.timed_out + st.rejected + st.shed
    if st.submitted != 64 or total != 64:
        raise AssertionError(f"CQE identity broken: {st}")
    for kind, c, i in subs:
        if not c.ok:
            continue
        want = 4 if kind == "kv" else gw.reference(order, starts[i], 7)
        if c.ret != want:
            raise AssertionError(f"serving loop ret wrong for {kind} {i}")
    log(f"[serving] 64 submissions: submitted {st.submitted} == executed "
        f"{st.executed} + flushed {st.flushed} + timed_out {st.timed_out} "
        f"+ rejected {st.rejected} + shed {st.shed}; ok {st.ok}; "
        f"tiara_gather launches {launches['serving_64']}; "
        f"{walls['serving_64'] * 1e3:.1f} ms for the whole phase")
    return walls, dict(tiara_gather=launches, lockstep_vm=lockstep), ran, \
        sides, forced


# ---------------------------------------------------------------------------
# Phase 16: the lockstep engine as one kernel per wave
# ---------------------------------------------------------------------------

#: the lockstep_vm kernel's source and the JAX engine it replaces (the
#: dense engine's lax.while_loop over a wave)
LOCKSTEP_SOURCE = "src/repro_torch/kernels/lockstep_vm/csrc/lockstep_vm.cu"
LOCKSTEP_REPLACES = "src/repro/core/vm.py:1122"


class _LockstepWaves:
    """Keeps the operands of the last lockstep wave launched on the card
    (``_Engine.run_kernel``): the engine, the pool and the wave's
    arguments, so the wave can be replayed on both routes after the run.
    A direct engine call never writes its input, so the reference keeps
    the pool as the wave found it; an endpoint's wave runs in place on
    its resident pool (``vm.donate``), so the reference then holds the
    pool as the wave left it, and a replay starts from there (copying
    the pool here would put a pool-sized copy back into the timed wave).
    With ``keep_first`` it also keeps the first wave, with a copy of its
    pool as the wave found it."""

    def __init__(self, keep_first=False):
        self.last = self.first = None
        self.keep_first = keep_first

    def __enter__(self):
        from repro_torch.core import vm
        self._orig = orig = vm._Engine.run_kernel

        def run_kernel(eng, mem, params, homes, failed, op_sel):
            snap = [np.array(a) if not isinstance(a, torch.Tensor)
                    else a.clone() for a in (params, homes, failed, op_sel)]
            self.last = dict(engine=eng, mem=mem, args=tuple(snap))
            if self.keep_first and self.first is None:
                self.first = dict(self.last, mem=mem.clone())
            return orig(eng, mem, params, homes, failed, op_sel)
        vm._Engine.run_kernel = run_kernel
        return self

    def __exit__(self, *exc):
        from repro_torch.core import vm
        vm._Engine.run_kernel = self._orig

    def take(self):
        w, self.last = self.last, None
        return w


def _restore_counts(saved):
    """Set every kernel's launch count back to ``saved`` (launches made to
    compare a kernel with its plain version are not the main path's)."""
    from repro_torch import kernels
    for mod in kernels._modules():
        for name in mod.COUNTS:
            mod.COUNTS[name] = saved[name]


def _same_wave(got, want) -> bool:
    return torch.equal(got.mem, want.mem) and all(
        torch.equal(getattr(got, f), getattr(want, f))
        for f in ("ret", "status", "steps", "regs", "fault"))


def side_by_side(tag, wave):
    """Replay one wave on both routes, each timed by the host wall to
    ``torch.cuda.synchronize()``: the kernel (one ``lockstep_vm`` launch)
    and its plain version (the host loop).  Bit-equal, or raise.  The
    replays' launches are taken back out of the counts."""
    from repro_torch import kernels
    saved = kernels.launch_counts()
    eng, mem, args = wave["engine"], wave["mem"], wave["args"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = eng.run_kernel(mem, *args)
    torch.cuda.synchronize()
    k_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    want = eng.run_host_loop(mem, *args)
    torch.cuda.synchronize()
    h_ms = (time.perf_counter() - t) * 1e3
    host_gathers = kernels.launch_counts()["tiara_gather"] \
        - saved["tiara_gather"]
    _restore_counts(saved)
    if not _same_wave(got, want):
        raise AssertionError(f"[lockstep] {tag}: the kernel differs from "
                             f"the host loop")
    row = dict(B=eng.B, macro_steps=int(got.steps.max()), kernel_ms=k_ms,
               host_loop_ms=h_ms, host_loop_tiara_gather=host_gathers)
    log(f"[lockstep] {tag}: B {eng.B}, {row['macro_steps']} macro-steps: "
        f"kernel {k_ms:.2f} ms (1 launch), host loop {h_ms:.2f} ms "
        f"({host_gathers} tiara_gather launches); bit-equal")
    return row


def wave_bytes(eng, mem, params, homes, failed, op_sel):
    """The bytes one wave must move and its longest lane's dependent pool
    accesses, from pyvm's trace of each lane run in lane order on a host
    copy of the pool (pyvm steps a lane as the host loop does): the
    instruction store, the region and slot tables and the wave's inputs
    read once, the outputs written once, and every word each executed
    instruction reads or writes in the pool (8 a LOAD or STORE, 16 a CAS
    or CAA, 16 a MEMCPY word); and the most LOAD, CAS, CAA and MEMCPY
    instructions any one lane executes (each waits for a word of the pool
    before the lane can go on)."""
    import types
    from repro_torch.core import pyvm
    from repro_torch.core.isa import Op
    host = mem.cpu().numpy().copy()
    p = np.asarray(_host_arr(params)).reshape(eng.B, -1)
    h = np.asarray(_host_arr(homes)).reshape(eng.B)
    f = {int(i) for i in np.flatnonzero(np.asarray(_host_arr(failed)))}
    sel = np.asarray(_host_arr(op_sel)).reshape(eng.B)
    rt = types.SimpleNamespace(
        as_arrays=lambda: (eng.base_np, eng.mask_np, None))
    n = eng.code_np.nbytes + eng.base_np.nbytes * 2 + 3 * eng.fuel_np.nbytes
    n += p.nbytes + 3 * 8 * eng.B + eng.B * (3 + 16 + 4) * 8
    per_op = {Op.LOAD: 8, Op.STORE: 8, Op.CAS: 16, Op.CAA: 16}
    waits = (Op.LOAD, Op.CAS, Op.CAA, Op.MEMCPY)
    dependent = 0
    for b in range(eng.B):
        s = int(np.clip(sel[b], 0, eng.n_ops - 1))
        op = types.SimpleNamespace(
            code=eng.code_np[eng.start_np[s]:eng.end_np[s]],
            step_bound=int(eng.fuel_np[s]))
        r = pyvm.run(op, rt, host, list(p[b]), home=int(h[b]), failed=f,
                     record_trace=True, protect=eng.protect)
        for ev in r.trace:
            n += 16 * ev.n_words if ev.op == Op.MEMCPY else \
                per_op.get(ev.op, 0)
        dependent = max(dependent, sum(ev.op in waits for ev in r.trace))
    return int(n), int(dependent)


def _host_arr(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def lockstep_row(wave, scratch, latency_ns):
    """The lockstep_vm row at one recorded main-path wave: the kernel's
    device time (the launch alone, on operands prepared once: the wave
    writes only its private pool, and the resolvers' waves read nothing
    they write), the whole call's (operands and launch) and its plain
    version's (CUDA events, L2 flushed), the byte bound of the wave, its
    latency bound (its longest lane's dependent pool accesses times the
    card's cold-word latency ``latency_ns``), its per-phase counters and
    its one-lane wave: the kernel's device time for one lane that retires
    at its first instruction (beside the launch floor, an empty
    kernel)."""
    from repro_torch import kernels
    from repro_torch.core import vm
    from repro_torch.core.memory import Grant, packed_table
    from repro_torch.core.program import OperatorBuilder
    from repro_torch.core.verifier import verify
    from repro_torch.kernels.lockstep_vm.kernel import lockstep_vm_kernel
    saved = kernels.launch_counts()
    eng, mem, args = wave["engine"], wave["mem"], wave["args"]
    got = eng.run_kernel(mem, *args)
    want = eng.run_host_loop(mem, *args)
    torch.cuda.synchronize()
    if not _same_wave(got, want):
        raise AssertionError("[lockstep] the timed wave differs from the "
                             "host loop")
    err = max(int((getattr(got, f) - getattr(want, f)).abs().max())
              for f in ("ret", "status", "steps", "regs", "fault"))
    ops = eng.kernel_operands(mem, *args)
    ms = time_cuda(lambda: lockstep_vm_kernel(**ops), scratch)
    call_ms = time_cuda(lambda: eng.run_kernel(mem, *args), scratch)
    plain_ms = time_cuda(lambda: eng.run_host_loop(mem, *args), scratch,
                         reps=5, warmup=1)
    rt = packed_table([("w", 64)])
    b = OperatorBuilder("ret", n_params=1, regions=rt)
    b.ret(b.param(0))
    one = verify(b.build(), grant=Grant.all_of(rt), regions=rt)
    e1 = vm._build_engine([one.code], [one.step_bound], rt, 1, 1)
    m1 = torch.zeros((1, rt.pool_words), dtype=torch.int64, device=mem.device)
    a1 = (np.zeros((1, 1), np.int64), np.zeros(1, np.int64),
          np.zeros(1, bool), np.zeros(1, np.int64))
    ops1 = e1.kernel_operands(m1, *a1)
    one_lane_ms = time_cuda(lambda: lockstep_vm_kernel(**ops1), scratch)
    moved, dependent = wave_bytes(eng, mem, *args)
    clocks = phase_clocks(ops, got)
    _restore_counts(saved)
    return dict(B=eng.B, macro_steps=int(got.steps.max()), ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, max_abs_err=err,
                bytes_moved=moved,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                dependent_accesses=dependent,
                latency_bound_ms=dependent * latency_ns * 1e-6,
                clocks=clocks, one_lane_ms=one_lane_ms)


def phase_clocks(ops, want):
    """One wave on the clocks build of the kernel (the same operands):
    its per-phase cycles a macro-step and their shares of the macro-steps'
    cycles; its fields must equal ``want``'s, the main build's."""
    from repro_torch.kernels.lockstep_vm import kernel as lk
    got, words = lk.lockstep_vm_clocks(**ops)
    torch.cuda.synchronize()
    for f in ("ret", "status", "steps", "regs", "fault"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"[lockstep] the clocks build differs "
                                 f"from the main build: {f}")
    c = dict(zip(lk.CLOCK_WORDS, words.tolist()))
    steps, total = max(c["steps"], 1), max(c["total"], 1)
    return dict(macro_steps=c["steps"], serial_lane_steps=c["serial"],
                cycles_per_step={k: c[k] / steps for k in "abcde"},
                share={k: c[k] / total for k in "abcde"},
                cycles=c["total"])


def lockstep_registers():
    """Registers and spills of the lockstep_vm kernels (the 256- and the
    512-thread build, main and clocks) from the ``-Xptxas=-v`` build
    log; fails when the 256-thread main build, the one every wave of at
    most 256 threads launches (the serving resolvers' among them),
    spills."""
    from repro_torch.kernels import _build
    rows, src, name, spill = [], "", None, None
    for line in _build.log_path().read_text().splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"lockstep_vm_kernelILi(\d+)ELb([01])E",
                             m.group(1))
            spill = None
        elif name and spill is None and "spill stores" in line:
            spill = [int(x) for x in
                     re.findall(r"(\d+) bytes spill (?:stores|loads)", line)]
        elif name and "Used" in line and "registers" in line:
            rows.append(dict(
                build="clocks" if "clocks" in src else "main",
                threads=int(name.group(1)), keeps_decode=name.group(2) == "1",
                registers=int(re.search(r"Used (\d+) registers",
                                        line).group(1)),
                spill_stores=spill[0], spill_loads=spill[1]))
            name = None
    if not rows:
        raise AssertionError("the build log names no lockstep_vm kernel")
    log("[kernel] lockstep_vm builds: " + ", ".join(
        f"{r['build']} {r['threads']} threads {r['registers']} registers, "
        f"spills {r['spill_stores']}/{r['spill_loads']} bytes"
        for r in rows))
    main = [r for r in rows if r["build"] == "main" and r["threads"] == 256]
    if not main or main[0]["spill_stores"] or main[0]["spill_loads"]:
        raise AssertionError(f"the 256-thread lockstep_vm build spills: "
                             f"{main}")
    return rows


#: The previous lockstep_vm kernel's walls (one block, lane state in
#: global memory, a pairwise sweep; commit a07ac83, PERF.md §5-§6: its
#: chip_smoke.py run on an NVIDIA H100 80GB HBM3 at 700 W), printed beside
#: this tree's (its source is not in the tree to build;
#: tools/lockstep_vm_walls.py times both trees side by side)
PREVIOUS_WALLS_MS = {"scout": "0.295 (Scout's recorded wave)", "tiny": "3.51",
                 "phase3": "10.01", "1024": "4.22-8.04",
                 "1500": "9.20-17.05"}


def cold_word_latency_ns(dev) -> float:
    """The card's load-to-use latency for a word no cache holds: one
    thread follows a random cycle through 2^20 words 1 KiB apart in a
    1 GiB buffer (20 times the 50 MB L2), 200,000 dependent loads, timed
    with CUDA events."""
    from repro_torch.kernels.lockstep_vm.kernel import pointer_chase
    n, nodes, steps = 1 << 27, 1 << 20, 200_000
    gen = torch.Generator().manual_seed(0)
    perm = torch.randperm(nodes, generator=gen).to(dev) * (n // nodes)
    buf = torch.zeros(n, dtype=torch.int64, device=dev)
    buf[perm] = torch.roll(perm, -1)
    pointer_chase(buf, int(perm[0]), 1000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = pointer_chase(buf, int(perm[7]), steps)
    b.record()
    b.synchronize()
    if int(out[1]) != int(perm[(7 + steps) % nodes]):
        raise AssertionError("the pointer chase lost its chain")
    ns = a.elapsed_time(b) * 1e6 / steps
    cycles = int(out[0]) / steps
    del buf, perm
    torch.cuda.empty_cache()
    log(f"[lockstep] cold-word load-to-use latency: {ns:.1f} ns "
        f"({cycles:.0f} SM cycles) per dependent load, one thread through "
        f"1 GiB")
    return ns


def lockstep_counters(dev, forced, latency_ns, card, floor_ms):
    """The per-phase counters of the waves PERF.md follows, each with its
    wall beside the previous kernel's and its bound: the larger of the bytes it moves at
    3.35 TB/s and its longest lane's dependent pool accesses times the
    cold-word latency."""
    from repro_torch import kernels
    from repro_torch.core import lockstep_corpus as lc
    from repro_torch.kernels.lockstep_vm.kernel import lockstep_vm_kernel

    def held(w):
        return dict(engine=w.engine(), mem=torch.from_numpy(w.mem).to(dev),
                    args=w.args())
    waves = [("resolver at Scout's lane count (16 tenants x 16 pages)",
              held(lc.resolver_wave(n_slots=16, pages=16)),
              PREVIOUS_WALLS_MS["scout"]),
             ("resolver at tiny-lm's geometry (8 tenants x 128 pages)",
              held(lc.resolver_wave()), PREVIOUS_WALLS_MS["tiny"]),
             ("phase 3's forced mixed wave", forced, PREVIOUS_WALLS_MS["phase3"])]
    for B in (1024, 1500):
        waves += [(w.name, held(w), PREVIOUS_WALLS_MS[str(B)])
                  for w in lc.stock_waves(B, serialized=False)]
    saved = kernels.launch_counts()
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)
    rows = []
    for tag, wave, prev in waves:
        eng, mem, args = wave["engine"], wave["mem"], wave["args"]
        ops = eng.kernel_operands(mem, *args)
        want = lockstep_vm_kernel(**ops)
        clocks = phase_clocks(ops, want)
        us = time_cuda(lambda: lockstep_vm_kernel(**ops), scratch) * 1e3
        moved, dependent = wave_bytes(eng, mem, *args)
        by_bytes = moved / HBM_BYTES_PER_S * 1e3
        by_latency = dependent * latency_ns * 1e-6
        rows.append(dict(wave=tag, B=eng.B, us=us, previous_ms=prev,
                         bytes_moved=moved, dependent_accesses=dependent,
                         bound_ms=max(by_bytes, by_latency),
                         bound_by="latency" if by_latency > by_bytes
                         else "bytes", **clocks))
        cy, sh = clocks["cycles_per_step"], clocks["share"]
        log(f"[lockstep] counters, {tag}: B {eng.B}, "
            f"{clocks['macro_steps']} macro-steps, {us:.1f} us (previous kernel: "
            f"{prev} ms); cycles a macro-step " + ", ".join(
                f"({k}) {cy[k]:.0f} ({100 * sh[k]:.0f}%)" for k in "abcde")
            + f"; {clocks['serial_lane_steps']} serial lane steps; bound "
            f"{rows[-1]['bound_ms'] * 1e3:.2f} us ({rows[-1]['bound_by']}: "
            f"{moved} bytes, {dependent} dependent accesses); "
            f"{floor_note(floor_ms)}; {card}")
        del ops, want
    del scratch
    _restore_counts(saved)
    return rows


def phase_lockstep(dev, card, forced, floor_ms):
    """Phase 16: the lockstep_vm kernel against the host loop on the
    card, bit for bit (mem, ret, status, steps, regs, fault), over the
    seeded corpus of ``core/lockstep_corpus.py``: every stock operator
    (remote replies among them), a contended lock, the fault-table rows
    under interp, batched and mixed, fuel below the bound, zero-trip and
    nested loops, and random verified operators, at B of 1, 7, 64, 1024
    and 1500.  Per wave: the macro-steps, both routes' walls and the
    launches."""
    from repro_torch import kernels
    from repro_torch.core import lockstep_corpus as lc
    t0 = time.perf_counter()
    waves = lc.corpus(sizes=lc.SIZES, n_random=40)
    rows, worst = [], 0
    for w in waves:
        eng = w.engine()
        mem = torch.from_numpy(w.mem).to(dev)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        got = eng(mem, *w.args())                   # the main-path call
        torch.cuda.synchronize()
        k_ms = (time.perf_counter() - t) * 1e3
        counts = kernels.launch_counts()
        if counts["lockstep_vm"] != 1 or counts["tiara_gather"]:
            raise AssertionError(f"[lockstep] {w.name}: launches {counts}")
        t = time.perf_counter()
        want = eng.run_host_loop(mem, *w.args())
        torch.cuda.synchronize()
        h_ms = (time.perf_counter() - t) * 1e3
        if not _same_wave(got, want):
            raise AssertionError(f"[lockstep] {w.name}: the kernel differs "
                                 f"from the host loop")
        rows.append(dict(name=w.name, B=w.B,
                         macro_steps=int(got.steps.max()),
                         statuses=sorted({int(s) for s in
                                          got.status.tolist()}),
                         kernel_ms=k_ms, host_loop_ms=h_ms,
                         launches=counts["lockstep_vm"]))
        worst = max(worst, int(got.steps.max()))
        log(f"[lockstep] {w.name}: {rows[-1]['macro_steps']} macro-steps, "
            f"statuses {rows[-1]['statuses']}; kernel {k_ms:.2f} ms "
            f"({counts['lockstep_vm']} launch), host loop {h_ms:.2f} ms; "
            f"bit-equal")
    latency_ns = cold_word_latency_ns(dev)
    counters = lockstep_counters(dev, forced, latency_ns, card,
                                 floor_ms)
    secs = time.perf_counter() - t0
    log(f"[lockstep] phase 16: {len(rows)} waves (B {min(r['B'] for r in rows)}"
        f"..{max(r['B'] for r in rows)}, up to {worst} macro-steps), each "
        f"one lockstep_vm launch and no tiara_gather, bit-equal to the "
        f"host loop; {len(counters)} waves counted; {secs:.1f} s; {card}")
    return dict(rows=rows, seconds=secs, latency_ns=latency_ns,
                counters=counters)


# ---------------------------------------------------------------------------
# Phase 15: the main path's contracts on the card
# ---------------------------------------------------------------------------

#: The engines the word-op fault rows run through (``interp`` takes one
#: post a wave, ``batched`` and ``compiled`` one operator a wave).
CONTRACT_ENGINES = ("interp", "batched", "compiled", "mixed", "segmented",
                    "serial")
#: An out-of-region translation for the gather chain's block table.
WILD_TRANSLATION = 10 ** 12


def _contract_ops(view):
    """Extra operators on phase 3's graph tenant: ``wload`` (reply[p1] =
    graph[p0] read on device p2, a device register), ``rload`` (returns
    reply[p0]) and four 8-word MEMCPYs from graph[0] to reply[p1] whose
    source (``*_src``) or destination (``*_dst``) device is p0, sync and
    async."""
    from repro_torch.core.program import OperatorBuilder as B
    b = B("wload", n_params=3, regions=view)
    x = b.reg()
    b.load(x, "graph", b.param(0), dev=b.param(2))
    b.store(x, "reply", b.param(1))
    b.ret(x)
    out = [b.build()]
    b = B("rload", n_params=1, regions=view)
    x = b.reg()
    b.load(x, "reply", b.param(0))
    b.ret(x)
    out.append(b.build())
    for name in ("rcpy_src", "arcpy_src", "rcpy_dst", "arcpy_dst"):
        b = B(name, n_params=2, regions=view)
        zero = b.const(0)
        dev = {name.split("_")[1] + "_dev": b.param(0)}
        b.memcpy(dst_region="reply", dst_off=b.param(1), src_region="graph",
                 src_off=zero, n_words=8, is_async=name[0] == "a", **dev)
        if name[0] == "a":
            b.wait(0)
        b.ret(b.const(7))
        out.append(b.build())
    return out


def _hog(view):
    """About 2.5M certified cycles (4096 x 4 loads): over the default
    budget of 2**21."""
    from repro_torch.core.program import OperatorBuilder as B
    b = B("hog", n_params=1, regions=view)
    z = b.const(0)
    r = b.reg()
    with b.loop(4096):
        for _ in range(4):
            b.load(r, "graph", z)
    b.ret(r)
    return b.build()


class _Recorded(np.ndarray):
    """A pool that records the ``(device, word)`` of every scalar write
    (pyvm writes the pool only as ``mem[device, word] = value``)."""

    def __setitem__(self, key, value):
        self.writes.append(key)
        super().__setitem__(key, value)


class _Contracts:
    """Phase 15's endpoint: phase 3's layout at real size (the paged-KV
    tenant over 131072 blocks of 8 KiB and the graph tenant over 2**20
    nodes) on two device rows, so that one of them can fail; a host
    mirror of the pool that pyvm replays every wave on; and the checks
    every row shares."""

    def __init__(self, dev, card):
        from repro_torch.core import costmodel as cm
        from repro_torch.core import operators as ops
        from repro_torch.core.endpoint import TiaraEndpoint
        from repro_torch.core.serving_loop import VirtualClock
        from repro_torch.kernels.lockstep_vm import kernel as lv
        from repro_torch.kernels.tiara_gather import kernel as tg
        self.dev, self.card, self.tg, self.lv = dev, card, tg, lv
        self.kv = ops.PagedKVFetch(n_blocks_pool=131072, block_bytes=8192,
                                   max_req_blocks=16, reply_slots=256)
        self.gw = ops.GraphWalk(n_nodes=1 << 20, reply_words=8 * 256)
        self.vc = VirtualClock()
        self.slept = []

        def sleep(s):
            self.slept.append(s)
            self.vc.sleep(s)

        t0 = time.perf_counter()
        self.cost = cm.DispatchCostModel(cm.EngineCost.measured(device=dev))
        self.ep, ss = TiaraEndpoint.for_tenants(
            [("kv", self.kv.regions()), ("gw", self.gw.regions())],
            n_devices=2, device=dev, clock=self.vc, sleep=sleep,
            cost_model=self.cost, retry_limit=3, retry_backoff_s=0.001,
            retry_jitter=0.5, retry_jitter_seed=7)
        self.kvs, self.gws = ss["kv"], ss["gw"]
        host = self.kvs.pool
        self.table = self.kv.populate(host, self.kvs.view, seed=1)
        self.orders = [self.gw.populate(host, self.gws.view, device=d,
                                        seed=2 + d) for d in range(2)]
        self.kvs.register(self.kv.build(self.kvs.view, reply_param=True))
        self.gws.register(self.gw.build(self.gws.view, reply_param=True))
        for prog in _contract_ops(self.gws.view):
            self.gws.register(prog)
        self.blocks = np.random.default_rng(3).choice(
            self.kv.n_blocks_pool, 16, replace=False)
        self.kvs.write_region("req", self.blocks)
        # the host copy the pool was populated in becomes pyvm's mirror
        # (the endpoint lets go of it at the first wave); the words pyvm
        # writes into it are recorded and written into a copy of the
        # pool on the card, which is held to the pool after every wave
        self.mirror_np = host.view(_Recorded)
        self.mirror_np.writes = []
        pool = self.ep.mem                           # upload once
        self.ref = pool.clone()
        self.sync()
        self.rows = {}
        self.slot = 16 * self.kv.block_words
        self.graph_words = self.gws.view["graph"].size
        log(f"[contracts] pool {tuple(pool.shape)} int64 = "
            f"{pool.numel() * 8 / 2**30:.2f} GiB resident on {pool.device} "
            f"(phase 3's layout on two device rows); set-up "
            f"{time.perf_counter() - t0:.1f} s; the card's EngineCost "
            f"launch {self.cost.cost.launch_us:.1f} us")

    # -- shared checks ------------------------------------------------------

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def snap(self):
        """The launch counts of the wave kernels now."""
        return {"tiara_gather": self.tg.COUNTS["tiara_gather"],
                "lockstep_vm": self.lv.COUNTS["lockstep_vm"]}

    def since(self, c0):
        """The wave kernels' launches since the snapshot ``c0``."""
        return {k: v - c0[k] for k, v in self.snap().items()}

    def hold(self, row, cs, failed=(), decision=None, launches=None,
             wall=None, polled=()):
        """Hold the posts of ``cs`` that ran (``event.wave >= 0``) to pyvm
        on the mirror in (wave, seq) order — ret, status, steps,
        registers, FaultInfo — then the whole pool to the mirror bit for
        bit, and every post to exactly one CQE (``polled``: those the
        row already took from the completion queues).  ``launches``: the
        row's launches of each wave kernel (:meth:`since`)."""
        from repro_torch.core import pyvm
        ep = self.ep
        vops = ep.registry.store_ops()
        ran = sorted((c for c in cs if c.event is not None
                      and c.event.wave >= 0),
                     key=lambda c: (c.event.wave, c.seq))
        for c in ran:
            r = pyvm.run(vops[c.op_id], ep.regions, self.mirror_np,
                         list(c.params), home=c.home, failed=set(failed))
            got = (c.ret, c.status, c.steps, c.fault,
                   [int(v) for v in c.regs])
            want = (r.ret, r.status, r.steps, r.fault,
                    [int(v) for v in r.regs])
            if got != want:
                raise AssertionError(f"[contracts] {row}: seq {c.seq} "
                                     f"({c.op_name} {c.params}) {got} != "
                                     f"pyvm {want}")
        self.check_pool(row)
        polled = list(polled) + self.kvs.poll_cq() + self.gws.poll_cq()
        if sorted(c.seq for c in polled) != sorted(c.seq for c in cs) or \
                not all(c.done for c in cs):
            raise AssertionError(f"[contracts] {row}: not exactly one CQE "
                                 f"per post")
        if self.kvs.poll_cq() or self.gws.poll_cq():
            raise AssertionError(f"[contracts] {row}: a CQE retired twice")
        launches = launches or {}
        self.rows[row] = dict(
            engine=decision, tiara_gather=launches.get("tiara_gather"),
            lockstep_vm=launches.get("lockstep_vm"),
            wall_ms=None if wall is None else wall * 1e3, posts=len(cs),
            ran=len(ran), statuses=sorted({int(c.status) for c in cs}))
        log(f"[contracts] {row}: engine {decision}; tiara_gather "
            f"{launches.get('tiara_gather')}, lockstep_vm "
            f"{launches.get('lockstep_vm')}; wave "
            f"{self.rows[row]['wall_ms']:.1f} ms; "
            f"{len(cs)} posts, {len(ran)} ran, == pyvm and the pool bit "
            f"for bit; {self.card}" if wall is not None else
            f"[contracts] {row}: {len(cs)} posts, {len(ran)} ran, == pyvm "
            f"and the pool bit for bit, one CQE each; {self.card}")

    def check_pool(self, row):
        """The whole pool against the pyvm mirror, bit for bit: the words
        written into the mirror since the last check go into its copy on
        the card, and the two pools are compared there."""
        w = self.mirror_np.writes
        if w:
            at = np.unique(np.asarray(w, dtype=np.int64), axis=0)
            vals = np.asarray(self.mirror_np[at[:, 0], at[:, 1]])
            at_t = torch.as_tensor(at, device=self.ref.device)
            self.ref[at_t[:, 0], at_t[:, 1]] = torch.as_tensor(
                vals, device=self.ref.device)
            del w[:]
        pool = self.ep.mem
        if not torch.equal(self.ref, pool):
            bad = torch.nonzero(self.ref != pool)[:4].tolist()
            raise AssertionError(f"[contracts] {row}: pool differs from "
                                 f"the pyvm replay at {bad}")

    def ring(self, **kw):
        """One doorbell: the engine the doorbell ran, its launches of
        each wave kernel and its wall."""
        ep = self.ep
        self.sync()
        d0, c0 = ep.last_decision, self.snap()
        t = time.perf_counter()
        ep.doorbell(**kw)
        ep.wait_all()
        self.sync()
        wall = time.perf_counter() - t
        return self.picked(kw.get("mode", "auto"), d0), self.since(c0), wall

    def picked(self, mode, before):
        """The mode asked for and the engine ``ep.last_decision`` names
        (the last sub-launch's, for a wave run in segments)."""
        d = self.ep.last_decision
        return mode if d is None or d is before else f"{mode} -> {d.mode}"

    def write(self, sess, region, words, offset=0, device=0):
        """A control-path write, to the pool and to the mirror."""
        sess.write_region(region, words, offset=offset, device=device)
        r = sess.view[region]
        for i, v in enumerate(words):
            self.mirror_np[device, r.base + offset + i] = v

    def corrupt(self, triples):
        from repro_torch.core import faults
        self.ep.inject(faults.corrupt_words(triples))
        for d, w, v in triples:          # applied before the next wave
            self.mirror_np[d, w] = v

    def wload(self, k, dev=0, off=None, slot=None):
        off = 8 * k + 3 if off is None else off
        return self.gws.post("wload", [off, 8 * k if slot is None else slot,
                                       dev])

    def expect_fault(self, row, c, *, opcode, device=None, addr=None):
        from repro_torch.core import isa
        f = c.fault
        if c.status != isa.STATUS_PROT_FAULT or f is None or \
                f.opcode != int(opcode) or \
                (device is not None and f.device != device) or \
                (addr is not None and f.addr != addr):
            raise AssertionError(f"[contracts] {row}: seq {c.seq} should "
                                 f"fault ({opcode}, device {device}, addr "
                                 f"{addr}); got status {c.status}, {f}")


def contract_word_faults(K):
    """A wild device register, an out-of-region offset and a word op on a
    failed device, through every engine: the faulting lane halts with
    its writes suppressed, the other lanes' writes land, and the session
    enters the error state with the first fault's FaultInfo."""
    from repro_torch.core import faults
    from repro_torch.core.isa import Op
    kinds = {"wild_device": dict(dev=7), "out_of_region":
             dict(off=K.graph_words + 5), "failed_device": dict(dev=1)}
    for kind, bad in kinds.items():
        for engine in CONTRACT_ENGINES:
            row = f"{kind} / {engine}"
            failed = {1} if kind == "failed_device" else set()
            if failed:
                K.ep.inject(faults.fail_devices(1))
            cs = []
            if engine == "interp":
                cs.append(K.wload(0, **bad))
            else:
                for k in range(8):
                    cs.append(K.wload(k, **bad) if k in (2, 5) else
                              K.wload(k, dev=k % 2 if not failed else 0))
            if engine in ("mixed", "segmented", "serial"):
                o = K.orders[0]
                cs += [K.gws.post("graph_walk", [int(o[i]) * 8, 6,
                                                 512 + 8 * i])
                       for i in range(2)]
                cs += [K.kvs.post("paged_kv_fetch", [16, i * K.slot])
                       for i in range(2)]
            picked, n, wall = K.ring(mode=engine)
            faulted = [c for c in cs if c.faulted]
            want = [cs[0]] if engine == "interp" else [cs[2], cs[5]]
            if faulted != want:
                raise AssertionError(f"[contracts] {row}: faulted "
                                     f"{[c.seq for c in faulted]}")
            for c in want:
                K.expect_fault(row, c, opcode=Op.LOAD,
                               device=7 if kind == "wild_device" else
                               (1 if failed else None))
            if K.gws.error != want[0].fault or K.kvs.in_error:
                raise AssertionError(f"[contracts] {row}: session state")
            if engine in ("interp", "batched", "mixed") and \
                    (n["lockstep_vm"] != 1 or n["tiara_gather"]):
                raise AssertionError(f"[contracts] {row}: the lockstep "
                                     f"wave made {n}, not one lockstep_vm "
                                     f"launch")
            if engine in ("segmented", "serial") and n["tiara_gather"] < 1:
                raise AssertionError(f"[contracts] {row}: the kv posts "
                                     f"launched no tiara_gather")
            K.hold(row, cs, failed, picked, n, wall)
            if engine in ("interp", "batched", "mixed"):
                K.rows[row]["side_by_side"] = side_by_side(
                    f"phase 15's {row}", K.rec.take())
            K.gws.reset()
            K.ep.revive()


def contract_gather_chain(K):
    """An out-of-region translation in the middle of the block table: the
    compiled gather chain launches tiara_gather and commits exactly the
    iterations before the fault, for the lanes that reach it."""
    from repro_torch.core import compile as tc
    from repro_torch.core.isa import Op
    bt = K.kvs.view["blocktable"]
    j = 8
    target = int(K.blocks[j])
    orig = int(K.mirror_np[0, bt.base + target])
    n_blocks = (4, 8, 9, 12, 16, 16, 2, 10)
    for mode, want_n in (("compiled", 1),
                         ("compiled_dbuf", -(-16 // tc.DBUF_CHUNK))):
        row = f"gather_chain_partial_commit / {mode}"
        K.corrupt([(0, bt.base + target, WILD_TRANSLATION)])
        cs = [K.kvs.post("paged_kv_fetch", [n, i * K.slot])
              for i, n in enumerate(n_blocks)]
        picked, n, wall = K.ring(mode=mode)
        if n["tiara_gather"] != want_n:
            raise AssertionError(f"[contracts] {row}: tiara_gather "
                                 f"launched {n} times, expected {want_n}")
        for c, nb in zip(cs, n_blocks):
            if nb > j:
                K.expect_fault(row, c, opcode=Op.MEMCPY, device=0,
                               addr=WILD_TRANSLATION)
            elif not c.ok or c.ret != nb:
                raise AssertionError(f"[contracts] {row}: seq {c.seq}")
        # the faulting lanes committed their first j blocks
        for c in cs[2:4]:
            done = K.kvs.read_region("reply", offset=c.params[1],
                                     count=(j + 1) * K.kv.block_words)
            first = K.kv.reference(K.mirror_np, K.kvs.view, K.table,
                                   K.blocks[:j])
            if not np.array_equal(done[:j * K.kv.block_words], first):
                raise AssertionError(f"[contracts] {row}: partial commit")
        K.hold(row, cs, (), picked, n, wall)
        K.write(K.kvs, "blocktable", [orig], offset=target)
        K.kvs.reset()


def contract_failed_memcpy(K):
    """MEMCPY to or from a failed device, sync and async: STATUS_OK,
    ERR_REG bit 0 set, the copy dropped, execution continues; the same
    copies on the healthy device land."""
    from repro_torch.core import faults, isa
    for engine in ("auto", "serial"):
        row = f"failed_device_memcpy / {engine}"
        K.ep.inject(faults.fail_devices(1))
        cs = []
        for dev in (1, 0):
            for i, op in enumerate(("rcpy_src", "arcpy_src", "rcpy_dst",
                                    "arcpy_dst")):
                cs.append(K.gws.post(op, [dev, 64 + 32 * dev + 8 * i]))
        picked, n, wall = K.ring(mode=engine)
        for c in cs:
            err = int(c.regs[isa.ERR_REG]) & 1
            if not c.ok or c.ret != 7 or err != (c.params[0] == 1):
                raise AssertionError(f"[contracts] {row}: seq {c.seq} "
                                     f"status {c.status} ERR_REG {err}")
        if K.gws.in_error:
            raise AssertionError(f"[contracts] {row}: degraded mode must "
                                 f"not error the session")
        K.hold(row, cs, {1}, picked, n, wall)
        K.ep.revive()


def contract_session_state(K):
    """A torn next-pointer faults a graph walk; the session's later posts
    retire STATUS_FLUSHED at once (``event.wave == -1``) until
    ``reset()``; after the reset and the repair the same walk is ok."""
    from repro_torch.core import isa
    row = "flush_until_reset"
    o = K.orders[0]
    g = K.gws.view["graph"]
    start = int(o[0])
    word = g.base + start * 8 + 1
    orig = int(K.mirror_np[0, word])
    K.corrupt([(0, word, -999_999)])
    bad = K.gws.post("graph_walk", [start * 8, 4, 0])
    picked, n, wall = K.ring()
    if not bad.faulted or K.gws.error != bad.fault:
        raise AssertionError(f"[contracts] {row}: the torn walk")
    flushed = [K.gws.post("graph_walk", [start * 8, 2, 8 * i])
               for i in range(3)]
    if any(not c.done or c.status != isa.STATUS_FLUSHED
           or c.event.wave != -1 for c in flushed):
        raise AssertionError(f"[contracts] {row}: posts in error state")
    if K.ep.outstanding:
        raise AssertionError(f"[contracts] {row}: a flushed post queued")
    K.hold(row, [bad] + flushed, (), picked, n, wall)
    K.gws.reset()
    K.write(K.gws, "graph", [orig], offset=start * 8 + 1)
    healed = K.gws.post("graph_walk", [start * 8, 12, 0])
    picked, n, wall = K.ring()
    if not healed.ok or healed.ret != K.gw.reference(o, start, 12):
        raise AssertionError(f"[contracts] {row}: the healed walk")
    K.hold("reset_and_repair", [healed], (), picked, n, wall)


def contract_split_phase(K):
    """Split-phase retirement of card waves: a ``wait=False`` pair whose
    second wave reads the first's writes, retired by ``wait_any`` then
    ``poll_cq``; a poisoned materialization requeues the wave intact and
    loses no CQE; lost doorbells retry with the seeded jitter, and their
    exhaustion raises with the wave requeued and the pool untouched."""
    from repro_torch.core import faults
    ep = K.ep
    # 1. the pair
    row = "split_phase_pair"
    K.sync()
    c0 = K.snap()
    t = time.perf_counter()
    off = 8 * 77 + 5
    a = [K.wload(0, off=off, slot=200)] + \
        [K.kvs.post("paged_kv_fetch", [16, i * K.slot]) for i in range(2)]
    d0 = ep.last_decision
    h1 = ep.doorbell(wait=False)
    picked = K.picked("auto", d0)
    b = [K.gws.post("rload", [200])]
    h2 = ep.doorbell(wait=False)
    first = ep.wait_any()
    if sorted(c.seq for c in first) != sorted(c.seq for c in a) or \
            not h1.done or any(c.done for c in b):
        raise AssertionError(f"[contracts] {row}: wait_any retired "
                             f"{[c.seq for c in first]}")
    got = K.gws.poll_cq()
    while b[0] not in got:                  # non-blocking, until it lands
        got += K.gws.poll_cq()
    K.sync()
    wall = time.perf_counter() - t
    if not h2.done or b[0].ret != K.mirror_np[0, K.gws.view["graph"].base
                                             + off]:
        raise AssertionError(f"[contracts] {row}: the second wave did not "
                             f"read the first's write")
    if [c.seq for c in got] != [a[0].seq, b[0].seq]:
        raise AssertionError(f"[contracts] {row}: poll_cq gave "
                             f"{[c.seq for c in got]}")
    K.hold(row, a + b, (), picked, K.since(c0), wall,
           polled=got)
    # 2. a poisoned materialization
    row = "poison_materialize"
    cs = [K.kvs.post("paged_kv_fetch", [16, 0]),
          K.gws.post("graph_walk", [int(K.orders[0][3]) * 8, 5, 0])]
    c0, d0 = K.snap(), ep.last_decision
    t = time.perf_counter()
    ep.doorbell(wait=False)
    picked = K.picked("auto", d0)
    ep.inject(faults.poison_materialize(1))
    try:
        ep.wait_all()
    except faults.InjectedEngineError:
        pass
    else:
        raise AssertionError(f"[contracts] {row}: the poison did not fire")
    if any(c.done for c in cs) or ep.in_flight_waves != 1:
        raise AssertionError(f"[contracts] {row}: the wave was lost")
    if ep.wait_all() != len(cs):
        raise AssertionError(f"[contracts] {row}: retry retired the wrong "
                             f"count")
    K.sync()
    K.hold(row, cs, (), picked, K.since(c0),
           time.perf_counter() - t)
    # 3. lost doorbells
    row = "dropped_doorbells"
    del K.slept[:]
    c = K.gws.post("graph_walk", [int(K.orders[0][9]) * 8, 3, 0])
    ep.inject(faults.drop_doorbells(2))
    picked, n, wall = K.ring()
    if not c.ok or len(K.slept) != 2 or \
            not (0.001 <= K.slept[0] <= 0.0015) or \
            not (0.002 <= K.slept[1] <= 0.003):
        raise AssertionError(f"[contracts] {row}: backoffs {K.slept}")
    K.hold(f"{row} / absorbed", [c], (), picked, n, wall)
    c2 = K.kvs.post("paged_kv_fetch", [16, 2 * K.slot])
    ep.inject(faults.drop_doorbells(4))
    try:
        ep.doorbell()
    except faults.TransientError:
        pass
    else:
        raise AssertionError(f"[contracts] {row}: exhaustion did not raise")
    if c2.done or ep.outstanding != 1 or len(K.slept) != 2 + 3:
        raise AssertionError(f"[contracts] {row}: the wave was not "
                             f"requeued")
    K.check_pool(row)                       # untouched by the lost launch
    picked, n, wall = K.ring()
    K.hold(f"{row} / exhausted, then rung", [c2], (), picked, n, wall)


def _drive_loop(K, loop, ceilings):
    """Drain a serving loop by forced pumps, holding each launched wave's
    cost-model price to its summed certified ceiling."""
    while loop.backlog:
        rep = loop.pump(force=True)
        if rep.launched:
            picked = loop._launched[-rep.launched:]
            ceiling = sum(K.ep.registry[c.op_id].certificate.wcet_latency_us
                          for c in picked)
            if rep.predicted_us > ceiling:
                raise AssertionError(f"wave priced {rep.predicted_us} us "
                                     f"over its certified {ceiling} us")
            ceilings.append((rep.predicted_us, ceiling))
        elif loop.backlog:
            K.vc.advance(0.001)
    return loop.drain()


def contract_serving_loop(K):
    """The serving loop on the virtual clock: EAGAIN from an empty token
    bucket, a full admitted queue and a full bounded SQ; shedding over
    the watermark (lowest weight, newest first); TIMEOUT at admission,
    pump and drain; a statically infeasible deadline never launched;
    and the exactly-one-CQE identity."""
    from repro_torch.core import isa
    from repro_torch.core.serving_loop import (ServingConfig, ServingLoop,
                                               TenantQoS)
    ep = K.ep
    ceilings = []

    def identity(row, st, n):
        total = st.executed + st.flushed + st.timed_out + st.rejected \
            + st.shed
        if st.submitted != n or total != st.submitted:
            raise AssertionError(f"[contracts] {row}: CQE identity {st}")

    def run(row, cs, loop, n_submitted):
        K.sync()
        d0, c0 = ep.last_decision, K.snap()
        t = time.perf_counter()
        st = _drive_loop(K, loop, ceilings)
        ep.wait_all()
        K.sync()
        identity(row, st, n_submitted)
        K.hold(row, cs, (), K.picked("auto", d0),
               K.since(c0), time.perf_counter() - t)
        return st

    # 1. admission rejects
    row = "admission_eagain"
    loop = ServingLoop(ep, ServingConfig(max_pending=4, ring_size=64,
                                         ring_age_s=1e9, min_efficiency=2.0),
                       qos={"gw": TenantQoS(rate=10.0, burst=2)})
    ep.max_sq_depth = 1
    a = [loop.submit("gw", "wload", [8 * i + 1, 8 * i, 0])
         for i in range(3)]                          # the bucket empties
    b = [loop.submit("kv", "paged_kv_fetch", [4, i * K.slot])
         for i in range(5)]                          # the queue fills
    d = [K.kvs.post("paged_kv_fetch", [4, (5 + i) * K.slot])
         for i in range(2)]                          # the SQ fills
    ep.max_sq_depth = None
    eagain = [c.rejected and c.event.wave == -1 for c in a + b + d]
    if eagain != [False, False, True] + [False] * 4 + [True, False, True]:
        raise AssertionError(f"[contracts] {row}: EAGAIN {eagain}")
    K.vc.advance(0.1)                                # one token back
    a.append(loop.submit("gw", "wload", [8 * 3 + 1, 8 * 3, 0]))
    run(row, a + b + d, loop, 9)
    # 2. load shedding
    row = "load_shed"
    loop = ServingLoop(ep, ServingConfig(ring_size=64, ring_age_s=1e9,
                                         min_efficiency=2.0,
                                         shed_watermark=6),
                       qos={"gw": TenantQoS(weight=2.0),
                            "kv": TenantQoS(weight=1.0)})
    g = [loop.submit("gw", "wload", [8 * i + 2, 8 * i, 0])
         for i in range(4)]
    k = [loop.submit("kv", "paged_kv_fetch", [4, i * K.slot])
         for i in range(4)]
    rep = loop.pump()
    if rep.shed != 2 or not (k[3].rejected and k[2].rejected) or \
            any(c.done for c in g + k[:2]):
        raise AssertionError(f"[contracts] {row}: shed {rep.shed}")
    st = run(row, g + k, loop, 8)
    if st.shed != 2:
        raise AssertionError(f"[contracts] {row}: stats {st}")
    # 3. deadlines at admission, pump and drain
    row = "deadline_timeout"
    loop = ServingLoop(ep, ServingConfig(ring_size=64, ring_age_s=1e9,
                                         min_efficiency=2.0))
    cs = [loop.submit("gw", "wload", [1, 0, 0], deadline_s=0.0)]
    cs.append(loop.submit("gw", "wload", [2, 8, 0], deadline_s=0.01))
    cs += [loop.submit("kv", "paged_kv_fetch", [16, i * K.slot])
           for i in range(2)]
    K.vc.advance(0.02)
    if loop.pump().timed_out != 1 or not cs[1].timed_out:
        raise AssertionError(f"[contracts] {row}: the pump's sweep")
    late = K.gws.post("wload", [3, 16, 0], deadline_s=0.01)
    K.vc.advance(0.02)
    if ep.doorbell() != 1 or not late.timed_out or late.event.wave != -1:
        raise AssertionError(f"[contracts] {row}: the drain's check")
    if not (cs[0].timed_out and cs[0].event.wave == -1):
        raise AssertionError(f"[contracts] {row}: admission")
    st = run(row, cs + [late], loop, 4)
    if st.timed_out != 2:
        raise AssertionError(f"[contracts] {row}: stats {st}")
    # 4. a statically infeasible deadline, and the check switched off
    op = K.kvs.op_id("paged_kv_fetch")
    wcet_s = ep.registry[op].certificate.wcet_latency_us * 1e-6
    for check in (True, False):
        row = f"wcet_deadline / admission_wcet={check}"
        loop = ServingLoop(ep, ServingConfig(ring_size=2, ring_age_s=0.0,
                                             admission_wcet=check))
        c = loop.submit("kv", "paged_kv_fetch", [16, 0],
                        deadline_s=0.25 * wcet_s)
        if check != (c.done and c.status == isa.STATUS_TIMEOUT
                     and c.event.wave == -1 and loop.stats.launched == 0):
            raise AssertionError(f"[contracts] {row}: {c.status}")
        st = run(row, [c], loop, 1)
        if check == (st.launched != 0):
            raise AssertionError(f"[contracts] {row}: launched "
                                 f"{st.launched}")
    return ceilings


def contract_certificates(K, ceilings):
    """Registration refuses an operator over the budget, naming its pc
    and resource; ``wave_us`` clamps to the certified ceiling on the
    card's measured EngineCost, as every loop wave above was."""
    from repro_torch.core.registry import RegistrationError
    row = "certificate_registration"
    try:
        K.gws.register(_hog(K.gws.view))
    except RegistrationError as e:
        msg = str(e)
    else:
        raise AssertionError(f"[contracts] {row}: the hog registered")
    if not all(s in msg for s in ("hog", "pc", "cycles", "LOAD")):
        raise AssertionError(f"[contracts] {row}: {msg}")
    log(f"[contracts] {row}: refused: {msg.splitlines()[0][:160]}")
    row = "certificate_wave_us"
    m = K.ep.cost_model
    op = K.kvs.op_id("paged_kv_fetch")
    cert_us = K.ep.registry[op].certificate.wcet_latency_us
    vop = K.ep.registry[op].verified
    clamps = []
    for batch in (1, 8, 256):
        free = m.wave_us(batch=batch, step_bound=vop.step_bound, key=op)
        for ceiling in (0.5 * free, batch * cert_us, 10 * free):
            got = m.wave_us(batch=batch, step_bound=vop.step_bound, key=op,
                            cert_ceiling_us=ceiling)
            if got != min(free, ceiling):
                raise AssertionError(f"[contracts] {row}: {got} for "
                                     f"{free} under {ceiling}")
            clamps.append((batch, free, ceiling, got))
    if not ceilings or any(p > c for p, c in ceilings):
        raise AssertionError(f"[contracts] {row}: loop waves {ceilings}")
    log(f"[contracts] {row}: on the card's EngineCost (launch "
        f"{m.cost.launch_us:.1f} us) a paged_kv_fetch wave of 1 / 8 / 256 "
        f"prices {', '.join(f'{c[1]:.1f}' for c in clamps[::3])} us, each "
        f"clamped to its ceiling; {len(ceilings)} loop waves priced at "
        f"most their summed certified WCET; {K.card}")
    K.rows[row] = dict(clamps=clamps, loop_waves=ceilings)


def phase_contracts(dev, card):
    """Phase 15: the fault table, split-phase completion, the serving
    loop's admission and the certificates on a card-resident pool, every
    wave held to pyvm; then the port's quickstart on the card."""
    t0 = time.perf_counter()
    K = _Contracts(dev, card)
    with _LockstepWaves() as K.rec:
        contract_word_faults(K)
    contract_gather_chain(K)
    contract_failed_memcpy(K)
    contract_session_state(K)
    contract_split_phase(K)
    ceilings = contract_serving_loop(K)
    contract_certificates(K, ceilings)
    rows, n_rows = K.rows, len(K.rows)
    rows_s = time.perf_counter() - t0
    del K                                  # the pool and its mirror
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    quick = _load_file("examples/quickstart_torch.py").main(
        ["--device", str(dev)])
    quick_s = time.perf_counter() - t
    log(f"[contracts] phase 15: {rows_s:.1f} s for {n_rows} rows "
        f"(set-up included), quickstart_torch on the card {quick_s:.1f} s "
        f"({quick['walls']}); {card}")
    return dict(rows=rows, seconds=rows_s, quickstart=quick,
                quickstart_s=quick_s)


# ---------------------------------------------------------------------------
# Phase 13: the sharded pool and the distributed layer
# ---------------------------------------------------------------------------


def _mesh_note(mesh) -> str:
    devs = sorted({str(d) for d in mesh.flat_devices})
    axes = " x ".join(f"{a} {n}" for a, n in mesh.shape.items())
    return f"{mesh.size} shards ({axes}), every one on {', '.join(devs)}"


def _acceptance_tenant(s, n_homes):
    """The reference's acceptance operators (tests/test_sharded.py) on one
    tenant: sum2, cas_latch, store_latch, rcpy (cross-home MEMCPY) and
    rcas (cross-home CAS), and each home's data region."""
    from repro_torch.core.program import OperatorBuilder as B
    rt = s.view
    b = B("sum2", n_params=2, regions=rt)
    x, y = b.reg(), b.reg()
    b.load(x, "data", b.param(0))
    b.load(y, "data", b.param(0), disp=1)
    b.add(x, x, y)
    b.store(x, "reply", b.param(1))
    b.ret(x)
    s.register(b.build())
    b = B("cas_latch", n_params=1, regions=rt)
    zero = b.const(0)
    old = b.reg()
    b.cas(old, "latch", zero, cmp=zero, swap=b.param(0))
    b.ret(old)
    s.register(b.build())
    b = B("store_latch", n_params=1, regions=rt)
    one = b.const(1)
    b.store(b.param(0), "latch", one)
    b.ret(b.param(0))
    s.register(b.build())
    b = B("rcpy", n_params=3, regions=rt)
    b.memcpy(dst_region="reply", dst_off=b.param(1), src_region="data",
             src_off=b.param(0), n_words=4, src_dev=b.param(2))
    b.ret(b.param(1))
    s.register(b.build())
    b = B("rcas", n_params=2, regions=rt)
    zero = b.const(0)
    old = b.reg()
    b.cas(old, "latch", zero, cmp=zero, swap=b.param(0), disp=2,
          dev=b.param(1))
    b.ret(old)
    s.register(b.build())
    for d in range(n_homes):
        s.write_region("data", np.arange(10, 74, dtype=np.int64) * (d + 1),
                       device=d)


def _acceptance_posts(sessions, n, n_homes, rng):
    """``n`` posts of the reference's acceptance mix over ``n_homes``
    homes: sum2 words in reply[0..512), rcpy windows in reply[512..1024),
    contention on the latches (tests/test_sharded.py:491)."""
    posts, n_sum, n_cpy = [], [0] * 4, [0] * 4
    for i in range(n):
        t = i % 4
        s = sessions[t]
        home = int(rng.integers(0, n_homes))
        kind = i % 8
        if kind < 3:
            posts.append((s, "sum2", [int(rng.integers(0, 60)),
                                      n_sum[t] % 512], home))
            n_sum[t] += 1
        elif kind < 5:
            posts.append((s, "rcpy", [int(rng.integers(0, 60)),
                                      512 + 4 * (n_cpy[t] % 128),
                                      int(rng.integers(0, n_homes))], home))
            n_cpy[t] += 1
        elif kind == 5:
            posts.append((s, "cas_latch", [10_000 + i], home))
        elif kind == 6:
            posts.append((s, "store_latch", [20_000 + i], home))
        else:
            posts.append((s, "rcas", [30_000 + i,
                                      int(rng.integers(0, n_homes))], home))
    return posts


def _hold_wave(tag, ep, cs, dense, replay, span):
    """A wave's CQEs and pool against the dense mixed engine's result on
    the same input (every field, the whole pool on the card) and against
    the pyvm replay (ret, status, steps; the pool over ``span``, the
    words the wave's tenants own)."""
    from repro_torch.distributed.mesh import Sharded
    lo, hi = span
    pool = ep._dev_mem
    rows = pool.shards if isinstance(pool, Sharded) \
        else [pool[d][None] for d in range(pool.shape[0])]
    for d, row in enumerate(rows):
        if not torch.equal(row[0], dense.mem[d]):
            raise AssertionError(f"{tag}: row {d} differs from the dense "
                                 f"mixed engine's")
        if not np.array_equal(row[0, lo:hi].cpu().numpy(),
                              replay[0][d, lo:hi]):
            raise AssertionError(f"{tag}: row {d} differs from the pyvm "
                                 f"replay")
    for i, c in enumerate(cs):
        want = (int(dense.ret[i]), int(dense.status[i]),
                int(dense.steps[i]))
        if (c.ret, c.status, c.steps) != want \
                or not np.array_equal(c.regs, dense.regs[i]):
            raise AssertionError(f"{tag}: seq {c.seq} differs from the "
                                 f"dense mixed engine")
        if (c.ret, c.status, c.steps) != replay[1][c.seq]:
            raise AssertionError(f"{tag}: seq {c.seq} differs from pyvm")


def _replay(ep, host, cs):
    """pyvm over ``cs`` in arrival order on the host pool, in place;
    returns the pool, each post's (ret, status, steps) and, from pyvm's
    traces, the pool bytes the wave's instructions move (8 a LOAD or
    STORE, 16 a CAS or CAA, 16 a MEMCPY word) and the most LOAD, CAS, CAA
    and MEMCPY instructions one post executes (each waits for a word of
    the pool before the post can go on)."""
    from repro_torch.core import pyvm
    from repro_torch.core.isa import Op
    vops = ep.registry.store_ops()
    per_op = {Op.LOAD: 8, Op.STORE: 8, Op.CAS: 16, Op.CAA: 16}
    waits = (Op.LOAD, Op.CAS, Op.CAA, Op.MEMCPY)
    out, moved, dependent = {}, 0, 0
    for c in sorted(cs, key=lambda c: c.seq):
        r = pyvm.run(vops[c.op_id], ep.regions, host, list(c.params),
                     home=c.home, record_trace=True)
        out[c.seq] = (r.ret, r.status, r.steps)
        for ev in r.trace:
            moved += 16 * ev.n_words if ev.op == Op.MEMCPY else \
                per_op.get(ev.op, 0)
        dependent = max(dependent, sum(ev.op in waits for ev in r.trace))
    return host, out, dict(pool_bytes=moved, dependent=dependent)


class _KernelCalls:
    """Records the operands of every ``lockstep_vm`` launch the engines
    of ``core.vm`` make inside the block (each call forwarded
    unchanged)."""

    def __enter__(self):
        from repro_torch.core import vm
        self.ops = []
        self._orig = orig = vm.lockstep_vm_kernel

        def rec(**operands):
            self.ops.append(operands)
            return orig(**operands)
        vm.lockstep_vm_kernel = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.core import vm
        vm.lockstep_vm_kernel = self._orig


SHARDED_REPLACES = "src/repro/core/vm.py:1297"


def sharded_host_loop(ep, mesh, cs, pre, replay):
    """13 (a)'s plain version: the acceptance wave again through the
    sharded engine's host loop (``impl="torch"``: ``shard_map`` over the
    mesh, collectives, ``tiara_gather`` owner reads) on the pool as the
    wave found it (``pre``), held bit for bit to the kernel route's
    result through the endpoint — every shard's row, and each CQE in
    arrival order (ret, status, steps, registers, fault) — and to the
    pyvm replay.  Its launches are a yardstick's: taken back out of the
    counts."""
    from repro_torch import kernels
    from repro_torch.core import compile as tc
    from repro_torch.core import vm
    saved = kernels.launch_counts()
    ids = [c.op_id for c in cs]
    homes = [c.home for c in cs]
    plan = tc.plan_mixed_batch(ids, homes=homes, n_devices=mesh.size)
    mesh.reset_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    hl = vm.invoke_sharded_mixed(
        ep.registry.store_ops(), ep.regions, pre, plan,
        [list(c.params) for c in cs], mesh=mesh,
        static_noconflict=bool(ep.registry.last_noconflict), impl="torch")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    gathers = kernels.launch_counts()["tiara_gather"] \
        - saved["tiara_gather"]
    _restore_counts(saved)
    for d, row in enumerate(ep._dev_mem.shards):
        if not torch.equal(row, hl.mem.shards[d]):
            raise AssertionError(f"[sharded] row {d}: the kernel route "
                                 f"differs from the host loop")
    if [c.seq for c in cs] != sorted(c.seq for c in cs):
        raise AssertionError("[sharded] CQEs out of arrival order")
    fields = np.asarray([[c.ret, c.status, c.steps, *c.regs] for c in cs])
    err = int(np.abs(fields - np.concatenate(
        [np.stack([hl.ret, hl.status, hl.steps], 1), hl.regs], 1)).max())
    for i, c in enumerate(cs):
        want = (int(hl.ret[i]), int(hl.status[i]), int(hl.steps[i]),
                vm.fault_info(hl.fault[i]))
        if (c.ret, c.status, c.steps, c.fault) != want \
                or not np.array_equal(c.regs, hl.regs[i]):
            raise AssertionError(f"[sharded] seq {c.seq}: the kernel "
                                 f"route differs from the host loop")
        if want[:3] != replay[1][c.seq]:
            raise AssertionError(f"[sharded] seq {c.seq}: the host loop "
                                 f"differs from pyvm")
    return dict(wall_s=wall, tiara_gather=gathers, max_abs_err=err,
                collectives=mesh.collective_counts(),
                collective_bytes=mesh.collective_bytes())


def sharded_kernel_row(ops, span, pre, scratch, floor_ms, latency_ns,
                       stats):
    """The sharded form's ``lockstep_vm`` row at the acceptance wave: the
    launch alone on the wave's own operands (``ops``, as the engine
    packed them), on copies of the shards' rows whose span of tenant
    words is put back to the pool as the wave found it (``pre``) before
    every call, outside the events (the wave writes its latches and
    replies, nothing else); equal to the endpoint's result after each
    call; its byte bound (the tables and inputs read once, the outputs
    written once and the pool words of ``stats``) and its latency bound
    (the longest post's dependent pool accesses times ``latency_ns``),
    beside the launch floor.  The timed launches are not counted."""
    from repro_torch import kernels
    from repro_torch.kernels.lockstep_vm.kernel import lockstep_vm_kernel
    saved = kernels.launch_counts()
    lo, hi = span
    rows = [r.clone() for r in ops["rows"]]
    want = [r[lo:hi].clone() for r in ops["rows"]]
    inputs = ops["inputs"].clone()
    n_dev = len(rows)
    inputs[-n_dev:] = torch.tensor([r.data_ptr() for r in rows],
                                   dtype=torch.int64)
    run = dict(ops, rows=rows, inputs=inputs)

    def setup():
        for d, r in enumerate(rows):
            r[lo:hi].copy_(pre[d, lo:hi])
    ms = time_cuda(lambda: lockstep_vm_kernel(**run), scratch,
                   setup=setup)
    torch.cuda.synchronize()
    if not all(torch.equal(r[lo:hi], w) for r, w in zip(rows, want)):
        raise AssertionError("[sharded] the timed launches differ from the "
                             "wave's")
    # the clocks build on the same wave: its macro-steps, serial lane
    # steps and thread 0's cycles a macro-step in each phase
    setup()
    out = lockstep_vm_kernel(**run)
    setup()
    clocks = phase_clocks(run, out)
    _restore_counts(saved)
    B = int(ops["B"])
    tables = sum(ops[k].numel() for k in ("code", "rbase", "rmask",
                                           "slot_start", "slot_end",
                                           "slot_fuel", "inputs"))
    moved = 8 * tables + B * (3 + 16 + 4) * 8 + stats["pool_bytes"]
    del rows, inputs, run
    torch.cuda.empty_cache()
    return dict(B=B, ms=ms, launch_floor_ms=floor_ms, bytes_moved=moved,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                dependent_accesses=stats["dependent"],
                latency_bound_ms=stats["dependent"] * latency_ns * 1e-6,
                clocks=clocks)


def sharded_call_walls(ep, mesh, cs, pre):
    """Where the acceptance wave's doorbell wall goes: the host wall of
    ``vm.invoke_sharded_mixed`` on the kernel route called directly (the
    plan, the marshalling, the private row copies, the launch, the
    scatter and the fields' copy to the host), and of the private row
    copies alone; each the median of 3 calls ended by a device sync.  The
    launches are taken back out of the counts."""
    from repro_torch import kernels
    from repro_torch.core import compile as tc
    from repro_torch.core import memory, vm
    saved = kernels.launch_counts()
    ids = [c.op_id for c in cs]
    params = [list(c.params) for c in cs]
    sh = memory.shard_pool(pre, mesh, "pool")

    def invoke():
        plan = tc.plan_mixed_batch(ids, homes=[c.home for c in cs],
                                   n_devices=mesh.size)
        return vm.invoke_sharded_mixed(
            ep.registry.store_ops(), ep.regions, sh, plan, params,
            mesh=mesh, static_noconflict=bool(ep.registry.last_noconflict),
            impl="cuda")
    invoke_ms, out = _wall(invoke)
    for d, row in enumerate(ep._dev_mem.shards):
        if not torch.equal(row, out.mem.shards[d]):
            raise AssertionError("[sharded] a direct kernel-route call "
                                 "differs from the doorbell's wave")
    del out
    copies_ms, rows = _wall(lambda: [vm.private_pool(r) for r in sh.shards])
    del rows
    _restore_counts(saved)
    torch.cuda.empty_cache()
    return dict(invoke_ms=invoke_ms, copies_ms=copies_ms)


def sharded_endpoint(dev, floor_ms, latency_ns):
    """13 (a): phase 3's region table on a pool of SHARDS rows, sharded
    over a mesh of SHARDS shards of the card, and the reference's
    acceptance wave through ``doorbell(placement="sharded")`` — one
    ``lockstep_vm`` launch over the shards' rows, no collective, no
    ``tiara_gather`` — then through the sharded host loop
    (``sharded_host_loop``), each held to the other, to the dense mixed
    engine and to pyvm, the kernel timed alone (``sharded_kernel_row``);
    then ``"auto"``; then a failed device under ``"auto"``."""
    from repro_torch.core import faults, isa, memory, vm
    from repro_torch.core import operators as ops
    from repro_torch.core.endpoint import TiaraEndpoint
    from repro_torch.distributed.mesh import Sharded, make_device_mesh
    from repro_torch.kernels.lockstep_vm import kernel as lk
    from repro_torch.kernels.tiara_gather import kernel as tg

    mesh = make_device_mesh(SHARDS, devices=[dev] * SHARDS)
    log(f"[sharded] mesh: {_mesh_note(mesh)}")
    kv = ops.PagedKVFetch(n_blocks_pool=131072, block_bytes=8192,
                          max_req_blocks=16, reply_slots=256)
    gw = ops.GraphWalk(n_nodes=1 << 20, reply_words=8 * 256)
    layout = memory.packed_table([("latch", 8), ("data", 64),
                                  ("reply", 1024)])
    t0 = time.perf_counter()
    ep, ss = TiaraEndpoint.for_tenants(
        [("kv", kv.regions()), ("gw", gw.regions())]
        + [(f"t{i}", layout) for i in range(4)],
        n_devices=SHARDS, device=dev, mesh=mesh)
    host = ss["kv"].pool                    # host copy, authoritative
    kv.populate(host, ss["kv"].view, seed=1)
    gw.populate(host, ss["gw"].view, seed=2)
    sessions = [ss[f"t{i}"] for i in range(4)]
    for s in sessions:
        _acceptance_tenant(s, SHARDS)
    lo = ss["t0"].view["latch"].base
    hi = ss["t3"].view["reply"].base + 1024
    pool0 = ep.mem                          # upload once
    torch.cuda.synchronize()
    log(f"[sharded] pool {tuple(pool0.shape)} int64 = "
        f"{pool0.numel() * 8 / 2**30:.2f} GiB ({SHARDS} x "
        f"{pool0[0].numel() * 8 / 2**30:.2f} GiB rows; kv + graph walk + 4 "
        f"tenants of latch/data/reply) on {pool0.device}; set-up "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(7)
    walls, rec = {}, {}

    def wave(name, placement, posts, pre):
        """Post, take the yardsticks from ``pre`` (the pool as the wave
        finds it), ring, hold."""
        cs = [s.post(op, p, home=h) for s, op, p, h in posts]
        ids = [c.op_id for c in cs]
        dense = vm.invoke_batched_mixed(
            ep.registry.store_ops(), ep.regions, pre, ids,
            [list(c.params) for c in cs], homes=[c.home for c in cs])
        replay = _replay(ep, host, cs)
        torch.cuda.synchronize()
        mesh.reset_stats()
        n0 = tg.COUNTS["tiara_gather"]
        w0 = lk.COUNTS["lockstep_vm"]
        kcalls = _KernelCalls()
        with kcalls:
            t = time.perf_counter()
            ep.doorbell(placement=placement)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t
        launches = tg.COUNTS["tiara_gather"] - n0
        waves = lk.COUNTS["lockstep_vm"] - w0
        _hold_wave(name, ep, cs, dense, replay, (lo, hi))
        sharded = isinstance(ep._dev_mem, Sharded)
        dec = ep.last_placement
        kops[name] = kcalls.ops
        rec[name] = dict(
            posts=len(cs), wall_s=walls[name], launches=launches,
            lockstep_vm=waves, ran="sharded" if sharded else "single",
            decision=None if dec is None else dict(mode=dec.mode,
                                                   costs=dec.costs),
            collectives=mesh.collective_counts(),
            collective_bytes=mesh.collective_bytes(),
            ok=sum(c.ok for c in cs))
        log(f"[sharded] {name}: {len(cs)} posts (4 tenants, homes over "
            f"{SHARDS}) placement={placement} -> ran "
            f"{rec[name]['ran']}"
            + ("" if dec is None else f" (cost model {dec.mode}: "
               f"{ {k: round(v, 1) for k, v in dec.costs.items()} } us)")
            + f"; wave wall {walls[name] * 1e3:.1f} ms; lockstep_vm "
            f"launches {waves}, tiara_gather launches {launches}; "
            f"collectives {rec[name]['collectives']}, bytes read across "
            f"shards {rec[name]['collective_bytes']}; == dense mixed "
            f"engine (whole pool, every CQE field) and == pyvm replay "
            f"({rec[name]['ok']} ok)")
        del dense
        return cs, replay

    kops = {}
    cs, replay = wave("sharded", "sharded",
                      _acceptance_posts(sessions, SHARDED_POSTS, SHARDS,
                                        rng), pool0)
    r = rec["sharded"]
    if r["ran"] != "sharded" or r["lockstep_vm"] != 1 \
            or r["launches"] != 0 or r["collectives"]:
        raise AssertionError(
            f"the sharded wave on a mesh of one card did not run as one "
            f"lockstep_vm launch without tiara_gather or a collective: "
            f"{r['lockstep_vm']} lockstep_vm, {r['launches']} tiara_gather, "
            f"collectives {r['collectives']}")
    hl = rec["host_loop"] = sharded_host_loop(ep, mesh, cs, pool0, replay)
    walls_a = rec["call_walls"] = sharded_call_walls(ep, mesh, cs, pool0)
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)
    krow = rec["kernel_row"] = sharded_kernel_row(
        kops["sharded"][0], (lo, hi), pool0, scratch, floor_ms, latency_ns,
        replay[2])
    krow.update(max_abs_err=hl.pop("max_abs_err"),
                plain_ms=hl["wall_s"] * 1e3, wall_ms=r["wall_s"] * 1e3,
                macro_steps=max(c.steps for c in cs))
    del scratch, cs, replay
    log(f"[sharded] acceptance wave, kernel route: one lockstep_vm launch "
        f"over {SHARDS} row buffers, {krow['B']} lanes in arrival order: "
        f"kernel {krow['ms'] * 1e3:.1f} us ({floor_note(floor_ms)}); the "
        f"wave's host wall through the doorbell {r['wall_s'] * 1e3:.1f} ms "
        f"(the {SHARDS} private row copies and marshalling included); "
        f"bound {krow['bound_ms'] * 1e3:.3f} us ({krow['bytes_moved']} "
        f"bytes at 3.35 TB/s), latency bound "
        f"{krow['latency_bound_ms'] * 1e3:.2f} us "
        f"({krow['dependent_accesses']} dependent pool accesses at "
        f"{latency_ns:.1f} ns); host loop {hl['wall_s'] * 1e3:.1f} ms with "
        f"{hl['tiara_gather']} tiara_gather launches and collectives "
        f"{hl['collectives']}; bit-equal (every row, every CQE field in "
        f"arrival order) and == pyvm; {card_line()}")
    ck = krow["clocks"]
    log(f"[sharded] the acceptance wave on the clocks build: "
        f"{ck['macro_steps']} macro-steps, {ck['serial_lane_steps']} serial "
        f"lane steps; thread 0's cycles a macro-step "
        + ", ".join(f"({k}) {ck['cycles_per_step'][k]:.0f}" for k in "abcde")
        + f"; of the doorbell's {r['wall_s'] * 1e3:.1f} ms, "
        f"vm.invoke_sharded_mixed called directly takes "
        f"{walls_a['invoke_ms']:.1f} ms, of which the {SHARDS} private row "
        f"copies {walls_a['copies_ms']:.1f} ms")
    del pool0
    torch.cuda.empty_cache()
    pre = vm.as_pool(ep._dev_mem)           # the dense yardstick's input
    wave("auto", "auto", _acceptance_posts(sessions, SHARDED_POSTS, SHARDS,
                                           rng), pre)
    del pre, kops
    torch.cuda.empty_cache()

    # a failed device: "auto" must run single, the posts homed there fault
    dead = SHARDS - 1
    ep.inject(faults.fail_devices(dead))
    posts = _acceptance_posts(sessions, 64, SHARDS, rng)
    cs = [s.post(op, p, home=h) for s, op, p, h in posts]
    ep.doorbell(placement="auto")
    dec = ep.last_placement
    if dec.mode != "single" or "sharded" in dec.costs:
        raise AssertionError(f"auto placed a wave on a mesh with a failed "
                             f"device: {dec.mode} {dec.costs}")
    word = [c for c in cs if c.home == dead
            and c.op_name in ("sum2", "cas_latch", "store_latch")]
    if not word or not all(c.faulted and c.fault.device == dead
                           for c in word):
        raise AssertionError("a word op homed on the failed device did "
                             "not fault")
    degraded = [c for c in cs if c.home == dead and c.op_name == "rcpy"]
    if not all(c.ok and int(c.regs[isa.ERR_REG]) & 1 for c in degraded):
        raise AssertionError("a MEMCPY into the failed device did not "
                             "take the degraded path")
    ep.revive(dead)
    for s in sessions:
        s.reset()
    again = [c.session.post(c.op_name, list(c.params), home=c.home)
             for c in word]
    ep.doorbell(placement="auto")
    if not all(c.ok for c in again) \
            or "sharded" not in ep.last_placement.costs:
        raise AssertionError("revive() + reset() did not recover")
    log(f"[sharded] device {dead} failed: placement=auto -> {dec.mode} "
        f"(no sharded candidate); {len(word)} word-op posts homed there "
        f"faulted on device {dead}, {len(degraded)} MEMCPYs into it "
        f"degraded (ERR_REG); revive() + reset(): the {len(again)} posts "
        f"ok again, the mesh a candidate again")
    rec["failed_device"] = dict(faulted=len(word), degraded=len(degraded),
                                recovered=len(again))
    del ep, ss, sessions, host
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def sharded_serving(dev, single_step_ms):
    """13 (b): tiny-lm at full width served with its block tables resolved
    over SHARDS homes on the mesh: ServingEngine(resolver="tiara",
    n_homes=SHARDS, placement="sharded") against resolver="host", tokens
    equal, a region rehomed mid-run; every decode step's resolver wave is
    one ``lockstep_vm`` launch over the shards' rows."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed.mesh import Sharded, make_device_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    cfg = get_config("tiny-lm")
    params = tf.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(17)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, n)))
               for n in rng.permutation(SHARDED_PLENS)]

    def engine(**kw):
        return ServingEngine(cfg, params, max_slots=len(prompts),
                             max_seq=SERVE_MAX_SEQ, eos_id=-1,
                             temperature=0.0, device=dev, **kw)

    host = engine()
    for p in prompts:
        host.submit(p, max_new=SHARDED_NEW)
    want = host.run_to_completion()
    del host
    mesh = make_device_mesh(SHARDS, devices=[dev] * SHARDS)
    eng = engine(resolver="tiara", n_homes=SHARDS, placement="sharded",
                 rehome_every=2, mesh=mesh)
    timed = _Timed(eng)
    kernels.reset_launch_counts()           # the sharded serving path
    mesh.reset_stats()
    t = time.perf_counter()
    hs = [eng.submit(p, max_new=SHARDED_NEW) for p in prompts]
    out = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()         # ... ends here
    aud = eng.resolver_audit()
    if out != want or not all(h.ok for h in hs):
        raise AssertionError("sharded tiara serving: tokens differ from the "
                             "host resolver's")
    if aud["rehomes"] < 1 or not isinstance(eng.resolver.ep._dev_mem,
                                            Sharded):
        raise AssertionError("sharded tiara serving: no rehome, or the pool "
                             "did not stay sharded")
    if min(timed.step_waves) < 1:
        raise AssertionError("sharded tiara serving: a decode step launched "
                             "no lockstep_vm")
    step = float(np.median(timed.step_ms))
    r = dict(requests=len(prompts), new=SHARDED_NEW, wall_s=wall,
             step_ms=list(timed.step_ms), step_ms_median=step,
             single_step_ms_median=single_step_ms, counts=counts,
             step_lockstep_vm=list(timed.step_waves),
             step_tiara_gather=list(timed.step_gathers),
             collectives=mesh.collective_counts(),
             collective_bytes=mesh.collective_bytes(),
             rehomes=int(aud["rehomes"]),
             rehomed_words=int(aud["rehomed_words"]),
             cross_device_words=int(aud["cross_device_words"]))
    log(f"[sharded] tiny-lm served over {SHARDS} homes (mesh: "
        f"{_mesh_note(mesh)}): {len(prompts)} requests (prompts "
        f"{min(SHARDED_PLENS)}..{max(SHARDED_PLENS)}), {SHARDED_NEW} new "
        f"tokens each, tokens == host resolver's; {len(timed.step_ms)} decode "
        f"steps, median {step:.2f} ms (phase 5's single-placement tiara "
        f"step: {single_step_ms:.1f} ms); launches a step: lockstep_vm "
        f"{timed.step_waves}, tiara_gather {timed.step_gathers}; launches "
        f"{counts}; rehomes "
        f"{r['rehomes']} ({r['rehomed_words']} words), cross-device words "
        f"{r['cross_device_words']}; collectives {r['collectives']}; "
        f"{wall:.1f} s")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return r


def _wall(fn, reps=3):
    """Median host wall of ``fn`` over ``reps`` calls, each ended by a
    device sync; returns (ms, the last result)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times)), out


def sharded_fetch(dev):
    """13 (c) tiara_fetch: a 1 GiB f32 pool of 8 KiB rows with its
    co-partitioned table over SHARDS shards, FETCH_IDS ids per shard."""
    from repro_torch.distributed import mesh as dmesh
    from repro_torch.distributed import tiara_fetch as tfetch
    from repro_torch.kernels.tiara_gather import kernel as tg
    mesh = dmesh.make_device_mesh(SHARDS, devices=[dev] * SHARDS)
    n, R = FETCH_ROWS, FETCH_ROW_FLOATS
    g = torch.Generator(dev).manual_seed(5)
    pool = torch.randn((n, R), generator=g, device=dev)
    t_shard = n // SHARDS
    table = torch.cat([s * t_shard + torch.randperm(t_shard, generator=g,
                                                    device=dev)
                       for s in range(SHARDS)]).to(torch.int32)
    ids = torch.randint(0, n, (SHARDS * FETCH_IDS,), generator=g,
                        device=dev, dtype=torch.int32)
    want = pool[table[ids].long()]
    fetch = tfetch.make_tiara_fetch(mesh, "pool", n, n, FETCH_QUOTA)
    out = fetch(table, pool, ids)
    if not torch.equal(out.full(), want):
        raise AssertionError("tiara_fetch != pool[table[ids]] (a quota "
                             "dropped a row?)")
    mesh.reset_stats()
    n0 = tg.COUNTS["tiara_gather"]
    ms, _ = _wall(lambda: fetch(table, pool, ids))
    launches = (tg.COUNTS["tiara_gather"] - n0) // 3
    counts = {k: v // 3 for k, v in mesh.collective_counts().items()}
    nbytes = {k: v // 3 for k, v in mesh.collective_bytes().items()}
    if counts != {"all-to-all": 2} or launches != SHARDS:
        raise AssertionError(f"tiara_fetch: collectives {counts}, "
                             f"tiara_gather launches {launches}")
    mesh.reset_stats()
    base_ms, base = _wall(lambda: tfetch.client_side_fetch(
        mesh, "pool", table, pool, ids))
    bcounts = {k: v // 3 for k, v in mesh.collective_counts().items()}
    bbytes = {k: v // 3 for k, v in mesh.collective_bytes().items()}
    if not torch.equal(base.full(), want) or sum(bcounts.values()) < 3:
        raise AssertionError(f"client_side_fetch: {bcounts}")
    log(f"[sharded] tiara_fetch: {n} rows of {R * 4} B (f32 pool "
        f"{pool.numel() * 4 / 2**30:.2f} GiB) and its co-partitioned table "
        f"over {_mesh_note(mesh)}, {FETCH_IDS} ids per shard, quota "
        f"{FETCH_QUOTA}: == pool[table[ids]] bit for bit; one round "
        f"{ms:.2f} ms host wall, collectives {counts}, bytes read across "
        f"shards {nbytes}, tiara_gather {launches} launches (one per "
        f"owner); client-side {base_ms:.2f} ms, collectives {bcounts}, "
        f"bytes {bbytes}")
    del pool, table, ids, want, out, base
    torch.cuda.empty_cache()
    return dict(ms=ms, collectives=counts, bytes=nbytes, launches=launches,
                client_ms=base_ms, client_collectives=bcounts,
                client_bytes=bbytes)


def sharded_decode(dev):
    """13 (c) sharded_paged_attention: tiny-lm's decode steps at full
    width on a 2 x 2 ("data", "model") mesh, pages per shard, against the
    unsharded steps (the paged_attention kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import mesh as dmesh
    from repro_torch.distributed import paged_decode
    from repro_torch.models import transformer as tf
    cfg = get_config("tiny-lm")
    params = tf.init_params(cfg, seed=0, device=dev)
    b, maxp = 4, DECODE_PAGES
    g = torch.Generator(dev).manual_seed(9)
    caches = tf.init_caches(cfg, b, maxp, device=dev)
    for c in caches:
        for pages in c.paged:
            pages.copy_(torch.randn(pages.shape, generator=g, device=dev)
                        * 0.1)
    bt = tf.default_block_tables(cfg, b, maxp, device=dev)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    toks = [torch.randint(1, cfg.vocab, (b, 1), generator=g, device=dev)
            for _ in range(DECODE_STEPS)]

    def clone(cs):
        return tuple(c._replace(paged=type(c.paged)(
            *(p.clone() for p in c.paged))) for c in cs)

    def run(cfg_, cs):
        logits, ms = [], []
        for i, tk in enumerate(toks):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = tf.decode_step(params, cfg_, {
                "tokens": tk, "caches": cs, "block_tables": bt,
                "lengths": lengths + i})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            logits.append(out.logits)
            cs = out.caches
        return logits, cs, ms

    base, base_caches, base_ms = run(cfg, clone(caches))
    mesh = dmesh.make_mesh((2, 2), ("data", "model"), [dev] * 4)
    res = {}
    for contiguous in (False, True):
        fn = paged_decode.sharded_paged_attention(
            mesh, ("data",), "model", contiguous=contiguous)
        sc = paged_decode.shard_pages(mesh, clone(caches),
                                      ("data", "model"))
        ptrs = [s.data_ptr() for s in sc[0].paged.k_pages.shards]
        mesh.reset_stats()
        got, out_caches, ms = run(cfg.replace(paged_attn_fn=fn), sc)
        err = max(float((a - w).abs().max()) for a, w in zip(got, base))
        kp = out_caches[0].paged.k_pages
        if err > DECODE_TOL or not all(bool(torch.isfinite(a).all())
                                       for a in got):
            raise AssertionError(f"sharded decode (contiguous="
                                 f"{contiguous}): logits differ by {err:.3g}")
        if not isinstance(kp, dmesh.Sharded) \
                or [s.data_ptr() for s in kp.shards] != ptrs:
            raise AssertionError("sharded decode: the pages left their "
                                 "shards")
        page_err = float((kp.full() - base_caches[0].paged.k_pages)
                         .abs().max())
        res[f"contiguous={contiguous}"] = dict(
            max_abs_err=err, page_max_abs_err=page_err, step_ms=ms,
            collectives={k: v // DECODE_STEPS
                         for k, v in mesh.collective_counts().items()},
            bytes={k: v // DECODE_STEPS
                   for k, v in mesh.collective_bytes().items()})
        log(f"[sharded] tiny-lm decode, {DECODE_STEPS} steps of batch {b} "
            f"(lengths {DECODE_LENGTHS}, {maxp} pages of {cfg.page_size} "
            f"each), pages over ({_mesh_note(mesh)}), contiguous="
            f"{contiguous}: logits max |diff| {err:.3g} vs the unsharded "
            f"step (the paged_attention kernel; tolerance {DECODE_TOL}); "
            f"pages stayed on their shards ({page_err:.2g} from the "
            f"unsharded pages); step {np.median(ms):.1f} ms (unsharded "
            f"{np.median(base_ms):.1f} ms); per step collectives "
            f"{res[f'contiguous={contiguous}']['collectives']}")
    res["unsharded_step_ms"] = base_ms
    del params, caches, base_caches
    torch.cuda.empty_cache()
    return res


def sharded_moe(dev):
    """13 (c) make_moe_ep: one MoE layer at Llama-4 Scout's published
    widths in f32 on a 2 x 2 mesh against moe_apply at a capacity that
    drops nothing; then Scout's 4-layer cut in bf16 through prefill and
    decode with cfg.moe_fn against the run without it."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import mesh as dmesh
    from repro_torch.distributed import moe_ep
    from repro_torch.models import blocks as bm
    from repro_torch.models import moe as mm
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import materialize, tree_leaves
    full = get_config(SCOUT_ARCH)
    spec = full.pattern[0].moe
    # capacity that drops nothing: every token could pick one expert
    wide = dataclasses.replace(spec, capacity_factor=float(
        spec.n_experts) / spec.top_k)
    mesh = dmesh.make_mesh((2, 2), ("data", "model"), [dev] * 4)
    g = torch.Generator(dev).manual_seed(21)
    w = materialize(mm.moe_defs(full.d_model, spec), g, torch.float32)
    n_bytes = sum(a.numel() * 4 for a in tree_leaves(w))
    x = torch.randn(MOE_TOKENS + (full.d_model,), generator=g, device=dev)
    plain_ms, (want, _) = _wall(lambda: mm.moe_apply(w, x, wide))
    fn = moe_ep.make_moe_ep(mesh, ("data",), wide)
    sw = moe_ep.shard_moe_params(mesh, w)
    mesh.reset_stats()
    ep_ms, (got, _) = _wall(lambda: fn(sw, x))
    rel = float((got - want).abs().max() / want.abs().max())
    calls = {k: v // 3 for k, v in mesh.collective_counts().items()}
    if rel > MOE_REL_TOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"moe_ep vs moe_apply: {rel:.3g} relative")
    log(f"[sharded] moe_ep: one Scout MoE layer (d_model {full.d_model}, "
        f"{spec.n_experts} experts top-{spec.top_k} of {spec.d_ff_expert} + "
        f"shared, f32, {n_bytes / 1e9:.2f} GB of weights) over "
        f"({_mesh_note(mesh)}), {x.shape[0]} x {x.shape[1]} tokens, "
        f"capacity factor {wide.capacity_factor} (nothing drops): max "
        f"|diff| / max |moe_apply| {rel:.3g} (tolerance {MOE_REL_TOL}); "
        f"{ep_ms:.1f} ms vs moe_apply {plain_ms:.1f} ms; collectives per "
        f"call {calls}")
    res = dict(f32_layer=dict(rel_err=rel, ms=ep_ms, moe_apply_ms=plain_ms,
                              collectives=calls, weight_bytes=n_bytes))
    del w, sw, x, want, got
    torch.cuda.empty_cache()

    cfg = full.replace(n_layers=SCOUT_LAYERS, pattern=tuple(
        dataclasses.replace(ls, moe=wide if ls.moe is not None else None)
        for ls in full.pattern))
    params = tf.init_params(cfg, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    ep_params = dict(params)
    ep_params["blocks"] = tuple(
        dict(bp, ffn=moe_ep.shard_moe_params(mesh, bp["ffn"], stacked=True))
        if ls.moe is not None else bp
        for bp, ls in zip(params["blocks"], cfg.pattern))
    ep_fn = moe_ep.make_moe_ep(mesh, ("data",), wide)
    routes = []

    def route_of(p, h):
        routes.append(mm.moe_route(p, h.reshape(-1, h.shape[-1]), wide)
                      .eidx[:, 0])

    def moe_fn(p, h):
        route_of(p, h)
        return ep_fn(p, h)

    moe_apply = bm.moe_apply

    def recorded(p, h, s, *, hints=False):
        route_of(p, h)
        return moe_apply(p, h, s, hints=hints)

    b, plen = len(MOE_PLENS), max(MOE_PLENS)
    rng = np.random.default_rng(23)
    toks = _pad([list(map(int, rng.integers(1, cfg.vocab, n)))
                 for n in MOE_PLENS], plen, dev)
    lengths = torch.tensor(MOE_PLENS, dtype=torch.int32, device=dev)
    maxp = (plen + MOE_DECODE) // cfg.page_size + 1
    bt = tf.default_block_tables(cfg, b, maxp, device=dev)
    nxt = [torch.randint(1, cfg.vocab, (b, 1), generator=g, device=dev)
           for _ in range(MOE_DECODE)]
    got = {}
    bm.moe_apply = recorded
    try:
        for name, cfg_, p_ in (("plain", cfg, params),
                               ("moe_ep", cfg.replace(moe_fn=moe_fn),
                                ep_params)):
            routes.clear()
            caches = tf.init_caches(cfg_, b, maxp, device=dev)
            with torch.no_grad():
                out = tf.apply_model(p_, cfg_, {
                    "tokens": toks, "caches": caches, "block_tables": bt,
                    "lengths": lengths}, mode="prefill")
                logit_rows = [out.logits[i, :n, :cfg.vocab]
                              for i, n in enumerate(MOE_PLENS)]
                caches = out.caches
                for i, tk in enumerate(nxt):
                    out = tf.decode_step(p_, cfg_, {
                        "tokens": tk, "caches": caches, "block_tables": bt,
                        "lengths": lengths + i})
                    caches = out.caches
                    logit_rows.append(out.logits[:, 0, :cfg.vocab])
            torch.cuda.synchronize()
            # a position's route over the layers: prefill rows then the
            # decode rows, in the order the layers ran
            got[name] = (torch.cat(logit_rows).float(), list(routes))
            del caches, out
    finally:
        bm.moe_apply = moe_apply
    (a, ra), (p, rp) = got["moe_ep"], got["plain"]
    n_pref = b * plen
    n_layers_moe = sum(ls.moe is not None for ls in cfg.pattern) \
        * cfg.n_repeat
    flip = torch.zeros(a.shape[0], dtype=torch.bool, device=dev)
    keep = torch.cat([torch.arange(n, device=dev) + i * plen
                      for i, n in enumerate(MOE_PLENS)])
    for li in range(len(ra)):
        x_, y_ = _route_sets(ra[li][:, None]), _route_sets(rp[li][:, None])
        diff = (x_ != y_).any(-1)
        if li < n_layers_moe:                       # prefill calls
            flip[:keep.numel()] |= diff[:n_pref][keep]
        else:                                       # decode calls
            step = (li - n_layers_moe) // n_layers_moe
            flip[keep.numel() + step * b:keep.numel() + (step + 1) * b] \
                |= diff
    err = (a - p).abs()
    ok = (err <= SCOUT_LOGIT_TOL * (1 + p.abs())).all(-1)
    n_flip, n_bad = int(flip.sum()), int((~ok & ~flip).sum())
    rows = int(a.shape[0])
    clean = err[~flip]
    res["scout"] = dict(
        positions=rows, flipped=n_flip,
        max_abs_err_unflipped=float(clean.max()) if clean.numel() else 0.0,
        rel_l2_all=float((a - p).norm() / p.norm()))
    log(f"[sharded] Scout {cfg.n_layers}-layer cut, bf16, capacity factor "
        f"{wide.capacity_factor}: prefill of {b} prompts "
        f"({MOE_PLENS}) + {MOE_DECODE} decode steps with cfg.moe_fn = "
        f"make_moe_ep over the 2 x 2 mesh, against the run without it: "
        f"{n_flip} of {rows} positions routed differently in some layer; "
        f"the others max |diff| {res['scout']['max_abs_err_unflipped']:.4g} "
        f"(tolerance {SCOUT_LOGIT_TOL} (1 + |plain|)); relative L2 over "
        f"all {res['scout']['rel_l2_all']:.3g}")
    if not bool(torch.isfinite(a).all()) or n_bad \
            or n_flip > SCOUT_MAX_FLIP_SHARE * rows:
        raise AssertionError(f"Scout with moe_ep: {n_bad} unflipped "
                             f"positions over the tolerance, {n_flip} "
                             f"flipped")
    del params, ep_params, got, a, p
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sharded_compress(dev):
    """13 (c) make_grad_compressor: tiny-lm's gradients of one train step
    at full width through the int8 all-reduce over the pod axis of a 2 x 2
    ("pod", "data") mesh; every pod holds the same gradient, so the
    result is twice it, within the reference's 0.02."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import mesh as dmesh
    from repro_torch.models.param import tree_leaves
    from repro_torch.training.optimizer import AdamWConfig, warmup_cosine
    from repro_torch.training.train_step import make_train_step
    cfg = get_config("tiny-lm")
    mesh = dmesh.make_mesh((2, 2), ("pod", "data"), [dev] * 4)
    inner = comp.make_grad_compressor(mesh, "pod")
    seen = {}

    def hook(grads):
        seen["in"] = [gr.clone() for gr in tree_leaves(grads)]
        mesh.reset_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(grads)
        torch.cuda.synchronize()
        seen["ms"] = (time.perf_counter() - t) * 1e3
        seen["out"] = [gr.clone() for gr in tree_leaves(out)]
        return out

    init, step = make_train_step(cfg, AdamWConfig(lr=warmup_cosine(
        1e-3, 2, 10)), grad_compressor=hook)
    state = init(0, device=dev)
    g = torch.Generator(dev).manual_seed(31)
    toks = torch.randint(1, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                         generator=g, device=dev)
    _, metrics = step(state, {"tokens": toks, "labels": toks})
    rel = max(float((o - 2 * i).abs().max() / i.abs().max())
              for i, o in zip(seen["in"], seen["out"])
              if float(i.abs().max()) > 0)
    n = sum(i.numel() for i in seen["in"])
    if rel >= INT8_REL_TOL or not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"int8 gradient all-reduce: {rel:.3g} "
                             f"relative")
    calls = mesh.collective_counts()
    log(f"[sharded] make_grad_compressor: tiny-lm's {n / 1e6:.1f}M "
        f"gradients of one train step ({TRAIN_BATCH} x {TRAIN_SEQ} tokens) "
        f"over the pod axis of ({_mesh_note(mesh)}): worst leaf "
        f"max |out - 2 g| / max |g| {rel:.4f} (limit {INT8_REL_TOL}); "
        f"{seen['ms']:.1f} ms for {calls} collectives, "
        f"{mesh.collective_bytes()} bytes read across shards")
    del state
    torch.cuda.empty_cache()
    return dict(rel_err=rel, ms=seen["ms"], collectives=calls,
                bytes=mesh.collective_bytes(), n_grads=n)


def phase_sharded(dev, single_step_ms, floor_ms, latency_ns):
    """Phase 13: the sharded endpoint at real size, tiny-lm served over
    SHARDS homes, and the distributed layer at full width, every mesh of
    SHARDS shards on this one card."""
    from repro_torch import kernels
    t = time.perf_counter()
    out = {}
    for name, fn in (("endpoint", lambda: sharded_endpoint(dev, floor_ms,
                                                           latency_ns)),
                     ("serving", lambda: sharded_serving(dev,
                                                         single_step_ms)),
                     ("fetch", lambda: sharded_fetch(dev)),
                     ("decode", lambda: sharded_decode(dev)),
                     ("moe", lambda: sharded_moe(dev)),
                     ("compress", lambda: sharded_compress(dev))):
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        out[name + "_s"] = time.perf_counter() - t1
        out[name + "_launches"] = kernels.launch_counts()
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t
    # the sharded paths' own launches: the endpoint's two waves, the
    # tiara serving run, one fetch (not the yardsticks they are held to)
    gathers = out["endpoint"]["sharded"]["launches"] \
        + out["endpoint"]["auto"]["launches"] \
        + out["serving"]["counts"]["tiara_gather"] \
        + out["fetch"]["launches"]
    out["tiara_gather_launches"] = gathers
    # the sharded engine's waves: the acceptance wave and the tiara
    # serving run (the "auto" wave runs where the cost model puts it)
    waves = out["endpoint"]["sharded"]["lockstep_vm"] \
        + out["serving"]["counts"]["lockstep_vm"]
    out["sharded_lockstep_vm_launches"] = waves
    log(f"[sharded] phase 13: {out['wall_s']:.1f} s (endpoint "
        f"{out['endpoint_s']:.1f}, serving {out['serving_s']:.1f}, fetch "
        f"{out['fetch_s']:.1f}, decode {out['decode_s']:.1f}, moe "
        f"{out['moe_s']:.1f}, compress {out['compress_s']:.1f}); "
        f"tiara_gather launched {gathers} times on the sharded paths, "
        f"lockstep_vm {waves} times by the sharded engine; {card_line()}")
    if gathers < 1:
        raise AssertionError("the sharded paths never launched "
                             "tiara_gather")
    if out["endpoint"]["sharded"]["lockstep_vm"] < 1 \
            or out["serving"]["counts"]["lockstep_vm"] < 1:
        raise AssertionError("the sharded engine's waves never launched "
                             "lockstep_vm")
    return out


def _dryrun_cells(arch: str, out_dir: str):
    """Phase 14(a)'s command for ``arch``: the dry-run CLI on the single
    production mesh over the shapes of the docstring."""
    shapes = ("decode_32k", "long_500k")
    if arch not in DRYRUN_LONG_LEFT:
        shapes = ("train_4k", "prefill_32k") + shapes
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", ",".join(shapes), "--mesh", "single", "--out",
            out_dir], shapes


def phase_dryrun(dev):
    """Phase 14: (b) CROSS_ARCH's cells on the card, then (a) the dry-run
    of the production cells on meta in subprocesses (after (b), so that
    they take no host time from its timed steps)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec,
                                     cell_applicable, get_config)
    from repro_torch.launch import dryrun
    t = time.perf_counter()
    cross = []
    cfg = get_config(CROSS_ARCH)
    for name, kind, seq, batch in CROSS_SHAPES:
        rec = dryrun.card_check(cfg, ShapeSpec(name, kind, seq, batch), dev,
                                reps=CROSS_REPS)
        cross.append(rec)
        log(f"[dryrun] (b) {rec['cell']}: argument bytes "
            f"{rec['arg_bytes']} = {rec['card_arg_bytes']} on the card; "
            f"FLOPs {rec['flops']} = {rec['card_flops']}; argument + temp "
            f"{(rec['arg_bytes'] + rec['temp_bytes']) / 2**30:.3f} GiB "
            f"against a peak of {rec['card_peak_bytes'] / 2**30:.3f} GiB "
            f"(x{rec['mem_ratio']:.4f}); floor {rec['floor_s'] * 1e3:.3f} "
            f"ms (compute {rec['compute_s'] * 1e3:.3f}, memory "
            f"{rec['memory_s'] * 1e3:.3f}); median wall plain "
            f"{rec['wall_plain_s'] * 1e3:.3f} ms (share "
            f"{rec['share_plain']:.3f}, MFU {rec['mfu_plain']:.4f}), "
            f"kernels {rec['wall_cuda_s'] * 1e3:.3f} ms (share "
            f"{rec['share_cuda']:.3f}, MFU {rec['mfu_cuda']:.4f}); "
            f"{card_line()}")
        gc.collect()
        torch.cuda.empty_cache()
    cross_s = time.perf_counter() - t

    out_dir = os.path.join(HERE, "chiprun_out", "dryrun_phase14")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    want = {"ok": 0, "skip": 0, "fail": 0}
    jobs = []
    for arch in ARCH_IDS:
        cmd, shapes = _dryrun_cells(arch, out_dir)
        for name in shapes:
            ok, _ = cell_applicable(get_config(arch), SHAPES[name])
            want["ok" if ok else "skip"] += 1
        jobs.append((arch, cmd))

    def run(cmd):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                           text=True, timeout=DRYRUN_PROC_TIMEOUT_S)
        return r, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=DRYRUN_PROCS) as pool:
        done = [(arch, pool.submit(run, cmd)) for arch, cmd in jobs]
        done = [(arch, fut.result()) for arch, fut in done]
    walls, counts = {}, {"ok": 0, "skip": 0, "fail": 0}
    for arch, (r, walls[arch]) in done:
        for line in r.stdout.splitlines():
            if line.startswith("["):
                log(f"[dryrun] (a) {line}")
                counts[line[1:5].strip()] += 1
        if r.returncode != 0:
            raise AssertionError(f"the dry-run of {arch} exited "
                                 f"{r.returncode}: {r.stderr[-2000:]}")
    wall = time.perf_counter() - t
    log(f"[dryrun] (a) {counts['ok']} ok, {counts['skip']} skip, "
        f"{counts['fail']} fail (want {want['ok']} ok, {want['skip']} "
        f"skip); per-arch walls (s) "
        + ", ".join(f"{a} {w:.1f}" for a, w in walls.items()))
    log(f"[dryrun] phase 14: {wall:.1f} s ((b) {cross_s:.1f} s)")
    if counts != want:
        raise AssertionError(f"phase 14(a): {counts}, want {want}")
    return {"cells": counts, "proc_walls_s": walls, "cross": cross,
            "cross_s": cross_s, "wall_s": wall}


def _load_file(path: str):
    """The module at ``path`` under the checkout (an example or a tool,
    which are files, not packages)."""
    import importlib.util
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(HERE, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_serve(dev):
    """``examples/serve_paged_torch.py`` at full width, ENTRY_REQUESTS
    requests into ENTRY_SLOTS slots for ENTRY_NEW tokens each, under the
    host resolver, then the tiara one: every handle ok with every token,
    no page leaked (the example raises on a leak), ``flash_attention`` 12
    times per prefill, ``paged_attention`` in the decode steps, a tiara
    kernel under tiara and none under host, and the same tokens."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    serve = _load_file("examples/serve_paged_torch.py")
    cfg = get_config("tiny-lm")
    n_req, max_new = ENTRY_REQUESTS, ENTRY_NEW
    runs = {}
    for resolver in ("host", "tiara"):
        kernels.reset_launch_counts()   # the serving example starts here
        out = serve.main([
            "--full-size", "--requests", str(n_req), "--slots",
            str(ENTRY_SLOTS), "--max-new", str(max_new), "--resolver",
            resolver, "--device", str(dev)])
        counts = kernels.launch_counts()    # ... and ends here
        if out["launches"] != counts:
            raise AssertionError(f"serve_paged_torch {resolver}: its "
                                 f"launches {out['launches']} != the "
                                 f"counts {counts}")
        if not out["ok"] or len(out["tokens"]) != n_req or any(
                len(t) != max_new for t in out["tokens"].values()):
            raise AssertionError(f"serve_paged_torch {resolver}: a sequence "
                                 f"did not finish ok: {out['statuses']}")
        if counts["flash_attention"] != cfg.n_layers * n_req \
                or counts["paged_attention"] < cfg.n_layers \
                or counts["flash_attention_bwd"]:
            raise AssertionError(f"serve_paged_torch {resolver}: launches "
                                 f"{counts}")
        tiara = counts["tiara_gather"] + counts["lockstep_vm"]
        if (resolver == "tiara") != (tiara > 0):
            raise AssertionError(f"serve_paged_torch {resolver}: tiara "
                                 f"kernel launches {tiara}")
        runs[resolver] = out
        log(f"[entry] serve_paged_torch --resolver {resolver}: {n_req} "
            f"requests, {sum(map(len, out['tokens'].values()))} tokens in "
            f"{out['steps']} engine steps, {out['wall_s']:.2f} s, "
            f"{out['tok_per_s']:.1f} tok/s; launches {counts}"
            + (f"; audit {out['audit']}" if out["audit"] else ""))
        gc.collect()
        torch.cuda.empty_cache()
    if runs["tiara"]["tokens"] != runs["host"]["tokens"]:
        raise AssertionError("serve_paged_torch: tiara tokens differ from "
                             "host tokens")
    log(f"[entry] serve_paged_torch: tiara tokens == host tokens for all "
        f"{n_req} requests, no page leaked")
    return {r: {k: v for k, v in out.items() if k != "tokens"}
            for r, out in runs.items()}


def entry_train(dev):
    """``examples/train_tiny_lm_torch.py`` at ENTRY_TRAIN_ARGS for the
    first of ENTRY_TRAIN_STEPS steps, then again to the second in the same
    checkpoint directory: the first call's loss falls, it leaves the
    step-ENTRY_CKPT_EVERY checkpoint and its last, and the second resumes
    from its last; per step 24 forward ``flash_attention`` launches
    (remat) and 12 backward, counted by shape (``_TrainShapes``: the
    kernels line holds them to the BWD_CASES case of their shape)."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config
    train = _load_file("examples/train_tiny_lm_torch.py")
    n_layers = get_config("tiny-lm").n_layers
    root = os.path.join(HERE, "build", "chip")
    os.makedirs(root, exist_ok=True)
    calls = []
    with tempfile.TemporaryDirectory(dir=root) as d, _TrainShapes() as shapes:
        for steps in ENTRY_TRAIN_STEPS:
            kernels.reset_launch_counts()   # the training example starts here
            out = train.main(list(ENTRY_TRAIN_ARGS) + [
                "--steps", str(steps), "--ckpt", d, "--device", str(dev)])
            counts = kernels.launch_counts()    # ... and ends here
            ran = steps - out["start_step"]
            want = dict(flash_attention=2 * n_layers * ran,
                        flash_attention_bwd=n_layers * ran,
                        paged_attention=0, tiara_gather=0, lockstep_vm=0,
                        selective_scan=0, wkv6=0)
            if counts != want or out["final_step"] != steps:
                raise AssertionError(f"train_tiny_lm_torch --steps {steps}: "
                                     f"ended at {out['final_step']}, "
                                     f"launches {counts}, expected {want}")
            out.update(launches=counts, kept=sorted(
                int(n[5:]) for n in os.listdir(d) if n.startswith("step_")),
                latest=ckpt.latest_step(d))
            calls.append(out)
            walls = [x * 1e3 for x in out["step_walls_s"]]
            log(f"[entry] train_tiny_lm_torch --steps {steps}: started at "
                f"step {out['start_step']}, loss {out['first_loss']:.4f} "
                f"at step {out['logged_steps'][0]} -> "
                f"{out['last_loss']:.4f} at step {out['logged_steps'][-1]}; "
                f"step wall median {np.median(walls):.2f} ms (first "
                f"{walls[0]:.2f}); checkpoints kept {out['kept']}; "
                f"stragglers {out['stragglers']}; launches {counts}")
    first, second = calls
    if not first["last_loss"] < first["first_loss"] \
            or not np.isfinite([first["first_loss"], first["last_loss"],
                                second["last_loss"]]).all():
        raise AssertionError(f"train_tiny_lm_torch: the loss did not fall: "
                             f"{first['first_loss']} -> "
                             f"{first['last_loss']}")
    if ENTRY_CKPT_EVERY not in first["kept"] \
            or first["latest"] != ENTRY_TRAIN_STEPS[0] \
            or second["start_step"] != first["latest"]:
        raise AssertionError(f"train_tiny_lm_torch: checkpoints "
                             f"{first['kept']} after the first call, the "
                             f"second started at {second['start_step']}")
    log(f"[entry] train_tiny_lm_torch: the second call resumed at step "
        f"{second['start_step']}, the newest of the first call's "
        f"checkpoints {first['kept']}, and ran to step "
        f"{second['final_step']}; launches by shape: forward {shapes.fwd}, "
        f"backward {shapes.bwd}")
    return dict(calls=calls, fwd_by_shape=shapes.fwd,
                bwd_by_shape=shapes.bwd,
                counts={k: sum(c["launches"][k] for c in calls)
                        for k in calls[0]["launches"]})


def entry_disaggregated_kv(dev):
    """``examples/disaggregated_kv_torch.py`` with its pool on the card,
    then on the CPU: the same figures, and the same delivered blocks (the
    example holds each reply to the pool's blocks at the requested ids).
    ``Session.trace`` runs on the pool's host copy, so this holds the
    pool's placement on the card and launches no kernel."""
    kv = _load_file("examples/disaggregated_kv_torch.py")
    card = kv.main(["--device", str(dev)])
    host = kv.main(["--device", "cpu"])
    if card["device"] != str(dev) or {k: v for k, v in card.items()
                                      if k != "device"} != \
            {k: v for k, v in host.items() if k != "device"}:
        raise AssertionError(f"disaggregated_kv_torch: the card's figures "
                             f"{card} != the CPU's {host}")
    log(f"[entry] disaggregated_kv_torch on {card['device']}: tiara "
        f"{card['tiara_us']:.1f} us, stop-and-wait "
        f"{card['stop_and_wait_us']:.1f} us, batched "
        f"{card['batched_us']:.1f} us "
        f"({card['over_stop_and_wait']:.1f}x, {card['over_batched']:.2f}x), "
        f"{card['fetched']} blocks delivered as the pools hold them; equal "
        f"to the same call's on the CPU, blocks included")
    return card


def phase_entry_points(dev):
    """Phase 17: the reference's last entry points on the port, each
    through its ``main(argv)`` in process on ``dev``."""
    t0 = time.perf_counter()
    res = dict(serve=entry_serve(dev), train=entry_train(dev),
               disaggregated_kv=entry_disaggregated_kv(dev))
    gate = _load_file("tools/check_budgets_torch.py").main([])
    if gate != 0:
        raise AssertionError(f"check_budgets_torch returned {gate}")
    res["budget_gate"] = gate
    res["wall_s"] = time.perf_counter() - t0
    log(f"[entry] check_budgets_torch: 0; phase 17 took "
        f"{res['wall_s']:.1f} s")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--attention-only", action="store_true",
                    help="only time the attention kernels at the timed "
                         "shapes and print one JSON line per shape")
    ap.add_argument("--decode-only", action="store_true",
                    help="only time the decode steps that run no tiara "
                         "(tiny-lm host serving, Jamba, RWKV-6) and print "
                         "one JSON line per path")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="only run phase 14 (the dry-run and its card "
                         "cross-check) and print its numbers as JSON")
    ap.add_argument("--src", help="with --attention-only or --decode-only: "
                    "the src directory whose repro_torch is timed (another "
                    "tree, e.g. a parent commit unpacked with git archive)")
    ap.add_argument("--label", default="this tree",
                    help="with --attention-only or --decode-only: the "
                         "name of the tree")
    args = ap.parse_args()
    if args.src and not (args.attention_only or args.decode_only):
        ap.error("--src needs --attention-only or --decode-only")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    if args.attention_only:
        return attention_only(dev, args.label)
    if args.decode_only:
        return decode_only(dev, args.label)
    if args.dryrun_only:
        log(f"[device] {torch.cuda.get_device_name(0)} | {card_line()}")
        phase_build()
        log(json.dumps(phase_dryrun(dev), default=str))
        return 0
    from repro_torch import kernels

    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    build_s = phase_build()
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)  # 256 MiB
    kinfo = phase_kernel(dev, scratch)
    floor_ms = kinfo["launch_floor_ms"]
    paged, flash = phase_attention(dev, scratch, floor_ms)
    del scratch
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()           # the endpoint path starts here
    walls, launches, ran, sides, forced = phase_endpoint(dev)
    counts = kernels.launch_counts()         # ... and ends here
    for k in ("tiara_gather", "lockstep_vm"):
        if counts[k] < 1:
            raise AssertionError(f"the endpoint path never launched {k}")
    log(f"[launches] endpoint path: {counts}")
    # resets the counts per wave, and takes its measurements' launches out
    lockstep = phase_lockstep(dev, card, forced, floor_ms)
    del forced
    kernels.reset_launch_counts()           # the contracts' path starts here
    contracts = phase_contracts(dev, card)
    ccounts = kernels.launch_counts()       # ... and ends here
    for k in ("tiara_gather", "lockstep_vm"):
        if ccounts[k] < 1:
            raise AssertionError(f"the contracts' path never launched {k}")
    log(f"[launches] contracts' path: {ccounts}")
    # the serving paths reset and read the counts around each resolver's
    # run; their host runs launch no tiara kernel
    runs, cpu_err, tiny_gathers, tiny_wave = phase_serving(dev)
    scout, scout_gathers, scout_wave = phase_scout(dev, floor_ms)
    gc.collect()                             # Scout's weights go here
    torch.cuda.empty_cache()
    log(f"[memory] after the Scout phase: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    # the recurrent paths reset and read the counts around their own runs
    jamba = phase_jamba(dev, floor_ms)
    gc.collect()
    torch.cuda.empty_cache()
    rwkv = phase_rwkv(dev, floor_ms)
    gc.collect()
    torch.cuda.empty_cache()
    qwen = phase_qwen(dev, floor_ms)
    gc.collect()
    torch.cuda.empty_cache()
    seamless = phase_seamless(dev, floor_ms)
    simulated = phase_simulator(dev)
    gc.collect()                             # SeamlessM4T's weights go here
    torch.cuda.empty_cache()
    # the training paths reset and read the counts around their own runs
    training = phase_training(dev, floor_ms)
    gc.collect()
    torch.cuda.empty_cache()
    # and so do the sharded paths, part by part
    sharded = phase_sharded(
        dev, float(np.median(runs["tiara"]["step_ms"])), floor_ms,
        lockstep["latency_ns"])
    gc.collect()
    torch.cuda.empty_cache()
    dry = phase_dryrun(dev)
    gc.collect()
    torch.cuda.empty_cache()
    entry = phase_entry_points(torch.device("cuda", 0))
    training["entry"] = entry["train"]
    # the serving paths: phase 5's runs and the serving example's (its
    # f32 prefills and decode steps, and its tiara waves)
    serving = {k: sum(r["counts"][k] for r in runs.values())
               + sum(r["launches"][k] for r in entry["serve"].values())
               for k in counts}
    scout_counts = {k: sum(r["counts"][k] for r in scout["runs"].values())
                    for k in counts}
    log(f"[launches] tiny-lm serving paths (phase 5 and the serving "
        f"example, host + tiara): {serving}")
    log(f"[launches] Scout serving path (host + tiara): {scout_counts}")
    for path in (serving, scout_counts):
        if path["flash_attention_bwd"]:
            raise AssertionError("a serving path launched the backward")
        for k in ("paged_attention", "flash_attention"):
            if path[k] < 1:
                raise AssertionError(f"a serving path never launched {k}")
        # its tiara waves run as compiled traces (tiara_gather) or as
        # lockstep waves (lockstep_vm), as the cost model picks
        if path["tiara_gather"] + path["lockstep_vm"] < 1:
            raise AssertionError("a serving path never launched a tiara "
                                 "kernel")
    kinfo["launches"] = counts["tiara_gather"] + ccounts["tiara_gather"] \
        + serving["tiara_gather"] \
        + scout_counts["tiara_gather"] + sharded["tiara_gather_launches"]
    jamba_counts = jamba["run"]["counts"]
    log(f"[launches] Jamba path (prefill + {RECURRENT_STEPS} decode steps): "
        f"{jamba_counts}")
    log(f"[launches] RWKV-6 path (prefill + {RECURRENT_STEPS} decode "
        f"steps): {rwkv['run']['counts']}")
    for tag, ph in (("Qwen2-VL", qwen), ("SeamlessM4T", seamless)):
        log(f"[launches] {tag} path (prefill + {RECURRENT_STEPS} decode "
            f"steps): {ph['run']['counts']}")
    model_paths = [jamba_counts] + [ph["run"]["counts"]
                                    for ph in (qwen, seamless)]
    model_paths.append(sharded["serving"]["counts"])
    paged["launches"] = serving["paged_attention"] \
        + scout_counts["paged_attention"] \
        + sum(c["paged_attention"] for c in model_paths)
    train_paths = [training[p]["counts"]
                   for p in ("tiny", "seamless", "entry")]
    log(f"[launches] training paths (tiny-lm {TRAIN_STEPS} steps, "
        f"SeamlessM4T {SEAMLESS_TRAIN_STEPS} steps, the training example "
        f"{ENTRY_TRAIN_STEPS[-1]} steps): {train_paths}")
    # tiny-lm's f32 prefills (served, and over 4 homes) run the f32 route;
    # the bf16 paths' launches and the training paths' have rows of their
    # own
    flash["launches"] = serving["flash_attention"] \
        + sharded["serving"]["counts"]["flash_attention"]

    # tiara_gather at the serving resolvers' own shapes, as recorded,
    # beside the launch floor and the latency bound (the sharded waves'
    # window copies run inside lockstep_vm and launch no tiara_gather)
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)
    shapes = {}
    for model, rec in (("tiny-lm", tiny_gathers), ("scout", scout_gathers)):
        for engine, call in sorted((rec or {}).items()):
            if call is None:
                continue
            r = shapes[f"{model}, {engine}"] = time_gather_call(
                call, scratch, lockstep["latency_ns"], floor_ms)
            log(f"[kernel] tiara_gather at the {model} shape ({engine}): "
                f"{r['n']} window(s) of {r['width']} word(s) over a "
                f"{r['pool_words']}-word pool"
                + (", one mask per lane" if r["per_lane_masks"] else "")
                + (", with ids" if r["ids"] else ", no ids")
                + f": equal, the same bits twice; kernel "
                f"{r['ms'] * 1e3:.2f} us on the card against launch floor "
                f"{floor_ms * 1e3:.2f} us + latency bound "
                f"{r['latency_bound_ms'] * 1e3:.2f} us "
                f"({r['dependent_loads']} dependent loads at "
                f"{lockstep['latency_ns']:.1f} ns) = "
                f"{(floor_ms + r['latency_bound_ms']) * 1e3:.2f} us; "
                f"{r['host_ms_per_call'] * 1e3:.2f} us of host wall per "
                f"call; plain {r['plain_ms'] * 1e3:.2f} us, library "
                + (("none (per-lane masks: no one call applies them)"
                    if r["per_lane_masks"] else "none (windows of more "
                    "than one word)")
                   if r["library_ms"] is None else
                   f"(index_select at the precomputed word offsets) "
                   f"{r['library_ms'] * 1e3:.2f} us")
                + f", byte bound {r['bound_ms'] * 1e6:.3f} ns; {card}")
    kinfo["serving_shapes"] = shapes
    # lockstep_vm at the first lockstep wave a tiara resolver gave it
    # (Scout's; tiny-lm's waves run as compiled traces unless the cost
    # model picks the lockstep engine), and its launches on every path
    # that counted them
    tag, wave = ("Scout's", scout_wave) if scout_wave is not None else \
        ("tiny-lm's", tiny_wave)
    if wave is None:
        raise AssertionError("no tiara resolver ran a lockstep wave")
    lrow = lockstep_row(wave, scratch, lockstep["latency_ns"])
    lrow["registers"] = lockstep_registers()
    del scratch, wave, scout_wave, tiny_wave
    lv_launches = counts["lockstep_vm"] + ccounts["lockstep_vm"] \
        + serving["lockstep_vm"] + scout_counts["lockstep_vm"]
    lvinfo = dict(name="lockstep_vm", route="cuda", source=LOCKSTEP_SOURCE,
                  replaces=LOCKSTEP_REPLACES, launches=lv_launches,
                  max_abs_err=lrow["max_abs_err"], ms=lrow["ms"],
                  plain_ms=lrow["plain_ms"], bound_ms=lrow["bound_ms"],
                  bound_by="bytes", library_ms=None,
                  one_lane_wave_ms=lrow["one_lane_ms"],
                  latency_bound_ms=lrow["latency_bound_ms"],
                  shape=f"all paths; timed at {tag} resolver wave: "
                        f"{lrow['B']} lanes, {lrow['macro_steps']} "
                        f"macro-steps, {lrow['bytes_moved']} bytes, "
                        f"{lrow['dependent_accesses']} dependent pool "
                        f"accesses on its longest lane")
    log(f"[kernel] lockstep_vm at the {tag} resolver's wave ({lrow['B']} "
        f"lanes, {lrow['macro_steps']} macro-steps): equal to the host "
        f"loop; kernel {lrow['ms'] * 1e3:.2f} us (the whole call, "
        f"operands included, {lrow['call_ms'] * 1e3:.2f} us), plain (host "
        f"loop) "
        f"{lrow['plain_ms']:.2f} ms, bound {lrow['bound_ms'] * 1e6:.1f} ns "
        f"({lrow['bytes_moved']} bytes at 3.35 TB/s), latency bound "
        f"{lrow['latency_bound_ms'] * 1e3:.2f} us "
        f"({lrow['dependent_accesses']} dependent pool accesses at "
        f"{lockstep['latency_ns']:.1f} ns), a one-lane wave (one RET) "
        f"{lrow['one_lane_ms'] * 1e3:.2f} us, {floor_note(floor_ms)}; "
        f"cycles a macro-step "
        + ", ".join(f"({k}) {lrow['clocks']['cycles_per_step'][k]:.0f}"
                    for k in "abcde")
        + f"; {lv_launches} launches on the counted paths; {card}")
    for name, ki in (("paged", paged), ("flash", flash)):
        ki["scout"] = scout["kernels"][name]
        ki["jamba"] = jamba["kernels"][name]

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s,
                   "kernels": [kinfo, paged, flash, lvinfo],
                   "wave_wall_s": walls, "wave_launches": launches,
                   "wave_engine": ran, "endpoint_launches": counts,
                   "lockstep": dict(lockstep, side_by_side=sides,
                                    row=lrow),
                   "contracts": contracts, "contracts_launches": ccounts,
                   "serving": {r: {k: v for k, v in run.items() if k != "out"}
                               for r, run in runs.items()},
                   "card_vs_cpu_max_abs_err": cpu_err,
                   "scout": {
                       "n_params": scout["n_params"],
                       "weight_bytes": scout["weight_bytes"],
                       "serving": {r: {k: v for k, v in run.items()
                                       if k != "out"}
                                   for r, run in scout["runs"].items()},
                       "tiara_on_host_loop": scout["host_loop"],
                       "logits": scout["logits"]},
                   "jamba": jamba, "rwkv": rwkv, "qwen": qwen,
                   "seamless": seamless, "simulator": simulated,
                   "training": training, "sharded": sharded,
                   "dryrun": dry, "entry_points": entry},
                  f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = [dict({k: ki[k] for k in keys}, shape="all paths; timed at "
                 + label) for ki, label in (
                     (kinfo, "the endpoint path's 4096 rows of 8 KiB"),
                     (paged, "tiny-lm's decode step"),
                     (flash, "tiny-lm's 2048-token prefill"))]
    rows.append({k: lvinfo[k] for k in keys + ("shape", "one_lane_wave_ms",
                                                "latency_bound_ms")})
    srow = sharded["endpoint"]["kernel_row"]
    rows.append(dict(
        name="lockstep_vm", route="cuda", source=LOCKSTEP_SOURCE,
        replaces=SHARDED_REPLACES,
        launches=sharded["sharded_lockstep_vm_launches"],
        max_abs_err=srow["max_abs_err"], ms=srow["ms"],
        plain_ms=srow["plain_ms"], bound_ms=srow["bound_ms"],
        bound_by="bytes", library_ms=None,
        latency_bound_ms=srow["latency_bound_ms"],
        shape=f"the sharded engine's wave on {SHARDS} rows of one card: "
              f"timed at the acceptance wave, {srow['B']} lanes, "
              f"{srow['macro_steps']} macro-steps, {srow['bytes_moved']} "
              f"bytes, {srow['dependent_accesses']} dependent pool "
              f"accesses on its longest lane; plain_ms is the sharded host "
              f"loop's wall on the same wave"))
    for tag, ki, n in (("Scout", scout["kernels"]["flash"],
                        scout_counts["flash_attention"]),
                       ("Jamba", jamba["kernels"]["flash"],
                        jamba_counts["flash_attention"])):
        rows.append(dict({k: ki[k] for k in keys if k in ki},
                         name=flash["name"], route=flash["route"],
                         source=FLASH_BF16_SOURCE,
                         replaces=flash["replaces"], launches=n,
                         shape=f"{tag}'s prefill: {ki['shape']} bf16"))
    for ph, name, source, replaces, model in (
            (jamba, "selective_scan", SELECTIVE_SCAN_SOURCE,
             SELECTIVE_SCAN_REPLACES, "Jamba"),
            (rwkv, "wkv6", WKV6_SOURCE, WKV6_REPLACES, "RWKV-6")):
        for label, r in ph["scans"].items():
            rows.append(dict(
                {k: r[k] for k in keys if k in r}, name=name, route="cuda",
                source=source, replaces=replaces,
                launches=ph["run"]["counts"][name],
                shape=f"{model}'s {label}: " + ", ".join(
                    "x".join(map(str, sh)) for sh in r["shape"])
                + (", valid from the prompts' lengths" if r["valid"]
                   else "") + " f32; launches: the path's prefill and "
                f"{RECURRENT_STEPS} decode steps"))
    rows += multimodal_rows(qwen, seamless, paged, flash)
    rows += training_rows(training)
    for r in rows:
        r["launch_floor_ms"] = floor_ms
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
