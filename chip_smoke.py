#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (veles_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Builds the kernels from ``veles_tpu_torch/csrc`` (nvcc, sm_90a),
   times the launch floor (the library's empty kernel, device time a
   launch: the least any kernel takes on the card) and draws threefry
   bits and dropout keep masks on the card at VGG16's fc mask shape
   (32, 4096) and at (7, 129, 3): bit-equal to the same draws on the
   CPU (``veles_tpu_torch/threefry.py``, JAX's key stream).
2. Holds ``matmul_int8``'s CUDA kernel against its plain PyTorch version
   on the card at the serving shapes (conv1_2 at rung 8; fc1, conv1_1,
   conv3_1, conv5_1 and fc2 at rung 32; a ragged shape), the weight
   K-major as the engine keeps it: bit for bit with scale 1 and bias 0
   (where |acc| < 2**24 the f32 output is the exact int32 sum), and to
   1 ulp with random per-column scale and bias.  Times the kernel and
   ``torch._int_mm`` + the epilogue (the library yardstick; the port
   never calls it; K zero-padded to a multiple of 8 once, outside the
   timing, where it is not one: conv1_1's 27) as device time a
   launch, the plain version with
   CUDA events, records the planner's tile and K split, and computes
   the least time the card could take (bytes over 3.35 TB/s or int8
   operations over 1,979 TOP/s, whichever is larger).
3. Serves VGG16 (config "D", 224x224x3, 1000 classes, random weights
   from seed 0) through the f32 ``AOTEngine`` and, after calibrating on
   64 seeded samples and quantizing, through the int8 ``AOTEngine`` and
   a ``ContinuousBatcher`` answering 48 requests from 4 threads.  The
   kernel's launch count is zeroed just before the int8 serve path and
   read just after.  Checks: every batched answer equals the same row
   through ``engine.infer`` at rung 32 bit for bit, outputs are finite,
   each int8 dispatch launches the kernel 16 times (13 conv + 3 fc), and
   two samples agree with the port's CPU forward (f32: rtol 1e-3 for
   the summation order of 16 layers; int8: atol 1e-3 on the
   probabilities, since a 1-ulp f32 difference can flip one
   quantization level).

4. Holds the training kernels against their plain PyTorch versions on
   the card, each run twice and required to give the same bits:
   ``gather_minibatch`` (32 of 256 VGG16 images in f32, with int32 and
   int64 indices, 32 of 1,024 in uint8 -> f32, an MNIST minibatch of 100
   of 60,000 uint8 rows; out-of-range indices too: bit-equal; then every
   dtype pair at widths 1, 3, 784 and 150,528, int32 and int64 indices,
   an unaligned base and batches 1 and 4,096, both paths served, and an
   int64 gather seen as one kernel in the run's one profiler session,
   after the ops layer), ``conv_wgrad`` at
   level 0 (the ``tc_bf16x3`` design) at VGG16 conv1_1 and conv1_2
   (batch 8), conv5_1 (batch 32) and a ragged, strided, asymmetric tanh
   case, and at level 1 (``simt``) at conv5_1 (grad_w and grad_b within
   max-rel 1e-5 of a float64 plain version and 2e-6 of the plain version
   at the same level on the same inputs, err within 1 ulp of the f32
   one, the design the planner picks), and ``max_pool_bwd`` at VGG16 pool1
   (batch 8, 2x2/2), an overlapping ceil-mode 3x3/2 case and AlexNet's
   pool1 (batch 32), then every VGG16 pool shape at batch 2, odd
   ceil-mode tails, C = 3, 5 and 130, windows with gaps, -inf and NaN
   inputs and an unaligned view, each on the design its geometry asks
   for ("cells" where windows do not overlap, else "overlap"): bit-equal.
   Each gets its time, the plain version's, a library call's (timed
   only, never called by the port: ``index_select().to()``,
   ``torch.nn.grad.conv2d_weight`` + the epilogue,
   ``max_pool2d_with_indices_backward``) and its bound: max(bytes /
   3.35 TB/s, operations at their peak: the wgrad's level 0 three bf16
   products at 989 TFLOP/s, its levels 1 and 2 f32 at 67 TFLOP/s, TF32
   being off).  The three kernels' and library calls' times are device
   time a call with a cold L2 (``cold_ms``: the calls cycle through
   index vectors covering a dataset over twice the 50 MB L2, or through
   copies of the operands); the five VGG16 pools at batch 32 are timed
   the same way and summed (a training step's pool backward).
5. Trains VGG16 (random weights from seed 0, momentum) at batch 32 on a
   128-sample dataset made on the card from a seed: one
   ``build_train_epoch`` (4 steps), one ``build_eval_epoch``, 3 keyless
   ``build_train_step`` steps on one minibatch and one keyed step (its
   two dropout masks drawn from ``fold_in(key, layer)`` and bit-equal to
   the CPU's draw from the same key), with the three kernels' launch
   counts zeroed just before and read just after.  Checks: each step
   launches ``conv_wgrad`` 13 times (all on the ``tc_bf16x3`` design) and
   ``max_pool_bwd`` 5 times (all on the "cells" design), each epoch
   ``gather_minibatch`` 4 times (all on the 4-element path);
   every metric and state leaf is finite; each of 3 steps, run from the
   same state through the kernels and through the plain versions on the
   card (kernels swapped out, cuDNN deterministic), agrees (loss within
   1e-5 rel, every leaf within max-rel 1e-4); and 2 steps of a small
   convnet on the card agree with the port's CPU run to the same
   tolerances.  Chained over 3 steps, runs drift apart at random init
   (updates near one f32 ulp of the weights flip ReLU masks and pool
   routes), so the chained drift of a second kernel run and of the plain
   run is reported, not held to a limit.  Reports step ms (CUDA events)
   and peak memory.

6. Holds the three flash-attention kernels (forward, dq, dk/dv) against
   their plain PyTorch versions on the card at the zoo transformer's
   (B*H, T, dh) = (512, 128, 64) at batch 64, the long sequence
   (8, 1024, 64) and the ragged (2, 300, 16) and (2, 37, 8), f32, and at
   (512, 128, 64) in bf16, each at precision level 0 (the three kernels'
   ``tc_bf16x3`` design) and level 1 (``simt``), against the plain
   versions at the same level: out, lse, dq, dk, dv within max-rel 1e-5
   (bf16: 1e-2), the same bits on a second run, and the same bits again
   with NaN after the operands in memory (the ragged last tiles read T
   rows and no more); ``attention_fwd.paths``, ``attention_dq.paths``
   and ``attention_dkv.paths`` count the design each call took.  Library
   yardstick (timed only, never called by the port):
   ``F.scaled_dot_product_attention`` forward, and its backward through
   autograd (dq, dk, dv together), beside the sum of the dq and dk/dv
   kernels.  Kernel and library times
   are device time a call (``device_ms``).  Bound: bytes over 3.35 TB/s
   or the products at the level's rate: at level 0 three bf16 products
   at 989 TFLOP/s for each product of f32 operands (bf16 inputs: one
   for q k^T and do v^T, two for the products with p or ds); at levels
   1 and 2 67 TFLOP/s f32 (989 TFLOP/s bf16 for q k^T and do v^T of
   bf16 inputs).
7. Serves the zoo transformer (2 pre-LN blocks, D 512, 8 heads, MLP
   2048, T 128, 10 classes, 6,960,138 random parameters from seed 0)
   through ``AOTEngine`` at rungs 1/8/32 and a ``ContinuousBatcher``
   answering 48 requests: 2 forward launches per dispatch, every one
   on ``tc_bf16x3`` (the model runs level 0), batched ==
   ``engine.infer`` bit for bit, two samples within rtol 1e-4 of the
   port's CPU forward; host-clock latency per rung.
8. Trains it at batch 64 on a 256-sample dataset made on the card: one
   4-step epoch, one eval epoch and 3 timed ``build_train_step`` steps
   (step ms, tokens/s = 64 * 128 / step time, peak memory), 2 forward, 2
   dq and 2 dk/dv launches per step, every forward, dq and dk/dv launch
   on ``tc_bf16x3`` (the model runs level 0).  Each step from one state,
   kernels vs plain versions, loss within 1e-5 rel and every leaf within
   max-rel 1e-4: with the backward kernels swapped, and with all three
   swapped and the MLP's ReLU masks of the plain run pinned to the
   kernel run's (``PinnedRelu``: the forward kernel's differences from
   its plain version, ~1e-6 since its 64-key tiles split p at the
   running max, flip masks at pre-activations within rounding of 0; the
   flips are counted, and the run with free masks is held on its loss).
   A small transformer's 2 steps on the card agree with the CPU (loss
   1e-5 rel, leaves 1e-4).
9. Holds ``mean_disp_normalize`` ((100, 784), (4096, 3072), (4096,
   3000), (100, 129) and an unaligned (4096, 3072) view, uint8 -> f32;
   from 1 MB up timed cold) and ``join`` ((100, 100) + (100, 100) f32,
   and (4096, 784) uint8 + (4096, 100) f32 + (4096, 10) f32 -> f32)
   against their plain versions on the card: bit-equal, and the same
   bits twice.  ``ms`` is the
   kernel's device time per launch, the host's per-call cost hidden
   behind a spin kernel (``device_ms``); ``call_ms`` the host-inclusive
   time of a loop of calls.  Library yardstick: ``torch.cat`` (which
   promotes the mixed uint8 + f32 inputs to f32 in one call); no single
   PyTorch call normalizes.
10. Runs the unit graph at MNIST width (examples/mnist.py: 784 ->
   all2all_tanh 100 -> softmax 10, minibatch 100, lr 0.1, moment 0.9,
   weight decay 5e-5) over 60,000 train and 10,000 validation uint8
   28x28 images made from a seed (one random prototype per class plus
   noise): (i) per unit (``root.common.engine.auto_fuse = False``), the
   loader gathering uint8 minibatches into a ``MeanDispNormalizer`` unit
   relinked in front of the first layer, whose mean / rdisp a
   ``MeanDispersionNormalizer`` reckoned on the train class; (ii) the
   product default, the loader normalizing float32 originals once on the
   host, ``StandardWorkflow.initialize(Device())`` fusing by itself;
   (iii) an inference DAG over the validation images: loader ->
   normalizer -> ``All2AllTanh(100)`` and ``All2AllRELU(100)`` ->
   ``InputJoiner`` (100, 200) -> ``All2AllSoftmax(10)``, run by the
   workflow's worklist.  (i) and (ii) each run one epoch (the validation
   class before and after the train class: 800 minibatches).  Checks:
   (i) against (ii) step by step from one state over the first 3 train
   minibatches (bit-equal minibatches, every leaf within max-rel 1e-5),
   (i) against the CPU port on the first (1e-5), (i)'s end-of-epoch
   weights and biases against (ii)'s (max-rel 1e-4: the two see the same
   minibatches bit for bit) and their train errors (within 1 sample), a
   validation error under 5 % after the epoch in both (chance is 90 %),
   one gather a minibatch, one normalize a minibatch in (i) and (iii) and
   none in (ii), one join a minibatch in (iii), and (iii)'s last answer
   against the plain forward on the CPU (1e-5).  Reports per-minibatch times (host clock and CUDA events),
   host syncs per minibatch (``torch.cuda.set_sync_debug_mode``) and the
   top units of ``Workflow.print_stats``.
11. The ops layer (run after the join checks): ``matmul`` at 3001^3 (the
   headline of ``bench.py``) f32 at levels 0, 1, 2 and bf16 with bf16
   and f32 out, at 2048^3, 1024^3 and 256^3 at level 0, at (17, 129,
   33), (130, 257, 5) and (1, 1, 1) at every level, on positive uniform
   operands: f32 within max-rel 1e-5 of a float64 product and of the
   plain version, bf16 within rtol 2e-2, the same bits twice; the
   adversarial ladder (err1 <= 1.001 err0, err2 <= 1.001 err1) and a
   NaN row, both with split-K active; the fc1 shape at level 1 and in
   bf16; ``gemm`` at VGG16 fc1 ((32, 25088) @ (25088, 4096) + c) and a
   transposed pair, max-rel 1e-5.  Each matmul record names the design
   that served it (``matmul.paths``: split_k, tma_wgmma, simt,
   general).  ``reduce_cols`` ((60000, 784),
   (3001, 3001), (4096, 4096) bf16, (100, 784), (32, 25088), (33, 129),
   (7, 3), (1, 1)) and
   ``reduce_rows`` ((3001, 3001), (32, 25088), (100, 784), (33, 129)):
   max-rel 1e-5 of float64 (bf16: 1 ulp), the same bits twice, one
   launch a call, on the design planned (``reduce_cols.paths``:
   ``split_col`` at (60000, 784), 3001^2 and 4096^2 bf16, ``whole_col``
   at (32, 25088), (100, 784) and (33, 129), with the columns a block
   named in ``REDUCE_COLS_PATHS``; ``reduce_rows.paths``: ``whole_row``
   at 3001^2, ``split`` at (32, 25088)); a column-sum call is one CUDA
   kernel in that profiler session at (33, 129) and 4096^2 bf16; from 1 MB
   up timed cold (copies of x over 128 MB).
   ``hardware_uniform`` at (32, 4096), (4096, 4096), (7, 129), (1,):
   bit-equal to the plain Philox, per-seed bits, [0, 1) on the 2^-24
   grid, mean and Kolmogorov-Smirnov at 4096^2.  Times on the card
   beside the plain version, one library call (``torch.matmul`` f32
   with TF32 off or bf16, ``torch.addmm``, ``torch.sum``,
   ``torch.rand``) and the bound (level 0 counts three bf16 products at
   989 TFLOP/s, levels 1 and 2 f32 at 67).  Then the ops path, the four
   kernels' counts and ``matmul.paths`` zeroed before and read after
   (fc1 through ``gemm`` must take split_k, ``matmul_benchmark(3001)``
   tma_wgmma): ``gemm`` at fc1, the
   power rating (``estimate_computing_power`` at 256 / repeats 1 and
   1024 / repeats 3, ``matmul_benchmark(3001)``,
   ``Device().computing_power``; each implied rate at most its level's
   peak), the MNIST train set's column means, (3001, 3001) column sums
   (two ``split_col`` launches), (32, 25088) row sums (one ``split``
   launch) and the (32, 4096) and
   (4096, 4096) uniforms.

12. The command line (``python -m veles_tpu_torch``) at the same MNIST
   width, on a workflow file written into a temporary directory (its
   ``FullBatchLoader`` subclass over the seeded images lives in the
   file, so a restoring process imports it): (1) a child process without
   ``-d`` (the card; it fuses by itself), 3 epochs with
   ``--snapshot-dir``, a snapshot at each improved epoch and of the final
   state; (2) a second child restoring the epoch-1 snapshot with ``-w``
   and running to the end: its final state (the directory's
   ``_current``) against run (1)'s, every leaf within max-rel 1e-4 and
   the loss within 1e-5 rel (0 expected; the actual maximum printed), the
   same ``Total epochs``; (3) the same command as (1) through
   ``Main().run`` in this process; (4) ``Main().run`` with
   ``VELES_CHAOS="seed=1;step.grad=nan:a4:x8"``, minibatch 15,000 (4
   train steps an epoch, as the JAX package's rollback test has) and a
   skip budget of 4: the poisoned steps trip the watchdog in epochs 2
   and 3, so the run ends with 2 rollbacks, the learning rates x 0.25,
   finite weights and ``complete``, one ``gather_minibatch`` launch a
   minibatch; (5) one ``--no-fuse`` epoch with a ``MeanDispNormalizer``
   in front of uint8 minibatches: one gather and one normalize a
   minibatch.  Reports the epoch time through the CLI and in process,
   the snapshot's bytes and write time, and the restore time.

13. The compile step (``veles_tpu_torch/graphs.py``).  Every train path
   above runs on captured CUDA graphs (``build_train_step``,
   ``build_train_epoch`` and ``build_eval_epoch`` by default, the fused
   trainer, each ``AOTEngine`` rung); the launch counts above are
   replays x a replay's launches.  The comparisons with the plain
   versions swap kernels under the raw step (``donate=False``), which
   a graph could not see.  Then the ``graphs:`` line, cuDNN
   deterministic: the MNIST step (batch 100) and epoch (950 rows, a
   masked tail, the gather inside the graph), the transformer step
   (batch 64) and the keyed VGG16 step (batch 32), each captured chain
   held against the raw step's over 3 steps from one state: every leaf
   and metric bit for bit, every launch counter moved by replays x the
   graph's launches; each keyed replay's two masks, read out of the
   graph, equal the CPU's draw from that step's key and differ from the
   previous replay's.  Each step timed raw and graphed in turns (raw,
   graph, graph, raw; 5 steps a turn, from one state): wall time (CUDA
   events) and host enqueue (host clock, no sync); the graph's pool
   bytes and capture seconds.  In the serve phases every rung's graph
   (f32 and int8 VGG16, the transformer) equals the engine's raw
   forward bit for bit, host-clock latency raw and graphed in turns,
   and ``swap_params`` (halved f32 weights, negated int8 weights) is
   seen by the next replay with no new capture.

14. The rest of the unit graph, per unit (``root.common.engine.auto_fuse
   = False``: each layer's forward and GD unit run eagerly, the GD units
   launching ``conv_wgrad``, ``max_pool_bwd`` and the attention kernels;
   weights from the units' seeded draws).  (a) CIFAR-10
   (examples/cifar10.py at full width: conv 32, 32, pool, conv 64, 64,
   pool, conv 128, pool, all2all 256, dropout 0.5, softmax 10; lr 0.02,
   moment 0.9, weight decay 4e-5, minibatch 100) over 50,000 + 10,000
   uint8 32x32x3 images made from one random prototype per class plus
   noise, a ``MeanDispNormalizer`` unit in front: the example's net
   (softplus "RELU") through the kernels against the plain versions
   over 3 train minibatches from one state (cuDNN deterministic, the
   same dropout masks on both sides: leaves within max-rel 1e-4; 5
   ``conv_wgrad``, 3 ``max_pool_bwd``, 1 gather, 1 normalize and 1 mask
   a train minibatch), then one epoch per unit and one fused of its
   strict-ReLU variant (the softplus net stays at chance through its
   first epoch in both packages): validation errors under 10 % and
   within 1 point of each other, the same launches a minibatch (fused: 5
   wgrads a train minibatch, replays counted), ms a minibatch, host
   syncs a minibatch, the top units.  (b) VGG16 per unit at batch 32, 3
   train minibatches through the kernels against the plain versions
   (1e-4), 13 ``conv_wgrad``, 5 ``max_pool_bwd`` and 2 dropout masks a
   step, the per-unit step's ms beside the graphed fused step's from
   13.  (c) The transformer workload per unit, each of 3 train
   minibatches against the fused raw step from the same state: the loss
   within 1e-5 rel, every leaf within 1e-4, 4 attention forwards (2 in
   the forward units, 2 recomputed in the GD units), 2 dq and 2 dk/dv
   launches a step.  (d) A small convnet with dropout per unit on the
   card and on the CPU, 2 chained train steps in lockstep: the loss
   within 1e-5 rel, leaves within 1e-4.

Prints the launch floor, the card's name and power limit, a
``{"kernels": [...]}`` line
and, as its last line, ``{"ok": true, "device": {...}}``.  Exits non-zero
without a result when there is no CUDA device or the port is missing.
"""

import functools
import itertools
import json
import os
import subprocess
import sys
import threading
import time
from contextlib import nullcontext

import numpy

PEAK_INT8_OPS = 1.979e15     # H100 SXM dense int8, operations/s
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3, bytes/s
TRAIN_BATCH = 32
TRAIN_SAMPLES = 128
LADDER = (1, 8, 32)
N_REQUESTS = 48
N_THREADS = 4


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn()`` on the card, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Mean device milliseconds of ``fn()``, the host's per-call cost
    hidden: a spin kernel holds the stream while the host enqueues the
    ``iters`` calls, so the events time them back to back on the card.
    For a launch-bound kernel this is its time on the card, where
    :func:`cuda_ms` measures the host issuing it.  Raises when the spin
    did not outlast the enqueue."""
    import torch
    fn()
    torch.cuda.synchronize()
    spin = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin.record()
    torch.cuda._sleep(int(5e8))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if enqueue_ms >= spin.elapsed_time(start):
        raise AssertionError("device_ms: the enqueue (%.1f ms) outlasted "
                             "the spin (%.1f ms)" % (
                                 enqueue_ms, spin.elapsed_time(start)))
    return start.elapsed_time(end) / iters


#: bytes a cold timing reads before it comes back to an operand set:
#: over twice the H100's 50 MB L2, so every call reads device memory
COLD_BYTES = 128e6


def cold_sets(nbytes):
    """How many operand sets of ``nbytes`` each a cold timing cycles
    through (1 where one set already exceeds ``COLD_BYTES``)."""
    return max(1, -(-int(COLD_BYTES) // max(1, int(nbytes))))


#: most calls one :func:`device_ms` window enqueues behind its spin: the
#: card queues about a thousand launches before the host blocks (a
#: library call may take two)
MAX_WINDOW_CALLS = 256


def cold_ms(fn, sets, rounds):
    """:func:`device_ms` of ``fn(*ops)`` over ``rounds`` passes through
    the operand sets ``sets`` (at most ``MAX_WINDOW_CALLS`` calls), one
    set a call: a call reads what the calls just before it did not, as
    an epoch reads each row once."""
    turn = itertools.cycle(sets)
    return device_ms(lambda: fn(*next(turn)),
                     min(rounds * len(sets), MAX_WINDOW_CALLS))


def bound(m, k, n):
    """(bound_ms, bound_by) for one (M,K)@(K,N) int8 product with f32
    scale, bias and output: each input read once, the output written
    once."""
    nbytes = m * k + k * n + 4 * n + 4 * n + 4 * m * n
    ops = 2.0 * m * k * n
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def check_kernel(name, m, k, n, amax, gen):
    """Kernel vs plain version on the card at one shape; returns the
    record.  ``amax`` bounds the operands so that |acc| < 2**24.  The
    kernel takes the weight K-major and K-padded (``kmajor_weight``, made
    once, as the serving engine keeps it) and ``a`` padded to that K
    once (as ``conv2d_int8`` builds its patches); the library call
    takes a and b zero-padded to a K that ``torch._int_mm`` accepts (a
    multiple of 8), made once; the kernel's and the
    library call's times are device time a launch (``device_ms``), the
    plain version's a loop of calls (``cuda_ms``); with the tile and K
    split the planner chose."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.ops.common import sm_count
    from veles_tpu_torch.ops.matmul_int8 import (kmajor_weight,
                                                 matmul_int8_kmajor,
                                                 matmul_int8_reference,
                                                 plan_int8)
    if k * amax * amax >= 2 ** 24:
        raise ValueError("%s: |acc| may reach 2**24" % name)
    a = torch.randint(-amax, amax + 1, (m, k), generator=gen,
                      device="cuda", dtype=torch.int8)
    b = torch.randint(-amax, amax + 1, (k, n), generator=gen,
                      device="cuda", dtype=torch.int8)
    wt = kmajor_weight(b)
    ap = F.pad(a, (0, wt.shape[1] - k)).contiguous()
    exact = matmul_int8_kmajor(ap, wt, 1.0)
    if not torch.equal(exact, matmul_int8_reference(a, b, 1.0)):
        raise AssertionError("%s: int32 sums differ from the plain "
                             "version" % name)
    scale = torch.rand(n, generator=gen, device="cuda") * 0.01
    bias = torch.randn(n, generator=gen, device="cuda")
    got = matmul_int8_kmajor(ap, wt, scale, bias)
    want = matmul_int8_reference(a, b, scale, bias)
    torch.cuda.synchronize()
    ulp = (got.view(torch.int32).long() -
           want.view(torch.int32).long()).abs().max().item()
    if ulp > 1:
        raise AssertionError("%s: %d ulp from the plain version"
                             % (name, ulp))
    max_abs = (got - want).abs().max().item()
    big = m * k * n > 1e9
    ms = device_ms(lambda: matmul_int8_kmajor(ap, wt, scale, bias),
                   10 if big else 50)
    plain_ms = cuda_ms(lambda: matmul_int8_reference(a, b, scale, bias), 3)
    library_ms = None
    if m > 16 and n % 8 == 0:   # torch._int_mm's domain, K padded to 8
        a8 = F.pad(a, (0, -k % 8)).contiguous()
        b8 = F.pad(b, (0, 0, 0, -k % 8)).contiguous()
        library_ms = device_ms(
            lambda: torch._int_mm(a8, b8).float() * scale + bias,
            10 if big else 50)
    bound_ms, bound_by = bound(m, k, n)
    plan = plan_int8(m, k, n, sm_count(a.device))
    return {"shape": "%dx%dx%d" % (m, k, n), "what": name,
            "max_abs_err": max_abs, "max_ulp": ulp, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tile": list(plan["tile"]), "splits": plan["splits"],
            "k_padded": plan["k_padded"]}


def serve_phase(device):
    """VGG16 through the f32 and int8 engines and the batcher."""
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import build_forward
    from veles_tpu_torch.convert import params_from_jax
    from veles_tpu_torch.models.zoo import build_plans_and_state, \
        vgg_layers
    from veles_tpu_torch.ops.matmul_int8 import matmul_int8
    from veles_tpu_torch.quant import (build_quantized_forward,
                                       quantize_model_spec)
    from veles_tpu_torch.serve import AOTEngine, ContinuousBatcher

    shape = (224, 224, 3)
    t0 = time.perf_counter()
    plans, state, out_shape = build_plans_and_state(
        vgg_layers(config="D"), shape, seed=0)
    params = [{"weights": s["weights"], "bias": s["bias"]}
              for s in state]
    del state
    log("vgg16: %d layers, %d parameters, output %s, init %.1fs" % (
        len(plans), sum(p["weights"].size + p["bias"].size
                        for p in params if p["weights"] is not None),
        out_shape, time.perf_counter() - t0))

    def latencies(engine, rng):
        out = {}
        for rung in engine.ladder:
            x = rng.uniform(-1, 1, (rung,) + shape).astype(numpy.float32)
            times = []
            for _ in range(5):
                start = time.perf_counter()
                engine.infer(x)
                times.append((time.perf_counter() - start) * 1e3)
            out[str(rung)] = float(numpy.median(times))
        return out

    f32 = AOTEngine(plans, params, shape, ladder=LADDER, device=device)
    receipt_f32 = f32.compile()
    lat_f32 = latencies(f32, numpy.random.RandomState(3))
    log("f32 engine: %s, latency ms per rung %s" % (receipt_f32,
                                                    lat_f32))

    t0 = time.perf_counter()
    calib = numpy.random.RandomState(1).uniform(
        -1, 1, (64,) + shape).astype(numpy.float32)
    qparams, calibration = quantize_model_spec(plans, params, calib,
                                               device=device)
    log("calibrated %d layers on 64 samples in %.1fs, clip fraction %g"
        % (len(calibration.layers), time.perf_counter() - t0,
           calibration.clip_fraction))
    requests = numpy.random.RandomState(2).uniform(
        -1, 1, (N_REQUESTS,) + shape).astype(numpy.float32)

    # -- the main path: int8 engine + batcher, launches counted --------
    matmul_int8.launches = 0
    int8 = AOTEngine(plans, qparams, shape, ladder=LADDER, device=device)
    receipt_int8 = int8.compile()
    warm_launches = matmul_int8.launches
    before = matmul_int8.launches
    int8.infer(requests[:1])
    per_dispatch = matmul_int8.launches - before
    batcher = ContinuousBatcher(int8, max_delay_s=0.05).start()
    answers = [None] * N_REQUESTS
    errors = []

    def client(ids):
        try:
            pending = [(i, batcher.submit(requests[i])) for i in ids]
            for i, req in pending:
                if not req.done.wait(120):
                    raise TimeoutError("request %d timed out" % i)
                if req.error is not None:
                    raise req.error
                answers[i] = req.result
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=client,
                                args=(range(t, N_REQUESTS, N_THREADS),))
               for t in range(N_THREADS)]
    t0 = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(300)
    served_s = time.perf_counter() - t0
    batcher.stop()
    if any(thread.is_alive() for thread in threads):
        raise RuntimeError("a client thread did not finish")
    if errors:
        raise errors[0]
    want = int8.infer(requests)   # rung 32 chunks
    launches = matmul_int8.launches
    # -- end of the counted run ------------------------------------------

    got = numpy.stack(answers)
    if per_dispatch != 16:
        raise AssertionError("an int8 VGG16 dispatch launched the kernel "
                             "%d times, expected 16" % per_dispatch)
    if warm_launches != 16 * len(LADDER):
        raise AssertionError("warm-up launched %d, expected %d"
                             % (warm_launches, 16 * len(LADDER)))
    if not numpy.isfinite(got).all() or got.shape != (N_REQUESTS, 1000):
        raise AssertionError("int8 answers: shape %s, finite %s" % (
            got.shape, numpy.isfinite(got).all()))
    if not (got == want).all():
        raise AssertionError("batched answers differ from engine.infer "
                             "in %d rows" % (got != want).any(1).sum())
    lat_int8 = latencies(int8, numpy.random.RandomState(3))
    f32_out = f32.infer(requests)
    if not numpy.isfinite(f32_out).all():
        raise AssertionError("f32 outputs are not finite")
    agree = float((f32_out.argmax(1) == got.argmax(1)).mean())

    # -- the port's CPU forward on two samples as the reference --------
    cpu = Device(backend="cpu")
    x2 = torch.from_numpy(requests[:2])
    with torch.inference_mode():
        ref_f32 = build_forward(plans)(params_from_jax(params, cpu),
                                       x2).numpy()
        ref_int8 = build_quantized_forward(plans)(
            params_from_jax(qparams, cpu), x2).numpy()
    err_f32 = float(numpy.abs(f32_out[:2] - ref_f32).max())
    err_int8 = float(numpy.abs(got[:2] - ref_int8).max())
    if not numpy.allclose(f32_out[:2], ref_f32, rtol=1e-3, atol=1e-7):
        raise AssertionError("f32 engine vs CPU forward: max abs %g"
                             % err_f32)
    if err_int8 > 1e-3:
        raise AssertionError("int8 engine vs CPU forward: max abs %g"
                             % err_int8)
    # the rungs' graphs against the raw forward, and swap_params seen by
    # the next replay (f32: halved weights; int8: negated int8 weights)
    def make_x(rung):
        return numpy.random.RandomState(rung).uniform(
            -1, 1, (rung,) + shape).astype(numpy.float32)

    graphs = {
        "f32": hold_rungs(f32, make_x, swap=[
            {k: None if v is None else v * numpy.float32(0.5)
             for k, v in e.items()} for e in params]),
        "int8": hold_rungs(int8, make_x, swap=[
            dict(e, weights=-e["weights"]) if e.get("weights_scale")
            is not None else e for e in qparams])}
    log("serve graphs: " + json.dumps(graphs))
    summary = {
        "model": "vgg16", "ladder": list(LADDER),
        "f32_receipt": receipt_f32, "int8_receipt": receipt_int8,
        "f32_latency_ms": lat_f32, "int8_latency_ms": lat_int8,
        "requests": N_REQUESTS, "threads": N_THREADS,
        "batcher_rungs": batcher.rungs, "served_s": served_s,
        "launches_per_dispatch": per_dispatch,
        "top1_agreement_f32_int8": agree,
        "cpu_ref_max_abs_f32": err_f32, "cpu_ref_max_abs_int8": err_int8,
    }
    log("serve: " + json.dumps(summary))
    return launches, per_dispatch


def f32_bound(nbytes, flops):
    """(bound_ms, bound_by) from bytes moved and f32 operations."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def max_rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max() /
            want.abs().max().clamp_min(1e-30)).item()


def max_ulp(got, want):
    import torch
    return (got.view(torch.int32).long() -
            want.view(torch.int32).long()).abs().max().item()


def record(what, shape, max_abs, ms, plain_ms, library_ms, bound_ms,
           bound_by, **extra):
    rec = {"what": what, "shape": shape, "max_abs_err": max_abs, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    rec.update(extra)
    return rec


def gather_dataset(n, sample, dtype, gen):
    """A seeded dataset of ``n`` rows on the card: f32 normals or
    0..255 integers."""
    import torch
    shape = (n,) + tuple(sample)
    if dtype == torch.float32:
        return torch.randn(shape, generator=gen, device="cuda")
    return torch.randint(0, 256, shape, generator=gen, device="cuda",
                         dtype=dtype)


def time_gather(data, batch, index_dtype, gen, rounds=8):
    """Device ms a call of ``gather_minibatch`` (to f32) and of the
    library's ``index_select(0, idx).to(float32)`` over ``data``, cold:
    the calls cycle through index vectors that together cover the
    dataset once (``randperm(n).view(-1, batch)``), so a call reads
    rows no call of the last n / batch - 1 read (cold where the dataset
    exceeds the L2: :func:`cold_dataset`).  Returns (ms, library_ms,
    the index vectors)."""
    import torch
    from veles_tpu_torch.ops.gather import gather_minibatch
    n = data.shape[0]
    order = torch.randperm(n, generator=gen, device="cuda")
    sets = [(idx.to(index_dtype).contiguous(),)
            for idx in order[:n - n % batch].view(-1, batch)]
    ms = cold_ms(lambda idx: gather_minibatch(data, idx, torch.float32),
                 sets, rounds)
    library_ms = cold_ms(
        lambda idx: data.index_select(0, idx).to(torch.float32), sets,
        rounds)
    return ms, library_ms, sets


def cold_dataset(data):
    """Whether :func:`time_gather` reads ``data`` cold: a dataset over
    ``COLD_BYTES`` cannot stay in the L2 (the MNIST train set, 47 MB,
    can; its 78 KB minibatch is launch-bound either way)."""
    return data.numel() * data.element_size() > COLD_BYTES


def gather_bound(batch, row, itemsize, index_bytes=4):
    """(bound_ms, bound_by): each gathered element read once and written
    as f32 once, the indices read once."""
    return f32_bound(batch * row * (itemsize + 4) + index_bytes * batch, 0)


def check_gather(what, n, sample, batch, dtype, gen,
                 index_dtype=None):
    """gather_minibatch vs its plain version: bit-equal, twice, on the
    first index vector of the rotation and on out-of-range indices;
    timed cold (:func:`time_gather`) on the card's clock."""
    import torch
    from veles_tpu_torch.ops.gather import (gather_minibatch,
                                            gather_minibatch_reference)
    index_dtype = index_dtype or torch.int32
    data = gather_dataset(n, sample, dtype, gen)
    before = dict(gather_minibatch.paths)
    ms, library_ms, sets = time_gather(data, batch, index_dtype, gen)
    paths = {k: v - before[k] for k, v in gather_minibatch.paths.items()
             if v != before[k]}
    idx = sets[0][0]
    wild = idx.clone()
    wild[:3] = torch.tensor([-1, n, 2 ** 31 - 1], dtype=index_dtype)
    for probe in (idx, wild):
        got = gather_minibatch(data, probe, torch.float32)
        again = gather_minibatch(data, probe, torch.float32)
        want = gather_minibatch_reference(data, probe, torch.float32)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)):
            raise AssertionError("gather %s: differs from the plain "
                                 "version or between runs" % what)
    bound_ms, bound_by = gather_bound(batch, data[0].numel(),
                                      data.element_size(),
                                      idx.element_size())
    return record(
        what, "%s %s -> %d rows f32, %s indices" % (
            "x".join(map(str, data.shape)), str(dtype).split(".")[-1],
            batch, str(index_dtype).split(".")[-1]),
        (got - want).abs().max().item(), ms,
        cuda_ms(lambda: gather_minibatch_reference(data, idx,
                                                   torch.float32), 20),
        library_ms, bound_ms, bound_by, cold_l2=cold_dataset(data),
        dataset_mb=data.numel() * data.element_size() / 1e6,
        rotation=len(sets), paths=paths)


def gather_cases(gen):
    """The gather kernel bit-equal to its plain version, and the same
    bits twice, for every dtype pair, widths 1, 3, 784 and 150,528,
    int32 and int64 indices with out-of-range ones, an unaligned base
    (a view 1 element into its storage) and batches 1 and 4,096; an
    int64 gather is put in ``ONE_KERNEL_CALLS`` (it must launch one
    kernel and nothing else)."""
    import torch
    from veles_tpu_torch.ops.gather import (gather_minibatch,
                                            gather_minibatch_reference)
    pairs = [(torch.uint8, torch.uint8), (torch.uint8, torch.float32),
             (torch.int8, torch.int8), (torch.int8, torch.float32),
             (torch.int32, torch.int32), (torch.int32, torch.float32),
             (torch.float32, torch.float32)]
    before = dict(gather_minibatch.paths)
    cases = 0
    for in_dtype, out_dtype in pairs:
        for width in (1, 3, 784, 150528):
            for offset in (0, 1):
                rows = 11
                if in_dtype == torch.float32:
                    flat = torch.randn(offset + rows * width, generator=gen,
                                       device="cuda")
                else:
                    low = {torch.uint8: 0, torch.int8: -128,
                           torch.int32: -2 ** 31}[in_dtype]
                    high = {torch.uint8: 256, torch.int8: 128,
                            torch.int32: 2 ** 31 - 1}[in_dtype]
                    flat = torch.randint(low, high, (offset + rows * width,),
                                         generator=gen, device="cuda",
                                         dtype=in_dtype)
                data = flat[offset:].view(rows, width)
                for index_dtype in (torch.int32, torch.int64):
                    big = 2 ** 40 if index_dtype == torch.int64 else \
                        2 ** 31 - 1
                    batches = [torch.tensor([7], dtype=index_dtype),
                               torch.randint(-3, rows + 3, (4096,),
                                             generator=gen, device="cuda"
                                             ).to(index_dtype)]
                    batches[1][:2] = torch.tensor([big, -big])
                    if width == 150528:
                        batches[1] = batches[1][:64]
                    for idx in batches:
                        idx = idx.to("cuda")
                        got = gather_minibatch(data, idx, out_dtype)
                        again = gather_minibatch(data, idx, out_dtype)
                        want = gather_minibatch_reference(data, idx,
                                                          out_dtype)
                        if not (got.dtype == out_dtype and
                                torch.equal(got, want) and
                                torch.equal(got, again)):
                            raise AssertionError(
                                "gather %s -> %s, width %d, offset %d, "
                                "%s indices, batch %d: differs from the "
                                "plain version or between runs" % (
                                    in_dtype, out_dtype, width, offset,
                                    index_dtype, idx.shape[0]))
                        cases += 1
    torch.cuda.synchronize()
    paths = {k: v - before[k] for k, v in gather_minibatch.paths.items()}
    if not (paths["vec4"] and paths["scalar"]):
        raise AssertionError("gather cases: paths %s, expected both"
                             % paths)
    data = gather_dataset(256, (784,), torch.uint8, gen)
    idx = torch.arange(100, device="cuda", dtype=torch.int64)
    gather_minibatch(data, idx, torch.float32)
    ONE_KERNEL_CALLS["gather_minibatch int64 indices"] = (
        lambda: gather_minibatch(data, idx, torch.float32), "gather")
    return {"cases": cases, "paths": paths}


def conv_operands(shape, co, ksize, padding, sliding, activation, gen):
    """Seeded x and (y, dy) of the layer's output shape on the card; y
    in the activation's range (ReLU zeros included)."""
    import torch
    from veles_tpu_torch.models.all2all import All2AllTanh
    n, h, w, _ = shape
    left, top, right, bottom = padding
    sx, sy = sliding
    oh = (h + top + bottom - ksize[0]) // sy + 1
    ow = (w + left + right - ksize[1]) // sx + 1
    x = torch.randn(shape, generator=gen, device="cuda")
    z = torch.randn((n, oh, ow, co), generator=gen, device="cuda")
    y = z.clamp_min(0) if activation == "strict_relu" else \
        All2AllTanh.A * torch.tanh(All2AllTanh.B * z)
    dy = torch.randn((n, oh, ow, co), generator=gen, device="cuda")
    return x, y, dy


def wgrad_bound(x_numel, p, r, co, level):
    """(bound_ms, bound_by) of one wgrad call: x read once, y and dy read
    once, err written once, grad_w and grad_b written once, against its
    2 P R Co products: three bf16 products at level 0 (bf16x3, the
    tensor cores' rate), one f32 product at levels 1 and 2."""
    nbytes = 4 * (x_numel + 3 * p * co + r * co + co)
    flops = 2.0 * p * r * co
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 3 * flops / PEAK_BF16_FLOPS if level == 0 else \
        flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def wgrad_library(x, y, dy, ksize, padding, sliding, activation):
    """One PyTorch call set for the same function (timed only, never
    used by the port): the activation epilogue, cuDNN's
    ``conv2d_weight`` and the bias sum.  Returns the callable; x is
    padded here, outside the timed call, where the padding is
    asymmetric."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.ops.conv_vjp import activation_grad
    left, top, right, bottom = padding
    sx, sy = sliding
    wshape = (y.shape[-1], x.shape[-1]) + tuple(ksize)
    if (left, top) == (right, bottom):
        xc, pad = x.permute(0, 3, 1, 2), (top, left)
    else:
        xc = F.pad(x, (0, 0, left, right, top, bottom)).permute(0, 3, 1, 2)
        pad = (0, 0)

    def library():
        e = activation_grad(activation, y, dy)
        torch.nn.grad.conv2d_weight(xc, wshape, e.permute(0, 3, 1, 2),
                                    stride=(sy, sx), padding=pad)
        e.sum(dim=(0, 1, 2))
    return library


#: operands below this many bytes are timed warm: a call that small is
#: launch-bound, and copies past the L2 would make a window of calls
#: outlast its spin
WARM_BYTES = 1e6


def time_wgrad(operands, kw, rounds=5):
    """Device ms a call of ``conv_wgrad`` and of the library's call set
    (:func:`wgrad_library`), cold: the calls cycle through copies of the
    operands that together exceed ``COLD_BYTES``, as a training step
    reads each layer's x, y and dy once (operands under ``WARM_BYTES``
    are not copied).  ``kw`` holds the keyword arguments of
    ``conv_wgrad`` (``precision_level`` among them).  Returns (ms,
    library_ms, the number of operand sets)."""
    from veles_tpu_torch.ops.conv_vjp import conv_wgrad
    nbytes = sum(4 * t.numel() for t in operands)
    copies = cold_sets(nbytes) if nbytes >= WARM_BYTES else 1
    sets = [operands] + [tuple(t.clone() for t in operands)
                         for _ in range(copies - 1)]
    ms = cold_ms(lambda x, y, dy: conv_wgrad(x, y, dy, **kw), sets, rounds)
    library = [wgrad_library(x, y, dy, kw["ksize"], kw["padding"],
                             kw["sliding"], kw["activation"])
               for x, y, dy in sets]
    library_ms = cold_ms(lambda fn: fn(), [(fn,) for fn in library],
                         rounds)
    return ms, library_ms, len(sets)


def check_wgrad(what, shape, co, ksize, padding, sliding, activation, gen,
                level=0):
    """conv_wgrad vs its plain version at ``level``: grad_w and grad_b
    within max-rel 1e-5 of float64 and 2e-6 of the plain version at the
    same level on the same inputs, err within 1 ulp, the same bits
    twice, the design ``plan_wgrad`` picks (level 0: ``tc_bf16x3``).
    The kernel and the library are timed cold on the card's clock
    (:func:`time_wgrad`), the plain version with :func:`cuda_ms`."""
    import torch
    from veles_tpu_torch.ops.common import sm_count
    from veles_tpu_torch.ops.conv_vjp import (conv_wgrad,
                                              conv_wgrad_reference,
                                              plan_wgrad)
    x, y, dy = conv_operands(shape, co, ksize, padding, sliding,
                             activation, gen)
    kw = dict(activation=activation, ksize=ksize, padding=padding,
              sliding=sliding, precision_level=level)
    n, oh, ow = y.shape[:3]
    path, tile, splits, chunk = plan_wgrad(
        (n, oh, ow, shape[-1]), co, ksize, level, x.dtype,
        sm_count(x.device))
    if level == 0 and path != "tc_bf16x3":
        raise AssertionError("conv_wgrad %s: level 0 planned on %s"
                             % (what, path))
    before = dict(conv_wgrad.paths)
    gw, gb, err = conv_wgrad(x, y, dy, **kw)
    gw2, gb2, err2 = conv_wgrad(x, y, dy, **kw)
    torch.cuda.synchronize()
    served = {k: v - before[k] for k, v in conv_wgrad.paths.items()}
    if served[path] != 2 or sum(served.values()) != 2:
        raise AssertionError("conv_wgrad %s: designs %s, expected %s"
                             % (what, served, path))
    if not (torch.equal(gw, gw2) and torch.equal(gb, gb2) and
            torch.equal(err, err2)):
        raise AssertionError("conv_wgrad %s: two runs differ" % what)
    rgw, rgb, _ = conv_wgrad_reference(x.double(), y.double(), dy.double(),
                                       **kw)
    pgw, pgb, ferr = conv_wgrad_reference(x, y, dy, **kw)
    rel_w, rel_b = max_rel(gw, rgw), max_rel(gb, rgb)
    plain_w, plain_b = max_rel(gw, pgw), max_rel(gb, pgb)
    ulp = max_ulp(err, ferr)
    if rel_w > 1e-5 or rel_b > 1e-5 or ulp > 1:
        raise AssertionError("conv_wgrad %s: grad_w max-rel %g, grad_b "
                             "max-rel %g, err %d ulp" % (what, rel_w, rel_b,
                                                         ulp))
    if plain_w > 2e-6 or plain_b > 2e-6:
        raise AssertionError("conv_wgrad %s: grad_w max-rel %g, grad_b "
                             "max-rel %g from the level-%d plain version"
                             % (what, plain_w, plain_b, level))
    del gw2, gb2, err2, pgw, pgb, ferr, rgb
    p, r = n * oh * ow, ksize[0] * ksize[1] * shape[-1]
    bound_ms, bound_by = wgrad_bound(x.numel(), p, r, co, level)
    big = p * r * co > 1e10
    ms, library_ms, rotation = time_wgrad((x, y, dy), kw,
                                          rounds=3 if big else 10)
    return record(
        what, "x %s, k %dx%d, Co %d, pad %s, stride %s, %s, level %d" % (
            "x".join(map(str, shape)), ksize[0], ksize[1], co, padding,
            sliding, activation, level),
        (gw.double() - rgw).abs().max().item(), ms,
        cuda_ms(lambda: conv_wgrad_reference(x, y, dy, **kw),
                3 if big else 10),
        library_ms, bound_ms, bound_by,
        grad_w_max_rel=rel_w, grad_b_max_rel=rel_b,
        plain_grad_w_max_rel=plain_w, plain_grad_b_max_rel=plain_b,
        err_max_ulp=ulp, path=path, tile=list(tile), splits=splits,
        chunk=chunk, cold_l2=4 * (x.numel() + 2 * y.numel()) >= WARM_BYTES,
        rotation=rotation)


def pool_operands(shape, window, sliding, gen):
    """Seeded ReLU-like x (zeros tie), its pooled y and a cotangent dy,
    on the card."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.models.pooling import _pool
    x = torch.randn(shape, generator=gen, device="cuda").clamp_min(0)
    y = _pool(x, window, sliding, float("-inf"), F.max_pool2d).contiguous()
    dy = torch.randn(y.shape, generator=gen, device="cuda")
    return x, y, dy


def time_pool(shape, window, sliding, gen, rounds=5):
    """Device ms a call of ``max_pool_bwd`` and of the library's
    ``max_pool2d_with_indices_backward`` (on indices made once by
    ``F.max_pool2d``), cold: the calls cycle through operand sets that
    together exceed ``COLD_BYTES``.  Returns (ms, library_ms, the first
    operand set)."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.ops.pool_bwd import max_pool_bwd
    ky, kx = window
    sx, sy = sliding
    first = pool_operands(shape, window, sliding, gen)
    x, y, dy = first
    sets = [first] + [pool_operands(shape, window, sliding, gen)
                      for _ in range(cold_sets(
                          4 * (2 * x.numel() + 2 * y.numel())) - 1)]
    ms = cold_ms(lambda a, b, c: max_pool_bwd(a, b, c, window=window,
                                               sliding=sliding),
                 sets, rounds)
    library = []
    for a, b, c in sets:
        ac = a.permute(0, 3, 1, 2)
        _, indices = F.max_pool2d(ac, (ky, kx), (sy, sx), ceil_mode=True,
                                  return_indices=True)
        library.append((c.permute(0, 3, 1, 2), ac, indices))
    library_ms = cold_ms(
        lambda c, a, i: torch.ops.aten.max_pool2d_with_indices_backward(
            c, a, [ky, kx], [sy, sx], [0, 0], [1, 1], True, i),
        library, rounds)
    return ms, library_ms, first


def pool_bound(x, y):
    """(bound_ms, bound_by): x read and dx written once, y and dy read
    once."""
    return f32_bound(4 * (2 * x.numel() + 2 * y.numel()), 0)


def check_pool(what, shape, window, sliding, gen):
    """max_pool_bwd vs its plain version: bit-equal, twice; timed cold
    (:func:`time_pool`) on the card's clock, with the design that
    served it."""
    import torch
    from veles_tpu_torch.ops.pool_bwd import (max_pool_bwd,
                                              max_pool_bwd_reference)
    before = dict(max_pool_bwd.paths)
    ms, library_ms, (x, y, dy) = time_pool(shape, window, sliding, gen)
    paths = {k: v - before[k] for k, v in max_pool_bwd.paths.items()
             if v != before[k]}
    got = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
    again = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
    want = max_pool_bwd_reference(x, y, dy, window=window, sliding=sliding)
    torch.cuda.synchronize()
    if not (torch.equal(got.view(torch.int32), want.view(torch.int32)) and
            torch.equal(got.view(torch.int32), again.view(torch.int32))):
        raise AssertionError("max_pool_bwd %s: differs from the plain "
                             "version or between runs" % what)
    bound_ms, bound_by = pool_bound(x, y)
    ky, kx = window
    big = x.numel() > 5e7
    return record(
        what, "x %s, window %dx%d, stride %s" % (
            "x".join(map(str, shape)), ky, kx, sliding),
        (got - want).abs().max().item(), ms,
        cuda_ms(lambda: max_pool_bwd_reference(x, y, dy, window=window,
                                               sliding=sliding),
                3 if big else 5),
        library_ms, bound_ms, bound_by, cold_l2=True, paths=paths)


#: VGG16's five pools (2x2/2) as (H, W, C) of their inputs
VGG16_POOLS = ((224, 224, 64), (112, 112, 128), (56, 56, 256),
               (28, 28, 512), (14, 14, 512))


def pool_cases(gen):
    """The pool kernel bit-equal to its plain version, and the same bits
    twice: every VGG16 pool shape at batch 2, an odd ceil-mode tail, C =
    3 and 130, windows with gaps and one wholly in the padding, inputs
    whose windows hold only -inf real taps, NaN inputs, AlexNet's 3x3/2
    at 13x13x96 and a view off 16 bytes; each served by the design the
    geometry asks for (``max_pool_bwd.paths``)."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.models.pooling import _pool
    from veles_tpu_torch.ops.pool_bwd import (max_pool_bwd,
                                              max_pool_bwd_reference)
    cases = [((2,) + hwc, (2, 2), (2, 2), "plain", "cells")
             for hwc in VGG16_POOLS]
    cases += [((3, 7, 9, 8), (2, 2), (2, 2), "plain", "cells"),
              ((2, 9, 11, 3), (2, 2), (2, 2), "plain", "cells"),
              ((2, 9, 11, 130), (2, 2), (2, 2), "plain", "cells"),
              ((2, 9, 10, 4), (2, 2), (3, 3), "plain", "cells"),
              ((2, 5, 5, 8), (1, 1), (3, 3), "neg_inf", "cells"),
              ((2, 7, 9, 64), (2, 2), (2, 2), "neg_inf", "cells"),
              ((2, 7, 9, 64), (3, 3), (2, 2), "neg_inf", "overlap"),
              ((2, 14, 14, 64), (2, 2), (2, 2), "nan", "cells"),
              ((2, 13, 13, 96), (3, 3), (2, 2), "nan", "overlap"),
              ((8, 13, 13, 96), (3, 3), (2, 2), "plain", "overlap"),
              ((2, 13, 13, 5), (3, 3), (2, 2), "plain", "overlap"),
              ((2, 8, 8, 4), (2, 2), (2, 2), "unaligned", "cells")]
    before = dict(max_pool_bwd.paths)
    want_paths = dict.fromkeys(before, 0)
    for shape, window, sliding, kind, design in cases:
        size = int(numpy.prod(shape))
        offset = 1 if kind == "unaligned" else 0
        x = torch.randn(offset + size, generator=gen,
                        device="cuda").clamp_min(0)[offset:].view(shape)
        if kind == "neg_inf":
            x[:, -1] = float("-inf")
            x[:, :, -1] = float("-inf")
            x[:, :2, :2] = float("-inf")
        elif kind == "nan":
            x[torch.rand(shape, generator=gen, device="cuda") < 0.2] = \
                float("nan")
        y = _pool(x, window, sliding, float("-inf"),
                  F.max_pool2d).contiguous()
        dy = torch.randn(y.shape, generator=gen, device="cuda")
        got = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
        again = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
        want = max_pool_bwd_reference(x, y, dy, window=window,
                                      sliding=sliding)
        want_paths[design] += 2
        torch.cuda.synchronize()
        bits = got.view(torch.int32)
        if not (torch.equal(bits, want.view(torch.int32)) and
                torch.equal(bits, again.view(torch.int32))):
            raise AssertionError(
                "max_pool_bwd %s %s/%s %s: differs from the plain version "
                "or between runs" % (shape, window, sliding, kind))
    paths = {k: v - before[k] for k, v in max_pool_bwd.paths.items()}
    if paths != want_paths:
        raise AssertionError("pool cases: designs %s, expected %s"
                             % (paths, want_paths))
    return {"cases": len(cases), "paths": paths}


def pool_step(gen):
    """VGG16's five pool backward shapes at the training batch, each
    timed cold on the card's clock like :func:`time_pool`: the kernel's
    summed ms a step beside the library's and the summed bound."""
    rows = []
    for h, w, c in VGG16_POOLS:
        ms, library_ms, (x, y, _) = time_pool((TRAIN_BATCH, h, w, c),
                                              (2, 2), (2, 2), gen,
                                              rounds=3)
        rows.append({"shape": [TRAIN_BATCH, h, w, c], "ms": ms,
                     "library_ms": library_ms,
                     "bound_ms": pool_bound(x, y)[0]})
        del x, y
    return {"pools": rows,
            "ms": sum(r["ms"] for r in rows),
            "library_ms": sum(r["library_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows)}


class PlainKernels(object):
    """Swaps the train path's kernels for their plain versions (for the
    comparison runs only), and back.  ``names`` picks a subset (by
    wrapper name)."""

    NAMES = ("conv_wgrad", "max_pool_bwd", "attention_fwd", "attention_dq",
             "attention_dkv")

    def __init__(self, names=NAMES):
        self.names = names

    @staticmethod
    def _modules():
        from veles_tpu_torch.ops import attention, conv_vjp, pool_bwd
        return {"conv_wgrad": conv_vjp, "max_pool_bwd": pool_bwd,
                "attention_fwd": attention, "attention_dq": attention,
                "attention_dkv": attention}

    def __enter__(self):
        from veles_tpu_torch.ops import attention, conv_vjp, pool_bwd
        modules = self._modules()
        self.saved = {name: getattr(modules[name], name)
                      for name in self.names}

        def wgrad(x, y, dy, *, activation, ksize, padding, sliding,
                  precision_level=0):
            return conv_vjp.conv_wgrad_reference(
                x, y, dy, activation=activation, ksize=ksize,
                padding=padding, sliding=sliding,
                precision_level=precision_level)

        plain = {"conv_wgrad": wgrad,
                 "max_pool_bwd": pool_bwd.max_pool_bwd_reference,
                 "attention_fwd": attention.attention_fwd_reference,
                 "attention_dq": attention.attention_dq_reference,
                 "attention_dkv": attention.attention_dkv_reference}
        for name in self.names:
            setattr(modules[name], name, plain[name])
        return self

    def __exit__(self, *exc):
        modules = self._modules()
        for name, fn in self.saved.items():
            setattr(modules[name], name, fn)


def state_max_rel(got, want):
    worst = 0.0
    for g, w in zip(got, want):
        for key, leaf in w.items():
            if leaf is not None:
                worst = max(worst, max_rel(g[key], leaf))
    return worst


def clone_state(state):
    """A copy of a state list (a donated step's returned state is its
    own buffers, which its next call rewrites)."""
    return [{k: None if v is None else v.clone() for k, v in e.items()}
            for e in state]


def all_finite(state):
    import torch
    return all(bool(torch.isfinite(leaf).all())
               for entry in state for leaf in entry.values()
               if leaf is not None)


def vgg16_step_bounds(batch):
    """Summed bounds of one VGG16 step's 13 wgrads and 5 pool backwards,
    and of one minibatch gather, from the layer shapes.  The wgrad bound
    is each layer's :func:`wgrad_bound` at level 0 (three bf16 products
    at 989 TFLOP/s against its bytes), summed over the layers; the f32
    figure (one product at 67 TFLOP/s) is what levels 1 and 2 would
    take."""
    from veles_tpu_torch.models.zoo import vgg_layers
    h = w = 224
    ci = 3
    wgrad_ms = wgrad_f32_ms = wgrad_flops = pool_bytes = 0
    for spec in vgg_layers(config="D"):
        if spec["type"] == "conv_str":
            co = spec["n_kernels"]
            p = batch * h * w
            wgrad_flops += 2.0 * p * 9 * ci * co
            wgrad_ms += wgrad_bound(p * ci, p, 9 * ci, co, 0)[0]
            wgrad_f32_ms += wgrad_bound(p * ci, p, 9 * ci, co, 1)[0]
            ci = co
        elif spec["type"] == "max_pooling":
            pool_bytes += 4 * (2 * batch * h * w * ci +
                               2 * batch * (h // 2) * (w // 2) * ci)
            h, w = h // 2, w // 2
    gather_bytes = batch * 224 * 224 * 3 * 8 + 4 * batch
    return {"wgrad_gflop": wgrad_flops / 1e9,
            "wgrad_bound_ms": wgrad_ms,
            "wgrad_f32_bound_ms": wgrad_f32_ms,
            "pool_gb": pool_bytes / 1e9,
            "pool_bound_ms": f32_bound(pool_bytes, 0)[0],
            "gather_mb": gather_bytes / 1e6,
            "gather_bound_ms": f32_bound(gather_bytes, 0)[0]}


def small_steps_vs_cpu(device, specs, input_shape, seed, classes=10):
    """2 steps of a small model on the card (kernels) and on the CPU
    (plain versions): loss within 1e-5 rel, leaves within 1e-4."""
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.convert import state_from_jax, state_to_numpy
    from veles_tpu_torch.models.zoo import build_plans_and_state
    plans, state, _ = build_plans_and_state(specs, input_shape, seed=seed)
    rng = numpy.random.RandomState(seed + 1)
    data = [(rng.randn(16, *input_shape).astype(numpy.float32),
             rng.randint(0, classes, 16).astype(numpy.int32))
            for _ in range(2)]
    cpu = Device(backend="cpu")
    results = []
    for dev in (device, cpu):
        # a donated step owns its state on one device: one step each
        step = build_train_step(plans)
        s = state_from_jax(state, dev)
        losses = []
        for x, t in data:
            s, m = step(s, dev.put(x), dev.put(t), 16.0)
            losses.append(float(m["loss"]))
        results.append((losses, state_to_numpy(s)))
    (card_loss, card_state), (cpu_loss, cpu_state) = results
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss))
    leaf_rel = state_max_rel(
        [{k: torch.from_numpy(v) for k, v in e.items() if v is not None}
         for e in card_state],
        [{k: torch.from_numpy(v) for k, v in e.items() if v is not None}
         for e in cpu_state])
    if loss_rel > 1e-5 or leaf_rel > 1e-4:
        raise AssertionError("small model: card vs CPU loss rel %g, leaf "
                             "max-rel %g" % (loss_rel, leaf_rel))
    return {"loss_rel": loss_rel, "leaf_max_rel": leaf_rel}


def train_small_vs_cpu(device):
    """A small convnet (strided, padded, overlapping pools)."""
    specs = [
        {"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3,
         "padding": 1, "learning_rate": 0.05, "gradient_moment": 0.9},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "conv_tanh", "n_kernels": 8, "kx": 3, "ky": 3,
         "padding": (1, 0, 2, 1), "sliding": (1, 2),
         "learning_rate": 0.05, "gradient_moment": 0.9},
        {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.05, "gradient_moment": 0.9}]
    return small_steps_vs_cpu(device, specs, (20, 18, 3), 4)


def train_phase(device):
    """VGG16 at batch 32 through the epoch, eval and step entry points;
    returns (launch counts, summary)."""
    import torch
    from veles_tpu_torch import threefry
    from veles_tpu_torch.compiler import (build_eval_epoch,
                                          build_train_epoch,
                                          build_train_step)
    from veles_tpu_torch.convert import state_from_jax
    from veles_tpu_torch.models.zoo import build_plans_and_state, \
        vgg_layers
    from veles_tpu_torch.ops.conv_vjp import conv_wgrad
    from veles_tpu_torch.ops.gather import gather_minibatch
    from veles_tpu_torch.ops.pool_bwd import max_pool_bwd

    shape = (224, 224, 3)
    t0 = time.perf_counter()
    plans, host_state, _ = build_plans_and_state(vgg_layers(config="D"),
                                                 shape, seed=0)
    state0 = state_from_jax(host_state, device)
    del host_state
    gen = torch.Generator(device="cuda").manual_seed(7)
    dataset = torch.rand((TRAIN_SAMPLES,) + shape, generator=gen,
                         device="cuda") * 2 - 1
    labels = torch.randint(0, 1000, (TRAIN_SAMPLES,), generator=gen,
                           device="cuda", dtype=torch.int32)
    order = torch.randperm(TRAIN_SAMPLES, generator=gen,
                           device="cuda").to(torch.int32)
    x, t = dataset[:TRAIN_BATCH], labels[:TRAIN_BATCH]
    torch.cuda.synchronize()
    log("train set-up: %.1fs" % (time.perf_counter() - t0))
    kernels = (gather_minibatch, conv_wgrad, max_pool_bwd)

    def counts():
        return [k.launches for k in kernels]

    # -- the main path: launches counted ----------------------------------
    for kernel in kernels:
        kernel.launches = 0
    for kernel in kernels:
        kernel.paths = dict.fromkeys(kernel.paths, 0)
    t0 = time.perf_counter()
    state1, totals = build_train_epoch(plans, TRAIN_BATCH)(
        state0, dataset, labels, order)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch_counts = counts()
    params1 = [{"weights": e["weights"], "bias": e["bias"]} for e in state1]
    t0 = time.perf_counter()
    evaluated = build_eval_epoch(plans, TRAIN_BATCH)(params1, dataset,
                                                     labels, order)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = counts()
    del state1, params1
    # the captured, donated step (the main path) and the raw step, which
    # the comparisons with the plain versions swap kernels under
    step = build_train_step(plans)
    raw = build_train_step(plans, donate=False)
    torch.cuda.reset_peak_memory_stats()
    state, losses, step_ms, per_step = state0, [], [], []
    for _ in range(3):
        before = counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, x, t, float(TRAIN_BATCH))
        end.record()
        losses.append(m["loss"])
        per_step.append([a - b for a, b in zip(counts(), before)])
        step_ms.append((start, end))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [s.elapsed_time(e) for s, e in step_ms]
    # the donated step rewrites its state at its next call
    kernel_state = clone_state(state)
    step_key = threefry.key(3)
    with RecordMasks() as drawn:
        keyed, keyed_m = step(state0, x, t, float(TRAIN_BATCH), step_key)
    torch.cuda.synchronize()
    launches = dict(zip(("gather_minibatch", "conv_wgrad",
                         "max_pool_bwd"), counts()))
    paths = {"gather_minibatch": dict(gather_minibatch.paths),
             "conv_wgrad": dict(conv_wgrad.paths),
             "max_pool_bwd": dict(max_pool_bwd.paths)}
    # -- end of the counted run -------------------------------------------

    if paths["max_pool_bwd"] != {"cells": launches["max_pool_bwd"],
                                 "overlap": 0} or \
            paths["gather_minibatch"]["vec4"] != \
            launches["gather_minibatch"] or \
            paths["conv_wgrad"] != {"tc_bf16x3": launches["conv_wgrad"],
                                    "simt": 0}:
        raise AssertionError("designs on the train path %s for launches "
                             "%s: expected every pool on cells, every "
                             "gather on vec4, every wgrad on tc_bf16x3"
                             % (paths, launches))

    if epoch_counts != [4, 52, 20] or \
            [a - b for a, b in zip(eval_counts, epoch_counts)] != [4, 0, 0]:
        raise AssertionError("launches: epoch %s, after eval %s; expected "
                             "[4, 52, 20] and 4 more gathers" % (
                                 epoch_counts, eval_counts))
    if any(c != [0, 13, 5] for c in per_step):
        raise AssertionError("launches per step %s, expected [0, 13, 5]"
                             % per_step)
    if int(totals["skipped"]) != 0 or not numpy.isfinite(
            float(totals["loss_mean"])):
        raise AssertionError("train epoch: %s" % totals)
    if int(evaluated["samples"]) != TRAIN_SAMPLES:
        raise AssertionError("eval epoch: %s" % evaluated)
    if not (all_finite(kernel_state) and all_finite(keyed) and
            bool(keyed_m["finite"])):
        raise AssertionError("a state leaf is not finite")
    masks = check_step_masks(plans, step_key, drawn.masks)
    del drawn

    # chained runs drift apart at random init: the weight updates sit
    # near one f32 ulp of the weights, so one rounding moves ReLU masks
    # and pool routes in later steps.  Measured, not held to a limit:
    # the kernels run twice, and the plain versions, over the same 3
    # steps as above.
    chained = {}
    for label in ("kernels_again", "plain"):
        state = state0
        with PlainKernels() if label == "plain" else nullcontext():
            for _ in range(3):
                state, _ = raw(state, x, t, float(TRAIN_BATCH))
        chained[label] = state_max_rel(state, kernel_state)
    del state
    # held to the limits: each of the 3 steps from the same state through
    # the kernels and through the plain versions, cuDNN deterministic so
    # that the kernels are the only difference
    torch.backends.cudnn.deterministic = True
    try:
        state, loss_rel, leaf_rel = state0, 0.0, 0.0
        for _ in range(3):
            kernel_out, km = raw(state, x, t, float(TRAIN_BATCH))
            with PlainKernels():
                plain_out, pm = raw(state, x, t, float(TRAIN_BATCH))
            loss_rel = max(loss_rel, abs(float(km["loss"]) -
                                         float(pm["loss"])) /
                           abs(float(pm["loss"])))
            leaf_rel = max(leaf_rel, state_max_rel(kernel_out, plain_out))
            if not all_finite(kernel_out):
                raise AssertionError("a state leaf is not finite")
            state = kernel_out
    finally:
        torch.backends.cudnn.deterministic = False
    del state, kernel_out, plain_out, step, raw, keyed
    if loss_rel > 1e-5 or leaf_rel > 1e-4:
        raise AssertionError("kernels vs plain versions, step by step: "
                             "loss rel %g, leaf max-rel %g" % (loss_rel,
                                                              leaf_rel))
    summary = {
        "model": "vgg16", "batch": TRAIN_BATCH, "samples": TRAIN_SAMPLES,
        "epoch_s": epoch_s, "eval_s": eval_s,
        "epoch_loss_mean": float(totals["loss_mean"]),
        "epoch_n_err": int(totals["n_err"]),
        "eval_n_err": int(evaluated["n_err"]),
        "step_losses": [float(v) for v in losses],
        "step_ms": step_ms, "peak_memory_gb": peak_gb,
        "launches_per_step": dict(zip(("gather_minibatch", "conv_wgrad",
                                       "max_pool_bwd"), per_step[0])),
        "paths": paths,
        "kernels_vs_plain_loss_rel": loss_rel,
        "kernels_vs_plain_leaf_max_rel": leaf_rel,
        "chained_3_steps_leaf_max_rel": chained,
        "keyed_step_loss": float(keyed_m["loss"]),
        "keyed_step_masks": masks,
        "step_bounds": vgg16_step_bounds(TRAIN_BATCH),
    }
    log("train: " + json.dumps(summary))
    return launches, summary

# -- slice 3: the transformer and its attention kernels -----------------------

#: the zoo transformer at the width of the repo's own workload
#: (veles_tpu/tune/__main__.py): D 512, 8 heads, MLP 2048, T 128, 2 blocks
TF_SHAPE = (128, 512)
TF_BATCH = 64
TF_SAMPLES = 256
TF_HEADS = 8


def transformer_spec():
    from veles_tpu_torch.models.zoo import transformer_layers
    return transformer_layers(blocks=2, heads=TF_HEADS, hidden=2048)


def attention_bound(b, t, dh, dtype, what, level=0):
    """(bound_ms, bound_by) of one attention kernel call: each input read
    once and each output written once, against the products at the rate
    the precision level computes them.  Each product is 2 BH T^2 dh FLOP.
    q k^T (all three kernels) and do v^T (dq, dk/dv) multiply operands of
    the input dtype; p v (forward), ds k (dq), p^T do and ds^T q (dk/dv)
    have an f32 operand, p or ds.  Level 0 (the TPU's bf16x3): three bf16
    products at 989 TFLOP/s for each product of f32 operands; with bf16
    inputs one for q k^T and do v^T and two (hi and lo of p or ds) for
    the others.  Levels 1 and 2: true f32 at 67 TFLOP/s, the typed
    products of bf16 inputs on the bf16 tensor cores; the tensor cores
    and the f32 units may run at once, so the larger of the two times is
    the bound there."""
    import torch
    mat = b * t * dh * (2 if dtype == torch.bfloat16 else 4)
    row = 4 * b * t
    nbytes, typed, f32 = {"fwd": (4 * mat + row, 1, 1),
                          "dq": (5 * mat + 2 * row, 2, 1),
                          "dkv": (6 * mat + 2 * row, 2, 2)}[what]
    product = 2.0 * b * t * t * dh
    if level == 0 and dtype == torch.bfloat16:
        t_ops = (typed + 2 * f32) * product / PEAK_BF16_FLOPS
    elif level == 0:
        t_ops = 3 * (typed + f32) * product / PEAK_BF16_FLOPS
    elif dtype == torch.bfloat16:
        t_ops = max(typed * product / PEAK_BF16_FLOPS,
                    f32 * product / PEAK_F32_FLOPS)
    else:
        t_ops = (typed + f32) * product / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def nan_tailed(x, tail):
    """x copied into the front of a buffer whose next ``tail`` elements
    are NaN: a kernel that reads past the end of x picks the NaN up."""
    import torch
    buf = torch.full((x.numel() + tail,), float("nan"), dtype=x.dtype,
                     device=x.device)
    view = buf[:x.numel()].view(x.shape)
    view.copy_(x)
    return view


def check_attention(what, shape, dtype, gen, level=0, library=None):
    """The three attention kernels vs their plain versions on the card at
    precision ``level``: out, lse, dq, dk, dv within max-rel 1e-5 (bf16:
    1e-2, one bf16 rounding of the outputs), at level 0 in f32 the out at
    least twice as near the level-0 plain version as the level-1 one
    (``out_level1``: the bf16x3 products, not true f32), the same bits on
    a second run, and the same bits again with 64 rows of NaN after each
    operand in memory (the last batch-head's tile reads T rows and no
    more, and its masked key columns add exact zeros); the calls of all
    three counted under the level's design.  ``library``: the SDPA times
    of an earlier call at the same shape, else timed here.  Returns one
    record per kernel."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.ops.attention import (
        attention_dkv, attention_dkv_reference, attention_dq,
        attention_dq_reference, attention_fwd, attention_fwd_reference,
        plan_attention)
    b, t, dh = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    scale = 1.0 / float(numpy.sqrt(dh))
    lv = dict(precision_level=level)
    path = plan_attention(level)
    counters = (attention_fwd, attention_dq, attention_dkv)
    paths = [dict(counter.paths) for counter in counters]
    out, lse = attention_fwd(q, k, v, scale, **lv)
    out2, lse2 = attention_fwd(q, k, v, scale, **lv)
    delta = torch.sum(do.float() * out.float(), dim=-1)
    bwd = (q, k, v, do, lse, delta, scale)
    dq, dq2 = attention_dq(*bwd, **lv), attention_dq(*bwd, **lv)
    (dk, dv), (dk2, dv2) = attention_dkv(*bwd, **lv), attention_dkv(*bwd,
                                                                   **lv)
    torch.cuda.synchronize()
    for counter, before in zip(counters, paths):
        if counter.paths != dict(before, **{path: before[path] + 2}):
            raise AssertionError("attention %s: paths %s after %s, expected "
                                 "two more %s" % (what, counter.paths,
                                                  before, path))
    for name, a, a2 in (("out", out, out2), ("lse", lse, lse2),
                        ("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
        if not torch.equal(a, a2):
            raise AssertionError("attention %s: two runs differ in %s"
                                 % (what, name))
    want_out, want_lse = attention_fwd_reference(q, k, v, scale, **lv)
    want_dq = attention_dq_reference(*bwd, **lv)
    want_dk, want_dv = attention_dkv_reference(*bwd, **lv)
    limit = 1e-5 if dtype == torch.float32 else 1e-2
    rels = {}
    for name, got, want in (("out", out, want_out), ("lse", lse, want_lse),
                            ("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("attention %s: %s not finite"
                                 % (what, name))
        rels[name] = max_rel(got.float(), want.float())
        if rels[name] > limit:
            raise AssertionError("attention %s: %s max-rel %g > %g" % (
                what, name, rels[name], limit))
    if level == 0 and dtype == torch.float32:
        # the level-0 forward computes bf16x3, not true f32: its out sits
        # at least twice as near the level-0 plain version as the level-1
        # one, where a true-f32 forward sits the other way round (both
        # within the 1e-5 above)
        level1_out = attention_fwd_reference(q, k, v, scale,
                                             precision_level=1)[0]
        rels["out_level1"] = max_rel(out, level1_out)
        if 2 * rels["out"] >= rels["out_level1"]:
            raise AssertionError(
                "attention %s: out max-rel %g from the level-0 plain version "
                "is not half its %g from the level-1 one" % (
                    what, rels["out"], rels["out_level1"]))
        del level1_out
    tq, tk, tv, tdo = (nan_tailed(x, 64 * dh) for x in (q, k, v, do))
    tout, tlse = attention_fwd(tq, tk, tv, scale, **lv)
    tails = (tout, tlse,
             attention_dq(tq, tk, tv, tdo, lse, delta, scale, **lv)) + \
        attention_dkv(tq, tk, tv, tdo, lse, delta, scale, **lv)
    for name, got, want in zip(("out", "lse", "dq", "dk", "dv"), tails,
                               (out, lse, dq, dk, dv)):
        if not torch.equal(got, want):
            raise AssertionError("attention %s: NaN after the operands "
                                 "changes %s" % (what, name))
    del tq, tk, tv, tdo, tout, tlse, tails

    big = b * t * t * dh > 1e8
    iters, plain_iters = (20, 5) if big else (50, 20)
    # the library yardstick, timed only: SDPA forward, and its backward
    # (dq, dk and dv together) through autograd.  Kernels and library on
    # the card's clock (device_ms), plain versions with cuda_ms
    if library is None:
        lq, lk, lv_ = (x.detach().clone().requires_grad_()
                       for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(lq, lk, lv_, scale=scale)

        with torch.no_grad():
            lib_fwd = device_ms(sdpa, iters)
        lout = sdpa()
        lib_bwd = device_ms(lambda: torch.autograd.grad(
            lout, (lq, lk, lv_), do, retain_graph=True), iters)
        lib_fwd_bwd = device_ms(lambda: torch.autograd.grad(
            sdpa(), (lq, lk, lv_), do), iters)
        del lout
    else:
        lib_fwd, lib_bwd, lib_fwd_bwd = (
            library["fwd"]["library_ms"], library["dq"]["library_ms"],
            library["dq"]["library_fwd_bwd_ms"])
    label = "%dx%dx%d %s" % (b, t, dh, str(dtype).split(".")[-1])
    common = dict(max_rel=rels, nan_tail="64 rows: the same bits",
                  level=level)
    recs = {}
    for name, fn, plain, lib, err in (
            ("fwd", lambda: attention_fwd(q, k, v, scale, **lv),
             lambda: attention_fwd_reference(q, k, v, scale, **lv), lib_fwd,
             (out.float() - want_out.float()).abs().max().item()),
            ("dq", lambda: attention_dq(*bwd, **lv),
             lambda: attention_dq_reference(*bwd, **lv), lib_bwd,
             (dq.float() - want_dq.float()).abs().max().item()),
            ("dkv", lambda: attention_dkv(*bwd, **lv),
             lambda: attention_dkv_reference(*bwd, **lv), lib_bwd,
             max((dk.float() - want_dk.float()).abs().max().item(),
                 (dv.float() - want_dv.float()).abs().max().item()))):
        bound_ms, bound_by = attention_bound(b, t, dh, dtype, name, level)
        recs[name] = record(
            what, label, err, device_ms(fn, iters),
            cuda_ms(plain, plain_iters), lib, bound_ms, bound_by,
            library_fwd_bwd_ms=lib_fwd_bwd,
            library_covers=("SDPA forward" if name == "fwd" else
                            "SDPA backward: dq, dk and dv together"),
            path=path, **common)
    # the backward as the library computes it: dq and dk/dv together
    for name in ("dq", "dkv"):
        recs[name]["dq_plus_dkv_ms"] = recs["dq"]["ms"] + recs["dkv"]["ms"]
    return recs


def tf_params(seed=0):
    from veles_tpu_torch.models.zoo import build_plans_and_state
    plans, state, _ = build_plans_and_state(transformer_spec(), TF_SHAPE,
                                            seed=seed)
    return plans, state


class PinnedRelu(object):
    """Pins the transformer MLP's ReLU masks from one run of a step to
    the next (for the comparison runs only).  Inside ``record()`` the
    MLP runs as it is and keeps each call's mask (pre-activation > 0);
    inside ``replay()`` it applies the kept masks, call by call, in place
    of its own.  A step is smooth in its inputs between the kinks where
    a pre-activation crosses 0, so two runs on the same masks differ as
    their roundings do.  ``flips`` counts the replayed entries whose own
    mask differed; ``flip_margin`` is the largest |pre-activation| among
    them over the largest |pre-activation| of its call."""

    def __init__(self):
        self.masks, self.at, self.replaying = [], 0, False
        self.flips, self.flip_margin = 0, 0.0

    def record(self):
        self.masks, self.replaying = [], False
        return self

    def replay(self):
        self.at, self.replaying = 0, True
        return self

    def __enter__(self):
        import torch
        from veles_tpu_torch.models import transformer
        self.saved = transformer.position_wise_mlp

        def mlp(x, w1, b1, w2):
            a = transformer._dense(x, w1) + b1
            own = (a > 0).detach()
            if not self.replaying:
                self.masks.append(own)
                z = torch.relu(a)
            else:
                mask = self.masks[self.at]
                self.at += 1
                flipped = mask != own
                n = int(flipped.sum())
                if n:
                    mag = a.detach().abs()
                    self.flips += n
                    self.flip_margin = max(self.flip_margin, float(
                        mag[flipped].max() / mag.max()))
                z = a * mask.to(a.dtype)
            return transformer._dense(z.to(x.dtype), w2)

        transformer.position_wise_mlp = mlp
        return self

    def __exit__(self, *exc):
        from veles_tpu_torch.models import transformer
        transformer.position_wise_mlp = self.saved


def per_step_vs(step, state0, batches, swap, pin=None):
    """[(loss rel, leaf max-rel)] of each step taken from one state as it
    is and under ``swap()`` (a context manager); the first run's state
    carries on to the next step.  ``pin``, a :class:`PinnedRelu`, gives
    the second run the first run's ReLU masks."""
    state, out = state0, []
    for x, t in batches:
        with pin.record() if pin else nullcontext():
            ref_out, rm = step(state, x, t, float(x.shape[0]))
        with swap(), pin.replay() if pin else nullcontext():
            swap_out, sm = step(state, x, t, float(x.shape[0]))
        if not (bool(rm["finite"]) and bool(sm["finite"])):
            raise AssertionError("a step is not finite: %s, %s" % (rm, sm))
        out.append((abs(float(rm["loss"]) - float(sm["loss"])) /
                    abs(float(sm["loss"])),
                    state_max_rel(ref_out, swap_out)))
        state = ref_out
    return out


def transformer_serve_phase(device):
    """The zoo transformer through AOTEngine and ContinuousBatcher; the
    forward kernel's launches and designs zeroed just before, read just
    after; returns (launches, launches a dispatch, designs)."""
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import build_forward
    from veles_tpu_torch.convert import params_from_jax
    from veles_tpu_torch.ops.attention import attention_fwd
    from veles_tpu_torch.serve import AOTEngine, ContinuousBatcher

    plans, state = tf_params()
    params = [{"weights": e["weights"], "bias": e["bias"]} for e in state]
    requests = numpy.random.RandomState(2).randn(
        N_REQUESTS, *TF_SHAPE).astype(numpy.float32)

    # -- the main path, launches counted ---------------------------------
    attention_fwd.launches = 0
    attention_fwd.paths = dict.fromkeys(attention_fwd.paths, 0)
    engine = AOTEngine(plans, params, TF_SHAPE, ladder=LADDER,
                       device=device)
    receipt = engine.compile()
    warm = attention_fwd.launches
    engine.infer(requests[:1])
    per_dispatch = attention_fwd.launches - warm
    batcher = ContinuousBatcher(engine, max_delay_s=0.05).start()
    try:
        pending = [batcher.submit(row) for row in requests]
        for i, req in enumerate(pending):
            if not req.done.wait(120):
                raise TimeoutError("request %d timed out" % i)
            if req.error is not None:
                raise req.error
    finally:
        batcher.stop()
    got = numpy.stack([req.result for req in pending])
    want = engine.infer(requests)
    launches = attention_fwd.launches
    paths = dict(attention_fwd.paths)
    # -- end of the counted run ------------------------------------------

    # the model runs level 0: every forward launch on the tensor cores
    if paths != {"simt": 0, "tc_bf16x3": launches}:
        raise AssertionError("transformer serve: attention_fwd paths %s for "
                             "%d launches, expected all tc_bf16x3"
                             % (paths, launches))
    if per_dispatch != 2 or warm != 2 * len(LADDER):
        raise AssertionError("forward launches: %d per dispatch, %d in the "
                             "warm-up; expected 2 and %d" % (
                                 per_dispatch, warm, 2 * len(LADDER)))
    if got.shape != (N_REQUESTS, 10) or not numpy.isfinite(got).all():
        raise AssertionError("transformer answers: shape %s, finite %s"
                             % (got.shape, numpy.isfinite(got).all()))
    if not (got == want).all():
        raise AssertionError("batched answers differ from engine.infer in "
                             "%d rows" % (got != want).any(1).sum())
    rng = numpy.random.RandomState(3)
    latency = {}
    for rung in engine.ladder:
        x = rng.randn(rung, *TF_SHAPE).astype(numpy.float32)
        times = []
        for _ in range(5):
            start = time.perf_counter()
            engine.infer(x)
            times.append((time.perf_counter() - start) * 1e3)
        latency[str(rung)] = float(numpy.median(times))
    cpu = Device(backend="cpu")
    with torch.inference_mode():
        ref = build_forward(plans)(params_from_jax(params, cpu),
                                   torch.from_numpy(requests[:2])).numpy()
    err = float(numpy.abs(want[:2] - ref).max())
    if not numpy.allclose(want[:2], ref, rtol=1e-4, atol=1e-7):
        raise AssertionError("transformer engine vs CPU forward: max abs %g"
                             % err)
    graphs = hold_rungs(
        engine, lambda rung: numpy.random.RandomState(rung).randn(
            rung, *TF_SHAPE).astype(numpy.float32),
        swap=[{k: None if v is None else v * numpy.float32(0.5)
               for k, v in e.items()} for e in params])
    log("transformer serve graphs: " + json.dumps(graphs))
    summary = {"model": "transformer", "ladder": list(LADDER),
               "receipt": receipt, "latency_ms": latency,
               "requests": N_REQUESTS, "batcher_rungs": batcher.rungs,
               "launches_per_dispatch": per_dispatch, "paths": paths,
               "cpu_ref_max_abs": err}
    log("transformer serve: " + json.dumps(summary))
    return launches, per_dispatch, paths


def transformer_train_phase(device):
    """The zoo transformer at batch 64 through the epoch, eval and step
    entry points; returns (launch counts, summary)."""
    import torch
    from veles_tpu_torch.compiler import (build_eval_epoch,
                                          build_train_epoch,
                                          build_train_step)
    from veles_tpu_torch.convert import state_from_jax
    from veles_tpu_torch.ops.attention import (attention_dkv, attention_dq,
                                               attention_fwd)
    from veles_tpu_torch.ops.gather import gather_minibatch

    t0 = time.perf_counter()
    plans, host_state = tf_params()
    state0 = state_from_jax(host_state, device)
    gen = torch.Generator(device="cuda").manual_seed(11)
    dataset = torch.randn((TF_SAMPLES,) + TF_SHAPE, generator=gen,
                          device="cuda")
    labels = torch.randint(0, 10, (TF_SAMPLES,), generator=gen,
                           device="cuda", dtype=torch.int32)
    order = torch.randperm(TF_SAMPLES, generator=gen,
                           device="cuda").to(torch.int32)
    # one minibatch a step: at lr 0.05 the 65,536-wide head memorizes a
    # minibatch in one step, and a repeated one then has loss exactly 0
    batches = [(dataset[i * TF_BATCH:(i + 1) * TF_BATCH],
                labels[i * TF_BATCH:(i + 1) * TF_BATCH]) for i in range(3)]
    torch.cuda.synchronize()
    log("transformer train set-up: %.1fs" % (time.perf_counter() - t0))
    names = ("gather_minibatch", "attention_fwd", "attention_dq",
             "attention_dkv")
    kernels = (gather_minibatch, attention_fwd, attention_dq, attention_dkv)

    def counts():
        return [k.launches for k in kernels]

    # -- the main path: launches counted ----------------------------------
    for kernel in kernels:
        kernel.launches = 0
    for kernel in (attention_fwd, attention_dq, attention_dkv):
        kernel.paths = dict.fromkeys(kernel.paths, 0)
    t0 = time.perf_counter()
    state1, totals = build_train_epoch(plans, TF_BATCH)(
        state0, dataset, labels, order)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch_counts = counts()
    params1 = [{"weights": e["weights"], "bias": e["bias"]} for e in state1]
    evaluated = build_eval_epoch(plans, TF_BATCH)(params1, dataset, labels,
                                                  order)
    torch.cuda.synchronize()
    eval_counts = counts()
    del state1, params1
    step = build_train_step(plans)
    raw = build_train_step(plans, donate=False)
    torch.cuda.reset_peak_memory_stats()
    state, losses, events, per_step = state0, [], [], []
    for x, t in batches:
        before = counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, x, t, float(TF_BATCH))
        end.record()
        losses.append(m["loss"])
        per_step.append([a - b for a, b in zip(counts(), before)])
        events.append((start, end))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [s.elapsed_time(e) for s, e in events]
    kernel_state = clone_state(state)
    launches = dict(zip(names, counts()))
    paths = {"attention_fwd": dict(attention_fwd.paths),
             "attention_dq": dict(attention_dq.paths),
             "attention_dkv": dict(attention_dkv.paths)}
    # -- end of the counted run -------------------------------------------

    # the model runs level 0: every attention launch on the tensor cores
    for name, served in paths.items():
        if served != {"simt": 0, "tc_bf16x3": launches[name]}:
            raise AssertionError("transformer train: %s paths %s for %d "
                                 "launches, expected all tc_bf16x3"
                                 % (name, served, launches[name]))

    steps = TF_SAMPLES // TF_BATCH
    if epoch_counts != [steps, 2 * steps, 2 * steps, 2 * steps] or \
            [a - b for a, b in zip(eval_counts, epoch_counts)] != \
            [steps, 2 * steps, 0, 0]:
        raise AssertionError("launches: epoch %s, after eval %s" % (
            epoch_counts, eval_counts))
    if any(c != [0, 2, 2, 2] for c in per_step):
        raise AssertionError("launches per step %s, expected [0, 2, 2, 2]"
                             % per_step)
    if int(totals["skipped"]) != 0 or not numpy.isfinite(
            float(totals["loss_mean"])):
        raise AssertionError("transformer train epoch: %s" % totals)
    if int(evaluated["samples"]) != TF_SAMPLES:
        raise AssertionError("transformer eval epoch: %s" % evaluated)
    if not (all_finite(kernel_state) and
            numpy.isfinite([float(v) for v in losses]).all()):
        raise AssertionError("a transformer loss or state leaf is not "
                             "finite")

    # reported: the chained drift of a second kernel run and of the plain
    # versions over the same 3 steps
    chained = {}
    for label in ("kernels_again", "plain"):
        state = state0
        with PlainKernels() if label == "plain" else nullcontext():
            for x, t in batches:
                state, _ = raw(state, x, t, float(TF_BATCH))
        chained[label] = state_max_rel(state, kernel_state)
    # each step from one state, kernels vs plain versions, held to loss
    # 1e-5 rel and every leaf max-rel 1e-4: with the backward kernels
    # swapped (the forward kernel in both runs), and with all three
    # swapped and the plain run on the kernel run's ReLU masks.  The
    # forward kernel's ~1e-6 differences flip a few of the MLP's 16.7 M
    # masks, at pre-activations within rounding of 0, and each flip moves
    # a w1 column's gradient by ~1 %: so with the masks free only the loss
    # is held, and the leaves are reported.
    attn = ("attention_fwd", "attention_dq", "attention_dkv")
    bwd_only = per_step_vs(raw, state0, batches,
                           lambda: PlainKernels(attn[1:]))
    pinned = PinnedRelu()
    all_three = per_step_vs(raw, state0, batches,
                            lambda: PlainKernels(attn), pin=pinned)
    free = per_step_vs(raw, state0, batches, lambda: PlainKernels(attn))
    if max(r[0] for r in bwd_only + all_three + free) > 1e-5 or \
            max(r[1] for r in bwd_only + all_three) > 1e-4:
        raise AssertionError("transformer kernels vs plain versions, step "
                             "by step (loss rel, leaf max-rel): backward "
                             "kernels %s, all three on pinned masks %s, "
                             "masks free %s" % (bwd_only, all_three, free))
    mean_ms = float(numpy.mean(step_ms))
    summary = {
        "model": "transformer", "batch": TF_BATCH, "samples": TF_SAMPLES,
        "sample_shape": list(TF_SHAPE), "epoch_s": epoch_s,
        "epoch_loss_mean": float(totals["loss_mean"]),
        "eval_n_err": int(evaluated["n_err"]),
        "step_losses": [float(v) for v in losses], "step_ms": step_ms,
        "tokens_per_s": TF_BATCH * TF_SHAPE[0] / (mean_ms / 1e3),
        "peak_memory_gb": peak_gb,
        "launches_per_step": dict(zip(names, per_step[0])),
        "paths": paths,
        "per_step_loss_rel_leaf_max_rel": {
            "backward_kernels_vs_plain": bwd_only,
            "all_kernels_vs_plain_masks_pinned": all_three,
            "all_kernels_vs_plain_masks_free": free},
        "relu_masks_flipped": pinned.flips,
        "relu_flip_margin": pinned.flip_margin,
        "chained_3_steps_leaf_max_rel": chained,
    }
    log("transformer train: " + json.dumps(summary))
    return launches, summary


def train_small_transformer_vs_cpu(device):
    """A 2-block transformer at T 37 (ragged tiles), D 32, 4 heads."""
    from veles_tpu_torch.models.zoo import transformer_layers
    return small_steps_vs_cpu(
        device, transformer_layers(blocks=2, heads=4, hidden=48), (37, 32),
        6)


# -- slice 4: the unit graph at MNIST width ---------------------------------

MNIST_VALID = 10000
MNIST_TRAIN = 60000
MNIST_BATCH = 100
MNIST_HIDDEN = 100
MNIST_SEED = 4


def mnist_arrays(seed, n_valid=None, n_train=None):
    """MNIST's shapes from a seed: uint8 28x28 images, one random
    prototype per class plus noise (learnable), laid out as the JAX
    package's MNIST loader lays them: (valid_x, valid_y, train_x,
    train_y)."""
    n_valid = MNIST_VALID if n_valid is None else n_valid
    n_train = MNIST_TRAIN if n_train is None else n_train
    rng = numpy.random.RandomState(seed)
    protos = rng.randint(0, 256, (10, 28, 28)).astype(numpy.int16)
    y = rng.randint(0, 10, n_valid + n_train).astype(numpy.int32)
    x = protos[y] + rng.randint(-96, 97, (len(y), 28, 28)).astype(
        numpy.int16)
    x = numpy.clip(x, 0, 255).astype(numpy.uint8)
    return x[:n_valid], y[:n_valid], x[n_valid:], y[n_valid:]


def mnist_layers():
    """examples/mnist.py: 784 -> all2all_tanh 100 -> softmax 10, lr 0.1,
    moment 0.9, weight decay 5e-5."""
    hyper = {"learning_rate": 0.1, "gradient_moment": 0.9,
             "weights_decay": 5e-5}
    return [dict(type="all2all_tanh", output_sample_shape=MNIST_HIDDEN,
                 **hyper),
            dict(type="softmax", output_sample_shape=10, **hyper)]


def arrays_loader(workflow, arrays, **kwargs):
    """A port FullBatchLoader over (valid_x, valid_y, train_x, train_y),
    laid out [valid | train]."""
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader

    class ArraysLoader(FullBatchLoader):
        def load_data(self):
            valid_x, valid_y, train_x, train_y = arrays
            self.original_data = numpy.concatenate([valid_x, train_x])
            self.original_labels = numpy.concatenate([valid_y, train_y])
            self.class_lengths[0] = 0
            self.class_lengths[1] = len(valid_x)
            self.class_lengths[2] = len(train_x)

    return ArraysLoader(workflow, **kwargs)


def mnist_workflow(arrays, stats, device, normalizer):
    """The MNIST workflow, initialized on ``device``: run (i) or (ii)
    of :func:`standard_workflow`."""
    return standard_workflow(arrays, stats, device, normalizer,
                             mnist_layers(), MNIST_BATCH, MNIST_SEED,
                             "mnist", 1)


def standard_workflow(arrays, stats, device, normalizer, layers, batch,
                      seed, loader_name, loader_seed, loader_kwargs=None,
                      state=None):
    """A StandardWorkflow over ``arrays``, initialized on ``device``.
    ``normalizer``: uint8 minibatches through a MeanDispNormalizer unit
    relinked in front of forwards[0] with link_from / link_attrs (run
    (i)); else float32 originals normalized once on the host by the
    loader (run (ii)), or as ``loader_kwargs`` say.  ``seed`` seeds the
    weights' draw; ``state``, a host state list, is adopted instead.
    Returns (workflow, normalizer unit or None)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.convert import adopt_workflow_state
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    from veles_tpu_torch.service_units import MeanDispNormalizer
    if normalizer:
        data, loader_kwargs = arrays, dict(dtype=numpy.uint8)
    else:
        data = tuple(a.astype(numpy.float32) if a.dtype == numpy.uint8
                     else a for a in arrays)
        if loader_kwargs is None:
            loader_kwargs = dict(normalization_type="mean_disp")
    sw = StandardWorkflow(
        DummyLauncher(), layers=layers,
        loader_factory=lambda w: arrays_loader(
            w, data, minibatch_size=batch,
            prng=prng.RandomGenerator(loader_name, seed=loader_seed),
            **loader_kwargs),
        decision_config=dict(max_epochs=1))
    norm = None
    if normalizer:
        norm = MeanDispNormalizer(sw, name="MeanDispNormalizer")
        norm.link_attrs(sw.loader, ("input", "minibatch_data"))
        norm.mean = stats.mean
        norm.rdisp = stats.rdisp
        first = sw.forwards[0]
        first.unlink_from(sw.loader)
        norm.link_from(sw.loader)
        first.link_from(norm)
        first.link_attrs(norm, ("input", "output"))
    if state is not None:
        adopt_workflow_state(sw, state)
    prng.get().seed(seed)
    sw.initialize(device=device)
    return sw, norm


def unit_state(sw):
    from veles_tpu_torch.compiler import extract_state
    return extract_state(sw)


def to_host(state):
    from veles_tpu_torch.convert import state_to_numpy
    return state_to_numpy(state)


def host_leaf_max_rel(got, want):
    """{leaf key: the worst max-rel over the layers}."""
    worst = {}
    for g, w in zip(got, want):
        for key, leaf in w.items():
            if leaf is not None:
                diff = numpy.abs(g[key].astype(numpy.float64) - leaf).max()
                worst[key] = max(worst.get(key, 0.0), float(
                    diff / max(numpy.abs(leaf).max(), 1e-30)))
    return worst


def host_state_max_rel(got, want):
    return max(host_leaf_max_rel(got, want).values(), default=0.0)


def drive_to_train(sws):
    """Serve (and skip) the validation minibatches the epoch starts with,
    in lockstep, until the next serve is a train minibatch."""
    from veles_tpu_torch.loader.base import TRAIN
    while True:
        offsets = [sw.loader.global_offset for sw in sws]
        if offsets[0] >= sws[0].loader.class_end_offsets[TRAIN - 1]:
            return
        for sw in sws:
            sw.loader.run()


def unit_step(sw, norm):
    sw.loader.run()
    if norm is not None:
        norm.run()
    for fwd in sw.forwards:
        fwd.run()
    sw.evaluator.run()
    sw.decision.run()
    if not bool(sw.decision.gd_skip):
        for gd in reversed(sw.gds):
            gd.run()


def fused_step(sw):
    sw.loader.run()
    sw.fused_trainer.run()
    sw.decision.run()


def unit_graph_steps(device, arrays, stats):
    """(i) per unit vs (ii) fused, step by step from one state over the
    first 3 train minibatches (every leaf within max-rel 1e-5, the
    minibatches bit-equal), and (i)'s first step against the CPU port
    (1e-5)."""
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.convert import adopt_workflow_state
    root.common.engine.auto_fuse = False
    try:
        per_unit, norm = mnist_workflow(arrays, stats, device, True)
        cpu, cpu_norm = mnist_workflow(arrays, stats, Device("cpu"), True)
    finally:
        root.common.engine.auto_fuse = True
    fused, _ = mnist_workflow(arrays, stats, device, False)
    if getattr(fused, "fused_trainer", None) is None or \
            getattr(per_unit, "fused_trainer", None) is not None:
        raise AssertionError("auto-fuse: the default did not fuse, or the "
                             "opt-out did")
    drive_to_train([per_unit, fused, cpu])
    rels = []
    for step in range(3):
        adopt_workflow_state(fused, to_host(unit_state(per_unit)))
        unit_step(per_unit, norm)
        fused_step(fused)
        if not torch.equal(norm.output.devmem,
                           fused.loader.minibatch_data.devmem):
            raise AssertionError("step %d: the normalizer unit's minibatch "
                                 "differs from the host-normalized one"
                                 % step)
        rels.append(host_state_max_rel(to_host(unit_state(fused)),
                                       to_host(unit_state(per_unit))))
        if step == 0:
            unit_step(cpu, cpu_norm)
            cpu_rel = host_state_max_rel(to_host(unit_state(per_unit)),
                                         to_host(unit_state(cpu)))
    if max(rels) > 1e-5 or cpu_rel > 1e-5:
        raise AssertionError("unit graph: per unit vs fused %s, card vs "
                             "CPU %g (limit 1e-5)" % (rels, cpu_rel))
    return {"per_unit_vs_fused_max_rel": rels, "card_vs_cpu_max_rel":
            cpu_rel}


def unit_kernel_counters():
    from veles_tpu_torch.ops.gather import gather_minibatch
    from veles_tpu_torch.ops.join import join
    from veles_tpu_torch.ops.normalize import mean_disp_normalize
    return {"gather_minibatch": gather_minibatch,
            "mean_disp_normalize": mean_disp_normalize, "join": join}


def timed_epoch(sw, label, counters=None):
    """Run the workflow (one epoch: validation, train, validation) with
    the kernels' counts (``counters``, by default
    :func:`unit_kernel_counters`) zeroed just before and read just after;
    host clock and CUDA events per minibatch, host syncs per minibatch
    (torch.cuda.set_sync_debug_mode), the top units of print_stats."""
    import io
    import warnings
    import torch
    counters = counters or unit_kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            start.record()
            sw.run()
            end.record()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    launches = {name: fn.launches for name, fn in counters.items()}
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    minibatches = sw.loader.run_calls
    out = io.StringIO()
    sw.print_stats(top_number=8, out=out)
    log("%s print_stats:\n%s" % (label, out.getvalue().rstrip()))
    top = [{"unit": unit.name, "s": seconds, "runs": runs}
           for seconds, unit, runs in sw.unit_stats()[:8]]
    return launches, {
        "minibatches": minibatches,
        "host_ms_per_minibatch": host_s * 1e3 / minibatches,
        "cuda_ms_per_minibatch": start.elapsed_time(end) / minibatches,
        "host_syncs": syncs, "host_syncs_per_minibatch":
            syncs / minibatches,
        "validation_error_pct": sw.decision.epoch_metrics[1],
        "best_validation_error_pct": sw.decision.best_metric,
        "train_error_pct": sw.decision.epoch_metrics[2],
        "top_units": top}


def dag_inference(device, arrays, stats):
    """(iii): the validation images through a per-unit DAG: loader ->
    MeanDispNormalizer -> All2AllTanh(100) and All2AllRELU(100) ->
    InputJoiner (100, 200) f32 -> All2AllSoftmax(10), wired with
    link_from / link_attrs and run by the workflow's worklist (the joiner
    waits on both branches).  Kernel counts zeroed just before the run,
    read just after.  The last minibatch's answer is held against the
    same units' plain PyTorch forward on the CPU (max-rel 1e-5)."""
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.models.all2all import (All2AllRELU,
                                                All2AllSoftmax, All2AllTanh)
    from veles_tpu_torch.ops.normalize import mean_disp_normalize_reference
    from veles_tpu_torch.plumbing import EpochCounter, Repeater
    from veles_tpu_torch.service_units import InputJoiner, MeanDispNormalizer
    valid_x, valid_y = arrays[0], arrays[1]
    empty_x, empty_y = valid_x[:0], valid_y[:0]
    wf = DummyWorkflow()
    repeater = Repeater(wf).link_from(wf.start_point)
    # the validation images as the loader's only class, in order
    loader = arrays_loader(wf, (empty_x, empty_y, valid_x, valid_y),
                           minibatch_size=MNIST_BATCH, dtype=numpy.uint8,
                           shuffle_limit=0).link_from(repeater)
    norm = MeanDispNormalizer(wf).link_from(loader)
    norm.link_attrs(loader, ("input", "minibatch_data"))
    norm.mean, norm.rdisp = stats.mean, stats.rdisp
    branch_a = All2AllTanh(wf, output_sample_shape=MNIST_HIDDEN)
    branch_b = All2AllRELU(wf, output_sample_shape=MNIST_HIDDEN)
    for branch in (branch_a, branch_b):
        branch.link_from(norm)
        branch.link_attrs(norm, ("input", "output"))
    joiner = InputJoiner(wf).link_from(branch_a, branch_b)
    joiner.link_inputs((branch_a, "output"), (branch_b, "output"))
    head = All2AllSoftmax(wf, output_sample_shape=10).link_from(joiner)
    head.link_attrs(joiner, ("input", "output"))
    passes = len(valid_x) // MNIST_BATCH
    counter = EpochCounter(wf, passes).link_from(head)
    repeater.link_from(counter)
    wf.end_point.link_from(counter)
    wf.end_point.gate_block = ~counter.complete
    prng.get().seed(MNIST_SEED + 1)
    wf.initialize(device=device)
    counters = unit_kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf.run()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    out = head.output.devmem
    if tuple(out.shape) != (MNIST_BATCH, 10) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError("DAG: output %s not finite (%d, 10)"
                             % (tuple(out.shape), MNIST_BATCH))
    # the last minibatch again, through the plain versions on the CPU
    x = torch.from_numpy(valid_x[-MNIST_BATCH:]).reshape(MNIST_BATCH, -1)
    h = mean_disp_normalize_reference(
        x, torch.from_numpy(stats.mean), torch.from_numpy(stats.rdisp))

    def params(unit):
        return {"weights": unit.weights.devmem.cpu(),
                "bias": unit.bias.devmem.cpu()}
    joined = torch.cat([All2AllTanh.apply(params(branch_a), h),
                        All2AllRELU.apply(params(branch_b), h)], dim=1)
    want = All2AllSoftmax.apply(params(head), joined)
    rel = max_rel(out.cpu(), want)
    if rel > 1e-5:
        raise AssertionError("DAG: card vs CPU max-rel %g" % rel)
    return launches, {"minibatches": loader.run_calls,
                      "host_ms_per_minibatch":
                          host_s * 1e3 / loader.run_calls,
                      "vs_cpu_max_rel": rel,
                      "joined_shape": list(joiner.output.devmem.shape)}


def unit_graph_phase(device):
    """The slice-4 path: the MNIST workflow at full width, (i) per unit
    with the normalizer unit, (ii) the fused product default, (iii) the
    InputJoiner DAG.  Returns ({run: launch counts}, summary)."""
    from veles_tpu_torch.normalization import MeanDispersionNormalizer
    from veles_tpu_torch.config import root
    t0 = time.perf_counter()
    arrays = mnist_arrays(MNIST_SEED)
    stats = MeanDispersionNormalizer()
    stats.analyze(arrays[2])          # the train class
    made_s = time.perf_counter() - t0
    steps = unit_graph_steps(device, arrays, stats)
    log("unit graph steps: %s" % json.dumps(steps))

    root.common.engine.auto_fuse = False
    try:
        per_unit, _ = mnist_workflow(arrays, stats, device, True)
    finally:
        root.common.engine.auto_fuse = True
    if getattr(per_unit, "fused_trainer", None) is not None:
        raise AssertionError("auto_fuse = False fused the workflow")
    launches_i, run_i = timed_epoch(per_unit, "(i) per unit")
    fused, _ = mnist_workflow(arrays, stats, device, False)
    if getattr(fused, "fused_trainer", None) is None:
        raise AssertionError("StandardWorkflow.initialize(Device()) did "
                             "not fuse")
    launches_ii, run_ii = timed_epoch(fused, "(ii) fused")
    # one epoch from one state over bit-equal minibatches: the chained
    # per-unit and fused runs part only by rounding.  The weights and
    # biases are held at 1e-4; the momentum buffers are reported: by the
    # epoch's end they sum gradients that have all but vanished on the
    # seeded prototypes, so their relative gap is the rounding of
    # near-zero values
    epoch_rel = host_leaf_max_rel(to_host(unit_state(fused)),
                                  to_host(unit_state(per_unit)))
    if max(epoch_rel["weights"], epoch_rel["bias"]) > 1e-4:
        raise AssertionError("unit graph: (i) and (ii) after the epoch: "
                             "max-rel %s (limit 1e-4 on weights and bias)"
                             % epoch_rel)
    train_errs = [round(run["train_error_pct"] * MNIST_TRAIN / 100.0)
                  for run in (run_i, run_ii)]
    if abs(train_errs[0] - train_errs[1]) > 1:
        raise AssertionError("unit graph: train errors after the epoch: "
                             "(i) %d, (ii) %d samples" % tuple(train_errs))
    launches_iii, run_iii = dag_inference(device, arrays, stats)
    for label, run, launches in (("(i)", run_i, launches_i),
                                 ("(ii)", run_ii, launches_ii)):
        err = run["validation_error_pct"]
        if err is None or not err < 5.0:
            raise AssertionError("%s validation error %s%% (limit 5 %%)"
                                 % (label, err))
        if launches["gather_minibatch"] != run["minibatches"]:
            raise AssertionError("%s: %d gathers for %d minibatches" % (
                label, launches["gather_minibatch"], run["minibatches"]))
    if launches_i["mean_disp_normalize"] != run_i["minibatches"] or \
            launches_ii["mean_disp_normalize"] != 0:
        raise AssertionError("normalize launches: (i) %d for %d "
                             "minibatches, (ii) %d" % (
                                 launches_i["mean_disp_normalize"],
                                 run_i["minibatches"],
                                 launches_ii["mean_disp_normalize"]))
    if launches_iii["join"] != run_iii["minibatches"] or \
            launches_iii["mean_disp_normalize"] != run_iii["minibatches"]:
        raise AssertionError("DAG launches %s for %d minibatches" % (
            launches_iii, run_iii["minibatches"]))
    summary = {"data_s": made_s, "steps": steps,
               "epoch_per_unit_vs_fused_max_rel": epoch_rel,
               "per_unit": run_i,
               "fused": run_ii, "dag": run_iii,
               "per_unit_over_fused": run_i["host_ms_per_minibatch"] /
               run_ii["host_ms_per_minibatch"]}
    log("unit graph: %s" % json.dumps(summary))
    return {"per_unit": launches_i, "fused": launches_ii,
            "dag": launches_iii}, summary


# -- slice 15: the per-unit conv, pooling, dropout and transformer units ----

CIFAR_VALID = 10000
CIFAR_TRAIN = 50000
CIFAR_BATCH = 100
CIFAR_SEED = 5
#: the kernels-vs-plain comparison's share of the images (validation,
#: train): its 3 train minibatches need no more
CIFAR_CHECK = (200, 400)
UNIT_STEPS = 3
VGG_VALID, VGG_TRAIN = TRAIN_BATCH, 3 * TRAIN_BATCH


def cifar_arrays(seed, n_valid=None, n_train=None):
    """CIFAR-10's shapes from a seed: uint8 32x32x3 images, one random
    prototype per class plus noise, laid out (valid_x, valid_y,
    train_x, train_y)."""
    n_valid = CIFAR_VALID if n_valid is None else n_valid
    n_train = CIFAR_TRAIN if n_train is None else n_train
    rng = numpy.random.RandomState(seed)
    protos = rng.randint(0, 256, (10, 32, 32, 3)).astype(numpy.int16)
    y = rng.randint(0, 10, n_valid + n_train).astype(numpy.int32)
    x = protos[y]
    x += rng.randint(-96, 97, x.shape).astype(numpy.int16)
    x = numpy.clip(x, 0, 255).astype(numpy.uint8)
    return x[:n_valid], y[:n_valid], x[n_valid:], y[n_valid:]


def cifar_layers(activation="relu"):
    """examples/cifar10.py:26-56: conv_relu 32, 32 -> max-pool 2 ->
    conv_relu 64, 64 -> pool -> conv_relu 128 -> pool -> all2all_relu 256
    -> dropout 0.5 -> softmax 10; lr 0.02, moment 0.9, weight decay
    4e-5.  ``activation="str"`` puts strict ReLU (conv_str, all2all_str)
    in place of the softplus "RELU": at the example's uniform
    1/sqrt(fan_in) weights the softplus net stays at chance through its
    first epoch, in both packages (its features' common mean swamps the
    head's gradient); the strict-ReLU one leaves it within ~200
    minibatches."""
    hyper = {"learning_rate": 0.02, "gradient_moment": 0.9,
             "weights_decay": 4e-5}

    def conv(n):
        return dict(type="conv_" + activation, n_kernels=n, kx=3, ky=3,
                    sliding=(1, 1), padding=1, **hyper)
    pool = {"type": "max_pooling", "kx": 2, "ky": 2}
    return [conv(32), conv(32), dict(pool), conv(64), conv(64), dict(pool),
            conv(128), dict(pool),
            dict(type="all2all_" + activation, output_sample_shape=256,
                 **hyper),
            {"type": "dropout", "dropout_ratio": 0.5},
            dict(type="softmax", output_sample_shape=10, **hyper)]


def vgg_unit_arrays():
    """VGG16's input shapes: 32 validation and 96 train images, uniform
    in [-1, 1], labels of 1000 classes."""
    rng = numpy.random.RandomState(23)
    return (rng.uniform(-1, 1, (VGG_VALID, 224, 224, 3)).astype(
                numpy.float32),
            rng.randint(0, 1000, VGG_VALID).astype(numpy.int32),
            rng.uniform(-1, 1, (VGG_TRAIN, 224, 224, 3)).astype(
                numpy.float32),
            rng.randint(0, 1000, VGG_TRAIN).astype(numpy.int32))


def tf_unit_arrays():
    """The transformer workload's input: 64 validation and 192 train
    (T, D) = (128, 512) sequences, normal, labels of 10 classes."""
    rng = numpy.random.RandomState(29)
    return (rng.randn(TF_BATCH, *TF_SHAPE).astype(numpy.float32),
            rng.randint(0, 10, TF_BATCH).astype(numpy.int32),
            rng.randn(3 * TF_BATCH, *TF_SHAPE).astype(numpy.float32),
            rng.randint(0, 10, 3 * TF_BATCH).astype(numpy.int32))


def per_unit_counters():
    from veles_tpu_torch.ops.attention import (attention_dkv, attention_dq,
                                               attention_fwd)
    from veles_tpu_torch.ops.conv_vjp import conv_wgrad
    from veles_tpu_torch.ops.gather import gather_minibatch
    from veles_tpu_torch.ops.normalize import mean_disp_normalize
    from veles_tpu_torch.ops.pool_bwd import max_pool_bwd
    return {fn.__name__: fn for fn in (
        conv_wgrad, max_pool_bwd, gather_minibatch, mean_disp_normalize,
        attention_fwd, attention_dq, attention_dkv)}


def per_unit(build):
    """``build()`` with the per-unit graph kept on the card
    (``root.common.engine.auto_fuse = False``)."""
    from veles_tpu_torch.config import root
    root.common.engine.auto_fuse = False
    try:
        sw, norm = build()
    finally:
        root.common.engine.auto_fuse = True
    if getattr(sw, "fused_trainer", None) is not None:
        raise AssertionError("auto_fuse = False fused the workflow")
    return sw, norm


def head_loss(sw):
    """The cross entropy of the softmax head's last output (float64 on
    the host) over the loader's minibatch."""
    import torch
    size = int(sw.loader.minibatch_size)
    probs = sw.forwards[-1].output.devmem[:size].double()
    labels = sw.loader.minibatch_labels.devmem[:size].long()
    return float(-torch.log(probs[torch.arange(size), labels]).mean())


def timed_unit_step(sw, norm, counters=None):
    """One per-unit step on the card: (CUDA-event ms, host ms, {kernel:
    launches}, dropout masks drawn), the counts zeroed just before and
    read just after."""
    import torch
    counters = counters or per_unit_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host = time.perf_counter()
    with RecordMasks() as drawn:
        start.record()
        unit_step(sw, norm)
        end.record()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - host) * 1e3
    return (start.elapsed_time(end), host_ms,
            {name: fn.launches for name, fn in counters.items()},
            len(drawn.masks))


def per_unit_vs_plain(build, label, steps=UNIT_STEPS):
    """Two per-unit workflows from one seed in lockstep on the card, cuDNN
    deterministic: before each train step the second adopts the first's
    state, the first steps through the kernels and the second under
    :class:`PlainKernels`; both draw the same dropout masks (their keys
    follow the seed and the step).  Every leaf within max-rel 1e-4.
    Returns (summary, {kernel: launches} of the kernel runs, masks)."""
    import torch
    from veles_tpu_torch.convert import adopt_workflow_state
    torch.backends.cudnn.deterministic = True
    try:
        a, norm_a = per_unit(build)
        b, norm_b = per_unit(lambda: build(state=to_host(unit_state(a))))
        drive_to_train([a, b])
        rels, times, launches, masks = [], [], {}, 0
        for _ in range(steps):
            adopt_workflow_state(b, to_host(unit_state(a)))
            ms, host_ms, counts, drawn = timed_unit_step(a, norm_a)
            with PlainKernels():
                unit_step(b, norm_b)
            rels.append(host_state_max_rel(to_host(unit_state(b)),
                                           to_host(unit_state(a))))
            times.append({"ms": ms, "host_ms": host_ms})
            for name, count in counts.items():
                launches[name] = launches.get(name, 0) + count
            masks += drawn
        finite = all_finite(unit_state(a))
    finally:
        torch.backends.cudnn.deterministic = False
    if max(rels) > 1e-4 or not finite:
        raise AssertionError("%s per unit, kernels vs plain: max-rel %s "
                             "(limit 1e-4), finite %s" % (label, rels,
                                                          finite))
    del a, b
    torch.cuda.empty_cache()
    return {"steps": steps, "leaf_max_rel": rels, "step_times": times,
            "masks": masks}, launches


def expect_per_step(label, launches, steps, want):
    """Each kernel's launches over ``steps`` train steps are ``want`` a
    step."""
    got = {name: launches.get(name, 0) / steps for name in want}
    if got != want:
        raise AssertionError("%s: launches a train step %s, expected %s"
                             % (label, got, want))
    return got


def cifar_per_unit(device):
    """(a): the CIFAR-10 workflow at full width: the example's net per
    unit through the kernels against the plain versions over 3 train
    minibatches, then one epoch of its strict-ReLU variant
    (:func:`cifar_layers`) per unit and one fused, whose validation
    errors are held under 10 % and within 1 point of each other.
    Returns ({run: launches}, summary)."""
    import torch
    from veles_tpu_torch.normalization import MeanDispersionNormalizer
    t0 = time.perf_counter()
    arrays = cifar_arrays(CIFAR_SEED)
    stats = MeanDispersionNormalizer()
    stats.analyze(arrays[2])          # the train class
    made_s = time.perf_counter() - t0
    n_valid, n_train = CIFAR_CHECK
    check_arrays = (arrays[0][:n_valid], arrays[1][:n_valid],
                    arrays[2][:n_train], arrays[3][:n_train])

    def build(arrays=arrays, state=None, normalizer=True,
              activation="str"):
        return standard_workflow(arrays, stats, device, normalizer,
                                 cifar_layers(activation), CIFAR_BATCH,
                                 CIFAR_SEED, "cifar", 3, state=state)
    # check 1: kernels vs plain per unit, 3 train minibatches
    check, check_launches = per_unit_vs_plain(
        lambda state=None: build(check_arrays, state, activation="relu"),
        "CIFAR-10")
    per_step = expect_per_step("CIFAR-10 check", check_launches, UNIT_STEPS,
                               {"conv_wgrad": 5, "max_pool_bwd": 3,
                                "gather_minibatch": 1,
                                "mean_disp_normalize": 1})
    if check["masks"] != UNIT_STEPS:
        raise AssertionError("CIFAR-10: %d dropout masks in %d steps"
                             % (check["masks"], UNIT_STEPS))
    # check 2 and 3: one epoch per unit, one fused
    sw, _ = per_unit(build)
    counters = per_unit_counters()
    with RecordMasks() as drawn:
        launches_unit, run_unit = timed_epoch(sw, "(a) per unit", counters)
    train_steps = sw.gds[-1].run_calls
    run_unit["train_minibatches"] = train_steps
    run_unit["masks"] = len(drawn.masks)
    del drawn, sw
    torch.cuda.empty_cache()
    fused, _ = build(normalizer=False)
    if getattr(fused, "fused_trainer", None) is None:
        raise AssertionError("StandardWorkflow.initialize(Device()) did "
                             "not fuse")
    launches_fused, run_fused = timed_epoch(fused, "(a) fused", counters)
    del fused
    torch.cuda.empty_cache()
    per_train_minibatch = expect_per_step(
        "CIFAR-10 per unit", dict(launches_unit, masks=run_unit["masks"]),
        train_steps, {"conv_wgrad": 5, "max_pool_bwd": 3, "masks": 1})
    per_minibatch = expect_per_step(
        "CIFAR-10 per unit", launches_unit, run_unit["minibatches"],
        {"gather_minibatch": 1, "mean_disp_normalize": 1})
    expect_per_step("CIFAR-10 fused", launches_fused, train_steps,
                    {"conv_wgrad": 5, "max_pool_bwd": 3})
    expect_per_step("CIFAR-10 fused", launches_fused,
                    run_fused["minibatches"], {"gather_minibatch": 1})
    errs = (run_unit["validation_error_pct"],
            run_fused["validation_error_pct"])
    if None in errs or not max(errs) < 10.0 or \
            abs(errs[0] - errs[1]) > 1.0:
        raise AssertionError("CIFAR-10 validation errors per unit %s, "
                             "fused %s (limits 10 %%, 1 point apart)"
                             % errs)
    summary = {"data_s": made_s, "check": check,
               "check_launches_per_step": per_step,
               "per_unit": run_unit, "fused": run_fused,
               "per_train_minibatch": per_train_minibatch,
               "per_minibatch": per_minibatch,
               "per_unit_over_fused": run_unit["host_ms_per_minibatch"] /
               run_fused["host_ms_per_minibatch"]}
    return {"check": check_launches, "per_unit": launches_unit,
            "fused": launches_fused}, summary


def vgg16_per_unit(device, graphs):
    """(b): VGG16 per unit at batch 32, kernels vs plain over 3 train
    minibatches; the per-unit step time beside the graphed fused step
    ``graphs_phase`` timed."""
    from veles_tpu_torch.models.zoo import vgg_layers
    arrays = vgg_unit_arrays()

    def build(state=None):
        return standard_workflow(arrays, None, device, False,
                                 vgg_layers(config="D"), TRAIN_BATCH, 0,
                                 "vgg", 5, loader_kwargs={}, state=state)
    summary, launches = per_unit_vs_plain(build, "VGG16")
    summary["launches_per_step"] = expect_per_step(
        "VGG16 per unit", launches, UNIT_STEPS,
        {"conv_wgrad": 13, "max_pool_bwd": 5, "gather_minibatch": 1})
    if summary["masks"] != 2 * UNIT_STEPS:
        raise AssertionError("VGG16 per unit: %d dropout masks in %d "
                             "steps" % (summary["masks"], UNIT_STEPS))
    timing = graphs.get("vgg16_keyed_timing", {}).get("turns", {})
    summary["graphed_fused_step_ms"] = [turn["wall_ms"] for turn in
                                        timing.get("graph", [])]
    summary["raw_fused_step_ms"] = [turn["wall_ms"] for turn in
                                    timing.get("raw", [])]
    return launches, summary


def transformer_per_unit(device):
    """(c): the repo's transformer workload per unit, each of 3 train
    minibatches against the fused raw step (``donate=False``) from the
    same state: the loss within 1e-5 rel, every leaf within max-rel
    1e-4; 4 forward, 2 dq and 2 dk/dv launches a train minibatch."""
    import torch
    from veles_tpu_torch.compiler import build_train_step, workflow_plan
    from veles_tpu_torch.convert import state_from_jax
    sw, _ = per_unit(lambda: standard_workflow(
        tf_unit_arrays(), None, device, False, transformer_spec(), TF_BATCH,
        0, "tf", 5, loader_kwargs={}))
    raw = build_train_step(workflow_plan(sw), donate=False)
    drive_to_train([sw])
    rows, launches = [], {}
    for _ in range(UNIT_STEPS):
        state0 = to_host(unit_state(sw))
        ms, host_ms, counts, _ = timed_unit_step(sw, None)
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
        size = int(sw.loader.minibatch_size)
        want, metrics = raw(state_from_jax(state0, device),
                            sw.loader.minibatch_data.devmem[:size],
                            sw.loader.minibatch_labels.devmem[:size],
                            float(size))
        loss = head_loss(sw)
        rows.append({"loss_rel": abs(loss - float(metrics["loss"])) /
                     abs(float(metrics["loss"])),
                     "leaf_max_rel": state_max_rel(unit_state(sw), want),
                     "ms": ms, "host_ms": host_ms})
    if max(r["loss_rel"] for r in rows) > 1e-5 or \
            max(r["leaf_max_rel"] for r in rows) > 1e-4:
        raise AssertionError("transformer per unit vs fused: %s" % rows)
    per_step = expect_per_step("transformer per unit", launches, UNIT_STEPS,
                               {"attention_fwd": 4, "attention_dq": 2,
                                "attention_dkv": 2, "gather_minibatch": 1})
    del sw, raw
    torch.cuda.empty_cache()
    return launches, {"steps": rows, "launches_per_step": per_step}


def small_per_unit_vs_cpu(device):
    """(d): a small convnet with dropout per unit, on the card (kernels)
    and on the CPU (plain versions), 2 chained train steps in lockstep:
    the head's loss within 1e-5 rel, every leaf within max-rel 1e-4."""
    from veles_tpu_torch.backends import Device
    hyper = {"learning_rate": 0.05, "gradient_moment": 0.9}
    specs = [
        dict(type="conv_str", n_kernels=8, kx=3, ky=3, padding=1, **hyper),
        {"type": "max_pooling", "kx": 2, "ky": 2},
        dict(type="conv_tanh", n_kernels=8, kx=3, ky=3,
             padding=(1, 0, 2, 1), sliding=(1, 2), **hyper),
        {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": "dropout", "dropout_ratio": 0.3},
        dict(type="softmax", output_sample_shape=10, **hyper)]
    rng = numpy.random.RandomState(31)
    arrays = (rng.randn(16, 20, 18, 3).astype(numpy.float32),
              rng.randint(0, 10, 16).astype(numpy.int32),
              rng.randn(32, 20, 18, 3).astype(numpy.float32),
              rng.randint(0, 10, 32).astype(numpy.int32))
    runs = [per_unit(lambda dev=dev: standard_workflow(
        arrays, None, dev, False, specs, 16, 4, "small", 5,
        loader_kwargs={}))[0] for dev in (device, Device("cpu"))]
    drive_to_train(runs)
    rows = []
    for _ in range(2):
        losses = []
        for sw in runs:
            unit_step(sw, None)
            losses.append(head_loss(sw))
        rows.append({"loss_rel": abs(losses[0] - losses[1]) /
                     abs(losses[1]),
                     "leaf_max_rel": host_state_max_rel(
                         to_host(unit_state(runs[0])),
                         to_host(unit_state(runs[1])))})
    if max(r["loss_rel"] for r in rows) > 1e-5 or \
            max(r["leaf_max_rel"] for r in rows) > 1e-4:
        raise AssertionError("small per-unit convnet, card vs CPU: %s"
                             % rows)
    return rows


def unit_graph_conv_phase(device, graphs):
    """The slice-15 path: (a) CIFAR-10, (b) VGG16 and (c) the
    transformer per unit, (d) a small per-unit convnet against the CPU.
    Returns ({run: launch counts}, summary)."""
    t0 = time.perf_counter()
    launches, summary = {}, {}
    cifar_launches, summary["cifar10"] = cifar_per_unit(device)
    launches.update(("cifar10_" + k, v) for k, v in cifar_launches.items())
    launches["vgg16"], summary["vgg16"] = vgg16_per_unit(device, graphs)
    launches["transformer"], summary["transformer"] = \
        transformer_per_unit(device)
    summary["small_vs_cpu"] = small_per_unit_vs_cpu(device)
    summary["phase_s"] = time.perf_counter() - t0
    log("unit graph, per-unit conv/pool/dropout/transformer: %s"
        % json.dumps(summary))
    return launches, summary


# -- the command line: python -m veles_tpu_torch ------------------------------

#: the CLI phase's workflow file, written into a temporary directory: its
#: loader class lives in the file itself, so a restoring process imports
#: it by the name the snapshot records (``mnist_cli.SeededMnist``)
CLI_WORKFLOW = '''"""The MNIST workflow of chip_smoke.py's CLI phase, for
``python -m veles_tpu_torch mnist_cli.py -``: examples/mnist.py's widths
(784 -> all2all_tanh 100 -> softmax 10, lr 0.1, moment 0.9, weight decay
5e-5) over @VALID@ + @TRAIN@ uint8 28x28 images made from seed @SEED@.

root.chip_cli: max_epochs (3), minibatch (100), skip_budget (16),
normalizer (False: float32 originals normalized once by the loader;
True: uint8 minibatches through a MeanDispNormalizer unit in front of
the first layer), report (a JSON file for the run's numbers).  The run
ends with a snapshot of its final state when it snapshots at all, so
the directory's ``_current`` is that state.
"""

import functools
import json
import time

import numpy

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.normalization import MeanDispersionNormalizer
from veles_tpu_torch.ops.gather import gather_minibatch
from veles_tpu_torch.ops.normalize import mean_disp_normalize
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.service_units import MeanDispNormalizer



def cfg():
    """The config node, read at each call (a session may replace it)."""
    return root.chip_cli


@functools.lru_cache(maxsize=1)
def mnist_arrays():
    """chip_smoke.mnist_arrays: one random prototype per class plus
    noise, laid out (valid_x, valid_y, train_x, train_y)."""
    rng = numpy.random.RandomState(@SEED@)
    protos = rng.randint(0, 256, (10, 28, 28)).astype(numpy.int16)
    y = rng.randint(0, 10, @VALID@ + @TRAIN@).astype(numpy.int32)
    x = protos[y] + rng.randint(-96, 97, (len(y), 28, 28)).astype(
        numpy.int16)
    x = numpy.clip(x, 0, 255).astype(numpy.uint8)
    return x[:@VALID@], y[:@VALID@], x[@VALID@:], y[@VALID@:]


class SeededMnist(FullBatchLoader):
    def load_data(self):
        valid_x, valid_y, train_x, train_y = mnist_arrays()
        data = numpy.concatenate([valid_x, train_x])
        if self.dtype != numpy.uint8:
            data = data.astype(numpy.float32)
        self.original_data = data
        self.original_labels = numpy.concatenate([valid_y, train_y])
        self.class_lengths[0] = 0
        self.class_lengths[1] = len(valid_x)
        self.class_lengths[2] = len(train_x)


def build(launcher):
    normalizer = cfg().get("normalizer", False)
    hyper = {"learning_rate": 0.1, "gradient_moment": 0.9,
             "weights_decay": 5e-5}
    sw = StandardWorkflow(
        launcher,
        layers=[dict(type="all2all_tanh", output_sample_shape=100, **hyper),
                dict(type="softmax", output_sample_shape=10, **hyper)],
        loader_factory=lambda w: SeededMnist(
            w, minibatch_size=cfg().get("minibatch", 100),
            prng=RandomGenerator("mnist", seed=1),
            **(dict(dtype=numpy.uint8) if normalizer
               else dict(normalization_type="mean_disp"))),
        decision_config=dict(max_epochs=cfg().get("max_epochs", 3),
                             skip_budget=cfg().get("skip_budget", 16)))
    if normalizer:
        stats = MeanDispersionNormalizer()
        stats.analyze(mnist_arrays()[2])
        norm = MeanDispNormalizer(sw, name="MeanDispNormalizer")
        norm.link_attrs(sw.loader, ("input", "minibatch_data"))
        norm.mean = stats.mean
        norm.rdisp = stats.rdisp
        first = sw.forwards[0]
        first.unlink_from(sw.loader)
        norm.link_from(sw.loader)
        first.link_from(norm)
        first.link_attrs(norm, ("input", "output"))
    return sw


def run(load, main):
    start = time.perf_counter()
    workflow, restored = load(build)
    restore_s = time.perf_counter() - start
    epoch0 = workflow.loader.epoch_number
    calls0 = workflow.loader.run_calls
    for kernel in (gather_minibatch, mean_disp_normalize):
        kernel.launches = 0
    main()
    report = {
        "restored": bool(restored),
        "restore_s": restore_s if restored else None,
        "epochs": workflow.loader.epoch_number - epoch0,
        "minibatches": workflow.loader.run_calls - calls0,
        "run_s": workflow._run_time_,
        "fused": getattr(workflow, "fused_trainer", None) is not None,
        "launches": {"gather_minibatch": gather_minibatch.launches,
                     "mean_disp_normalize": mean_disp_normalize.launches},
        "best_metric": workflow.decision.best_metric,
        "epoch_metrics": workflow.decision.epoch_metrics,
    }
    snapshotter = workflow.snapshotter
    if snapshotter is not None:
        snapshotter.suffix = "final"
        snapshotter.export()
        report["snapshot"] = snapshotter.last_export
        report["rollbacks"] = snapshotter.rollbacks
    if cfg().get("report"):
        with open(cfg().report, "w") as fout:
            json.dump(report, fout)
'''


def write_cli_workflow(directory):
    path = os.path.join(directory, "mnist_cli.py")
    text = CLI_WORKFLOW
    for key, value in (("@SEED@", MNIST_SEED), ("@VALID@", MNIST_VALID),
                       ("@TRAIN@", MNIST_TRAIN)):
        text = text.replace(key, str(value))
    with open(path, "w") as fout:
        fout.write(text)
    return path


def cli_subprocess(args, report):
    """``python -m veles_tpu_torch ARGS`` in a child process (the card by
    default: no ``-d``); its numbers from the workflow's report file."""
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    for name in ("VELES_CHAOS", "VELES_BACKEND"):
        env.pop(name, None)
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch"] + list(args) +
        ["root.chip_cli.report=%r" % report], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise AssertionError("python -m veles_tpu_torch %s: exit %d\n%s" % (
            " ".join(args), proc.returncode, proc.stderr[-4000:]))
    with open(report) as fin:
        out = json.load(fin)
    out["process_s"] = time.perf_counter() - start
    return out


def cli_in_process(args, report, chaos_spec=None):
    """``Main().run(ARGS)`` in this process, the config tree put back
    afterwards; the kernels' counts are zeroed by the workflow file just
    before the run and read just after."""
    import copy
    from veles_tpu_torch import chaos
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.config import root
    saved = copy.deepcopy(root)
    if chaos_spec:
        os.environ["VELES_CHAOS"] = chaos_spec
    try:
        main = Main()
        code = main.run(list(args) + ["root.chip_cli.report=%r" % report])
    finally:
        os.environ.pop("VELES_CHAOS", None)
        chaos.uninstall()
        root.__dict__.clear()
        root.__dict__.update(saved.__dict__)
    if code != 0:
        raise AssertionError("Main().run(%s): exit %d" % (args, code))
    with open(report) as fin:
        return json.load(fin), main.workflow


def current_state(directory):
    """(leaves, last loss) of the workflow in ``directory``'s
    ``_current`` snapshot."""
    from veles_tpu_torch.snapshotter import SnapshotterBase
    wf = SnapshotterBase.import_file(
        os.path.join(directory, "StandardWorkflow_current"))
    leaves = {}
    for i, (fwd, gd) in enumerate(zip(wf.forwards, wf.gds)):
        for name, arr in (("weights", fwd.weights), ("bias", fwd.bias),
                          ("accum_weights", gd.accum_weights),
                          ("accum_bias", gd.accum_bias)):
            leaves["%s%d" % (name, i)] = numpy.array(arr.mem)
    return leaves, float(wf.fused_trainer.last_loss)


def snapshot_epochs(directory):
    found = {}
    for name in os.listdir(directory):
        if name.endswith(".manifest"):
            with open(os.path.join(directory, name)) as fin:
                manifest = json.load(fin)
            found[manifest["epoch"]] = os.path.join(
                directory, name[:-len(".manifest")])
    return found


CLI_CHAOS = "seed=1;step.grad=nan:a4:x8"


def cli_phase(smi):
    """The command line on the card: (1) ``python -m veles_tpu_torch``
    fused by itself (no ``-d``), 3 epochs with ``--snapshot-dir``; (2)
    ``-w`` on its epoch-1 snapshot in a second process, to the end: the
    final states (each run's ``_current``) agree within max-rel 1e-4 on
    every leaf and 1e-5 rel on the loss; (3) the same command as (1) in
    this process through ``Main().run``, for the epoch time; (4) a run
    under ``VELES_CHAOS`` whose poisoned steps trip the watchdog twice: 2
    rollbacks, finite weights, complete, one gather a minibatch; (5) one
    ``--no-fuse`` epoch with a ``MeanDispNormalizer`` in front: one
    gather and one normalize a minibatch.  Returns ({run: launches},
    summary)."""
    import shutil
    import tempfile
    base = tempfile.mkdtemp(prefix="chip_cli_")
    # the snapshots name the loader class mnist_cli.SeededMnist
    sys.path.insert(0, base)
    try:
        wf = write_cli_workflow(base)
        dirs = {name: os.path.join(base, name)
                for name in ("run1", "inproc", "chaos")}
        # -r: the weights are drawn at initialize from the global
        # stream, which this process has used before
        common = ["-r", str(MNIST_SEED), "--snapshot-time-interval", "0",
                  "--snapshot-compress", ""]
        run1 = cli_subprocess(
            [wf, "-", "--snapshot-dir", dirs["run1"],
             "--result-file", os.path.join(base, "r1.json"),
             "root.chip_cli.max_epochs=3"] + common,
            os.path.join(base, "run1.json"))
        if not run1["fused"] or run1["epochs"] != 3:
            raise AssertionError("CLI run 1: %s" % json.dumps(run1))
        epochs = snapshot_epochs(dirs["run1"])
        if 1 not in epochs:
            raise AssertionError("no epoch-1 snapshot: %s" % sorted(epochs))
        snapshot_bytes = os.path.getsize(epochs[1])
        state1, loss1 = current_state(dirs["run1"])
        # the restored workflow keeps its snapshotter, and so its
        # directory: run 2's final state becomes run1's _current
        run2 = cli_subprocess(
            [wf, "-", "-w", epochs[1],
             "--result-file", os.path.join(base, "r2.json")] + common,
            os.path.join(base, "run2.json"))
        with open(os.path.join(base, "r1.json")) as fin:
            results1 = json.load(fin)
        with open(os.path.join(base, "r2.json")) as fin:
            results2 = json.load(fin)
        if not run2["restored"] or run2["epochs"] != 2 or \
                results2["Total epochs"] != results1["Total epochs"]:
            raise AssertionError("CLI resume: %s, results %s vs %s" % (
                json.dumps(run2), results1, results2))
        state2, loss2 = current_state(dirs["run1"])
        resume_rel = host_state_max_rel([state2], [state1])
        loss_rel = abs(loss2 - loss1) / max(abs(loss1), 1e-30)
        log("CLI resume from epoch 1 vs the uninterrupted run: leaves "
            "max-rel %r, loss rel %r, best metric %r vs %r" % (
                resume_rel, loss_rel, results2["Best metric"],
                results1["Best metric"]))
        if resume_rel > 1e-4 or loss_rel > 1e-5:
            raise AssertionError("CLI resume: leaves %g (limit 1e-4), loss "
                                 "%g (limit 1e-5)" % (resume_rel, loss_rel))

        inproc, _ = cli_in_process(
            [wf, "-", "--snapshot-dir", dirs["inproc"],
             "root.chip_cli.max_epochs=3"] + common,
            os.path.join(base, "inproc.json"))
        state3, _ = current_state(dirs["inproc"])
        inproc_rel = host_state_max_rel([state3], [state1])
        shutil.rmtree(dirs["run1"])
        shutil.rmtree(dirs["inproc"])

        chaos_run, workflow = cli_in_process(
            [wf, "-", "--snapshot-dir", dirs["chaos"],
             "root.chip_cli.max_epochs=5", "root.chip_cli.minibatch=15000",
             "root.chip_cli.skip_budget=4"] + common,
            os.path.join(base, "chaos.json"), chaos_spec=CLI_CHAOS)
        weights = [leaf for leaf in current_state(dirs["chaos"])[0].values()]
        rates = sorted({gd.learning_rate for gd in workflow.gds})
        if chaos_run["rollbacks"] != 2 or \
                not bool(workflow.decision.complete) or \
                not all(numpy.isfinite(w).all() for w in weights) or \
                rates != [0.1 * 0.25] or \
                chaos_run["launches"]["gather_minibatch"] != \
                chaos_run["minibatches"]:
            raise AssertionError("CLI under %s: %s, learning rates %s" % (
                CLI_CHAOS, json.dumps(chaos_run), rates))
        shutil.rmtree(dirs["chaos"])

        per_unit, _ = cli_in_process(
            [wf, "-", "-r", str(MNIST_SEED), "--no-fuse",
             "root.chip_cli.normalizer=True", "root.chip_cli.max_epochs=1"],
            os.path.join(base, "per_unit.json"))
        if per_unit["fused"] or any(
                count != per_unit["minibatches"]
                for count in per_unit["launches"].values()):
            raise AssertionError("--no-fuse epoch: %s" % json.dumps(
                per_unit))
    finally:
        sys.path.remove(base)
        shutil.rmtree(base, ignore_errors=True)
    summary = {
        "card": smi,
        "cli_s_per_epoch": run1["run_s"] / run1["epochs"],
        "in_process_s_per_epoch": inproc["run_s"] / inproc["epochs"],
        "cli_process_s": run1["process_s"],
        "snapshot_bytes": snapshot_bytes,
        "snapshot_write_s": run1["snapshot"]["seconds"],
        "final_snapshot_bytes": run1["snapshot"]["bytes"],
        "restore_s": run2["restore_s"],
        "resume_leaves_max_rel": resume_rel, "resume_loss_rel": loss_rel,
        "in_process_vs_cli_leaves_max_rel": inproc_rel,
        "chaos": {"spec": CLI_CHAOS, "rollbacks": chaos_run["rollbacks"],
                  "minibatches": chaos_run["minibatches"],
                  "best_metric": chaos_run["best_metric"]},
        "per_unit_s_per_epoch": per_unit["run_s"] / per_unit["epochs"],
        "validation_error_pct": {"cli": run1["epoch_metrics"][1],
                                 "resumed": run2["epoch_metrics"][1],
                                 "per_unit": per_unit["epoch_metrics"][1]},
    }
    log("cli: %s" % json.dumps(summary))
    return {"chaos": chaos_run["launches"],
            "per_unit": per_unit["launches"]}, summary


def time_normalize(x, mean, rdisp):
    """Device ms a call of ``mean_disp_normalize``.  From 1 MB of x up,
    cold: the calls cycle through copies of x that together exceed
    ``COLD_BYTES`` (smaller shapes are launch-bound).  Each copy starts
    as far into its storage as x does, so that an unaligned view is
    timed unaligned throughout.  Returns (ms, the number of copies)."""
    import torch
    from veles_tpu_torch.ops.normalize import mean_disp_normalize
    nbytes = x.numel() * x.element_size()
    skip = x.storage_offset()

    def copy():
        flat = torch.empty(x.numel() + skip, dtype=x.dtype, device=x.device)
        return flat[skip:].view(x.shape).copy_(x)
    sets = [(x,)] + [(copy(),) for _ in range(
        cold_sets(nbytes) - 1 if nbytes >= 1e6 else 0)]
    if any(t.data_ptr() % 16 != x.data_ptr() % 16 for (t,) in sets):
        raise AssertionError("normalize timing: a copy lost x's alignment")
    rounds = max(1, 100 // len(sets))
    return cold_ms(lambda t: mean_disp_normalize(t, mean, rdisp), sets,
                   rounds), len(sets)


def check_normalize(what, shape, gen, offset=0):
    """mean_disp_normalize of uint8 vs its plain version: bit-equal,
    twice.  ``offset``: x starts that many bytes into its storage (a
    sliced view), so its rows start off a 16-byte boundary."""
    import torch
    from veles_tpu_torch.ops.normalize import (
        mean_disp_normalize, mean_disp_normalize_reference)
    flat = torch.randint(0, 256, (shape[0] * shape[1] + offset,),
                         generator=gen, device="cuda", dtype=torch.uint8)
    x = flat[offset:].view(shape)
    width = shape[1]
    mean = torch.rand(width, generator=gen, device="cuda") * 255
    rdisp = 1.0 / (torch.rand(width, generator=gen, device="cuda") * 255 +
                   1.0)
    got = mean_disp_normalize(x, mean, rdisp)
    again = mean_disp_normalize(x, mean, rdisp)
    want = mean_disp_normalize_reference(x, mean, rdisp)
    torch.cuda.synchronize()
    if not (torch.equal(got.view(torch.int32), want.view(torch.int32)) and
            torch.equal(got.view(torch.int32), again.view(torch.int32))):
        raise AssertionError("normalize %s: differs from the plain version "
                             "or between runs" % what)
    nbytes = x.numel() + 8 * width + 4 * x.numel()
    bound_ms, bound_by = f32_bound(nbytes, 0)
    kernel = functools.partial(mean_disp_normalize, x, mean, rdisp)
    plain = functools.partial(mean_disp_normalize_reference, x, mean, rdisp)
    ms, sets = time_normalize(x, mean, rdisp)
    return record(
        what, "%dx%d uint8 -> f32" % shape, (got - want).abs().max().item(),
        ms, device_ms(plain, 100), None, bound_ms, bound_by,
        call_ms=cuda_ms(kernel, 100), plain_call_ms=cuda_ms(plain, 100),
        x_offset_bytes=offset, cold_l2=sets > 1, rotation=sets)


def check_join(what, batch, parts_spec, gen):
    """join of (batch, width) inputs, ``parts_spec`` = [(width, dtype)],
    to f32 vs its plain version: bit-equal, twice."""
    import torch
    from veles_tpu_torch.ops.join import join, join_reference
    parts = []
    for width, dtype in parts_spec:
        if dtype == torch.uint8:
            parts.append(torch.randint(0, 256, (batch, width), generator=gen,
                                       device="cuda", dtype=dtype))
        else:
            parts.append(torch.randn(batch, width, generator=gen,
                                     device="cuda", dtype=dtype))
    got = join(*parts, out_dtype=torch.float32)
    again = join(*parts, out_dtype=torch.float32)
    want = join_reference(*parts, out_dtype=torch.float32)
    torch.cuda.synchronize()
    if not (torch.equal(got.view(torch.int32), want.view(torch.int32)) and
            torch.equal(got.view(torch.int32), again.view(torch.int32))):
        raise AssertionError("join %s: differs from the plain version or "
                             "between runs" % what)
    nbytes = sum(p.numel() * p.element_size() for p in parts) + \
        4 * got.numel()
    bound_ms, bound_by = f32_bound(nbytes, 0)
    kernel = functools.partial(join, *parts, out_dtype=torch.float32)
    plain = functools.partial(join_reference, *parts,
                              out_dtype=torch.float32)
    library = functools.partial(torch.cat, parts, dim=1)
    shape = " + ".join("%dx%d %s" % (batch, p.shape[1],
                                      str(p.dtype).split(".")[-1])
                       for p in parts) + " -> f32"
    return record(
        what, shape, (got - want).abs().max().item(),
        device_ms(kernel, 100), device_ms(plain, 100),
        device_ms(library, 100), bound_ms, bound_by,
        call_ms=cuda_ms(kernel, 100), plain_call_ms=cuda_ms(plain, 100),
        library_call_ms=cuda_ms(library, 100))


# -- the ops layer: matmul, gemm, the power rating, reductions, uniforms ---

MATMUL_HEADLINE = 3001       # bench.py's N, matmul_benchmark's default
FC1 = (32, 25088, 4096)      # VGG16 fc1 at batch 32: (B, K) @ (K, N)
PEAK_LEVEL0_FLOPS = PEAK_BF16_FLOPS / 3   # three bf16 products a MAC


def matmul_bound(m, k, n, level, dtype, out_dtype):
    """(bound_ms, bound_by): level 0 on f32 counts three bf16 products,
    levels 1 and 2 on f32 one f32 product, bf16 operands one bf16."""
    import torch
    isz = 4 if dtype == torch.float32 else 2
    osz = 4 if out_dtype == torch.float32 else 2
    nbytes = (m * k + k * n) * isz + m * n * osz
    flops = 2.0 * m * k * n
    if dtype == torch.float32 and level == 0:
        t_ops = 3 * flops / PEAK_BF16_FLOPS
    elif dtype == torch.float32:
        t_ops = flops / PEAK_F32_FLOPS
    else:
        t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def benchmark_operand(shape, dtype):
    """``matmul_benchmark``'s signed data, ``(RandomState(13).rand - 0.5)
    * 0.01``, at ``shape``, on the card."""
    import torch
    host = (numpy.random.RandomState(13).rand(*shape) - 0.5) * 0.01
    return torch.from_numpy(host).to("cuda").to(dtype)


def _served_by(before):
    """The matmul path whose count moved since ``before``."""
    from veles_tpu_torch.ops.matmul import matmul
    return [p for p, c in matmul.paths.items() if c != before[p]]


def check_matmul(what, m, k, n, level, dtype, out_dtype, gen, timed=True):
    """matmul vs its plain version and a float64 product on positive
    uniform operands (f32 out: max-rel 1e-5 against both; bf16 out: rtol
    2e-2 against float64), the same bits twice, and the design that
    served it (``matmul.paths``); times on the benchmark's signed data
    (kernel and library: device time a call; the plain version's many
    launches: a loop of calls)."""
    import torch
    from veles_tpu_torch.ops.matmul import matmul, matmul_reference
    a = torch.rand(m, k, generator=gen, device="cuda").to(dtype)
    b = torch.rand(k, n, generator=gen, device="cuda").to(dtype)
    before = dict(matmul.paths)
    got = matmul(a, b, level, out_dtype=out_dtype)
    path = _served_by(before)
    again = matmul(a, b, level, out_dtype=out_dtype)
    want = matmul_reference(a, b, level, out_dtype=out_dtype)
    exact = a.double() @ b.double()
    torch.cuda.synchronize()
    bits = torch.int32 if out_dtype == torch.float32 else torch.int16
    if not torch.equal(got.view(bits), again.view(bits)):
        raise AssertionError("matmul %s: two runs differ" % what)
    if out_dtype == torch.float32:
        rel, rel_plain = max_rel(got, exact), max_rel(got, want)
        if rel > 1e-5 or rel_plain > 1e-5:
            raise AssertionError("matmul %s: max-rel %.3g from float64, %.3g "
                                 "from the plain version" % (what, rel,
                                                             rel_plain))
    else:
        rel = ((got.double() - exact).abs() /
               exact.abs().clamp_min(1e-30)).max().item()
        rel_plain = max_rel(got, want)
        if rel > 2e-2:
            raise AssertionError("matmul %s: rel %.3g from float64" %
                                 (what, rel))
    rec = record(what, "%dx%dx%d %s -> %s, level %d" % (
        m, k, n, str(dtype).split(".")[-1], str(out_dtype).split(".")[-1],
        level), (got.double() - want.double()).abs().max().item(),
        None, None, None, *matmul_bound(m, k, n, level, dtype, out_dtype),
        max_rel_f64=rel, max_rel_plain=rel_plain, path=path[0])
    if timed:
        sa = benchmark_operand((m, k), dtype)
        sb = benchmark_operand((k, n), dtype)
        big = m * k * n > 1e9
        rec["ms"] = device_ms(lambda: matmul(sa, sb, level,
                                             out_dtype=out_dtype),
                              10 if big else 50)
        rec["plain_ms"] = cuda_ms(lambda: matmul_reference(
            sa, sb, level, out_dtype=out_dtype), 3)
        rec["library_ms"] = device_ms(
            lambda: torch.matmul(sa, sb).to(out_dtype), 10 if big else 50)
    return rec


def check_ladder_and_nan():
    """tests/test_ops.py's adversarial accumulation on the card: err1 <=
    1.001 err0 and err2 <= 1.001 err1 against float64, so the Kahan and
    Neumaier folds survived compilation; and a NaN in a row of ``a``
    fills that output row and no other."""
    import torch
    from veles_tpu_torch.ops.matmul import matmul
    k = 4096
    a = torch.where(torch.arange(k) % 2 == 0, 1e6, 1.0).float()
    a = a.reshape(1, k).repeat(8, 1).cuda()
    b = torch.where(torch.arange(k) % 2 == 0, 1.0, -1e-3).float()
    b = b.reshape(k, 1).repeat(1, 8).cuda()
    exact = a.double() @ b.double()
    errs = [(matmul(a, b, level, blocks=(8, 128, 256)).double() -
             exact).abs().max().item() for level in (0, 1, 2)]
    if not (errs[1] <= errs[0] * 1.001 and errs[2] <= errs[1] * 1.001):
        raise AssertionError("matmul ladder inverted on the card: %s" % errs)
    nan_rows = []
    for level in (0, 1, 2):
        x = torch.ones(40, 70, device="cuda")
        x[1, 2] = float("nan")
        out = matmul(x, torch.ones(70, 30, device="cuda"), level)
        bad = (~torch.isfinite(out)).any(dim=1).nonzero().flatten().tolist()
        if bad != [1] or not torch.isnan(out[1]).all():
            raise AssertionError("matmul level %d: a NaN in row 1 gave "
                                 "non-finite rows %s" % (level, bad))
        nan_rows.append(bad)
    return {"ladder_abs_err": errs, "nan_rows": nan_rows}


def check_gemm_fc1(gen):
    """gemm at VGG16 fc1: (32, 25088) @ (25088, 4096) + c, alpha 1, beta
    1, and a transposed pair at a small shape, each within max-rel 1e-5
    of float64.  Library yardstick: ``torch.addmm`` in f32."""
    import torch
    from veles_tpu_torch.ops.blas import gemm
    from veles_tpu_torch.ops.matmul import matmul_reference
    bsz, k, n = FC1
    a = torch.rand(bsz, k, generator=gen, device="cuda")
    w = torch.rand(k, n, generator=gen, device="cuda") * 0.01
    c = torch.rand(bsz, n, generator=gen, device="cuda")
    from veles_tpu_torch.ops.matmul import matmul
    before = dict(matmul.paths)
    got = gemm(a, w, c, alpha=1.0, beta=1.0)
    path = _served_by(before)
    again = gemm(a, w, c, alpha=1.0, beta=1.0)
    exact = a.double() @ w.double() + c.double()
    plain = matmul_reference(a, w, out_dtype=torch.float32) + c
    torch.cuda.synchronize()
    rel = max_rel(got, exact)
    if rel > 1e-5 or not torch.equal(got.view(torch.int32),
                                     again.view(torch.int32)):
        raise AssertionError("gemm fc1: max-rel %.3g from float64, or two "
                             "runs differ" % rel)
    ta = torch.rand(70, 50, generator=gen, device="cuda")
    tb = torch.rand(33, 70, generator=gen, device="cuda")
    tc = torch.rand(50, 33, generator=gen, device="cuda")
    small = gemm(ta, tb, tc, alpha=1.0, beta=1.0, trans_a=True,
                 trans_b=True)
    rel_t = max_rel(small, ta.double().t() @ tb.double().t() + tc.double())
    if rel_t > 1e-5:
        raise AssertionError("gemm trans_a, trans_b: max-rel %.3g" % rel_t)
    nbytes = (bsz * k + k * n + 2 * bsz * n) * 4
    flops = 3 * 2.0 * bsz * k * n
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return record(
        "VGG16 fc1, batch 32, through gemm",
        "%dx%dx%d f32 + c, level 0" % FC1,
        (got.double() - plain.double()).abs().max().item(),
        device_ms(lambda: gemm(a, w, c, alpha=1.0, beta=1.0), 10),
        cuda_ms(lambda: matmul_reference(a, w, out_dtype=torch.float32) + c,
                3),
        device_ms(lambda: torch.addmm(c, a, w), 10),
        max(t_bytes, t_ops) * 1e3,
        "bytes" if t_bytes >= t_ops else "operations", max_rel_f64=rel,
        transposed_max_rel_f64=rel_t, path=path[0],
        call_ms=cuda_ms(lambda: gemm(a, w, c, alpha=1.0, beta=1.0), 10))


#: the row-sum design each named shape must take: the headline's rows
#: fit a block, fc1's 32 rows are split over blocks
REDUCE_ROWS_PATHS = {(3001, 3001): "whole_row", (32, 25088): "split"}
#: the column-sum design and columns a block each named shape must take:
#: few tiles split their rows over blocks, many are summed whole; rows
#: of 3,001 or 129 f32 start off 16-byte boundaries (31 lanes a tile)
REDUCE_COLS_PATHS = {(60000, 784): ("split_col", 128),
                     (3001, 3001): ("split_col", 124),
                     (4096, 4096): ("split_col", 256),
                     (32, 25088): ("whole_col", 128),
                     (100, 784): ("whole_col", 128),
                     (33, 129): ("whole_col", 124)}
#: shapes at which a reduce_cols call must run one CUDA kernel
REDUCE_COLS_PROFILED = ((33, 129), (4096, 4096))


def check_reduce(kind, shape, dtype, gen):
    """reduce_cols / reduce_rows vs a float64 sum on positive data (f32:
    max-rel 1e-5, also against the plain version; bf16: within 1 ulp of
    the float64 sum rounded), the same bits twice, one launch a call,
    on the design ``plan_reduce_cols`` / ``plan_reduce_rows`` names (and,
    at the shapes of ``REDUCE_COLS_PATHS`` / ``REDUCE_ROWS_PATHS``, the
    one named there), counted by ``reduce_cols.paths`` /
    ``reduce_rows.paths``; at ``REDUCE_COLS_PROFILED`` a reduce_cols
    call goes into ``ONE_KERNEL_CALLS``."""
    import torch
    from veles_tpu_torch.ops import reduce as ops_reduce
    kernel = getattr(ops_reduce, kind)
    plain = getattr(ops_reduce, kind + "_reference")
    dim = 0 if kind == "reduce_cols" else 1
    x = torch.rand(shape, generator=gen, device="cuda").to(dtype)
    launches = kernel.launches
    paths = dict(getattr(kernel, "paths", {}))
    got, again = kernel(x), kernel(x)
    launches = kernel.launches - launches
    paths = {k: v - paths[k] for k, v in getattr(kernel, "paths",
                                                 {}).items() if v > paths[k]}
    want = plain(x)
    exact = x.double().sum(dim=dim, keepdim=True)
    torch.cuda.synchronize()
    if launches != 2:
        raise AssertionError("%s %s: %d launches for 2 calls" % (
            kind, shape, launches))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if kind == "reduce_rows":
        path = ops_reduce.plan_reduce_rows(*shape, x.element_size(), sms)[0]
        named = REDUCE_ROWS_PATHS.get(shape, path)
        extra = {"path": path}
    else:
        path, tile, chunks = ops_reduce.plan_reduce_cols(
            *shape, x.element_size(), sms, x.data_ptr())
        named = REDUCE_COLS_PATHS.get(shape, (path, tile))
        extra = {"path": path, "columns_a_block": tile, "chunks": chunks}
        path = (path, tile)
        if shape in REDUCE_COLS_PROFILED:
            ONE_KERNEL_CALLS["reduce_cols %dx%d %s" % (
                shape + (str(dtype).split(".")[-1],))] = (
                    lambda: kernel(x), "cols_kernel")
    if paths != {extra["path"]: 2} or path != named:
        raise AssertionError("%s %s took %s, expected %s" % (
            kind, shape, paths, named))
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    if not torch.equal(got.view(bits), again.view(bits)):
        raise AssertionError("%s %s: two runs differ" % (kind, shape))
    if dtype == torch.float32:
        rel = max(max_rel(got, exact), max_rel(got, want))
        if rel > 1e-5:
            raise AssertionError("%s %s: max-rel %.3g" % (kind, shape, rel))
        err = rel
    else:
        err = (got.view(bits).long() -
               exact.to(dtype).view(bits).long()).abs().max().item()
        if err > 1:
            raise AssertionError("%s %s: %d ulp from float64" % (kind, shape,
                                                                 err))
    nbytes = x.numel() * x.element_size() + got.numel() * got.element_size()
    bound_ms, bound_by = f32_bound(nbytes, 0)
    ms, library_ms, sets = time_reduce(kind, x)
    return record(
        "%s %s" % (kind, str(dtype).split(".")[-1]),
        "%dx%d %s" % (shape + (str(dtype).split(".")[-1],)),
        (got.double() - want.double()).abs().max().item(), ms,
        device_ms(lambda: plain(x), 3 if x.numel() > 1e7 else 10),
        library_ms, bound_ms, bound_by, cold_l2=sets > 1 or
        x.numel() * x.element_size() > COLD_BYTES, rotation=sets,
        **{"max_rel_f64" if dtype == torch.float32 else "max_ulp": err},
        **extra)


#: calls that must each run one CUDA kernel and nothing else: name ->
#: (the call, a part of that kernel's name); :func:`one_kernel_census`
#: counts them all in one profiler session
ONE_KERNEL_CALLS = {}


def one_kernel_census():
    """The CUDA kernels each call of ``ONE_KERNEL_CALLS`` runs, counted in
    one torch.profiler session (on an H100 with torch 2.11, a second
    session in one process saw no kernels): the calls run in turn, each
    after the library's empty kernel, which marks where its kernels
    start, and a synchronize.  Raises unless each ran exactly one
    kernel, of the name expected; returns name -> the kernels' names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from veles_tpu_torch.ops.common import empty_kernel
    card = torch.device("cuda", 0)
    names = list(ONE_KERNEL_CALLS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name in names:
            empty_kernel(card)
            torch.cuda.synchronize()
            ONE_KERNEL_CALLS[name][0]()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start)
    groups = []
    for event in events:
        if "empty_kernel" in event.name:
            groups.append([])
        elif groups:
            groups[-1].append(event.name)
    if len(groups) != len(names):
        raise AssertionError("one-kernel census: %d marks for %d calls (%s)"
                             % (len(groups), len(names),
                                [e.name for e in events]))
    census = dict(zip(names, groups))
    for name, kernels in census.items():
        part = ONE_KERNEL_CALLS[name][1]
        if len(kernels) != 1 or part not in kernels[0]:
            raise AssertionError("%s ran %s on the card, expected one %s "
                                 "kernel" % (name, kernels, part))
    return census


def time_reduce(kind, x):
    """Device ms a call of ``reduce_cols`` / ``reduce_rows`` on x and of
    the library's ``torch.sum`` over the same axis in f32.  From 1 MB
    up, cold: the calls cycle through copies of x that together exceed
    ``COLD_BYTES`` (smaller shapes are launch-bound).  Returns (ms,
    library_ms, the number of copies)."""
    import torch
    from veles_tpu_torch.ops import reduce as ops_reduce
    kernel = getattr(ops_reduce, kind)
    dim = 0 if kind == "reduce_cols" else 1
    nbytes = x.numel() * x.element_size()
    sets = [(x,)] + [(x.clone(),) for _ in range(
        cold_sets(nbytes) - 1 if nbytes >= 1e6 else 0)]
    rounds = max(1, (20 if x.numel() > 1e7 else 100) // len(sets))
    ms = cold_ms(kernel, sets, rounds)
    library_ms = cold_ms(
        lambda t: torch.sum(t, dim=dim, dtype=torch.float32), sets, rounds)
    return ms, library_ms, len(sets)


def check_uniform(shape, gen):
    """hardware_uniform: bit-equal to the plain Philox on the card, the
    same bits per seed and others for another seed, every value in [0,
    1) on the 2**-24 grid; at 4096 x 4096 also the mean within 1e-3 of
    0.5 and a Kolmogorov-Smirnov p-value above 1e-4 on 2**20 samples.
    Library yardstick: ``torch.rand`` on a CUDA generator."""
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops.random import (hardware_uniform,
                                            hardware_uniform_reference)
    device = Device()
    got = hardware_uniform(1234, shape, device=device)
    again = hardware_uniform(1234, shape, device=device)
    other = hardware_uniform(1235, shape, device=device)
    want = hardware_uniform_reference(1234, shape, device.torch_device)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, again)):
        raise AssertionError("hardware_uniform %s: differs from the plain "
                             "Philox or between runs" % (shape,))
    if got.numel() > 1 and torch.equal(got, other):
        raise AssertionError("hardware_uniform %s: seeds 1234 and 1235 give "
                             "the same bits" % (shape,))
    grid = 2.0 ** -24
    if not (bool((got >= 0).all()) and bool((got < 1).all()) and
            torch.equal(torch.floor(got / grid) * grid, got)):
        raise AssertionError("hardware_uniform %s: a value off [0, 1) or "
                             "off the 2**-24 grid" % (shape,))
    extra = {}
    if got.numel() >= 2 ** 24:
        from scipy import stats
        mean = got.double().mean().item()
        sample = got.reshape(-1)[:2 ** 20].cpu().double().numpy()
        pvalue = float(stats.kstest(sample, "uniform").pvalue)
        if abs(mean - 0.5) > 1e-3 or pvalue <= 1e-4:
            raise AssertionError("hardware_uniform %s: mean %.6f, KS p %.3g"
                                 % (shape, mean, pvalue))
        extra = {"mean": mean, "ks_pvalue": pvalue}
    bound_ms, bound_by = f32_bound(4 * got.numel(), 0)
    big = got.numel() > 1e6
    rgen = torch.Generator(device="cuda").manual_seed(1234)
    return record(
        "hardware_uniform", "x".join(map(str, shape)) + " f32",
        (got - want).abs().max().item(),
        device_ms(lambda: hardware_uniform(1234, shape, device=device),
                  20 if big else 100),
        device_ms(lambda: hardware_uniform_reference(
            1234, shape, device.torch_device), 3),
        device_ms(lambda: torch.rand(shape, generator=rgen, device="cuda"),
                  20 if big else 100),
        bound_ms, bound_by, **extra)


def ops_path(gen):
    """The ops layer's public entries at their callers' sizes, with the
    four kernels' counts zeroed just before and read just after: gemm at
    VGG16 fc1, the power rating (``estimate_computing_power`` at the
    client handshake's 256 and repeats 1, and at its default 1024 and
    repeats 3; ``matmul_benchmark`` at 3001; ``Device().computing_power``),
    column sums of the MNIST train set (the normalizer's mean) and of
    (3001, 3001), row sums of (32, 25088), and VGG16's fc dropout-mask
    uniforms (32, 4096) and (4096, 4096).  Each rating's implied rate must
    not exceed its level's peak (989/3 TFLOP/s at level 0, 67 for the
    f32 ``torch.matmul`` of ``Device.computing_power``)."""
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops.benchmark import (estimate_computing_power,
                                               matmul_benchmark)
    from veles_tpu_torch.ops.blas import gemm
    from veles_tpu_torch.ops.matmul import matmul
    from veles_tpu_torch.ops.random import hardware_uniform
    from veles_tpu_torch.ops.reduce import reduce_cols, reduce_rows
    bsz, k, n = FC1
    a = torch.rand(bsz, k, generator=gen, device="cuda")
    w = torch.rand(k, n, generator=gen, device="cuda") * 0.01
    train = torch.rand(MNIST_TRAIN, 784, generator=gen, device="cuda")
    square = torch.rand(MATMUL_HEADLINE, MATMUL_HEADLINE, generator=gen,
                        device="cuda")
    torch.cuda.synchronize()
    counters = {"matmul": matmul, "reduce_cols": reduce_cols,
                "reduce_rows": reduce_rows,
                "hardware_uniform": hardware_uniform}
    for fn in counters.values():
        fn.launches = 0
    for fn in (matmul, reduce_cols, reduce_rows):
        fn.paths = dict.fromkeys(fn.paths, 0)
    out = gemm(a, w, alpha=1.0, beta=0.0)
    gemm_path = _served_by(dict.fromkeys(matmul.paths, 0))
    if gemm_path != ["split_k"]:
        raise AssertionError("gemm at fc1 took %s, not split_k" % gemm_path)
    ratings = {}
    for size, repeats in ((256, 1), (1024, 3)):
        power = estimate_computing_power(size=size, repeats=repeats)
        ratings["estimate_computing_power(%d, %d)" % (size, repeats)] = {
            "power": power, "seconds": 1000.0 / power,
            "tflops": 2.0 * size ** 3 * power / 1000.0 / 1e12,
            "peak_tflops": PEAK_LEVEL0_FLOPS / 1e12}
    before = dict(matmul.paths)
    slope = matmul_benchmark(size=MATMUL_HEADLINE)
    bench_paths = _served_by(before)
    if bench_paths != ["tma_wgmma"]:
        raise AssertionError("matmul_benchmark(3001) took %s, not "
                             "tma_wgmma" % bench_paths)
    ratings["matmul_benchmark(3001)"] = {
        "seconds": slope, "tflops": 2.0 * MATMUL_HEADLINE ** 3 / slope / 1e12,
        "peak_tflops": PEAK_LEVEL0_FLOPS / 1e12}
    power = Device().computing_power
    ratings["Device().computing_power"] = {
        "power": power, "seconds": 1000.0 / power,
        "tflops": 2.0 * 1024 ** 3 * power / 1000.0 / 1e12,
        "peak_tflops": PEAK_F32_FLOPS / 1e12}
    means = reduce_cols(train) / MNIST_TRAIN
    col_sums = reduce_cols(square)
    row_sums = reduce_rows(a)
    masks = [hardware_uniform(seed, shape) for seed, shape in
             ((1, (bsz, n)), (2, (n, n)))]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, count in launches.items():
        if count < 1:
            raise AssertionError("the ops path launched %s no time" % name)
    if reduce_rows.paths != {"whole_row": 0, "split": 1}:
        raise AssertionError("the ops path's fc1 row sums took %s, not one "
                             "split launch" % reduce_rows.paths)
    if reduce_cols.paths != {"whole_col": 0, "split_col": 2}:
        raise AssertionError("the ops path's column sums took %s, not two "
                             "split_col launches" % reduce_cols.paths)
    for name, rating in ratings.items():
        if not rating["seconds"] > 0 or \
                rating["tflops"] > rating["peak_tflops"]:
            raise AssertionError("%s: %s implies more than the peak" %
                                 (name, rating))
    checks = {
        "gemm_max_rel_f64": max_rel(out, a.double() @ w.double()),
        "mean_max_rel_f64": max_rel(means, train.double().mean(
            dim=0, keepdim=True)),
        "col_sums_max_rel_f64": max_rel(col_sums, square.double().sum(
            dim=0, keepdim=True)),
        "row_sums_max_rel_f64": max_rel(row_sums, a.double().sum(
            dim=1, keepdim=True))}
    for name, rel in checks.items():
        if rel > 1e-5:
            raise AssertionError("ops path %s: %.3g" % (name, rel))
    for mask in masks:
        if not (bool((mask >= 0).all()) and bool((mask < 1).all())):
            raise AssertionError("ops path: a uniform off [0, 1)")
    summary = {"launches": launches, "ratings": ratings, "checks": checks,
               "paths": dict(matmul.paths),
               "reduce_cols_paths": dict(reduce_cols.paths),
               "reduce_rows_paths": dict(reduce_rows.paths),
               "gemm_fc1_path": gemm_path[0],
               "matmul_benchmark_path": bench_paths[0]}
    log("ops path: %s" % json.dumps(summary))
    return launches, summary


def ops_phase(gen):
    """Kernel checks for matmul, gemm, the reductions and
    hardware_uniform, then the ops path with its launch counts."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    t0 = time.perf_counter()
    headline = MATMUL_HEADLINE
    matmuls = [check_matmul("bench.py headline", headline, headline,
                            headline, level, f32, f32, gen)
               for level in (0, 1, 2)]
    matmuls += [check_matmul("bench.py headline, bf16", headline, headline,
                             headline, 0, bf16, out, gen)
                for out in (bf16, f32)]
    matmuls += [check_matmul(what, size, size, size, 0, f32, f32, gen)
                for what, size in (("autotune default", 2048),
                                   ("power rating default", 1024),
                                   ("client handshake", 256))]
    matmuls += [check_matmul("odd", m, k, n, level, f32, f32, gen,
                             timed=level == 0)
                for m, k, n in ((17, 129, 33), (130, 257, 5), (1, 1, 1))
                for level in (0, 1, 2)]
    matmuls += [check_matmul("VGG16 fc1 shape", *FC1, level, dtype, f32, gen)
                for level, dtype in ((1, f32), (0, bf16))]
    matmuls.append(check_gemm_fc1(gen))
    edges = check_ladder_and_nan()
    log("matmul ladder and NaN rows: %s" % json.dumps(edges))
    cols = [check_reduce("reduce_cols", shape, dtype, gen)
            for shape, dtype in (((MNIST_TRAIN, 784), f32),
                                 ((headline, headline), f32),
                                 ((4096, 4096), bf16), ((100, 784), f32),
                                 ((FC1[0], FC1[1]), f32), ((33, 129), f32),
                                 ((7, 3), f32), ((1, 1), f32))]
    rows = [check_reduce("reduce_rows", shape, f32, gen)
            for shape in ((headline, headline), (FC1[0], FC1[1]),
                          (100, 784), (33, 129))]
    uniforms = [check_uniform(shape, gen)
                for shape in ((FC1[0], FC1[2]), (4096, 4096), (7, 129),
                              (1,))]
    for name, recs in (("matmul", matmuls), ("reduce_cols", cols),
                       ("reduce_rows", rows),
                       ("hardware_uniform", uniforms)):
        for rec in recs:
            log("%s %s: %s" % (name, rec["what"], json.dumps(rec)))
    log("ops checks: %.1fs" % (time.perf_counter() - t0))
    launches, summary = ops_path(gen)
    return launches, summary, {"matmul": matmuls, "reduce_cols": cols,
                               "reduce_rows": rows,
                               "hardware_uniform": uniforms}




def launch_floor():
    """Device ms of the library's empty kernel (one warp that does
    nothing) on the clock every kernel row uses (:func:`device_ms`), the
    least of three windows of 200: the least time any launch takes on
    the card, a floor under every kernel's bound."""
    import torch
    from veles_tpu_torch.ops.common import empty_kernel
    card = torch.device("cuda", 0)
    runs = [device_ms(lambda: empty_kernel(card), 200) for _ in range(3)]
    return {"ms": min(runs), "runs_ms": runs, "calls": 200}


def check_dropout_bits():
    """The threefry bits and keep masks drawn on the card equal the same
    calls on the CPU bit for bit, at VGG16's fc mask shape (batch 32,
    4096) and an odd shape; the mask's time (host-inclusive, and device
    time behind a spin: ~160 small integer ops)."""
    import torch
    from veles_tpu_torch import threefry
    from veles_tpu_torch.models.dropout import DropoutForward
    card = torch.device("cuda", 0)
    key = threefry.fold_in(threefry.key(1234), 5)
    out = []
    for shape in ((TRAIN_BATCH, 4096), (7, 129, 3)):
        bits = threefry.random_bits(key, shape, card)
        keep = threefry.bernoulli(key, 0.5, shape, card)
        if not (torch.equal(bits.cpu(), threefry.random_bits(key, shape))
                and torch.equal(keep.cpu(),
                                threefry.bernoulli(key, 0.5, shape))):
            raise AssertionError("threefry bits at %s: the card's differ "
                                 "from the CPU's" % (shape,))
        mask = functools.partial(DropoutForward.make_mask, key, shape, 0.5,
                                 torch.float32, card)
        out.append({"shape": list(shape), "bits_equal_cpu": True,
                    "keep_share": keep.float().mean().item(),
                    "mask_call_ms": cuda_ms(mask, 20),
                    "mask_device_ms": device_ms(mask, 4)})
    return out


class RecordMasks(object):
    """Records each dropout mask a step draws, with its key, shape,
    ratio and dtype, by wrapping ``DropoutForward.make_mask``."""

    def __enter__(self):
        from veles_tpu_torch.models.dropout import DropoutForward
        self.cls, self.masks = DropoutForward, []
        self.original = DropoutForward.__dict__["make_mask"]
        draw = DropoutForward.make_mask

        def spy(key, shape, ratio, dtype, device):
            mask = draw(key, shape, ratio, dtype, device)
            self.masks.append((key, tuple(shape), ratio, dtype, mask))
            return mask
        DropoutForward.make_mask = staticmethod(spy)
        return self

    def __exit__(self, *exc):
        self.cls.make_mask = self.original


def check_step_masks(plans, step_key, masks):
    """The masks a keyed step drew: one per dropout layer i, from
    ``fold_in(step_key, i)``, each equal bit for bit to the same draw on
    the CPU."""
    import torch
    from veles_tpu_torch import threefry
    from veles_tpu_torch.models.dropout import DropoutForward
    layers = [i for i, plan in enumerate(plans)
              if issubclass(plan.forward_cls, DropoutForward)]
    # a captured step's warm-up draws first, on copies: its capture's
    # masks are the last, their keys device words read after the replay
    masks = [(tuple(int(w) for w in key),) + tuple(rest)
             for key, *rest in masks[-len(layers):]]
    if [key for key, *_ in masks] != [threefry.fold_in(step_key, i)
                                      for i in layers]:
        raise AssertionError("the step drew %d masks with keys %s for "
                             "dropout layers %s" % (
                                 len(masks), [m[0] for m in masks], layers))
    out = []
    for i, (key, shape, ratio, dtype, mask) in zip(layers, masks):
        want = DropoutForward.make_mask(key, shape, ratio, dtype,
                                        torch.device("cpu"))
        if not torch.equal(mask.cpu(), want):
            raise AssertionError("dropout layer %d: the card's mask %s "
                                 "differs from the CPU's" % (i, shape))
        out.append({"layer": i, "shape": list(shape), "ratio": ratio,
                    "keep_share": (want > 0).float().mean().item(),
                    "equal_cpu": True})
    return out


# -- slice 14: the compile step, captured graphs against raw steps -----------

GRAPH_STEPS = 3     # replays held bit for bit against the raw step
GRAPH_REPS = 5      # timed steps a turn (raw, graph, graph, raw)


def graph_counters():
    from veles_tpu_torch.graphs import counters
    return {w.__name__: w for w in counters()}


def hold_graph_steps(name, plans, host_state, batches, seed=None,
                     epoch=None):
    """The captured, donated step against the raw step on the card, one
    chain each from one state over ``batches`` (cuDNN deterministic):
    every state leaf and metric bit for bit, every launch counter equal
    to replays x the graph's launches a replay, and, for a keyed step
    (``seed``), each replay's masks, read out of the graph, equal to the
    CPU's draw from that step's key and unlike the previous replay's.
    ``epoch`` (dataset, labels, order, batch) holds a train epoch
    instead: the gather inside the graph, one replay a minibatch."""
    import torch
    from veles_tpu_torch import threefry
    from veles_tpu_torch.compiler import build_train_epoch, build_train_step
    from veles_tpu_torch.convert import state_from_jax
    from veles_tpu_torch.models.dropout import DropoutForward
    device = torch.device("cuda", 0)
    state0 = state_from_jax(host_state, _card())

    def key(n):
        return None if seed is None else threefry.fold_in(
            threefry.key(seed), n)

    if epoch is not None:
        dataset, labels, order, batch = epoch
        raw = build_train_epoch(plans, batch, donate=False)
        cap = build_train_epoch(plans, batch)
        want_state, want = raw(state0, dataset, labels, order, key(1))
        counters = graph_counters()
        before = {n: w.launches for n, w in counters.items()}
        got_state, got = cap(state0, dataset, labels, order, key(1))
        torch.cuda.synchronize()
        receipt = cap.graphs.receipt
        delta = {n: w.launches - before[n] for n, w in counters.items()
                 if w.launches != before[n]}
        per_replay = {}
        for graph in cap.graphs._graphs.values():
            for wrapper, launches, _ in graph.delta:
                per_replay[wrapper.__name__] = launches
        replays = receipt["replays"]
        want_metrics, got_metrics = [want], [got]
        masks = []
    else:
        raw = build_train_step(plans, donate=False)
        cap = build_train_step(plans)
        s, want_metrics = state0, []
        for n, (x, t) in enumerate(batches, 1):
            s, m = raw(s, x, t, float(x.shape[0]), key(n))
            want_metrics.append({k: v.clone() for k, v in m.items()})
        want_state = s
        counters = graph_counters()
        before = {n: w.launches for n, w in counters.items()}
        s, got_metrics, masks = state0, [], []
        with RecordMasks() as drawn:
            for n, (x, t) in enumerate(batches, 1):
                s, m = cap(s, x, t, float(x.shape[0]), key(n))
                got_metrics.append(m)
                if seed is not None:
                    layers = [i for i, p in enumerate(plans)
                              if issubclass(p.forward_cls, DropoutForward)]
                    masks.append([(i, tuple(shape), ratio,
                                   mask.detach().clone()) for i, (
                                       _, shape, ratio, _, mask) in
                                  zip(layers, drawn.masks[-len(layers):])])
        torch.cuda.synchronize()
        got_state = s
        receipt = cap.graphs.receipt
        delta = {n: w.launches - before[n] for n, w in counters.items()
                 if w.launches != before[n]}
        graph = next(iter(cap.graphs._graphs.values()))
        per_replay = {w.__name__: launches for w, launches, _ in graph.delta}
        replays = receipt["replays"]
    leaves = sum(1 for e in want_state for v in e.values() if v is not None)
    differ = sum(1 for g, w in zip(got_state, want_state)
                 for k, v in w.items()
                 if v is not None and not torch.equal(g[k], v))
    metric_differ = [k for g, w in zip(got_metrics, want_metrics)
                     for k in w if not torch.equal(g[k], w[k])]
    if differ or metric_differ:
        raise AssertionError("graphs, %s: %d of %d leaves and metrics %s "
                             "differ from the raw step's" % (
                                 name, differ, leaves, metric_differ))
    want_delta = {n: launches * replays for n, launches in
                  per_replay.items() if launches}
    if delta != want_delta:
        raise AssertionError("graphs, %s: counters moved %s over %d "
                             "replays, expected %s" % (name, delta,
                                                       replays, want_delta))
    mask_check = []
    for n, drawn_masks in enumerate(masks, 1):
        for j, (i, shape, ratio, mask) in enumerate(drawn_masks):
            cpu = DropoutForward.make_mask(
                threefry.fold_in(key(n), i), shape, ratio, torch.float32,
                torch.device("cpu"))
            if not torch.equal(mask.cpu(), cpu):
                raise AssertionError("graphs, %s: replay %d's mask of "
                                     "layer %d differs from the CPU's draw"
                                     % (name, n, i))
            if n > 1 and torch.equal(mask, masks[n - 2][j][3]):
                raise AssertionError("graphs, %s: replay %d drew replay "
                                     "%d's mask again at layer %d" % (
                                         name, n, n - 1, i))
            mask_check.append({"replay": n, "layer": i,
                               "keep_share": (cpu > 0).float().mean()
                               .item()})
    if seed is not None and len(mask_check) != 2 * len(batches):
        raise AssertionError("graphs, %s: %d masks read, expected 2 a "
                             "replay" % (name, len(mask_check)))
    del cap, raw
    return {"leaves": leaves, "bit_equal": True, "replays": replays,
            "launches_per_replay": per_replay, "counters_moved": delta,
            "receipt": dict(receipt), "masks": mask_check}


def _card():
    from veles_tpu_torch.backends import Device
    return Device()


def time_graph_steps(plans, host_state, x, t, seed=None):
    """Raw and captured steps in turns (raw, graph, graph, raw), each
    turn GRAPH_REPS steps from one state: wall (CUDA events around the
    step, the card's clock) and host enqueue (host clock, no sync), the
    medians of each turn."""
    import torch
    from veles_tpu_torch import threefry
    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.convert import state_from_jax
    state0 = state_from_jax(host_state, _card())
    raw = build_train_step(plans, donate=False)
    cap = build_train_step(plans)
    key = None if seed is None else threefry.fold_in(threefry.key(seed), 1)
    cap_state = cap.own_state(state0)
    cap(cap_state, x, t, float(x.shape[0]), key)     # captured here
    turns = {"raw": [], "graph": []}
    for label in ("raw", "graph", "graph", "raw"):
        walls, enqueues = [], []
        for _ in range(GRAPH_REPS):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            host = time.perf_counter()
            start.record()
            if label == "raw":
                raw(state0, x, t, float(x.shape[0]), key)
            else:
                cap(cap_state, x, t, float(x.shape[0]), key)
            end.record()
            enqueues.append((time.perf_counter() - host) * 1e3)
            torch.cuda.synchronize()
            walls.append(start.elapsed_time(end))
        turns[label].append({"wall_ms": float(numpy.median(walls)),
                             "enqueue_ms": float(numpy.median(enqueues))})
    receipt = dict(cap.graphs.receipt)
    del cap, raw, state0, cap_state
    return {"turns": turns, "pool_bytes": receipt["pool_bytes"],
            "capture_s": receipt["capture_s"]}


def hold_rungs(engine, make_x, swap=None):
    """Each rung's graph against the engine's raw forward on the same
    batch, bit for bit; host-clock latency of a dispatch (copy in,
    replay, copy out to the host) beside the raw forward's, in turns
    (raw, graph, graph, raw).  ``swap``: parameters swapped in after,
    which the next replay must use (held against the raw forward over a
    fresh upload of them) without a capture."""
    import torch
    out = {}
    for rung in engine.ladder:
        x = make_x(rung)
        x_dev = engine.device.put(x)

        def graph():
            return engine.run_host(x, rung).cpu().numpy()

        def raw():
            with torch.inference_mode():
                return engine._forward(engine._params_dev,
                                       engine.device.put(x)).cpu().numpy()

        if not (graph() == raw()).all():
            raise AssertionError("graphs: rung %d differs from the raw "
                                 "forward" % rung)
        turns = {"raw": [], "graph": []}
        for label in ("raw", "graph", "graph", "raw"):
            fn = raw if label == "raw" else graph
            times = []
            for _ in range(GRAPH_REPS):
                start = time.perf_counter()
                fn()
                times.append((time.perf_counter() - start) * 1e3)
            turns[label].append(float(numpy.median(times)))
        out[str(rung)] = turns
        del x_dev
    if swap is not None:
        rung = engine.ladder[-1]
        x = make_x(rung)
        before = engine.run_host(x, rung).cpu().numpy()
        captures = engine.graphs.receipt["captures"]
        engine.swap_params(swap)
        got = engine.run_host(x, rung).cpu().numpy()
        with torch.inference_mode():
            want = engine._forward(engine._put_params(swap),
                                   engine.device.put(x)).cpu().numpy()
        if not (got == want).all() or (got == before).all() or \
                engine.graphs.receipt["captures"] != captures:
            raise AssertionError("graphs: swap_params at rung %d: equal "
                                 "to the new weights' forward %s, changed "
                                 "%s, captures %d -> %d" % (
                                     rung, (got == want).all(),
                                     not (got == before).all(), captures,
                                     engine.graphs.receipt["captures"]))
        out["swap_params_seen"] = True
    out["receipt"] = {k: engine.compile_receipt[k] for k in (
        "graphs", "capture_s", "warmup_launches", "pool_bytes")}
    return out


def graphs_phase(device):
    """The slice's captured paths held against their raw runs and
    timed; returns the summary."""
    import torch
    from veles_tpu_torch.models.zoo import build_plans_and_state, vgg_layers
    gen = torch.Generator(device="cuda").manual_seed(21)
    summary = {}
    torch.backends.cudnn.deterministic = True
    try:
        # the MNIST workflow's step and epoch (the trainer's path)
        plans, state, _ = build_plans_and_state(mnist_layers(), (784,),
                                                seed=MNIST_SEED)
        data = torch.rand((1000, 784), generator=gen, device="cuda")
        labels = torch.randint(0, 10, (1000,), generator=gen,
                               device="cuda", dtype=torch.int32)
        batches = [(data[i * MNIST_BATCH:(i + 1) * MNIST_BATCH],
                    labels[i * MNIST_BATCH:(i + 1) * MNIST_BATCH])
                   for i in range(GRAPH_STEPS)]
        summary["mnist_step"] = hold_graph_steps("MNIST step", plans, state,
                                                 batches)
        order = torch.randperm(1000, generator=gen,
                               device="cuda").to(torch.int32)[:950]
        summary["mnist_epoch"] = hold_graph_steps(
            "MNIST epoch", plans, state, None,
            epoch=(data, labels, order, MNIST_BATCH))
        summary["mnist_timing"] = time_graph_steps(plans, state,
                                                   *batches[0])
        # the transformer step
        tf_plans, tf_state = tf_params()
        tf_batches = [(torch.randn((TF_BATCH,) + TF_SHAPE, generator=gen,
                                   device="cuda"),
                       torch.randint(0, 10, (TF_BATCH,), generator=gen,
                                     device="cuda", dtype=torch.int32))
                      for _ in range(GRAPH_STEPS)]
        summary["transformer_step"] = hold_graph_steps(
            "transformer step", tf_plans, tf_state, tf_batches)
        summary["transformer_timing"] = time_graph_steps(
            tf_plans, tf_state, *tf_batches[0])
        del tf_batches, tf_state
        # the keyed VGG16 step
        plans, state, _ = build_plans_and_state(vgg_layers(config="D"),
                                                (224, 224, 3), seed=0)
        vgg_batches = [(torch.rand((TRAIN_BATCH, 224, 224, 3),
                                   generator=gen, device="cuda") * 2 - 1,
                        torch.randint(0, 1000, (TRAIN_BATCH,),
                                      generator=gen, device="cuda",
                                      dtype=torch.int32))
                       for _ in range(GRAPH_STEPS)]
        summary["vgg16_keyed_step"] = hold_graph_steps(
            "keyed VGG16 step", plans, state, vgg_batches, seed=17)
        summary["vgg16_keyed_timing"] = time_graph_steps(
            plans, state, *vgg_batches[0], seed=17)
        del vgg_batches, state
    finally:
        torch.backends.cudnn.deterministic = False
        torch.cuda.empty_cache()
    log("graphs: " + json.dumps(summary))
    return summary


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops import common

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    log("python %s, torch %s, cuda %s" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda))

    start = time.perf_counter()
    common.load_kernels()
    log("build: %.2fs (%s)" % (time.perf_counter() - start,
                               common.build_info["path"]))
    seconds, last = {}, [start]

    def lap(name):
        """Seconds since the previous lap, under ``name``."""
        now = time.perf_counter()
        seconds[name] = now - last[0]
        last[0] = now
    lap("build")
    for line in common.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    floor = launch_floor()
    log("launch floor: %s" % json.dumps(floor))
    dropout = check_dropout_bits()
    log("dropout bits, card vs CPU: %s" % json.dumps(dropout))

    device = Device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [check_kernel("conv1_2, rung 8", 8 * 224 * 224, 576, 64,
                           127, gen),
              check_kernel("fc1, rung 32", 32, 25088, 4096, 16, gen),
              check_kernel("conv1_1, rung 32", 32 * 224 * 224, 27, 64, 127,
                           gen),
              check_kernel("conv3_1, rung 32", 32 * 56 * 56, 1152, 256, 120,
                           gen),
              check_kernel("conv5_1, rung 32", 32 * 14 * 14, 4608, 512, 60,
                           gen),
              check_kernel("fc2, rung 32", 32, 4096, 4096, 63, gen),
              check_kernel("ragged", 37, 91, 53, 127, gen)]
    for rec in shapes:
        log("matmul_int8 %s: %s" % (rec["what"], json.dumps(rec)))
    gathers = [
        check_gather("32 of 256 VGG16 images f32", 256, (224, 224, 3),
                     TRAIN_BATCH, torch.float32, gen),
        check_gather("32 of 1,024 VGG16 images uint8", 1024, (224, 224, 3),
                     TRAIN_BATCH, torch.uint8, gen),
        check_gather("32 of 256 VGG16 images f32, int64 indices", 256,
                     (224, 224, 3), TRAIN_BATCH, torch.float32, gen,
                     torch.int64),
        check_gather("MNIST minibatch, 100 of 60,000 uint8", MNIST_TRAIN,
                     (784,), MNIST_BATCH, torch.uint8, gen)]
    gather_summary = gather_cases(gen)
    log("gather_minibatch cases: %s" % json.dumps(gather_summary))
    wgrads = [
        check_wgrad("conv1_2, batch 8", (8, 224, 224, 64), 64, (3, 3),
                    (1, 1, 1, 1), (1, 1), "strict_relu", gen),
        check_wgrad("conv1_1, batch 8", (8, 224, 224, 3), 64, (3, 3),
                    (1, 1, 1, 1), (1, 1), "strict_relu", gen),
        check_wgrad("conv5_1, batch 32", (32, 14, 14, 512), 512, (3, 3),
                    (1, 1, 1, 1), (1, 1), "strict_relu", gen),
        check_wgrad("conv5_1, batch 32, level 1", (32, 14, 14, 512), 512,
                    (3, 3), (1, 1, 1, 1), (1, 1), "strict_relu", gen,
                    level=1),
        check_wgrad("ragged", (3, 37, 29, 5), 7, (3, 2), (2, 1, 0, 1),
                    (2, 3), "tanh", gen)]
    pools = [
        check_pool("pool1, batch 8", (8, 224, 224, 64), (2, 2), (2, 2),
                   gen),
        check_pool("overlapping ceil-mode", (3, 13, 13, 96), (3, 3),
                   (2, 2), gen),
        check_pool("AlexNet pool1, batch 32", (32, 55, 55, 96), (3, 3),
                   (2, 2), gen)]
    pool_summary = pool_cases(gen)
    pool_summary["vgg16_step_batch_32"] = pool_step(gen)
    log("max_pool_bwd cases: %s" % json.dumps(pool_summary))
    for name, recs in (("gather_minibatch", gathers),
                       ("conv_wgrad", wgrads), ("max_pool_bwd", pools)):
        for rec in recs:
            log("%s %s: %s" % (name, rec["what"], json.dumps(rec)))

    attn = []
    for what, shape, dtype in (
            ("model, batch 64", (TF_BATCH * TF_HEADS, TF_SHAPE[0], 64),
             torch.float32),
            ("long sequence", (8, 1024, 64), torch.float32),
            ("ragged 300", (2, 300, 16), torch.float32),
            ("ragged 37", (2, 37, 8), torch.float32),
            ("model, batch 64, bf16", (TF_BATCH * TF_HEADS, TF_SHAPE[0],
                                       64), torch.bfloat16)):
        attn.append(check_attention(what, shape, dtype, gen))
        attn.append(check_attention(what + ", level 1", shape, dtype, gen,
                                    level=1, library=attn[-1]))
    for recs in attn:
        for name, rec in recs.items():
            log("attention_%s %s: %s" % (name, rec["what"], json.dumps(rec)))
    normalizes = [
        check_normalize("unit graph minibatch", (MNIST_BATCH, 784), gen),
        check_normalize("large", (4096, 3072), gen),
        check_normalize("width not a multiple of 16", (4096, 3000), gen),
        check_normalize("odd width", (MNIST_BATCH, 129), gen),
        check_normalize("unaligned view", (4096, 3072), gen, offset=1)]
    joins = [
        check_join("DAG branches", MNIST_BATCH,
                   [(MNIST_HIDDEN, torch.float32)] * 2, gen),
        check_join("mixed", 4096, [(784, torch.uint8), (100, torch.float32),
                                   (10, torch.float32)], gen)]
    for name, recs in (("mean_disp_normalize", normalizes),
                       ("join", joins)):
        for rec in recs:
            log("%s %s: %s" % (name, rec["what"], json.dumps(rec)))
    ops_launches, ops_summary, ops = ops_phase(gen)
    census = one_kernel_census()
    log("one-kernel census: %s" % json.dumps(census))
    lap("kernel checks")

    launches, per_dispatch = serve_phase(device)
    lap("serve")
    train_launches, train = train_phase(device)
    small = train_small_vs_cpu(device)
    log("small convnet, card vs CPU: %s" % json.dumps(small))
    lap("train")
    tf_serve_launches, tf_per_dispatch, tf_serve_paths = \
        transformer_serve_phase(device)
    lap("transformer serve")
    tf_launches, tf_train = transformer_train_phase(device)
    small_tf = train_small_transformer_vs_cpu(device)
    log("small transformer, card vs CPU: %s" % json.dumps(small_tf))
    lap("transformer train")
    graph_summary = graphs_phase(device)
    lap("graphs")
    graph_launches, graph = unit_graph_phase(device)
    graph_gathers = sum(run["gather_minibatch"]
                        for run in graph_launches.values())
    lap("unit graph")
    conv_launches, conv_graph = unit_graph_conv_phase(device, graph_summary)
    lap("unit graph, per-unit conv")

    def per_unit_sum(name):
        return sum(run.get(name, 0) for run in conv_launches.values())
    cli_launches, cli = cli_phase(smi)
    cli_gathers = sum(run["gather_minibatch"]
                      for run in cli_launches.values())
    lap("cli")
    seconds["total"] = last[0] - start
    log("phase seconds: %s" % json.dumps(seconds))

    def entry(name, source, replaces, count, recs, **extra):
        top = recs[0]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": count,
               "shape": "%s (%s)" % (top["shape"], top["what"])}
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms"):
            row[key] = top[key]
        row.update(extra)
        row["shapes"] = recs
        return row

    print(json.dumps({"kernels": [
        entry("matmul_int8", "veles_tpu_torch/csrc/matmul_int8.cu",
              "veles_tpu/ops/matmul_int8.py:183", launches, shapes,
              launches_per_dispatch=per_dispatch),
        entry("gather_minibatch", "veles_tpu_torch/csrc/gather.cu",
              "veles_tpu/ops/gather.py:59",
              train_launches["gather_minibatch"] +
              tf_launches["gather_minibatch"] + graph_gathers + cli_gathers +
              per_unit_sum("gather_minibatch"),
              gathers,
              launches_vgg16=train_launches["gather_minibatch"],
              launches_transformer=tf_launches["gather_minibatch"],
              launches_unit_graph=graph_gathers,
              launches_cli=cli_gathers,
              launches_per_unit_conv=per_unit_sum("gather_minibatch") -
              conv_launches["cifar10_fused"]["gather_minibatch"],
              launches_cifar10_fused=conv_launches["cifar10_fused"][
                  "gather_minibatch"],
              launches_per_epoch=TRAIN_SAMPLES // TRAIN_BATCH,
              paths_vgg16=train["paths"]["gather_minibatch"],
              int64_kernels=census["gather_minibatch int64 indices"],
              cold_l2=True),
        entry("conv_wgrad", "veles_tpu_torch/csrc/conv_wgrad.cu",
              "veles_tpu/ops/conv_vjp.py:258",
              train_launches["conv_wgrad"] + per_unit_sum("conv_wgrad"),
              wgrads,
              launches_vgg16=train_launches["conv_wgrad"],
              launches_per_unit={k: v["conv_wgrad"] for k, v in
                                 conv_launches.items()
                                 if k != "cifar10_fused"},
              launches_cifar10_fused=conv_launches["cifar10_fused"][
                  "conv_wgrad"],
              launches_per_step=train["launches_per_step"]["conv_wgrad"],
              launches_per_unit_cifar10_train_minibatch=conv_graph[
                  "cifar10"]["per_train_minibatch"]["conv_wgrad"],
              launches_per_unit_vgg16_step=conv_graph["vgg16"][
                  "launches_per_step"]["conv_wgrad"],
              paths_vgg16=train["paths"]["conv_wgrad"], cold_l2=True),
        entry("max_pool_bwd", "veles_tpu_torch/csrc/pool_bwd.cu",
              "veles_tpu/ops/pool_bwd.py:192",
              train_launches["max_pool_bwd"] + per_unit_sum("max_pool_bwd"),
              pools,
              launches_vgg16=train_launches["max_pool_bwd"],
              launches_per_unit={k: v["max_pool_bwd"] for k, v in
                                 conv_launches.items()
                                 if k != "cifar10_fused"},
              launches_cifar10_fused=conv_launches["cifar10_fused"][
                  "max_pool_bwd"],
              launches_per_step=train["launches_per_step"][
                  "max_pool_bwd"],
              launches_per_unit_cifar10_train_minibatch=conv_graph[
                  "cifar10"]["per_train_minibatch"]["max_pool_bwd"],
              launches_per_unit_vgg16_step=conv_graph["vgg16"][
                  "launches_per_step"]["max_pool_bwd"],
              paths_vgg16=train["paths"]["max_pool_bwd"],
              step_ms=pool_summary["vgg16_step_batch_32"]["ms"],
              step_library_ms=pool_summary["vgg16_step_batch_32"][
                  "library_ms"],
              step_bound_ms=pool_summary["vgg16_step_batch_32"]["bound_ms"],
              cold_l2=True),
        entry("attention_fwd", "veles_tpu_torch/csrc/attention_fwd.cu",
              "veles_tpu/ops/attention.py:145",
              tf_serve_launches + tf_launches["attention_fwd"] +
              per_unit_sum("attention_fwd"),
              [recs["fwd"] for recs in attn],
              launches_serve=tf_serve_launches,
              launches_train=tf_launches["attention_fwd"],
              launches_per_unit=per_unit_sum("attention_fwd"),
              launches_per_unit_step=conv_graph["transformer"][
                  "launches_per_step"]["attention_fwd"],
              launches_per_dispatch=tf_per_dispatch,
              launches_per_step=tf_train["launches_per_step"][
                  "attention_fwd"],
              paths_serve=tf_serve_paths,
              paths_transformer=tf_train["paths"]["attention_fwd"]),
        entry("attention_dq", "veles_tpu_torch/csrc/attention_bwd.cu",
              "veles_tpu/ops/attention.py:257",
              tf_launches["attention_dq"] + per_unit_sum("attention_dq"),
              [recs["dq"] for recs in attn],
              launches_per_step=tf_train["launches_per_step"][
                  "attention_dq"],
              launches_per_unit=per_unit_sum("attention_dq"),
              paths_transformer=tf_train["paths"]["attention_dq"]),
        entry("attention_dkv", "veles_tpu_torch/csrc/attention_bwd.cu",
              "veles_tpu/ops/attention.py:279",
              tf_launches["attention_dkv"] + per_unit_sum("attention_dkv"),
              [recs["dkv"] for recs in attn],
              launches_per_step=tf_train["launches_per_step"][
                  "attention_dkv"],
              launches_per_unit=per_unit_sum("attention_dkv"),
              paths_transformer=tf_train["paths"]["attention_dkv"]),
        entry("mean_disp_normalize", "veles_tpu_torch/csrc/normalize.cu",
              "veles_tpu/ops/normalize.py:39",
              graph_launches["per_unit"]["mean_disp_normalize"] +
              graph_launches["dag"]["mean_disp_normalize"] +
              cli_launches["per_unit"]["mean_disp_normalize"] +
              per_unit_sum("mean_disp_normalize"), normalizes,
              launches_per_unit_cifar10=per_unit_sum(
                  "mean_disp_normalize"),
              launches_per_unit_run=graph_launches["per_unit"][
                  "mean_disp_normalize"],
              launches_cli=cli_launches["per_unit"]["mean_disp_normalize"],
              launches_fused_run=graph_launches["fused"][
                  "mean_disp_normalize"],
              launches_dag=graph_launches["dag"]["mean_disp_normalize"]),
        entry("join", "veles_tpu_torch/csrc/join.cu",
              "veles_tpu/ops/join.py:47", graph_launches["dag"]["join"],
              joins, launches_dag=graph_launches["dag"]["join"]),
        entry("matmul", "veles_tpu_torch/csrc/matmul.cu",
              "veles_tpu/ops/matmul.py:228", ops_launches["matmul"],
              ops["matmul"], paths=ops_summary["paths"]),
        entry("hardware_uniform", "veles_tpu_torch/csrc/uniform.cu",
              "veles_tpu/ops/random.py:211",
              ops_launches["hardware_uniform"], ops["hardware_uniform"]),
        entry("reduce_cols", "veles_tpu_torch/csrc/reduce.cu",
              "veles_tpu/ops/reduce.py:47", ops_launches["reduce_cols"],
              ops["reduce_cols"], paths=ops_summary["reduce_cols_paths"],
              kernels_a_call={name: kernels for name, kernels in
                              census.items() if name.startswith("reduce")}),
        entry("reduce_rows", "veles_tpu_torch/csrc/reduce.cu",
              "veles_tpu/ops/reduce.py:85", ops_launches["reduce_rows"],
              ops["reduce_rows"], paths=ops_summary["reduce_rows_paths"]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
