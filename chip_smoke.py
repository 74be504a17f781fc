#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (horovod_tpu_torch) on one GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --only kernels   # or api, train, bn_kernels,
                                           # resnet, resnet_lean,
                                           # ring_kernels, sp, lc, lc_sp,
                                           # wire_kernels, zero1, moe,
                                           # ulysses, inception,
                                           # resnet_nf, vgg16, word2vec,
                                           # core, launch, serve, fleet

Phases, in order; any failure exits non-zero:

1. device: requires CUDA and prints the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit``).
2. build: compiles ``horovod_tpu_torch/ops/csrc/*.cu`` with nvcc for
   sm_90a, one process per source, and beside it the negotiation core
   (``horovod_tpu_torch/native``) with g++, and prints the seconds.
2b. api: the data-parallel API on a one-rank NCCL group
   (``init(model_parallel=1)``): ``new_group([0])``; ``allreduce`` and
   ``reduce_scatter`` (an odd count, 1,000,003) without a group, with
   ``WORLD`` and with the new group, averaged or summed, with and without
   pre- and postscale, and ``allreduce`` under the fp16 and bf16 codecs,
   each equal (``torch.equal``) to what one rank implies, computed in the
   same order; ``allgather``; the broadcast of a dict of tensors;
   ``metric_average``; the digest advancing once a collective and equal to
   this script's own FoldCall over the calls' (op, dtype, ndim, name);
   ``assert_synchronized``; ``sync_batch_norm_stats`` against
   ``torch.var_mean`` (norm-relative <= 1e-4) and the stock sync BN against
   the stock BN without sync on a (32, 64, 56, 56) f32 activation (y, dx,
   dgamma, dbeta, running statistics, each <= 1e-4).
3. kernels: runs the flash forward (K1), dQ (K2) and dK/dV (K3) kernels at
   the training shape (B=8, H=12, L=2048, D=64, bf16, causal) and at an odd
   shape (B=1, H=4, G=2, L=160, non-causal) and holds each against its
   plain version computed in float32 from the same inputs:
   ||kernel - plain||_2 / ||plain||_2 <= 1e-2 for O, dQ, dK and dV, and
   max |lse - plain lse| <= 1e-3. K2 and K3 run twice: on the plain
   version's lse and delta, and chained on K1's own lse and O. Times
   kernel, plain version and PyTorch's scaled_dot_product_attention
   forward and backward (a yardstick the port never calls) with CUDA
   events. Then K1-K3 with rotary the same way (chained too) at the lc
   phase's launch (B=2, H=6, G=2, L=8192, D=128, causal) and at an odd
   shape (B=1, H=6, G=2, L=333, D=128, full) against the rotary plain
   versions on the same bf16 inputs, timed beside the same launch without
   rotary and beside SDPA (enable_gqa) on q and k rotated beforehand, the
   rotation's time apart. No mainloop rotates: the rotary pass
   (``rope_rotate``, rope.cu) rotates q and k and the kernels read the
   copies. K1_rot is checked and timed through its wrapper (the pass, then
   K1); K2_rot and K3_rot (which counter-rotate dQ, dK) through their
   wrappers and ``flash_backward`` (each with its own pass), timed alone
   on the rotated copies; and ``flash_attention`` with rotary forward and
   backward, whose forward must launch the pass twice and whose backward
   (on the copies autograd kept) none. One layer's pass, K1, K2_rot and
   K3_rot are timed beside K1-K3 without rotary. The pass itself must
   equal its plain version (``apply_rotary`` at the shard's positions) bit
   for bit on q and k at the lc launch, a 4-rank zigzag shard and ragged
   lengths, and is timed at the lc launch.
4. train: ``hvd.init()`` (a one-rank NCCL group), the GPT-2-small flash LM
   (vocab 32000, 12 layers, 12 x 64 heads, embed 768, MLP 3072, bf16 over
   f32 params) from a seeded generator, Adam(1e-4) in
   ``DistributedOptimizer`` (overlapped: its buckets go out during the
   backward) and ``make_train_step`` with ``lm_loss``; 2 warm-up and 5
   timed steps on one batch of 8 x 2048 tokens. Before the steps, one
   backward through the optimizer's hooks: every bucket sent during it,
   in bucket order, and its gradients equal to ``allreduce_gradients`` on
   a copy of the same local gradients bit for bit; after an accumulating
   backward (``_no_sync``) ``synchronize()`` sends every bucket in order. Before the
   steps, the same weights through plain (dense) attention: the first
   loss at 8 x 2048, and every parameter's gradient at 2 x 2048 (worst
   ||g_flash - g_plain||_2 / ||g_plain||_2 <= 5e-2). Checks finite and
   falling losses and 12 launches of each kernel per step. Then the same
   LM from the same seed with ``DistributedOptimizer(negotiated=True)``
   (ROADMAP A8c2: every bucket an ``allreduce_async`` negotiated by the
   core and run on NCCL by its device op; ``train_negotiated``): the
   same overlap check against both routes' ``allreduce_gradients`` bit
   for bit, 7 steps with finite, falling losses and 12 launches of each
   of K1-K3 a step; its step ms printed beside the direct route's.
5. bn_kernels: runs the BN statistics kernels K7 (sum x, sum x^2) and K8
   (sum dy, sum dy * x_hat) at ResNet-50 shapes (the stem, M = 256 * 112 *
   112, C = 64; a stage-3 layer, 50176 x 1024; the last stage, 12544 x
   2048; and an odd 1000003 x 72 with f32 dy over bf16 x) on bf16 inputs,
   and holds each output row to ||kernel - plain||_2 / ||plain||_2 <= 1e-4
   against the f32 plain version; at the stem also K7 over 8 ghost groups
   (batches of 32) and K8 over them under the ReLU mask, in both arithmetic
   modes. At every K7 case, K7 with the forward's terms
   (``batch_norm_stats_terms``: mean, var, rstd, a, b) must equal the
   torch ops of ``batch_norm_stats_terms_ref`` applied to K7's own sums
   bit for bit (``torch.equal``). Every K7, K7-with-terms and K8 case runs
   again, from a CUDA graph's replays and once more after them, and must
   give its first outputs bit for bit (each call leaves its scratch's
   counters at 0). The normalize pass (``bn_apply``) and the dx pass
   (``bn_dx``), in both modes (f32 "pallas", bf16 "lean"), with and
   without the ReLU, at every shape and with 8 ghost groups where they
   divide M (at the odd shape also with the mean and var cotangents),
   must equal their plain versions bit for bit (``torch.equal``). Times
   kernel, plain version and PyTorch's own ``torch.batch_norm_stats``
   (beside K7 and K7 with terms: it returns mean and invstd),
   ``torch.batch_norm_backward_reduce``, ``torch.batch_norm_elemt`` and
   ``torch.batch_norm_backward_elemt`` (yardsticks the port never calls)
   at the stem, each back to back (``ms``) and replayed from a CUDA graph
   (``device_ms``: at short launches the host sets the back-to-back pace,
   and between replays the inputs stay in L2). The same checks and times
   at five of InceptionV3's launches at batch 128: the stem (M = 128 * 149
   * 149, C = 32), a 1x1 of 80 channels (128 * 73 * 73), an E block's 448
   (128 * 8 * 8), 64 at 35 x 35 and 192 at 17 x 17. One call of each BN
   kernel (K7, K7 with terms, K8 and the passes) under torch.profiler must
   run its one kernel and nothing else on the device, and one
   ``fused_batch_norm_train`` forward K7's kernel and ``bn_apply``'s.
   Last, ``inception_step_ms``: K7 with terms, K8 and both passes and their
   library calls at all 18 (M, C) shapes of Inception's 94 BN launches,
   weighted by their layers, back to back and on the device.
6. resnet: ``hvd.init()``, ResNet-50 with ``norm="pallas"`` (bf16 over f32
   params) from a seeded generator, its block-final BN scales set nonzero
   from the seed, SGD(0.01, momentum 0.9) in ``DistributedOptimizer`` and
   ``make_train_step`` with ``classification_loss``; 2 warm-up and 5 timed
   steps on one batch of 256 224 x 224 images with labels. Before the
   steps, the same weights through the stock BN (``norm="batch"``): the
   first loss at batch 256 (relative gap <= 2e-2), and every parameter's
   gradient at batch 32 in float32 (worst ||g_pallas - g_stock||_2 /
   ||g_stock||_2 <= 5e-2).
   Checks finite and falling losses and 53 launches of each of K7, K8,
   ``bn_apply`` and ``bn_dx`` per step, none with the ReLU.
6b. resnet_lean: the same with ``ResNet50Lean`` (``norm="lean"``: the same
   kernels in bf16 arithmetic, the ReLU fused into the stem's norm and the
   first two of each block, 33 of 53), and one more gradient check in
   float32: ghost BN (``bn_virtual_batch_size=16``, 2 groups at batch 32)
   against the stock BN run on each group alone. 53 launches of each
   kernel per step, 33 of K8, ``bn_apply`` and ``bn_dx`` with the ReLU or
   mask. Then ``ResNet50Lean(bn_remat=True)`` on the same initial weights
   and batch: one gradient against ``bn_remat=False`` with cuDNN
   deterministic, every parameter's bit for bit, and the running
   statistics after it equal; 53 launches of K7 and 85 of ``bn_apply``
   (65 with the ReLU) in that forward and backward, the 32 norms inside
   the blocks that a convolution reads recomputed; then 2 warm-up and 5
   timed steps (the same launch counts a step, the first loss that of
   bn_remat=False), peak memory and step time printed beside
   bn_remat=False's.
7. ring_kernels: the ring-attention step kernels K4 (forward step with
   carried state), K5 (ring dQ) and K6 (ring dK/dV) through a whole 4-rank
   ring inside this process, every virtual rank with its own offsets and
   carried state, and each k/v shard's dK/dV accumulators carried across
   the ranks that see it: bf16, causal, B=2, H=12, D=64, global L=8192
   (shards of 2048), zigzag and contiguous; GQA H=4, G=2 with ragged
   shards of 160, contiguous, causal and not; and the sp phase's own
   launches, one rank holding the whole 8192 as the zigzag chunks at
   (0, 4096). Every launch is held against
   its plain version on the same inputs (o, l, and the increments of dQ,
   dK, dV: norm-relative <= 1e-2; m: <= 1e-3), and the assembled out, lse,
   dQ, dK, dV (natural order) against plain full attention and against
   K1-K3 over the whole sequence, with the same limits. Times one
   off-diagonal and one diagonal step of each kernel at [2, 12, 2048, 64],
   and PyTorch's scaled_dot_product_attention forward and backward on the
   same block (the nearest yardstick, not the same function: it carries
   no state); and each kernel at the sp phase's own launch, [2, 12, 8192,
   64] causal with zigzag chunks (0, 4096), beside SDPA's causal forward
   and backward at that shape. The sp launch, a 4-rank zigzag ring and the
   lc_sp phase's own launch at the lc model's widths (B=2, H=6, G=2,
   L=8192, D=128; one rank: chunks (0, 4096)) run again with rotary,
   assembled as ``parallel.ring`` runs it: each rank's q shard and home k
   shard rotated once by ``ring.rotate_shards``, K4-K6 without rotary on
   the copies, dQ and dK counter-rotated after the ring by
   ``ring._counter_rotate``, the whole-sequence references rotary. K4-K6
   called through their wrappers with rotary (the pass, then the kernel)
   are held against the rotary plain versions at the lc_sp launch, and
   timed there as K1_rot-K3_rot, beside the same launches without rotary.
8. sp: ``hvd.init()``, ``hybrid_mesh((1,), ("sp",))``, the GPT-2-small LM
   of the train phase with ``attention="ring"``, ``sp_axis="sp"``,
   ``sp_schedule="zigzag"``; a dict batch {tokens, positions, labels} of
   2 x 8192 tokens (labels shifted in natural order, then
   ``zigzag_shard``), ``shard_lm_loss``, Adam(1e-4) in
   ``DistributedOptimizer`` and ``make_train_step``; 2 warm-up and 5 timed
   steps. Before the steps, the same weights through ``attention="flash"``:
   the first loss (relative gap <= 2e-2) and every parameter's gradient at
   1 x 8192 (worst gap <= 5e-2). Checks finite and falling losses, 12
   launches each of K4, K5 and K6 per step and none of K1-K3.
9. lc: the long-context GQA LM (``bench.py --seq-len 8192 --fused-xent
   --tokens-batch 2 --num-heads 6 --num-kv-heads 2 --fused-rope``: vocab
   32000, 12 layers, 6 query heads of 128 on 2 kv heads, embed 768, MLP
   3072, ``rope_fused=True``, bf16 over f32), ``lm_loss_streaming``,
   Adam(1e-4), 2 x 8192 tokens; every parameter's gradient at 2 x 2048
   and the first loss at 2 x 8192 against the same weights through dense
   attention with rotary outside, and every parameter's gradient at 2 x
   8192 against the same weights with ``rope_fused=False`` (rotary outside,
   K1-K3): worst gap <= 5e-2 each; 2 warm-up and 5 timed steps, a profile
   of 3 more (device busy and idle); then the same step on the same
   weights with ``rope_fused=False``, timed and profiled the same way.
   Checks finite, falling losses and 12 launches of each of K1_rot-K3_rot
   and 24 of the rotary pass a step, all 24 in the loss's forward and none
   in its backward (K1-K3 and no pass in the unfused run).
10. lc_sp: the lc model with ``attention="ring"`` (zigzag, one-rank "sp"
   axis, ``shard_lm_loss``): 24 launches of the rotary pass a step, all in
   the forward, and 12 each of K4, K5 and K6 (on the rotated q and k), the
   first loss and gradients at 1 x 8192 against the lc flash model.

11. wire_kernels: the wire codec kernels (``ops/csrc/wire_codec.cu``:
   ``wire_encode``, ``wire_decode_add``) in bf16 and int8 against their
   plain versions, equal (NaN where NaN), at one ring chunk of the LM's flat
   f32 gradient over 4 ranks (33,526,528 elements), at 4 blocks and on
   blocks holding NaN, +inf and -inf, zeros, ties (k + 0.5 at scale 1) and
   a huge value; the
   decode-add also into an empty destination. Times at the LM chunk beside
   the bounds and, for bf16, ``x.to(torch.bfloat16)`` and ``acc.add_(p)``
   (int8 has no PyTorch call). Then ``parallel.ring``'s three schedules
   (allreduce, reduce-scatter, allgather) over 4 virtual ranks in this
   process on the LM's flat gradient (134,105,856 f32 a rank), in bf16,
   int8 and none, through the kernels and through the plain versions:
   equal; the allreduce and the reduce-scatter within 2e-2 (bf16), 4e-2
   (int8), 1e-5 (none) of the f32 sum, of max |sum|; every rank's
   allreduce and allgather identical; the launches of each schedule as
   counted (per rank: allreduce n encodes and 2n - 1 decodes,
   reduce-scatter n - 1 of each, allgather 1 and n).
12. zero1: the LM of the train phase (same weights, batch, Adam 1e-4): 3
   replicated steps as the reference; ``make_train_step(zero1=True,
   compression="int8")`` on the one-rank NCCL group, 7 steps, and
   ``make_fsdp_train_step``, 5 steps, from the same weights: every
   parameter after 3 steps within 1e-6 (norm-relative) of the replicated
   step's, losses finite and falling, 12 launches of K1-K3 a step and no
   codec launch (one rank: the ring applies no codec); step time,
   optimizer-state bytes and peak memory of each.

13. moe: the Switch-MoE LM of bench.py's MoE row (``--moe-experts 8
   --fused-xent``: MODEL's widths, a ``MoeMlp`` of 8 experts in every
   second block, top-1, capacity factor 1.25; flash attention,
   ``lm_loss_streaming``, Adam(1e-4) in ``DistributedOptimizer``, 8 x 2048
   tokens). Before the steps: the first MoE layer's output on its real
   input against a per-token computation without one-hot contractions
   (top-1 expert and gate from the router, queue positions by a stable
   sort, tokens past the capacity dropped, gate * FFN_e(x) in f32 from the
   same bf16 inputs): the same drop set (y's zero rows), the same routing
   and slots in ``topk_dispatch``'s dispatch, the kept tokens within 2e-2
   (norm-relative), the dropped share printed; the same weights with
   ``ep_axis="ep"`` on ``hybrid_mesh((1,), ("ep",))`` (NCCL's
   all-to-all) against the model without it: the first loss and every
   gradient equal bit for bit; the same weights through dense attention:
   the first loss at 8 x 2048 within 2e-2, every gradient at 2 x 2048 in
   bf16 and float32, each with the share of tokens whose top-1 expert
   differs between flash and dense, and again with the dense run routed
   to the flash run's experts; the float32 gap on the same routing is held
   to 5e-2 (a near-tie broken apart by the two attentions' roundings moves
   a token to another expert and its gradients with it: the other three
   are logged). Then 2 warm-up and 5 timed steps: finite, falling losses,
   12 launches each of K1-K3 a step; step ms, tokens/s, peak memory, and
   one MoE layer's parts timed forward and backward (the routing with the
   [T, E, C] one-hot construction, the dispatch contraction, the experts'
   products, the combine contraction).
14. ulysses: the lc model with ``attention="ulysses"`` on a one-rank "sp"
   axis (its all-to-alls run: NCCL copies): the first loss and every
   gradient at 2 x 8192 equal to the lc flash model's on the same weights
   bit for bit; 24 launches of the rotary pass in one loss's forward and
   none in its backward; 2 warm-up and 3 timed steps of the flash model,
   then of the Ulysses model (12 launches each of K1_rot-K3_rot and 24 of
   the pass a step); step ms and peak memory of both.
15. inception: bench.py's inception3pbn row, ``InceptionV3(norm="pallas")``
   (94 ConvBN blocks on K7, K8 and the two BN passes) at 128 x 299 x 299,
   SGD 0.01 momentum 0.9, dropout on: every block's kernel, scale and bias
   gradients at batch 32 in float32 against the stock BN's on the same
   weights, given the block's input and output cotangent in the stock
   model's loss (<= 5e-2; the whole model's gaps are logged: chained
   through 94 BN layers at initialisation two sound paths stand 0.06
   apart), the first loss at 128 against it (2e-2 relative); 2 warm-up
   and 5 timed steps with finite, falling losses and 94 launches of each
   BN kernel a step; step ms, images/s, peak memory.
16. resnet_nf: ``ResNet50NF`` at batch 256 through
   ``make_train_step(agc=0.01)`` (the share of AGC units clipped in the
   first step printed), then ``ResNet50GN`` (GroupNorm) without AGC: 7
   steps each, finite and falling losses, step ms and peak memory beside
   the resnet phase's ResNet-50.
17. vgg16: ``VGG16`` at batch 64 x 224, SGD, dropout on: 7 steps, finite
   and falling losses, step ms, peak memory.
18. word2vec: ``SkipGram`` at bench.py's word2vec row (V 50000, D 256, B
   4096, K 512, lr 0.5, Zipf ids) on a one-rank NCCL group: 10 steps on the
   sparse plane (``allreduce_sparse``, ``apply_sparse_``) and 10 on the
   dense one from the same tables; the tables then within 1e-5
   (norm-relative) of each other, and the sparse path's peak memory above
   the tables under one [V, D] table; ms a step of each. Then
   ``MnistCNN`` (5 SGD steps at batch 64) and a ``checkpoint`` save and
   restore of ResNet50NF's state and its optimizer's, equal bit for bit.
18b. core: the port's negotiation core (``horovod_tpu_torch/native/``,
   ROADMAP A8c1) built with g++ on this machine's host (the seconds
   printed; the library must answer as the build its name hashes, and
   its CRC32C the check vector), then ``python -m horovod_tpu_torch.run
   -np 2`` of ``tests/torch_port_core_worker.py smoke`` on CPU ranks (one
   H100 holds one NCCL rank): each rank's asynchronous allreduce (float32
   within 1e-5 of numpy's sum, int64 and bfloat16 equal), allgather of
   uneven rows, broadcast and reduce-scatter against numpy, 24
   collectives enqueued and synchronized in rank-shuffled orders, and 16
   allreduces enqueued together fused into fewer responses than tensors.
   Then CUDA tensors through the core's device op (ROADMAP A8c2), in this
   process on a one-rank NCCL group (``core_cuda_checks``): every
   ``*_async`` in float32, bfloat16 and int64 with pre- and postscale and
   ``out=`` aliasing the input, each equal (``torch.equal``) to what one
   rank implies; an allgather of a [5, 3] tensor; a ``group=`` of the one
   rank (its core id its id); 16 small allreduces enqueued together, in
   fewer responses than tensors; an input a long kernel writes on a side
   stream, ``poll`` False before ``synchronize`` and the result read on a
   third stream; a host name reused on the GPU (the response cache keys
   on the device). Over all of them the core's CPU ops and its TCP data
   plane move nothing (its ring byte and host-op counters). Deterministic
   checks only; prints ``{"core": ...}`` with the CUDA checks' seconds.
19. launch: the train phase's LM (MODEL, BATCH, seeds 0 and 1, Adam 1e-4
   in the overlapped DistributedOptimizer) started by the port's launcher
   and trained in ``@elastic.run`` with a ``TorchState`` committed every
   step (``tests/torch_port_launch_worker.py``). First the durable
   checkpoints' crc32c library (built with g++ in the checkout) against
   its plain version ``_py_crc32c`` on 4 MiB of seeded bytes, equal, and
   its rate on 256 MiB. (a) ``python -m horovod_tpu_torch.run -np 1 -H
   localhost:1 ... --steps 6``: the worker asserts that the launcher
   started it and that ``init()`` read no MASTER_ADDR, and counts 12
   launches of K1, K2 and K3 each a step; it saves its final parameters
   and Adam moments. (b) The same run again: whether two uninterrupted
   runs agree bit for bit, and the gap if not. (c) The launcher with
   ``--min-np 1 --max-np 1 --ckpt-dir D --restart-from-ckpt``: durable
   every commit; after step 3's manifest is published the worker kills
   itself with SIGKILL, the elastic driver restarts the job once, and the
   new worker resumes at step 3 from the CRC-checked shards and runs to
   step 6; its final state must equal run a's (``torch.equal`` if a and b
   agreed, else within a-b's gap). Prints the restarts, the resumed step,
   the checkpoint's bytes, the write time (the median shard's split into
   staging on the host, pickling, CRC, writing and fsync), the crc32c
   rate, the median commit time beside the median step time, every step's
   time and host enqueue time (medians over the warm steps: not a
   process's first, nor the profiled one), step 5 of runs a and c under
   torch.profiler
   (the kernels' device time beside the wall time: in c the writer is
   busy), and each run's peak device memory. Any non-zero exit, a worker
   off the GPU, a launch count other than 12 a step or a restart count
   other than 1 fails the phase. The K1-K3 launches of runs a and c add
   to the kernels line's counts.
20. serve: the serve plane (``horovod_tpu_torch.serve``) at ``bench.py
   --serve``'s two configurations (``bench.py:608-780``). (a) In this
   process on cuda:0: ``make_forward`` for the affine model at dim 16 and
   the mlp at dim 2048 (hidden 8192) in every bucket up to the replica's
   max batch of 16, each against the numpy ``forward`` (largest absolute
   error <= 1e-4), timed with CUDA events as the replica calls it (frame
   to the device, the products, the result back) and its products alone,
   beside their bound; the peak device memory. (b) The curve: ``python -m
   horovod_tpu_torch.serve -np 2 --model affine --dim 16`` over a lineage
   at step 10, every replica's ``/healthz`` device on the GPU, open-loop
   load at 20, 40 and 80 rps for 3 s each: zero errors, zero mismatches,
   every request answered once, and at least 0.9 of the offered rate
   achieved; then SIGTERM drains the pool and the supervisor exits
   ``EXIT_DRAINED``. The load comes from 4 processes of 128 senders each
   on one shared schedule (request k at k / rate), so a slow answer
   delays no later send; latency counts from the scheduled time. The
   answers are checked after each window, in one numpy forward for each
   weight set they name, row by row as ``check_response`` does (atol
   1e-3). The load encodes a request's body before its time and parses
   the answers after the window, so that its own JSON is off the clock.
   (c) The step: the port's ``ServeSupervisor`` with 2 replicas of the
   mlp at dim 2048, three windows at 280 rps. Swap (5 s): step 20 is
   published 1 s in, both replicas swap to it within the window, answers
   by both weight sets, the same limits as (b). Kill (4 s): one replica
   is SIGKILLed 1 s in; every answer by step 20's weights, none failed,
   none lost, no hang; the survivor alone is past its capacity until the
   respawn serves, so here 0.9 of the offered rate must be sent on
   schedule, not answered. Respawned (3 s): once the driver's new replica
   serves step 20 on the GPU, the pool answers 280 rps again by step
   20's weights alone, each replica some, the limits of (b). Then the
   pool drains to ``EXIT_DRAINED``. Prints each window's offered, sent
   and achieved rps, p50 and p99, the forward's times, each replica's
   device and the peak memory of (a). For each replica's swap, the
   seconds of its stages (scan, stagger, read and CRC of the shards with
   the unpickling, extract, fingerprint, upload, warm-up, flip; the
   ``swap_profile`` of its ``/serve``) and the batch loop's longest gap
   between two batches from the swap's start to a second after its flip,
   printed before the window is checked, not limited. The serve path
   runs no
   hand-written kernel (the products are cuBLAS's through
   ``torch.matmul``).
21. fleet: the fleet controller (``python -m horovod_tpu_torch.fleet.cli
   --port 0``) on a pool of one slot, the card. Job ``train0`` (priority
   0, durable every commit) is the launch phase's LM worker for 6 steps,
   which prints the fleet's lineage lines (the CRC32C of the parameters,
   Adam's moments and the steps at every start, commit and end) and holds
   after step 2's commit until a drain request reaches it. Job ``serve0``
   (kind serve, priority 10) is one replica of the serve phase's mlp at
   2048 over a lineage at step 10, serving for 12 s
   (``HVD_TPU_SERVE_EXIT_AFTER``); it arrives 25 s after the controller
   starts, so the controller preempts train0 by graceful drain, which
   lands at a commit strictly inside the run. While serve0 holds the
   slot: its replica answers 300 requests at 100 rps, each checked as
   the serve phase's windows are and by step 10's weights, on the GPU;
   ``nvidia-smi --query-compute-apps=pid`` lists no process of train0,
   train0's drained process is gone and the device memory in use above
   the phase's start is under train0's peak; the durable lineage's last
   step is the drained step, the highest committed; ``/fleet`` shows each job's
   kind, placement and state; ``python -m horovod_tpu_torch.run.top
   --fleet --once`` renders both jobs. When serve0 retires (exit 0),
   train0 is restored from its lineage and finishes. The controller's
   log must name the preemption and the restore and end with all 2 jobs
   completed, rc 0; the drained worker exits ``EXIT_DRAINED`` unescalated
   and the restored one starts at the drained step from a state it
   committed (its start CRC among that step's commit CRCs); every step of
   both processes launches K1-K3 12 times each; train0's final parameters
   and Adam moments equal bit for bit those of an uninterrupted run of
   the same worker for the same steps (the launch phase's run a when it
   ran, else one run here); the lingering controller's ``/metrics``
   counts 1 preemption, 1 restore and 2 completions and has observed the
   drain and restore latencies. Prints ``{"fleet": {...}}``: the drained
   step, the drain and restore seconds, the serve window's answers and
   p50, train0's warm step before and after the restore, the phase's
   seconds and the card. Its K1-K3 launches add to the kernels line's
   counts.

Before the last line it prints one ``{"kernels": [...]}`` JSON line; the
last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# Limits against the f32 plain versions on the same bf16 inputs, set
# between the readings of the sound kernels on an H100 and of kernels with a
# planted fault (K1 or K2 skipping one key tile, or K3 one q tile, for the
# rows from 1024 on): O, dQ, dK, dV read 2.0e-3 to 2.5e-3 sound and 5.1e-2
# to 9.2e-2 planted; lse 1.9e-6 and 0.23; the worst parameter's gradient
# gap 0.0196 and 0.099 to 0.258.
REL_TOL = 1e-2             # ||kernel - plain||_2 / ||plain||_2
LSE_TOL = 1e-3             # max |lse - plain lse|, natural-log units
GRAD_TOL = 5e-2            # worst parameter's gradient gap, flash vs dense

# The BN kernels against their f32 plain versions: the same f32 values
# summed in another order (each output row, norm-relative).
BN_TOL = 1e-4
# the eps of K7's terms in the bn_kernels phase (the ResNet's)
BN_EPS = 1e-5
# the name under which a row holds K7 with terms (its keys "terms_...")
BN_TERMS = "batch_norm_stats_terms"
# The ResNet: the first loss and the worst parameter's gradient gap
# (norm-relative) between norm="pallas" and the stock BN on the same weights.
RESNET_LOSS_TOL = 2e-2
RESNET_GRAD_TOL = 5e-2

# The api phase: an odd count for the collectives (reduce_scatter's shard
# is the whole at one rank), stage 2's widest BN activation for the
# statistics (256 x 28 x 28 rows), and a stem-like activation for the
# stock sync BN. The statistics from partial sums (E[x^2] - E[x]^2 in f32)
# stand apart from torch.var_mean's by f32 rounding of 2e5-term sums; the
# sync BN's statistics and gradients from cuDNN's the same way.
API_COUNT = 1_000_003
API_BN_ROWS = 256 * 28 * 28
API_BN_SHAPE = (32, 64, 56, 56)
API_STATS_TOL = 1e-4
API_SYNC_BN_TOL = 1e-4
SLICE = dict(B=8, H=12, G=12, L=2048, D=64, causal=True)
ODD = dict(B=1, H=4, G=2, L=160, D=64, causal=False)
# Fused rotary (the kernels' rotary instantiations, K1_rot-K6_rot): the base
# of bench.py's TransformerConfig (rope_base), K1-K3 at the lc phase's
# launch and at an odd shape (a ragged L, GQA 3, full attention).
ROPE_BASE = 10000.0
ROT_SLICE = dict(B=2, H=6, G=2, L=8192, D=128, causal=True)
ROT_ODD = dict(B=1, H=6, G=2, L=333, D=128, causal=False)
# bench.py --model transformer: GPT-2-small widths and depth, 8 x 2048
MODEL = dict(vocab_size=32000, num_layers=12, num_heads=12, embed_dim=768,
             mlp_dim=3072)
BATCH = (8, 2048)
# bench.py --model resnet50pbn --batch-size 256, 224 x 224 images
RESNET_BATCH, IMAGE, RESNET_GRAD_BATCH = 256, 224, 32
RESNET_BN_LAYERS = 53  # bn_init + 3 per block (16) + 4 projections
# ResNet50Lean's norms with the ReLU fused: bn_init + the first 2 of each
# block; the ghost-BN gradient check's virtual batch (2 groups of 16)
RESNET_RELU_LAYERS = 33
RESNET_GHOST_BATCH = 16
# bn_remat recomputes the output of each norm inside a block that a
# convolution reads: the first two of each of the 16 blocks, all with the
# ReLU fused
RESNET_REMAT_LAYERS = 32
# the ghost groups of the bn_kernels phase's grouped checks: ghost batches of
# 32 at the stem (the batch of 256 in 8 groups)
BN_GROUPS = 8
# name -> (M, C, dy dtype): M = batch * H * W rows of C channels
BN_SHAPES = {
    "stem": (256 * 112 * 112, 64, "bfloat16"),
    "stage3": (256 * 14 * 14, 1024, "bfloat16"),
    "last": (256 * 7 * 7, 2048, "bfloat16"),
    "odd": (1_000_003, 72, "float32"),
}

# The long-context GQA LM, bench.py --model transformer --seq-len 8192
# --fused-xent --tokens-batch 2 --num-heads 6 --num-kv-heads 2 --fused-rope
# (bench.py:2513-2560): 12 layers, 6 query heads of 128 on 2 kv heads, the
# streaming loss, fused rotary; 2 x 8192 tokens a step, the gradient check
# against dense attention at 2 x 2048.
LC_MODEL = dict(vocab_size=32000, num_layers=12, num_heads=6, num_kv_heads=2,
                embed_dim=768, mlp_dim=3072)
LC_BATCH, LC_GRAD_LEN = (2, 8192), 2048

# wrapper name -> (source, TPU kernel it replaces, products per (q,k) pair);
# "<name>_rot" counts the wrapper's calls under rotary (its own counter)
KERNELS = {
    "flash_fwd": ("horovod_tpu_torch/ops/csrc/flash_fwd.cu",
                  "horovod_tpu/ops/flash_attention.py:170", 2),
    "flash_bwd_dq": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                     "horovod_tpu/ops/flash_attention.py:841", 3),
    "flash_bwd_dkv": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                      "horovod_tpu/ops/flash_attention.py:895", 4),
    # f32 operations per (row, channel): K7 s += x, ss += x * x; K8
    # s += dy, s2 += dy * ((x - mean) * rstd)
    "batch_norm_stats": ("horovod_tpu_torch/ops/csrc/batch_norm.cu",
                         "horovod_tpu/ops/batch_norm.py:100", 3),
    "batch_norm_grad_stats": ("horovod_tpu_torch/ops/csrc/batch_norm.cu",
                              "horovod_tpu/ops/batch_norm.py:133", 5),
    # the passes the JAX package leaves to XLA (port-only kernels): the
    # normalize of _bn_train_fwd (and _lean_fwd :363), y = x * a + b; the dx
    # of _bn_train_bwd (and _lean_bwd :399), x - mean, * rstd, dy - c1,
    # x_hat * c2, the difference, * k
    "bn_apply": ("horovod_tpu_torch/ops/csrc/batch_norm.cu",
                 "horovod_tpu/ops/batch_norm.py:211", 2),
    "bn_dx": ("horovod_tpu_torch/ops/csrc/batch_norm.cu",
              "horovod_tpu/ops/batch_norm.py:237", 6),
    "flash_ring_step": ("horovod_tpu_torch/ops/csrc/flash_fwd.cu",
                        "horovod_tpu/ops/flash_attention.py:431", 2),
    "flash_ring_bwd_dq": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                          "horovod_tpu/ops/flash_attention.py:620", 3),
    "flash_ring_bwd_dkv": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                           "horovod_tpu/ops/flash_attention.py:673", 4),
    # the rotary branches of the same TPU kernels (K1_rot and K4_rot: the
    # rotary pass, then K1 or K4 on the copies, RUNS)
    "flash_fwd_rot": ("horovod_tpu_torch/ops/csrc/flash_fwd.cu",
                      "horovod_tpu/ops/flash_attention.py:201", 2),
    "flash_bwd_dq_rot": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                         "horovod_tpu/ops/flash_attention.py:869", 3),
    "flash_bwd_dkv_rot": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                          "horovod_tpu/ops/flash_attention.py:928", 4),
    "flash_ring_step_rot": ("horovod_tpu_torch/ops/csrc/flash_fwd.cu",
                            "horovod_tpu/ops/flash_attention.py:470", 2),
    # the rotation those branches apply to q and k (_rot_apply), done once
    # a layer in the forward: K1, or the ring's K4 steps, read its output,
    # and autograd keeps it for K2_rot and K3_rot, or the ring's K5 and K6;
    # f32 operations an element: two products and a sum
    "rope_rotate": ("horovod_tpu_torch/ops/csrc/rope.cu",
                    "horovod_tpu/ops/flash_attention.py:93", 3),
    # the wire codec of the ring collectives (port-only kernels: on the TPU
    # XLA fuses the encode and the decode-add into each hop of the ring's
    # fori_loop, _ring_codec); f32 operations an element: int8 encode
    # abs, max, product, rint, clip (2); decode-add product and sum
    "wire_encode": ("horovod_tpu_torch/ops/csrc/wire_codec.cu",
                    "none: XLA-fused per ring hop (horovod_tpu/parallel/"
                    "ring.py:533 _ring_codec, compression/__init__.py:228)",
                    6),
    "wire_decode_add": ("horovod_tpu_torch/ops/csrc/wire_codec.cu",
                        "none: XLA-fused per ring hop (horovod_tpu/parallel/"
                        "ring.py:506 rs_body, compression/__init__.py:247)",
                        2),
}
# what the rotary forward wrappers launch: the pass over q and k, then the
# kernel without rotary on the copies (on the lc_sp path the ring rotates
# once a layer and its steps count as flash_ring_step)
RUNS = {"flash_fwd_rot": "pass + K1", "flash_ring_step_rot": "pass + K4"}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BN = ("batch_norm_stats", "batch_norm_grad_stats", "bn_apply", "bn_dx")
# the launches of K8 and the passes with the ReLU (mask), counted apart too
BN_RELU = ("batch_norm_grad_stats_relu", "bn_apply_relu", "bn_dx_relu")
RING = ("flash_ring_step", "flash_ring_bwd_dq", "flash_ring_bwd_dkv")
FLASH_ROT = tuple(n + "_rot" for n in FLASH)
RING_ROT = tuple(n + "_rot" for n in RING)
ROPE = "rope_rotate"
# The rotary pass against its plain version, bit for bit: (label, [B,
# heads, L, D], shard offsets). The lc launch's q and k at 0..8191 (one
# rank's zigzag chunks (0, 4096) are the same positions); rank 1's
# zigzag shard of the 4-rank ring at the lc widths; a ragged L in one
# chunk past 0, and in two zigzag chunks.
ROPE_CHECKS = (("lc_q", (2, 6, 8192, 128), (0,)),
               ("lc_k", (2, 2, 8192, 128), (0,)),
               ("lc_ring_q", (2, 6, 2048, 128), (1024, 6144)),
               ("lc_ring_k", (2, 2, 2048, 128), (1024, 6144)),
               ("odd", (1, 6, 333, 128), (5000,)),
               ("odd_zigzag", (1, 6, 334, 128), (167, 501)))
# The ring: n virtual ranks over a global sequence of L (shards of L / n).
RING_SHAPE = dict(B=2, H=12, G=12, L=8192, D=64, n=4)
# The sp phase's own launches: one rank, its zigzag shard the whole sequence
# as two chunks at offsets (0, 4096).
RING_SP = dict(RING_SHAPE, n=1)
RING_ODD = dict(B=1, H=4, G=2, L=640, D=64, n=4)
# The lc_sp phase's own launches (LC_MODEL's widths at one rank, zigzag
# chunks (0, 4096)), and a 4-rank ring at the same widths.
LC_SP = dict(B=2, H=6, G=2, L=8192, D=128, n=1)
LC_RING = dict(LC_SP, n=4)
# (label, shape, schedule, causal, rotary base) of the ring_kernels phase
RING_RUNS = (("main", RING_SHAPE, "zigzag", True, None),
             ("main", RING_SHAPE, "contiguous", True, None),
             ("odd", RING_ODD, "contiguous", True, None),
             ("odd", RING_ODD, "contiguous", False, None),
             ("sp", RING_SP, "zigzag", True, None),
             ("rot_sp", RING_SP, "zigzag", True, ROPE_BASE),
             ("rot_lc", LC_RING, "zigzag", True, ROPE_BASE),
             ("rot_lc_sp", LC_SP, "zigzag", True, ROPE_BASE))
# The sequence-parallel LM: 2 sequences of 8192 tokens a step; the gradient
# check against the flash model on the first of them.
SP_BATCH, SP_GRAD_BATCH = (2, 8192), 1
WIRE = ("wire_encode", "wire_decode_add")
# The wire codec at the LM's flat f32 gradient (134,105,856 parameters, all
# f32, MODEL's) over 4 ring ranks: one rank's chunk, chunk_length(P, 4);
# the small shape (4 blocks) and a block each of NaN, +inf and zeros.
LM_PARAMS = 134_105_856
WIRE_RANKS = 4
WIRE_SMALL = 1024
# the ring's sum against the f32 sum, of max |sum|
# (tests/test_compression.py:138); none adds the same f32 values in the
# ring's order
WIRE_SUM_TOL = {"none": 1e-5, "bf16": 2e-2, "int8": 4e-2}
# the decode-add's library call against its plain version, of max |result|:
# one f32 rounding apart where the call fuses the multiply and the add
WIRE_LIBRARY_TOL = 1e-6
# elements of an int8 block, one f32 scale each
WIRE_BLOCK = 256
# bench.py's MoE row (bench.py:305, built at :2508-2521): --moe-experts 8
# on the LM (every second block, top-1, capacity factor 1.25), with
# --fused-xent; the gradient check against dense attention at 2 x 2048
MOE = dict(moe_experts=8, moe_every=2, moe_capacity_factor=1.25,
           moe_top_k=1)
MOE_GRAD_BATCH = 2
# one MoE layer's kept tokens against the per-token computation in f32 from
# the same bf16 inputs, norm-relative: the module rounds the expert
# products and the gate-weighted combine to bf16. Between the sound
# reading on an H100 (3.87e-3) and a combine that drops its gate (5.6 at a
# small size on the CPU; slots shifted by one change the drop set)
MOE_TOKEN_TOL = 2e-2
# the zero1 and FSDP steps against the replicated one from the same
# weights, norm-relative per parameter, after ZERO1_CHECK_STEP steps
ZERO1_TOL = 1e-6
ZERO1_CHECK_STEP = 3
# bench.py's inception3pbn row (bench.py:302-303, built at :2577-2636):
# InceptionV3(norm="pallas") at 128 x 299 x 299, 94 BN layers; the
# gradient check at batch 32 (the resnet phase's limits)
INCEPTION_BATCH, INCEPTION_IMAGE, INCEPTION_GRAD_BATCH = 128, 299, 32
INCEPTION_BN_LAYERS = 94
# Inception's BN launches for the bn_kernels phase, name -> (M, C, dy
# dtype, (H, W)) at batch 128: the stem's first (149 x 149 x 32), the 1x1
# of 80 channels at 73 x 73, an E block's 448 at 8 x 8, and the commonest
# widths of the 35 x 35 and 17 x 17 blocks (64 and 192)
INCEPTION_BN_SHAPES = {
    "inc_stem": (128 * 149 * 149, 32, "bfloat16", (149, 149)),
    "inc_c80": (128 * 73 * 73, 80, "bfloat16", (73, 73)),
    "inc_c448": (128 * 8 * 8, 448, "bfloat16", (8, 8)),
    "inc_c64_35": (128 * 35 * 35, 64, "bfloat16", (35, 35)),
    "inc_c192_17": (128 * 17 * 17, 192, "bfloat16", (17, 17)),
}
# All 94 of Inception's BN launches at batch 128, (H * W, C) -> layers
# (forward hooks on the port's InceptionV3 at 299; a CPU test recounts
# them): the passes' launch-weighted cost a step, inception_step_ms
INCEPTION_BN_LAUNCHES = {
    (149 * 149, 32): 1, (147 * 147, 32): 1, (147 * 147, 64): 1,
    (73 * 73, 80): 1, (71 * 71, 192): 1,
    (35 * 35, 32): 1, (35 * 35, 48): 3, (35 * 35, 64): 12, (35 * 35, 96): 7,
    (17 * 17, 96): 1, (17 * 17, 128): 6, (17 * 17, 160): 12,
    (17 * 17, 192): 26, (17 * 17, 384): 1,
    (8 * 8, 192): 3, (8 * 8, 320): 3, (8 * 8, 384): 12, (8 * 8, 448): 2,
}
# bench.py's resnet50nf row trains with AGC 0.01 (bench.py:2620-2636);
# its vgg16 row at batch 64
AGC_CLIPPING = 0.01
VGG_BATCH = 64
# bench.py's word2vec row (bench.py:2200-2262; --vocab-size 50000), 10
# steps of each plane from the same tables; examples/jax_mnist.py's batch
W2V_ROW = dict(V=50000, D=256, B=4096, K=512, lr=0.5, steps=10)
W2V_TABLE_TOL = 1e-5
MNIST_BATCH, MNIST_STEPS = 64, 5
# each phase's printed result, by phase
RESULTS = {}


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def fail(msg):
    log("chip_smoke: FAIL: " + msg)
    sys.exit(1)


def time_ms(fn, n=20, reps=5, warmup=3):
    """Milliseconds per call of ``fn()``: ``reps`` times, ``n`` calls back
    to back between two CUDA events (so the host's dispatch overlaps the
    device's work), after ``warmup`` calls; the median of the reps."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


_GRAPH_STREAM = []


def graph_ms(fn, n=20, reps=5, warmup=3):
    """Milliseconds per call of ``fn()`` on the device: ``n`` calls
    captured once in a CUDA graph and replayed ``reps`` times between two
    CUDA events, the median. The replay launches the captured kernels
    without the host, so at short launches this reads the device's time
    where ``time_ms`` (the host dispatching each call) reads the host's.
    Between the replayed calls the inputs stay in the card's 50 MB L2 where
    they fit: a short launch's reading may beat its HBM bound. The warm-up
    and the capture run on one side stream, made once: the BN statistics
    keep their scratch for each stream and make it outside a capture."""
    import torch
    if not _GRAPH_STREAM:
        _GRAPH_STREAM.append(torch.cuda.Stream())
    side = _GRAPH_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke test runs "
             "only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail("nvidia-smi failed: " + smi.stderr.strip())
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log("torch %s, CUDA %s, %s x%d" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    return card


# seconds of the negotiation core's g++ build in phase_build
CORE_BUILD = {}


def phase_build():
    """nvcc for the kernels and, beside it, g++ for the negotiation core
    (the core and train phases load it). The core is built here, before
    the first profiler session: built in the train phase, after the
    kernels phase's traces, its g++ processes were followed by
    bn_kernels' traces losing device records (twice in the first smoke on
    a fresh machine; never in a process that had not traced yet)."""
    import threading
    from horovod_tpu_torch.common import core
    from horovod_tpu_torch.ops import _build
    core_thread = threading.Thread(
        target=lambda: CORE_BUILD.update(seconds=core.build()))
    core_thread.start()
    seconds = _build.build()
    core_thread.join()
    if "seconds" not in CORE_BUILD:
        fail("the negotiation core did not build (see the traceback above)")
    print("build: %.1f s (%s); the core %.1f s" % (seconds, ", ".join(
        "%s.cu" % s for s in _build.SOURCES), CORE_BUILD["seconds"]),
        flush=True)
    for src in _build.SOURCES:
        log_file = _build.library_path(src).with_suffix(".log")
        if not log_file.exists():
            continue
        kernel, spills = "?", ""
        for line in log_file.read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]  # mangled: name, dtype, D
            elif "spill stores" in line:
                spills = line.strip()
            elif "Performance Loss" in line or "is injected" in line:
                log("ptxas " + line.split(":", 1)[1].strip())
            elif "registers" in line:
                log("ptxas %s: %s; %s" % (kernel, line.split(":", 1)[1]
                                           .strip(), spills))


def _inputs(shape, seed):
    """q, dout [B, H, L, D] and k, v [B, G, L, D] in bf16, laid out as the
    model's [B, L, heads, D] activations (transposed views)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, G, L, D = (shape[k] for k in "BHGLD")

    def rnd(heads):
        return torch.randn(B, L, heads, D, generator=g, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16
                                                   ).transpose(1, 2)
    return rnd(H), rnd(G), rnd(G), rnd(H)


def _err(kernel_out, plain_out):
    """(max |kernel - plain|, ||kernel - plain||_2 / ||plain||_2)."""
    d = kernel_out.float() - plain_out.float()
    norm = plain_out.float().norm().item()
    return d.abs().max().item(), d.norm().item() / max(norm, 1e-30)


def _bound_ms(shape, products, n_bytes):
    B, H, L, D = (shape[k] for k in "BHLD")
    pairs = L * (L + 1) / 2 if shape["causal"] else L * L
    flops = products * 2.0 * B * H * pairs * D
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernels(shape, seed, timed, rotary=None):
    """Runs K1-K3 at ``shape`` against their plain versions; returns
    {name: row} with errors and, when ``timed``, times. K2 and K3 run on
    the plain version's lse and delta, and again chained on K1's own lse
    and O (delta from K1's O), as the model's backward runs them. With
    ``rotary`` (a base) the rotary instantiations run (rows ``<name>_rot``)
    against the rotary plain versions on the same bf16 inputs, which round
    the rotated q and k to bf16 as the kernels do; their times stand beside
    the kernels' without rotary and SDPA's (GQA) on q and k rotated
    beforehand, the rotation's own time apart."""
    import torch
    import horovod_tpu_torch.ops.flash_attention  # noqa: F401
    fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]
    q, k, v, dout = _inputs(shape, seed)
    causal = shape["causal"]
    scale = shape["D"] ** -0.5
    rb = rotary
    # the plain versions' inputs: f32 copies, or (rotary) the bf16 tensors
    ref_in = ([q, k, v, dout] if rb is not None else
              [t.float() for t in (q, k, v, dout)])
    out_ref, lse = fa.flash_forward_ref(*ref_in[:3], scale, causal, rb)
    delta = fa._delta(out_ref, ref_in[3])
    dq_ref = fa.flash_bwd_dq_ref(*ref_in, lse, delta, scale, causal, rb)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*ref_in, lse, delta, scale, causal,
                                          rb)

    def row(pairs):
        errs = [_err(a, b) for a, b in pairs]
        return dict(max_abs_err=max(e[0] for e in errs),
                    rel_l2_err=max(e[1] for e in errs))

    sfx = "" if rb is None else "_rot"
    out, lse_k = fa.flash_fwd(q, k, v, scale, causal, rb)
    torch.cuda.synchronize()
    rows = {"flash_fwd" + sfx: row([(out, out_ref)])}
    rows["flash_fwd" + sfx]["lse_abs_err"] = (lse_k - lse).abs().max().item()
    delta_k = fa._delta(out, dout)
    for name, lse_in, delta_in in (("", lse, delta),
                                   ("chained_", lse_k, delta_k)):
        dq = fa.flash_bwd_dq(q, k, v, dout, lse_in, delta_in, scale, causal,
                             rb)
        torch.cuda.synchronize()
        dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse_in, delta_in, scale,
                                  causal, rb)
        torch.cuda.synchronize()
        for kname, r in (("flash_bwd_dq" + sfx, row([(dq, dq_ref)])),
                         ("flash_bwd_dkv" + sfx, row([(dk, dk_ref),
                                                      (dv, dv_ref)]))):
            got = rows.setdefault(kname, {})
            for key, val in r.items():
                got[name + key] = val
        del dq, dk, dv
    if rb is not None:
        # the model's backward: q and k rotated once, both kernels on them
        dq, dk, dv = fa.flash_backward(q, k, v, out, lse_k, dout, scale,
                                       causal, rb)
        torch.cuda.synchronize()
        for kname, r in (("flash_bwd_dq" + sfx, row([(dq, dq_ref)])),
                         ("flash_bwd_dkv" + sfx, row([(dk, dk_ref),
                                                      (dv, dv_ref)]))):
            for key, val in r.items():
                rows[kname]["backward_" + key] = val
        del dq, dk, dv
        # the model's path: flash_attention rotates q and k once in its
        # forward (the pass, then K1 on the copies), its autograd keeps the
        # copies, and its backward launches K2_rot and K3_rot on them and no
        # pass
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        passes = fa.launch_counts()[ROPE]
        out_a = fa.flash_attention(*leaves, causal=causal, scale=scale,
                                   rotary_base=rb)
        torch.cuda.synchronize()
        mid = fa.launch_counts()[ROPE]
        grads = [t.transpose(1, 2) for t in torch.autograd.grad(
            out_a, leaves, dout.transpose(1, 2))]
        torch.cuda.synchronize()
        rows[ROPE + "_autograd"] = dict(
            forward_passes=mid - passes,
            backward_passes=fa.launch_counts()[ROPE] - mid)
        for kname, r in (("flash_fwd" + sfx,
                          row([(out_a.transpose(1, 2), out_ref)])),
                         ("flash_bwd_dq" + sfx, row([(grads[0], dq_ref)])),
                         ("flash_bwd_dkv" + sfx, row([(grads[1], dk_ref),
                                                      (grads[2], dv_ref)]))):
            for key, val in r.items():
                rows[kname]["autograd_" + key] = val
        del leaves, out_a, grads
    del dq_ref, dk_ref, dv_ref

    if timed:
        nb = 2  # bytes of a bf16 element
        act = q.numel() * nb          # one [B, H, L, D] tensor
        kv = k.numel() * nb
        stat = lse.numel() * 4        # one f32 [B, H, L]
        io = {"flash_fwd": 2 * act + 2 * kv + stat,
              "flash_bwd_dq": 3 * act + 2 * kv + 2 * stat,
              "flash_bwd_dkv": 2 * act + 4 * kv + 2 * stat}
        runs = {
            "flash_fwd": (lambda r: fa.flash_fwd(q, k, v, scale, causal, r),
                          lambda: fa.flash_forward_ref(*ref_in[:3], scale,
                                                       causal, rb)),
            "flash_bwd_dq": (
                lambda r: fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale,
                                          causal, r),
                lambda: fa.flash_bwd_dq_ref(*ref_in, lse, delta, scale,
                                            causal, rb)),
            "flash_bwd_dkv": (
                lambda r: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale,
                                           causal, r),
                lambda: fa.flash_bwd_dkv_ref(*ref_in, lse, delta, scale,
                                             causal, rb)),
        }
        if rb is not None:
            # K2_rot and K3_rot alone: on q and k rotated beforehand, as
            # flash_backward launches them
            qk = fa._rope_qk(q, k, (0,), (0,), rb)
            bwd_args = (q, k, v, dout, lse, delta, scale, causal, rb, qk)
            alone = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, scale,
                                                       causal, rb),
                     "flash_bwd_dq": lambda: fa._bwd_dq(*bwd_args),
                     "flash_bwd_dkv": lambda: fa._bwd_dkv(*bwd_args)}
        for name, (kern, plain) in runs.items():
            r = rows[name + sfx]
            r["ms"] = time_ms(alone[name] if rb is not None
                              else lambda: kern(None))
            if rb is not None:  # the same launch without rotary
                r["norot_ms"] = time_ms(lambda: kern(None))
            r["plain_ms"] = time_ms(plain, n=5, reps=3, warmup=1)
            r["bound_ms"], r["bound_by"] = _bound_ms(
                shape, KERNELS[name][2], io[name])
        if rb is None:
            rows["library"] = sdpa_times(q, k, v, dout, causal, scale)
        else:
            lib = rotated_sdpa_times(q, k, v, dout, causal, scale, rb)
            for name in FLASH:
                rows[name + sfx].update(
                    library_ms=lib["sdpa_fwd_ms" if name == "flash_fwd"
                                   else "sdpa_bwd_ms"],
                    rotate_ms=lib["rotate_ms"],
                    library=lib["note"])
            del qk, bwd_args
            rows[ROPE] = rope_timings(q, k, v, dout, lse, delta, scale,
                                      causal, rb)
    return rows


def check_rope(seed):
    """The rotary pass against its plain version (``apply_rotary`` at the
    shard's positions, on the same bf16 values) at ROPE_CHECKS, on views of
    [B, L, heads, D] activations as the model hands them over: every
    element must be equal. Returns {label_mismatched: count} and the
    largest |difference|."""
    import torch
    fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    row, bad = {"max_abs_err": 0.0}, []
    for label, (B, heads, L, D), offset in ROPE_CHECKS:
        x = torch.randn(B, L, heads, D, generator=g, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
        got = fa.rope_rotate(x, offset, ROPE_BASE)
        want = fa.apply_rotary(x, fa.shard_positions(offset, L, x.device),
                               ROPE_BASE)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        row[label + "_mismatched"] = int((got != want).sum().item())
        row["max_abs_err"] = max(row["max_abs_err"], diff.max().item())
        if row[label + "_mismatched"]:
            bad.append("%s %s at %s: %d of %d elements differ (max %.3g)" % (
                label, tuple(x.shape), offset, row[label + "_mismatched"],
                got.numel(), diff.max().item()))
    log("%s against apply_rotary: %s" % (ROPE, ", ".join(
        "%s %s" % kv for kv in sorted(row.items()))))
    return row, bad


def rope_timings(q, k, v, dout, lse, delta, scale, causal, rb):
    """The rotary pass at the lc launch: q and k (its two launches a
    layer's forward), its plain version on the same tensors, its bound
    (bytes: q and k read and written once, the tables of their positions
    read once); and one layer's attention kernels as the model launches
    them (``layer_ms``: the pass, then K1, K2_rot and K3_rot on the
    copies) beside K1, K2 and K3 without rotary (``norot_layer_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]
    L, D = q.shape[2], q.shape[3]

    def rotate():
        fa.rope_rotate(q, (0,), rb)
        fa.rope_rotate(k, (0,), rb)
    # Two short launches back to back are as fast as the host issues them
    # (event_ms); ms is the kernels' own device time (torch.profiler).
    event_ms = time_ms(rotate)
    n = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            rotate()
        torch.cuda.synchronize()
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    for e in prof.key_averages() if "rope_rotate" in e.key)
    if not device_us:
        log("%s: the profiler saw no device time; ms is the events' time"
            % ROPE)
    r = {"ms": device_us / 1e3 / n if device_us else event_ms,
         "event_ms": event_ms,
         "plain_ms": time_ms(lambda: (
             fa.apply_rotary(q, fa.shard_positions((0,), L, q.device), rb),
             fa.apply_rotary(k, fa.shard_positions((0,), L, k.device), rb)),
             n=5, reps=3, warmup=1)}
    elements = q.numel() + k.numel()
    n_bytes = 2 * elements * q.element_size() + 2 * L * (D // 2) * 4
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = KERNELS[ROPE][2] * elements / PEAK_F32_FLOPS * 1e3
    r["bound_ms"], r["bound_by"] = ((t_ops, "operations") if t_ops > t_bytes
                                    else (t_bytes, "bytes"))
    r["library"] = ("none: no one PyTorch call computes the rotation "
                    "(ms covers q and k, the pass's two launches)")
    def layer(base):
        qr, kr = fa._rotated(q, k, base)
        qk = fa._bf16(qr, kr)
        args = (qr, kr, v, dout, lse, delta, scale, causal, base, qk)
        fa._fwd(qr, kr, v, scale, causal, base, qk)
        fa._bwd_dq(*args)
        fa._bwd_dkv(*args)
    r["layer_ms"] = time_ms(lambda: layer(rb))
    r["norot_layer_ms"] = time_ms(lambda: layer(None))
    return r


def sdpa_times(q, k, v, dout, causal, scale):
    """PyTorch's fused attention on the same inputs: the forward (one
    ``scaled_dot_product_attention`` call, K1's function) and the backward
    (one ``autograd.grad`` call through it, dQ, dK and dV together: K2's
    and K3's functions in one launch). GQA (fewer k/v heads) through
    ``enable_gqa``. A yardstick only, never called by the port."""
    import torch
    import torch.nn.functional as F
    gqa = dict(enable_gqa=True) if k.shape[1] != q.shape[1] else {}
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                           scale=scale, **gqa)

    o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal,
                                       scale=scale, **gqa)

    def bwd():
        torch.autograd.grad(o, (qq, kk, vv), dout, retain_graph=True)

    return {"sdpa_fwd_ms": time_ms(fwd), "sdpa_bwd_ms": time_ms(bwd)}


def rotated_sdpa_times(q, k, v, dout, causal, scale, rotary, q_pos=None,
                       k_pos=None):
    """The yardstick of the rotary kernels: ``sdpa_times`` on q and k
    rotated beforehand (``apply_rotary`` at ``q_pos``/``k_pos``, default
    0..L-1), and apart from it the time of that rotation of q and k (which
    the kernels do inside)."""
    import torch
    fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]
    L = q.shape[2]
    q_pos = torch.arange(L, device=q.device) if q_pos is None else q_pos
    k_pos = torch.arange(L, device=q.device) if k_pos is None else k_pos

    def rotate():
        return (fa.apply_rotary(q, q_pos, rotary),
                fa.apply_rotary(k, k_pos, rotary))
    qr, kr = rotate()
    times = sdpa_times(qr, kr, v, dout, causal, scale)
    times["rotate_ms"] = time_ms(rotate)
    times["note"] = ("scaled_dot_product_attention%s on q and k rotated "
                     "beforehand; rotate_ms, the rotation of q and k, is "
                     "not in it" % (" (enable_gqa)" if k.shape[1] !=
                                    q.shape[1] else ""))
    return times


def phase_kernels():
    import torch
    slice_rows = check_kernels(SLICE, seed=1, timed=True)
    torch.cuda.empty_cache()
    odd_rows = check_kernels(ODD, seed=2, timed=False)
    torch.cuda.empty_cache()
    slice_rows.update(check_kernels(ROT_SLICE, seed=3, timed=True,
                                    rotary=ROPE_BASE))
    torch.cuda.empty_cache()
    odd_rows.update(check_kernels(ROT_ODD, seed=4, timed=False,
                                  rotary=ROPE_BASE))
    torch.cuda.empty_cache()
    library = slice_rows.pop("library")
    rope_row, bad = check_rope(seed=5)
    slice_rows[ROPE].update(rope_row)
    for label, rows in (("slice", slice_rows), ("odd", odd_rows)):
        passes = rows.pop(ROPE + "_autograd")
        log("flash_attention with rotary at the %s shape: %d launches of the "
            "pass in the forward, %d in the backward" % (
                label, passes["forward_passes"], passes["backward_passes"]))
        if passes != dict(forward_passes=2, backward_passes=0):
            bad.append("flash_attention with rotary at the %s shape launched "
                       "the pass %d times in its forward and %d in its "
                       "backward, not 2 and 0" % (
                           label, passes["forward_passes"],
                           passes["backward_passes"]))
    torch.cuda.empty_cache()
    for name in FLASH + FLASH_ROT:
        for label, rows in (("slice", slice_rows), ("odd", odd_rows)):
            r = rows[name]
            log("%s %s: %s" % (name, label, ", ".join(
                "%s %.3g" % (key, val) for key, val in sorted(r.items())
                if key.endswith("_err"))))
            for key, val in r.items():
                limit = (LSE_TOL if key == "lse_abs_err" else
                         REL_TOL if key.endswith("rel_l2_err") else None)
                if limit is not None and not val <= limit:
                    bad.append("%s at the %s shape: %s %.3g > %g"
                               % (name, label, key, val, limit))
        slice_rows[name]["odd_rel_l2_err"] = max(
            val for key, val in odd_rows[name].items()
            if key.endswith("rel_l2_err"))
    if bad:
        fail("kernels disagree with their plain versions: " + "; ".join(bad))
    shape = "x".join(str(ROT_SLICE[c]) for c in "BHGLD")
    for name in FLASH_ROT:
        r = slice_rows[name]
        log("%s at %s: %.4f ms (without rotary %.4f, bound %.4f, plain %.3f, "
            "SDPA on rotated q, k %.4f + rotation %.4f)" % (
                name, shape, r["ms"], r["norot_ms"], r["bound_ms"],
                r["plain_ms"], r["library_ms"], r["rotate_ms"]))
    r = slice_rows[ROPE]
    log("%s of q and k at %s: %.4f ms on the device, %.4f between events "
        "(bound %.4f by %s, plain %.3f); a layer's pass, K1, K2_rot and "
        "K3_rot %.4f ms, K1-K3 without rotary %.4f (%.3fx)" % (
            ROPE, shape, r["ms"], r["event_ms"], r["bound_ms"],
            r["bound_by"], r["plain_ms"], r["layer_ms"],
            r["norot_layer_ms"], r["layer_ms"] / r["norot_layer_ms"]))
    return slice_rows, library


def _bn_inputs(M, C, dy_dtype, seed):
    """x (M, C) bf16 with an offset mean, dy in ``dy_dtype``, and x's
    f32 mean and rstd, from a seeded CUDA generator."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(M, C, generator=g, device="cuda") * 2.0 + 0.5).to(
        torch.bfloat16)
    dy = torch.randn(M, C, generator=g, device="cuda").to(
        getattr(torch, dy_dtype))
    xf = x.float()
    mean = xf.mean(0)
    rstd = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
    del xf
    return x, dy, mean, rstd


def _bn_bound_ms(name, M, C, n_bytes):
    t_ops = KERNELS[name][2] * M * C / PEAK_F32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bn_pass_checks(bn, x, dy, gamma, beta, groups, extra):
    """The normalize and dx passes at one shape, both modes, with and
    without the ReLU (and, with ``extra``, the mean and var cotangents),
    against their plain versions: the cases that are not equal bit for bit,
    and the largest |kernel - plain| of each pass."""
    import torch
    M, C = x.shape
    s, ss = bn.batch_norm_stats_ref(x, groups)
    mean = s / (M // groups)
    rstd = torch.rsqrt(torch.clamp(ss / (M // groups) - mean * mean, min=0.0)
                       + 1e-5)
    a = gamma * rstd
    b = beta - mean * a
    dbeta, dgamma = bn.batch_norm_grad_stats_ref(dy, x, mean, rstd, groups)
    cot = [dict()]
    if extra:
        g = torch.Generator(device=x.device).manual_seed(groups)
        cot.append({k: torch.randn(mean.shape, generator=g, device=x.device)
                    for k in ("gmean", "gvar")})
    bad, worst = [], {"bn_apply": 0.0, "bn_dx": 0.0}
    for mode in bn.MODES:
        for relu in (False, True):
            runs = [("bn_apply", bn.bn_apply, bn.bn_apply_ref,
                     (x, a, b, groups, relu, mode), {})]
            for kw in cot:
                runs.append(("bn_dx", bn.bn_dx, bn.bn_dx_ref,
                             (dy, x, mean, rstd, gamma, beta, dbeta, dgamma,
                              M // groups, groups, relu, mode), kw))
            for name, kern, plain, args, kw in runs:
                got, ref = kern(*args, **kw), plain(*args, **kw)
                # the registered custom op (bn_remat's route) on the same
                # arguments: the wrapper's launch, bit for bit
                op_args = args + ((kw.get("gmean"), kw.get("gvar"))
                                  if name == "bn_dx" else ())
                via_op = getattr(torch.ops.horovod_tpu_torch, name)(*op_args)
                worst[name] = max(worst[name], _err(got, ref)[0])
                for label, out in (("", got), (" (custom op)", via_op)):
                    if not torch.equal(out, ref):
                        bad.append("%s%s %s relu=%s groups=%d%s" % (
                            name, label, mode, relu, groups,
                            " +cotangents" if kw else ""))
                del got, ref, via_op
    return bad, worst


def _bn_runs(bn, x, dy, gamma, beta, mean, rstd, hw, names=None):
    """name -> (kernel call, plain call, library call, bytes it must move)
    of the four BN kernels at one launch, as the resnet and inception phases
    call them (f32 arithmetic, no ReLU), and of K7 with the forward's terms
    (``batch_norm_stats_terms``, what the forward without a sync group
    launches); only ``names`` if given. The library calls are PyTorch's own
    on the same memory viewed as [N, C, H, W] channels_last (``hw``), given
    the same statistics (sum dy * (x - mean) = dgamma / rstd, formed
    outside the timed call): yardsticks the port never calls.
    ``torch.batch_norm_stats`` returns mean and invstd, the function of K7
    with terms; it stands beside K7's sums too."""
    import torch
    M, C = x.shape
    x4, dy4 = (t.view(-1, *hw, C).permute(0, 3, 1, 2) for t in (x, dy))
    a = gamma * rstd
    b = beta - mean * a
    dbeta, dgamma = bn.batch_norm_grad_stats_ref(dy, x, mean, rstd)
    sum_dy_xmu = dgamma / rstd
    count = torch.tensor([M], dtype=torch.int32, device="cuda")
    dx_args = (dy, x, mean, rstd, gamma, beta, dbeta, dgamma, M)
    runs = {
        "batch_norm_stats": (
            lambda: bn.batch_norm_stats(x),
            lambda: bn.batch_norm_stats_ref(x),
            lambda: torch.batch_norm_stats(x4, 1e-5),
            x.numel() * x.element_size() + 2 * C * 4),
        # reads x, gamma and beta, writes mean, var, rstd, a and b
        "batch_norm_stats_terms": (
            lambda: bn.batch_norm_stats_terms(x, gamma, beta, BN_EPS),
            lambda: bn.batch_norm_stats_terms_ref(x, gamma, beta, BN_EPS),
            lambda: torch.batch_norm_stats(x4, BN_EPS),
            x.numel() * x.element_size() + 7 * C * 4),
        "batch_norm_grad_stats": (
            lambda: bn.batch_norm_grad_stats(dy, x, mean, rstd),
            lambda: bn.batch_norm_grad_stats_ref(dy, x, mean, rstd),
            lambda: torch.batch_norm_backward_reduce(
                dy4, x4, mean, rstd, None, True, False, False),
            (x.numel() * x.element_size() + dy.numel() * dy.element_size()
             + 2 * C * 4 + 2 * C * 4)),
        "bn_apply": (
            lambda: bn.bn_apply(x, a, b),
            lambda: bn.bn_apply_ref(x, a, b),
            lambda: torch.batch_norm_elemt(x4, gamma, beta, mean, rstd,
                                           1e-5),
            2 * x.numel() * x.element_size() + 2 * C * 4),
        # the raw vectors the kernel reads: mean, rstd, gamma, dbeta, dgamma
        "bn_dx": (
            lambda: bn.bn_dx(*dx_args),
            lambda: bn.bn_dx_ref(*dx_args),
            lambda: torch.batch_norm_backward_elemt(
                dy4, x4, mean, rstd, gamma, dbeta, sum_dy_xmu, count),
            (2 * x.numel() * x.element_size() + dy.numel()
             * dy.element_size() + 5 * C * 4)),
    }
    return {k: v for k, v in runs.items() if names is None or k in names}


def _device_activity(fn):
    """The names of the device's kernels, copies and sets in one call of
    ``fn`` under torch.profiler (after one call outside it). The session
    opens with a spin kernel of its own, left out of the names: after a
    long profiled run in the same process (``--profile``'s steps) a
    session's first device record went missing, whichever kernel it was."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and "spin_kernel" not in e.name]


def _traced_as(fn, kernels, tries=5):
    """(names, ok): one call of ``fn`` traced by ``_device_activity`` must
    run exactly ``kernels`` (name fragments, in order) and nothing else.
    The profiler now and then delivers no record of a kernel that ran (an
    empty or shorter trace, at any of these calls on the H100), so a trace
    that holds only expected kernels but not all of them is taken again,
    up to ``tries`` times; a trace with anything else fails at once."""
    for _ in range(tries):
        seen = _device_activity(fn)
        if not all(any(k in n for k in kernels) for n in seen):
            return seen, False
        if len(seen) == len(kernels) and all(
                k in n for k, n in zip(kernels, seen)):
            return seen, True
    return seen, False


def _row_key(name, key):
    """(row, key) of a reading: K7 with terms goes in K7's row, prefixed."""
    if name == BN_TERMS:
        return "batch_norm_stats", "terms_" + key
    return name, key


def _bn_pass_launches(bn, rows):
    """A profiler trace, at 8,192 x 448 (f32 arithmetic, no ReLU, the mean
    and var cotangents absent), of one call of each BN kernel (K7, K7 with
    terms, K8, bn_apply, bn_dx): each must show its one kernel and no
    other device activity; and of one ``fused_batch_norm_train`` forward
    without a sync group: K7's kernel and bn_apply's, nothing else.
    Returns the failures."""
    import torch
    x, dy, mean, rstd = _bn_inputs(128 * 8 * 8, 448, "bfloat16", 99)
    gamma = torch.rand(448, device="cuda") + 0.5
    beta = torch.randn(448, device="cuda")
    runs = _bn_runs(bn, x, dy, gamma, beta, mean, rstd, (8, 8))
    bad = []
    kernel = {"batch_norm_stats": "bn_stats_kernel",
              BN_TERMS: "bn_stats_kernel",
              "batch_norm_grad_stats": "bn_stats_kernel",
              "bn_apply": "bn_apply_kernel", "bn_dx": "bn_dx_kernel"}
    for name, (kern, _, _, _) in runs.items():
        seen, ok = _traced_as(kern, [kernel[name]])
        row, key = _row_key(name, "trace_device_activity")
        rows[row][key] = seen
        log("%s, one call under the profiler: %s" % (name, seen))
        if not ok:
            bad.append("one %s call ran %s on the device, not its one kernel"
                       % (name, seen))
    seen, ok = _traced_as(lambda: bn.fused_batch_norm_train(
        x, gamma, beta, BN_EPS), ["bn_stats_kernel", "bn_apply_kernel"])
    rows["bn_apply"]["fused_forward_trace_device_activity"] = seen
    log("fused_batch_norm_train forward under the profiler: %s" % seen)
    if not ok:
        bad.append("one fused_batch_norm_train forward ran %s on the device, "
                   "not K7's kernel and bn_apply's" % seen)
    return bad


def _inception_step(bn, rows):
    """The BN kernels' cost an Inception step: K7 with terms (as the
    forward launches it), K8, bn_apply's and bn_dx's times (and their
    library calls') at each of Inception's 18 (M, C) launch shapes,
    weighted by its layers (INCEPTION_BN_LAUNCHES, 94 in all), back to back
    (``inception_step_ms``) and on the device (``_device_ms``, CUDA graphs:
    the short launches' inputs sit in L2 between calls)."""
    import torch
    names = (BN_TERMS, "batch_norm_grad_stats", "bn_apply", "bn_dx")
    keys = ("inception_step_ms", "inception_step_device_ms",
            "library_inception_step_ms", "library_inception_step_device_ms")
    for name in names:
        for key in keys:
            row, k = _row_key(name, key)
            rows[row][k] = 0.0
    for seed, ((hw, C), layers) in enumerate(INCEPTION_BN_LAUNCHES.items()):
        side = round(hw ** 0.5)
        M = INCEPTION_BATCH * hw
        x, dy, mean, rstd = _bn_inputs(M, C, "bfloat16", 200 + seed)
        g = torch.Generator(device="cuda").manual_seed(300 + seed)
        gamma = torch.rand(C, generator=g, device="cuda") + 0.5
        beta = torch.randn(C, generator=g, device="cuda")
        runs = _bn_runs(bn, x, dy, gamma, beta, mean, rstd, (side, side),
                        names)
        for name, (kern, _, library, _) in runs.items():
            times = (time_ms(kern), graph_ms(kern), time_ms(library),
                     graph_ms(library))
            for key, t in zip(keys, times):
                row, k = _row_key(name, key)
                rows[row][k] += layers * t
            log("%s at %d x %d (x%d): %.4f ms, device %.4f; library %.4f, "
                "device %.4f" % ((name, M, C, layers) + times))
        del x, dy, runs
        torch.cuda.empty_cache()
    for name in names:
        got = {}
        for key in keys:
            row, k = _row_key(name, key)
            got[key] = rows[row][k]
        log("%s over Inception's 94 launches a step: %s" % (
            name, json.dumps(got)))


def _stats_repeat(fn):
    """Whether ``fn()`` (a K7 or K8 call) gives its first outputs bit for
    bit when called again, from a CUDA graph's replays, and once more after
    them: each call must leave the scratch's counters at 0."""
    import torch
    first = fn()
    again = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    after = fn()
    same = all(torch.equal(a, b) for out in (again, captured, after)
               for a, b in zip(first, out))
    del graph
    return same


def _terms_check(bn, terms, sums, count, gamma, beta):
    """The names of K7's terms that differ from the torch ops
    (``_terms_of_sums``) on K7's own sums, and the largest |difference| of
    each in units of the reference's last place (ulp)."""
    import torch
    ref = bn._terms_of_sums(*sums, count, gamma, beta, BN_EPS)
    bad, ulps = [], {}
    for name, got, want in zip(("mean", "var", "rstd", "a", "b"), terms,
                               ref):
        ulp = (torch.nextafter(want.abs(), torch.full_like(want, math.inf))
               - want.abs())
        ulps[name] = ((got - want).abs() / ulp).max().item()
        if not torch.equal(got, want):
            bad.append(name)
    return bad, ulps


def phase_bn_kernels():
    """K7 and K8 against their plain versions at BN_SHAPES and at
    INCEPTION_BN_SHAPES (and, at the stem, with BN_GROUPS ghost groups and
    K8 with the ReLU mask), the normalize and dx passes bit for bit against
    theirs (both modes, with and without the ReLU, with ghost groups where
    they divide M); times at the ResNet stem, the widest activation of the
    main path (the row's ``ms``), and at the five Inception launches
    (``<label>_ms``), each back to back and on the device (``device_ms``,
    CUDA graphs), beside its plain version, library call and bound; one
    call of each pass under the profiler (one kernel, nothing else on the
    device); and the passes' launch-weighted cost an Inception step
    (``inception_step_ms``). Returns {name: row}."""
    import torch
    from horovod_tpu_torch.ops import batch_norm as bn
    rows = {name: {} for name in BN}
    bad = []
    shapes = dict(BN_SHAPES, **{k: v[:3] for k, v in
                                INCEPTION_BN_SHAPES.items()})
    timed = dict(stem=(112, 112), **{k: v[3] for k, v in
                                     INCEPTION_BN_SHAPES.items()})
    for seed, (label, (M, C, dy_dtype)) in enumerate(shapes.items()):
        x, dy, mean, rstd = _bn_inputs(M, C, dy_dtype, seed)
        g = torch.Generator(device="cuda").manual_seed(100 + seed)
        gamma = torch.rand(C, generator=g, device="cuda") + 0.5
        beta = torch.randn(C, generator=g, device="cuda")
        # case -> (groups, K7 or K8 call, its plain call)
        calls = {"batch_norm_stats": (
                     1, lambda: bn.batch_norm_stats(x),
                     lambda: bn.batch_norm_stats_ref(x)),
                 "batch_norm_grad_stats": (
                     1, lambda: bn.batch_norm_grad_stats(dy, x, mean, rstd),
                     lambda: bn.batch_norm_grad_stats_ref(dy, x, mean,
                                                          rstd))}
        if label == "stem":
            # ghost batches of 32, K8 also under the mask in both modes
            gm = bn.batch_norm_stats_ref(x, BN_GROUPS)[0] / (M // BN_GROUPS)
            gr = torch.full_like(gm, 0.5)
            calls["batch_norm_stats@g8"] = (
                BN_GROUPS, lambda: bn.batch_norm_stats(x, BN_GROUPS),
                lambda: bn.batch_norm_stats_ref(x, BN_GROUPS))
            for mode in bn.MODES:
                args = (dy, x, gm, gr, BN_GROUPS, gamma, beta, mode)
                calls["batch_norm_grad_stats@g8_mask_" + mode] = (
                    BN_GROUPS,
                    lambda args=args: bn.batch_norm_grad_stats(*args),
                    lambda args=args: bn.batch_norm_grad_stats_ref(*args))
        for key, (groups, kern, plain) in calls.items():
            name, _, case = key.partition("@")
            tag = label + ("_" + case if case else "")
            got = kern()
            errs = [_err(a, b) for a, b in zip(got, plain())]
            r = rows[name]
            r[tag + "_max_abs_err"] = max(e[0] for e in errs)
            r[tag + "_rel_l2_err"] = max(e[1] for e in errs)
            log("%s %s (%d x %d): max_abs_err %.3g, rel_l2_err %.3g"
                % (name, tag, M, C, r[tag + "_max_abs_err"],
                   r[tag + "_rel_l2_err"]))
            if not r[tag + "_rel_l2_err"] <= BN_TOL:
                bad.append("%s at the %s shape: rel_l2_err %.3g > %g"
                           % (name, tag, r[tag + "_rel_l2_err"], BN_TOL))
            if not _stats_repeat(kern):
                bad.append("%s at the %s shape: a repeated call or a graph "
                           "replay differs from the first call" % (name, tag))
            if name != "batch_norm_stats":
                continue
            # K7 with terms on the same split: its terms equal to the torch
            # ops on K7's own sums (got), bit for bit
            terms_call = functools.partial(bn.batch_norm_stats_terms, x,
                                           gamma, beta, BN_EPS, groups)
            miss, ulps = _terms_check(bn, terms_call(), got, M // groups,
                                      gamma, beta)
            r["terms_%s_max_ulp" % tag] = max(ulps.values())
            log("%s %s (%d x %d): the terms %s their torch ops on K7's sums "
                "(largest gap in ulp %s)" % (
                    BN_TERMS, tag, M, C, "differ from" if miss else "equal",
                    json.dumps(ulps)))
            if miss:
                bad.append("%s at the %s shape: %s differ from the torch ops "
                           "on K7's sums" % (BN_TERMS, tag, ", ".join(miss)))
            if not _stats_repeat(terms_call):
                bad.append("%s at the %s shape: a repeated call or a graph "
                           "replay differs from the first call"
                           % (BN_TERMS, tag))
            del got
        for groups in (1, BN_GROUPS) if M % BN_GROUPS == 0 else (1,):
            miss, worst = _bn_pass_checks(bn, x, dy, gamma, beta, groups,
                                          extra=label == "odd")
            bad += ["%s at the %s shape" % (m, label) for m in miss]
            for name, err in worst.items():
                key = "%s_%s_max_abs_err" % (label, "g%d" % groups
                                             if groups > 1 else "plain")
                rows[name][key] = err
            log("bn_apply, bn_dx %s (%d x %d) groups=%d: %d of %d cases "
                "equal their plain versions" % (
                    label, M, C, groups, 8 + 4 * (label == "odd") - len(miss),
                    8 + 4 * (label == "odd")))
        if label in timed:
            pre = "" if label == "stem" else label + "_"
            runs = _bn_runs(bn, x, dy, gamma, beta, mean, rstd, timed[label])
            for name, (kern, plain, library, n_bytes) in runs.items():
                row, p = _row_key(name, pre)
                r = rows[row]
                r[p + "ms"] = time_ms(kern)
                r[p + "device_ms"] = graph_ms(kern)
                r[p + "plain_ms"] = time_ms(plain, n=5, reps=3, warmup=1)
                r[p + "library_ms"] = time_ms(library)
                r[p + "library_device_ms"] = graph_ms(library)
                r[p + "bound_ms"], r[p + "bound_by"] = _bn_bound_ms(
                    row, M, C, n_bytes)
                log("%s %s (%d x %d): %.4f ms, device %.4f (bound %.4f, "
                    "plain %.3f, library %.4f, device %.4f)" % (
                        name, label, M, C, r[p + "ms"], r[p + "device_ms"],
                        r[p + "bound_ms"], r[p + "plain_ms"],
                        r[p + "library_ms"], r[p + "library_device_ms"]))
        if label == "stem":
            # the resnet_lean phase's calls: bf16 arithmetic, the ReLU
            a = gamma * rstd
            b = beta - mean * a
            dbeta, dgamma = bn.batch_norm_grad_stats_ref(dy, x, mean, rstd)
            lean = {"bn_apply": lambda: bn.bn_apply(x, a, b, 1, True, "lean"),
                    "bn_dx": lambda: bn.bn_dx(dy, x, mean, rstd, gamma, beta,
                                              dbeta, dgamma, M, 1, True,
                                              "lean")}
            for name, fn in lean.items():
                rows[name]["lean_relu_ms"] = time_ms(fn)
                rows[name]["lean_relu_device_ms"] = graph_ms(fn)
            log("stem, lean mode with the ReLU: bn_apply %.4f ms (device "
                "%.4f), bn_dx %.4f (device %.4f)" % (
                    rows["bn_apply"]["lean_relu_ms"],
                    rows["bn_apply"]["lean_relu_device_ms"],
                    rows["bn_dx"]["lean_relu_ms"],
                    rows["bn_dx"]["lean_relu_device_ms"]))
        del x, dy
        torch.cuda.empty_cache()
    bad += _bn_pass_launches(bn, rows)
    if not bad:
        _inception_step(bn, rows)
    if bad:
        fail("BN kernels disagree with their plain versions: "
             + "; ".join(bad))
    print("bn_kernels: " + json.dumps(rows), flush=True)
    return rows


def _fold_call(digest, op, dtype, ndim, name):
    """native/divergence.cc FoldCall, written here apart from the port's:
    FNV-1a over (op, dtype, ndim, the name's bytes, 0xFF)."""
    for b in [op, dtype, ndim] + list(name.encode()) + [0xFF]:
        digest = ((digest ^ b) * 1099511628211) % (1 << 64)
    return digest


def phase_api():
    """The data-parallel API on a one-rank NCCL group: checks that fail
    the phase are exact unless a tolerance is stated."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import batch_norm as bn

    hvd.init(model_parallel=1)
    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(5)
    bad = []

    def check(what, ok):
        if not ok:
            bad.append(what)

    g = hvd.new_group([0])
    check("new_group", (g.id, g.ranks, g.rank(), g.size()) == (1, (0,), 0, 1))
    check("mesh", (hvd.model_parallel_size(), hvd.mesh_groups())
          == (1, (None, None)))
    # message.h's codes: allreduce 0, allgather 1, broadcast 2,
    # reduce_scatter 3; f16 6, f32 7, int64 5, bf16 10
    codes = {torch.float32: 7, torch.float16: 6, torch.bfloat16: 10,
             torch.int64: 5, torch.float64: 8}
    seq0, digest = hvd.collective_digest()
    calls = []

    def called(op, t, name):
        calls.append((op, codes[t.dtype], t.dim(), name))

    x = torch.randn(API_COUNT, generator=gen, device=dev)
    for gname, group in (("none", None), ("world", hvd.WORLD), ("new", g)):
        for avg, pre, post in ((True, 1.0, 1.0), (False, 0.5, 3.0),
                               (True, 2.0, 0.25)):
            tag = "%s/%s/%g/%g" % (gname, avg, pre, post)
            want = (x.clone() if pre == 1.0 else x * pre).div_(1) \
                if avg else (x.clone() if pre == 1.0 else x * pre)
            if post != 1.0:
                want.mul_(post)
            got = hvd.allreduce(x, average=avg, prescale_factor=pre,
                                postscale_factor=post, group=group,
                                name="ar/" + tag)
            called(0, x, "ar/" + tag)
            check("allreduce " + tag, torch.equal(got, want))
            got = hvd.reduce_scatter(x, average=avg, prescale_factor=pre,
                                     postscale_factor=post, group=group,
                                     name="rs/" + tag)
            called(3, x, "rs/" + tag)
            check("reduce_scatter of %d %s" % (API_COUNT, tag),
                  got.shape == x.shape and torch.equal(got, want))
        got = hvd.allgather(x.view(-1, 1)[:7], group=group,
                            name="ag/" + gname)
        called(1, x.view(-1, 1), "ag/" + gname)
        check("allgather " + gname, torch.equal(got, x.view(-1, 1)[:7]))
    for codec, dt in ((hvd.Compression.fp16, torch.float16),
                      (hvd.Compression.bf16, torch.bfloat16)):
        got = hvd.allreduce(x, compression=codec, prescale_factor=0.5,
                            postscale_factor=3.0, name="codec/%s" % dt)
        called(0, x.to(dt), "codec/%s" % dt)
        want = (x.to(dt) * 0.5).div_(1).mul_(3.0).float()
        check("allreduce with the %s codec" % dt,
              got.dtype == torch.float32 and torch.equal(got, want))
    tree = {"w": x[:700].view(-1, 7), "b": (x[:3], x[3:5].double())}
    got = hvd.broadcast(tree, root_rank=0, name="tree")
    for i, leaf in enumerate((x[:3], x[3:5].double(), tree["w"])):
        called(2, leaf, "tree.%d" % i)  # the leaves in sorted key order
    check("broadcast of a dict", list(got) == ["w", "b"] and all(
        torch.equal(a, b) for a, b in ((got["w"], tree["w"]),
                                       (got["b"][0], tree["b"][0]),
                                       (got["b"][1], tree["b"][1]))))
    check("metric_average", hvd.metric_average(2.5, name="m") == 2.5)
    called(0, torch.zeros((), dtype=torch.float64), "m")
    seq, got_digest = hvd.collective_digest()
    for call in calls:
        digest = _fold_call(digest, *call)
    check("digest advancing once a collective (%d calls, seq %d -> %d)"
          % (len(calls), seq0, seq), seq == seq0 + len(calls))
    check("digest %016x, FoldCall gives %016x" % (got_digest, digest),
          got_digest == digest)
    hvd.assert_synchronized()
    check("assert_synchronized's own allgather",
          hvd.collective_digest()[0] == seq + 1)

    # sync_batch_norm_stats against torch.var_mean, stage 2's widest BN
    # activation (E[x^2] - E[x]^2 in f32 against var_mean's two-pass)
    xb = (torch.randn(API_BN_ROWS, 128, generator=gen, device=dev) * 2
          + 0.5).to(torch.bfloat16).float()
    mean, var, n = hvd.sync_batch_norm_stats(xb.sum(0), (xb * xb).sum(0),
                                             API_BN_ROWS, group=g)
    var_ref, mean_ref = torch.var_mean(xb, dim=0, correction=0)
    stats_err = max(_err(mean, mean_ref)[1], _err(var, var_ref)[1])
    check("sync_batch_norm_stats vs torch.var_mean: rel %.3g > %g"
          % (stats_err, API_STATS_TOL), n == API_BN_ROWS
          and stats_err <= API_STATS_TOL)

    # the stock sync BN against the stock BN without sync (cuDNN), f32
    xs = torch.randn(API_BN_SHAPE, generator=gen, device=dev).to(
        memory_format=torch.channels_last)
    w = torch.randn(API_BN_SHAPE, generator=gen, device=dev)
    C = API_BN_SHAPE[1]
    scale = torch.rand(C, generator=gen, device=dev) + 0.5
    shift = torch.randn(C, generator=gen, device=dev)
    outs = []
    for group in (g, None):
        m = bn.StockBatchNorm(C, group=group)
        with torch.no_grad():
            m.weight.copy_(scale)
            m.bias.copy_(shift)
        leaf = xs.clone().requires_grad_()
        y = m(leaf)
        grads = torch.autograd.grad((y * w).sum(), (leaf, m.weight, m.bias))
        outs.append([y.detach(), *grads, m.running_mean, m.running_var])
    sync_err = {k: _err(a, b)[1] for k, a, b in zip(
        ("y", "dx", "dgamma", "dbeta", "running_mean", "running_var"),
        *outs)}
    worst = max(sync_err, key=sync_err.get)
    check("stock sync BN vs stock BN: %s rel %.3g > %g"
          % (worst, sync_err[worst], API_SYNC_BN_TOL),
          sync_err[worst] <= API_SYNC_BN_TOL)
    hvd.shutdown()
    result = dict(calls=len(calls) + 1, digest="%016x" % got_digest,
                  sync_bn_stats_rel_err=stats_err,
                  stock_sync_bn_rel_err=sync_err)
    if bad:
        fail("api: " + "; ".join(bad))
    print("api: " + json.dumps(result), flush=True)


def check_overlap(hvd, opt, params, backward, negotiated=False):
    """The overlapped reduction of ``opt`` (a DistributedOptimizer over
    ``params``) on one ``backward()``: every bucket must go out while the
    backward runs, in bucket order, and the reduced gradients must equal
    ``allreduce_gradients`` on a copy of the same local gradients bit for
    bit (``negotiated``: both routes' ``allreduce_gradients``); after a
    backward that sent nothing (as an accumulating microbatch's),
    ``synchronize()`` must send every bucket in order. Leaves the
    gradients cleared."""
    import torch
    opt.zero_grad()
    backward()
    in_backward = list(opt._order)
    local = [None if p.grad is None else p.grad.clone() for p in params]
    opt.synchronize()
    got = [p.grad for p in params]
    equal = True
    for route in ((False, True) if negotiated else (False,)):
        for p, g in zip(params, local):
            p.grad = None if g is None else g.clone()
        hvd.allreduce_gradients(params, negotiated=route)
        equal = equal and all(
            (a is None and p.grad is None) or torch.equal(a, p.grad)
            for a, p in zip(got, params))
    opt.zero_grad()
    with opt._no_sync():
        backward()
    sent_early = list(opt._order)
    opt.synchronize()
    at_sync = list(opt.launch_order)
    opt.zero_grad()
    del got, local
    n = len(opt.buckets)
    log("overlapped reduction: %d buckets; sent in the backward %s; at "
        "synchronize after an accumulating backward %s; equal to "
        "allreduce_gradients bit for bit: %s" % (n, in_backward, at_sync,
                                                  equal))
    if not (equal and in_backward == list(range(n)) and sent_early == []
            and at_sync == list(range(n))):
        fail("the overlapped reduction: buckets sent in the backward %s, at "
             "synchronize %s (expected %s each); equal to the fused "
             "reduction: %s" % (in_backward, at_sync, list(range(n)), equal))
    return dict(buckets=n, overlap_bitwise=equal)


def phase_train(profile_dir=None):
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.ops.flash_attention import (launch_counts,
                                                       reset_launch_counts)
    from horovod_tpu_torch.parallel import lm_loss, make_train_step

    hvd.init()
    dev = hvd.device()
    cfg = TransformerConfig(attention="flash", dtype=torch.bfloat16,
                            max_seq_len=8192, **MODEL)
    B, L = BATCH
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, L), device=dev,
                           generator=torch.Generator(device=dev
                                                     ).manual_seed(1))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    # The same weights through the plain (dense) attention: the reference
    # for the first step's loss, and for every parameter's gradient on two
    # of the sequences (the dense backward of all 8 would hold about 60 GB
    # of scores). The gradients go through the kernels as the model calls
    # them: strided [B, L, H, D] views, K1's lse and O feeding K2 and K3.
    import dataclasses
    dense = Transformer(dataclasses.replace(cfg, attention="dense"),
                        device=dev)
    dense.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss_plain = lm_loss(dense, tokens).item()
    grad_gaps = gradient_gaps(model, dense, tokens[:2], lm_loss)
    del dense
    torch.cuda.empty_cache()
    worst = max(grad_gaps, key=grad_gaps.get)
    log("gradient gap flash vs plain attention at 2 x %d: worst %s %.3g, "
        "median %.3g" % (L, worst, grad_gaps[worst],
                         statistics.median(grad_gaps.values())))
    if not grad_gaps[worst] <= GRAD_TOL:
        fail("gradients through the flash kernels disagree with plain "
             "attention: %s %.3g > %g" % (worst, grad_gaps[worst], GRAD_TOL))

    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(),
                                                    lr=1e-4),
                                   model.named_parameters())
    overlap = check_overlap(hvd, opt, list(model.parameters()),
                            lambda: lm_loss(model, tokens).backward())
    step = make_train_step(model, lm_loss, opt)
    warmup, timed = 2, 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(tokens).item()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log("step %d: loss %.5f, %.1f ms" % (i, loss, times[-1] * 1e3))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = warmup + timed

    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        fail("non-finite loss: %s" % losses)
    if not losses[-1] < losses[0]:
        fail("loss did not fall: %s" % losses)
    for name, n in counts.items():
        per_step = cfg.num_layers if name in FLASH else 0
        if n != per_step * steps:
            fail("%s launched %d times in %d steps, expected %d per step"
                 % (name, n, steps, per_step))
    rel = abs(losses[0] - loss_plain) / abs(loss_plain)
    log("first loss %.6f, plain attention %.6f, rel %.3g"
        % (losses[0], loss_plain, rel))
    if not rel <= 2e-2:
        fail("first loss %.6f vs plain attention %.6f (rel %.3g)"
             % (losses[0], loss_plain, rel))

    step_s = statistics.median(times[warmup:])
    result = dict(step_ms=step_s * 1e3, seq_per_s=B / step_s,
                  tokens_per_s=B * L / step_s, peak_mem_gb=peak / 1e9,
                  tflops=lm_step_flops(cfg, B, L) / step_s / 1e12,
                  loss_first=losses[0], loss_last=losses[-1],
                  loss_plain=loss_plain, grad_gap_worst=grad_gaps[worst],
                  launches=counts, steps=steps, **overlap)
    print("train: " + json.dumps(result), flush=True)
    if profile_dir:
        profile_steps(step, tokens, profile_dir, "lm")
    del step, opt, model
    torch.cuda.empty_cache()
    negotiated = train_negotiated(hvd, cfg, tokens, result["step_ms"],
                                  profile_dir)
    hvd.shutdown()
    return {name: counts[name] + negotiated[name] for name in FLASH}


def train_negotiated(hvd, cfg, tokens, direct_step_ms, profile_dir=None):
    """The train phase's LM again, from the same seed, with its gradients
    negotiated through the core (ROADMAP A8c2):
    ``DistributedOptimizer(negotiated=True)``, each bucket an
    ``allreduce_async`` of CUDA tensors that the core's device op runs on
    NCCL. One backward through its hooks (``check_overlap``: the buckets
    in order, the gradients equal to both routes' ``allreduce_gradients``
    bit for bit), then 2 warm-up and 5 timed steps: finite, falling
    losses, 12 launches of each of K1-K3 a step, every bucket through the
    device op. Prints the step ms beside the direct route's; no limit.
    With ``profile_dir``, 3 more steps profiled (``lm_negotiated``).
    Returns the kernels' launches."""
    import torch
    from horovod_tpu_torch.common import core, device_plane
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.ops.flash_attention import (launch_counts,
                                                       reset_launch_counts)
    from horovod_tpu_torch.parallel import lm_loss, make_train_step
    dev = hvd.device()
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    core.init()
    plane = device_plane.current()
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(),
                                                    lr=1e-4),
                                   model.named_parameters(), negotiated=True)
    overlap = check_overlap(hvd, opt, list(model.parameters()),
                            lambda: lm_loss(model, tokens).backward(),
                            negotiated=True)
    step = make_train_step(model, lm_loss, opt)
    warmup, timed = 2, 5
    torch.cuda.synchronize()
    responses0 = plane.responses
    tensors0 = core.get_core().perf_counters()[1]
    reset_launch_counts()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(tokens).item()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log("negotiated step %d: loss %.5f, %.1f ms"
            % (i, loss, times[-1] * 1e3))
    counts = launch_counts()
    steps = warmup + timed
    responses = plane.responses - responses0
    tensors = core.get_core().perf_counters()[1] - tensors0
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        fail("negotiated: non-finite loss: %s" % losses)
    if not losses[-1] < losses[0]:
        fail("negotiated: loss did not fall: %s" % losses)
    for name, n in counts.items():
        per_step = cfg.num_layers if name in FLASH else 0
        if n != per_step * steps:
            fail("negotiated: %s launched %d times in %d steps, expected %d "
                 "per step" % (name, n, steps, per_step))
    if tensors != steps * len(opt.buckets) or responses < 1:
        fail("negotiated: %d tensors and %d device responses in %d steps "
             "of %d buckets" % (tensors, responses, steps, len(opt.buckets)))
    step_ms = statistics.median(times[warmup:]) * 1e3
    result = dict(step_ms=step_ms, direct_step_ms=direct_step_ms,
                  device_responses=responses, tensors=tensors,
                  loss_first=losses[0], loss_last=losses[-1],
                  launches=counts, steps=steps, **overlap)
    log("negotiated LM step %.1f ms beside the direct route's %.1f ms"
        % (step_ms, direct_step_ms))
    print("train negotiated: " + json.dumps(result), flush=True)
    if profile_dir:
        profile_steps(step, tokens, profile_dir, "lm_negotiated")
    del step, opt, model
    core.shutdown()
    torch.cuda.empty_cache()
    return counts


def _ghost_gradient_gaps(model, stock, batch, vbs):
    """{parameter: gap} between ``model`` with ghost BN (virtual batch
    ``vbs``) on ``batch`` and the stock model run on each virtual batch
    alone: the mean loss of the whole is the mean of the groups' mean
    losses, so its gradient is the mean of theirs."""
    import torch
    from horovod_tpu_torch.parallel import classification_loss
    n = batch["y"].shape[0] // vbs
    g_model = torch.autograd.grad(classification_loss(model, batch),
                                  list(model.parameters()))
    g_ref = None
    for i in range(n):
        part = {k: v[i * vbs:(i + 1) * vbs] for k, v in batch.items()}
        g = torch.autograd.grad(classification_loss(stock, part),
                                list(stock.parameters()))
        g_ref = g if g_ref is None else [a + b for a, b in zip(g_ref, g)]
    return {name: ((a - b / n).norm() / (b / n).norm().clamp_min(1e-30)
                   ).item()
            for (name, _), a, b in zip(model.named_parameters(), g_model,
                                       g_ref)}


def phase_resnet(profile_dir=None, lean=False):
    """The ResNet-50 train step at batch 256: norm="pallas" (K7, K8 and the
    normalize and dx passes in f32) or, with ``lean``, ResNet50Lean (the same
    kernels in bf16, the ReLU fused into 33 of the 53 norms); returns the
    kernels' launch counts of its 7 steps."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet50, ResNet50Lean, ResNet50PBN
    from horovod_tpu_torch.ops import batch_norm as bn
    from horovod_tpu_torch.ops.flash_attention import (launch_counts,
                                                       reset_launch_counts)
    from horovod_tpu_torch.parallel import (classification_loss,
                                            make_train_step)

    name = "resnet_lean" if lean else "resnet"
    model_cls, norm = ((ResNet50Lean, "lean") if lean
                       else (ResNet50PBN, "pallas"))
    hvd.init()
    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = model_cls(num_classes=1000, dtype=torch.bfloat16, device=dev,
                      generator=gen)
    # flax starts each block-final BN scale at 0, which zeroes every
    # gradient upstream of it inside the block; nonzero scales let the
    # gradient check below see every layer's K8 and dx pass.
    with torch.no_grad():
        for block in model.blocks:
            block.norms[-1].weight.uniform_(0.1, 0.5, generator=gen)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    # the weights before any step, for the bn_remat run
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {"x": torch.randn(RESNET_BATCH, 3, IMAGE, IMAGE, generator=gen,
                              device=dev),
             "y": torch.randint(0, 1000, (RESNET_BATCH,), generator=gen,
                                device=dev)}

    # The same weights through the stock BN: the first loss at batch 256,
    # and every parameter's gradient at batch 32. The gradients are
    # compared in float32: at init, in bf16, two sound BN paths already
    # stand 0.4-0.5 apart (median leaf, CPU at batch 8), which would hide a
    # wrong kernel; in float32 they stand 0.007 apart. The bf16 gap is
    # logged beside it.
    stock = ResNet50(num_classes=1000, dtype=torch.bfloat16, device=dev)
    stock.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss_plain = classification_loss(stock, batch).item()
    small = {k: v[:RESNET_GRAD_BATCH] for k, v in batch.items()}
    gaps_bf16 = gradient_gaps(model, stock, small, classification_loss)
    del stock
    f32 = []
    for cls in (model_cls, ResNet50):
        f32.append(cls(num_classes=1000, dtype=torch.float32, device=dev))
        f32[-1].load_state_dict(model.state_dict())
    grad_gaps = gradient_gaps(*f32, small, classification_loss)
    checks = [("float32", grad_gaps)]
    if lean:
        # ghost BN: 2 virtual batches of 16 against the stock BN on each
        ghost = ResNet50Lean(num_classes=1000, dtype=torch.float32,
                             device=dev, bn_virtual_batch_size=
                             RESNET_GHOST_BATCH)
        ghost.load_state_dict(model.state_dict())
        checks.append(("float32, ghost BN %d x %d" % (
            RESNET_GRAD_BATCH // RESNET_GHOST_BATCH, RESNET_GHOST_BATCH),
            _ghost_gradient_gaps(ghost, f32[1], small, RESNET_GHOST_BATCH)))
        del ghost
    del f32
    torch.cuda.empty_cache()
    for label, gaps in [("bf16, not checked", gaps_bf16)] + checks:
        leaf = max(gaps, key=gaps.get)
        log("%s gradient gap %s vs stock BN at batch %d (%s): worst %s %.3g, "
            "median %.3g" % (name, norm, RESNET_GRAD_BATCH, label, leaf,
                             gaps[leaf], statistics.median(gaps.values())))
    worst = {label: max(gaps.values()) for label, gaps in checks}
    for label, gaps in checks:
        leaf = max(gaps, key=gaps.get)
        if not gaps[leaf] <= RESNET_GRAD_TOL:
            fail("ResNet gradients (norm=%r, %s) disagree with the stock BN: "
                 "%s %.3g > %g" % (norm, label, leaf, gaps[leaf],
                                   RESNET_GRAD_TOL))

    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        model.named_parameters())
    step = make_train_step(model, classification_loss, opt)
    warmup, timed = 2, 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    bn.reset_launch_counts()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(batch).item()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log("%s step %d: loss %.5f, %.1f ms" % (name, i, loss,
                                                times[-1] * 1e3))
    counts = dict(launch_counts(), **bn.launch_counts())
    peak = torch.cuda.max_memory_allocated()
    steps = warmup + timed

    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        fail("non-finite %s loss: %s" % (name, losses))
    if not losses[-1] < losses[0]:
        fail("%s loss did not fall: %s" % (name, losses))
    for kernel, n in counts.items():
        per_step = (RESNET_BN_LAYERS if kernel in BN else
                    RESNET_RELU_LAYERS if kernel in BN_RELU and lean else 0)
        if n != per_step * steps:
            fail("%s launched %d times in %d %s steps, expected %d per step"
                 % (kernel, n, steps, name, per_step))
    rel = abs(losses[0] - loss_plain) / abs(loss_plain)
    log("%s first loss %.6f, stock BN %.6f, rel %.3g"
        % (name, losses[0], loss_plain, rel))
    if not rel <= RESNET_LOSS_TOL:
        fail("%s first loss %.6f vs stock BN %.6f (rel %.3g)"
             % (name, losses[0], loss_plain, rel))

    step_s = statistics.median(times[warmup:])
    result = dict(step_ms=step_s * 1e3, images_per_s=RESNET_BATCH / step_s,
                  peak_mem_gb=peak / 1e9, loss_first=losses[0],
                  loss_last=losses[-1], loss_plain=loss_plain,
                  grad_gap_worst=worst["float32"],
                  grad_gap_worst_bf16=max(gaps_bf16.values()),
                  **({"grad_gap_worst_ghost": worst[checks[1][0]]}
                     if lean else {}),
                  launches=counts, steps=steps)
    if profile_dir:
        profile_steps(step, batch, profile_dir, name)
    if lean:
        del step, opt, model
        torch.cuda.empty_cache()
        result["bn_remat"], remat_counts = phase_bn_remat(
            initial, batch, result, profile_dir)
    print("%s: %s" % (name, json.dumps(result)), flush=True)
    RESULTS[name] = result
    hvd.shutdown()
    return {kernel: counts[kernel] + (remat_counts[kernel] if lean else 0)
            for kernel in BN}


def phase_bn_remat(initial, batch, plain, profile_dir=None):
    """ResNet50Lean with bn_remat on the weights ``initial`` and ``batch``
    of the resnet_lean phase (whose result is ``plain``): one gradient
    against bn_remat=False with cuDNN deterministic (bit for bit: the same
    operations on the same values), and the running statistics after it;
    then the step, its launches (one more normalize pass for each of the
    32 recomputed norms, K7 once a norm) and its peak memory. Returns (its
    result, the kernels' launches over its steps)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet50Lean
    from horovod_tpu_torch.ops import batch_norm as bn
    from horovod_tpu_torch.parallel import (classification_loss,
                                            make_train_step)
    dev = hvd.device()
    models = {}
    for remat in (False, True):
        m = ResNet50Lean(num_classes=1000, dtype=torch.bfloat16, device=dev,
                         bn_remat=remat)
        m.load_state_dict(initial)
        models[remat] = m
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        grads, launches = {}, {}
        for remat, m in models.items():
            bn.reset_launch_counts()
            grads[remat] = torch.autograd.grad(
                classification_loss(m, batch), list(m.parameters()))
            torch.cuda.synchronize()
            launches[remat] = bn.launch_counts()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    names = [n for n, _ in models[True].named_parameters()]
    unequal = [n for n, a, b in zip(names, grads[True], grads[False])
               if not torch.equal(a, b)]
    stats = [n for (n, a), b in zip(models[True].named_buffers(),
                                    models[False].buffers())
             if not torch.equal(a, b)]
    del grads, models[False]
    want = {"batch_norm_stats": RESNET_BN_LAYERS,
            "bn_apply": RESNET_BN_LAYERS + RESNET_REMAT_LAYERS,
            "bn_apply_relu": RESNET_RELU_LAYERS + RESNET_REMAT_LAYERS}
    log("bn_remat: gradients unequal to bn_remat=False: %s; running "
        "statistics unequal: %s; launches of one forward and backward %s "
        "(bn_remat=False: %s)" % (unequal or "none", stats or "none",
                                  launches[True], launches[False]))
    if unequal or stats:
        fail("bn_remat differs from bn_remat=False: gradients %s, running "
             "statistics %s" % (unequal, stats))
    for kernel, n in want.items():
        if launches[True][kernel] != n:
            fail("bn_remat: %s launched %d times in one forward and "
                 "backward, expected %d" % (kernel, launches[True][kernel], n))
    model = models[True]
    del models
    torch.cuda.empty_cache()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        model.named_parameters())
    step = make_train_step(model, classification_loss, opt)
    warmup, timed = 2, 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bn.reset_launch_counts()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(batch).item()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log("resnet_lean bn_remat step %d: loss %.5f, %.1f ms"
            % (i, loss, times[-1] * 1e3))
    counts = bn.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = warmup + timed
    if not all(x == x and abs(x) != float("inf") for x in losses) or \
            not losses[-1] < losses[0]:
        fail("bn_remat loss not finite or not falling: %s" % losses)
    if abs(losses[0] - plain["loss_first"]) > 1e-6 * abs(plain["loss_first"]):
        fail("bn_remat first loss %.6f vs bn_remat=False %.6f"
             % (losses[0], plain["loss_first"]))
    per_step = dict(
        {k: RESNET_BN_LAYERS for k in BN},
        batch_norm_grad_stats_relu=RESNET_RELU_LAYERS,
        bn_dx_relu=RESNET_RELU_LAYERS, **want)
    for kernel, n in counts.items():
        if n != per_step[kernel] * steps:
            fail("bn_remat: %s launched %d times in %d steps, expected %d "
                 "per step" % (kernel, n, steps, per_step[kernel]))
    step_s = statistics.median(times[warmup:])
    result = dict(step_ms=step_s * 1e3, images_per_s=RESNET_BATCH / step_s,
                  peak_mem_gb=peak / 1e9,
                  peak_mem_gb_without=plain["peak_mem_gb"],
                  step_ms_without=plain["step_ms"], loss_first=losses[0],
                  loss_last=losses[-1], gradients_bitwise=True,
                  launches=counts, steps=steps)
    log("bn_remat: peak %.2f GB (bn_remat=False %.2f), step %.1f ms "
        "(bn_remat=False %.1f)" % (result["peak_mem_gb"],
                                    plain["peak_mem_gb"], result["step_ms"],
                                    plain["step_ms"]))
    if profile_dir:
        profile_steps(step, batch, profile_dir, "resnet_lean_remat")
    del step, opt, model
    torch.cuda.empty_cache()
    return result, counts


def _m_err(a, b):
    """max |a - b| of two running maxima or lse rows; the -inf entries (rows
    that saw no key) must be the same in both, else inf."""
    import torch
    if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
        return float("inf")
    fin = ~torch.isneginf(b)
    return (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0


def _by_row(ref, tensors, *rest):
    """``ref(*tensors, *rest)`` one batch row of ``tensors`` at a time, the
    outputs joined again: at one rank and L = 8192 the f32 scores of one
    row are 3.2 GB."""
    import torch
    parts = [ref(*(t[b:b + 1] for t in tensors), *rest)
             for b in range(tensors[0].shape[0])]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=0) for p in zip(*parts))
    return torch.cat(parts, dim=0)


def run_ring(shape, schedule, causal, seed, rotary=None):
    """A whole ring of ``shape["n"]`` virtual ranks through K4-K6 in this
    process: each rank with its own offsets and carried state, each k/v
    shard's dK/dV accumulators carried across the ranks that see it, in the
    order of the real ring. Returns (per-launch errors {kernel: {key:
    worst}}, errors of the assembled results {key: value}): every launch
    against its plain version on the same inputs, the assembled out, lse,
    dQ, dK, dV (natural order) against plain full attention in f32 and
    against K1-K3 over the whole sequence. With ``rotary`` (a base) the
    ring is assembled as ``parallel.ring`` runs it: each rank rotates its q
    shard and home k shard once with the ring's own ``rotate_shards`` (the
    pass), K4-K6 run without rotary on the copies (each launch against its
    plain version on the same copies), dQ and dK are counter-rotated after
    the last step by the ring's ``_counter_rotate``, and the whole-sequence
    references rotate (on the bf16 inputs, rounding the rotation as the
    pass does)."""
    import torch
    import horovod_tpu_torch.ops.flash_attention  # noqa: F401
    from horovod_tpu_torch.parallel.ring import (_counter_rotate,
                                                 _schedule_offsets,
                                                 _step_runs, rotate_shards,
                                                 zigzag_shard,
                                                 zigzag_unshard)
    fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]
    n, L, D = shape["n"], shape["L"], shape["D"]
    Ls, scale = L // n, D ** -0.5
    q, k, v, dout = _inputs(shape, seed)  # global, natural order
    zig = schedule == "zigzag"

    def unlay(parts):
        x = torch.cat(parts, dim=2)
        return zigzag_unshard(x, n, axis=2) if zig else x

    qs, ks, vs, dos = (torch.chunk(zigzag_shard(x, n, axis=2) if zig else x,
                                   n, dim=2) for x in (q, k, v, dout))

    def off(r):
        return _schedule_offsets(schedule, r, n, Ls)

    def runs(src, r):
        return _step_runs(causal, schedule, src, r, Ls, Ls)

    rb = rotary
    if rb is not None:  # the shards every step reads, rotated once
        qs, ks = zip(*(rotate_shards(qs[r], ks[r], off(r), off(r), rb)
                       for r in range(n)))
    errs = {name: {} for name in RING}

    def note(name, key, pair):
        mx, rel = _err(*pair)
        got = errs[name]
        got["max_abs_err"] = max(got.get("max_abs_err", 0.0), mx)
        got[key] = max(got.get(key, 0.0), rel)

    outs, lses = [], []
    for r in range(n):
        o = torch.zeros(qs[r].shape, device=q.device)
        m = torch.full(qs[r].shape[:3], float("-inf"), device=q.device)
        l = torch.zeros(qs[r].shape[:3], device=q.device)
        for i in range(n):
            src = (r - i) % n
            if not runs(src, r):
                continue
            args = (qs[r], ks[src], vs[src])
            ref = _by_row(fa.flash_ring_step_ref, (*args, o, m, l), off(r),
                          off(src), scale, causal)
            fa.flash_ring_step(*args, o, m, l, off(r), off(src), scale,
                               causal)
            torch.cuda.synchronize()
            note("flash_ring_step", "o_rel_l2_err", (o, ref[0]))
            note("flash_ring_step", "l_rel_l2_err", (l, ref[2]))
            e = errs["flash_ring_step"]
            e["m_abs_err"] = max(e.get("m_abs_err", 0.0), _m_err(m, ref[1]))
            del ref
        l1 = torch.where(l == 0.0, 1.0, l)
        outs.append((o / l1[..., None]).to(q.dtype))
        lses.append(m + torch.log(l1))
        del o, m, l

    deltas = [fa._delta(outs[r], dos[r]) for r in range(n)]
    dq = [torch.zeros(x.shape, device=q.device) for x in qs]
    dk = [torch.zeros(x.shape, device=q.device) for x in ks]
    dv = [torch.zeros(x.shape, device=q.device) for x in vs]
    for i in range(n):
        for r in range(n):
            src = (r - i) % n
            if not runs(src, r):
                continue
            args = (qs[r], ks[src], vs[src], dos[r], lses[r], deltas[r])
            offs = (off(r), off(src), scale, causal)
            before = [t.clone() for t in (dq[r], dk[src], dv[src])]
            ref_dq = _by_row(fa.flash_ring_bwd_dq_ref, (*args, dq[r]), *offs)
            ref_dk, ref_dv = _by_row(fa.flash_ring_bwd_dkv_ref,
                                     (*args, dk[src], dv[src]), *offs)
            fa.flash_ring_bwd_dq(*args, dq[r], *offs)
            fa.flash_ring_bwd_dkv(*args, dk[src], dv[src], *offs)
            torch.cuda.synchronize()
            # what this launch added, against what the plain version added
            note("flash_ring_bwd_dq", "dq_rel_l2_err",
                 (dq[r] - before[0], ref_dq - before[0]))
            note("flash_ring_bwd_dkv", "dk_rel_l2_err",
                 (dk[src] - before[1], ref_dk - before[1]))
            note("flash_ring_bwd_dkv", "dv_rel_l2_err",
                 (dv[src] - before[2], ref_dv - before[2]))
            del before, ref_dq, ref_dk, ref_dv

    if rb is not None:  # shard r's dk is home on rank r after the ring
        for r in range(n):
            dq[r], dk[r] = _counter_rotate(dq[r], dk[r], off(r), off(r), rb)
    got = dict(out=unlay(outs), lse=unlay(lses), dq=unlay(dq), dk=unlay(dk),
               dv=unlay(dv))
    del outs, lses, dq, dk, dv, deltas
    # Plain full attention in f32, one sequence at a time (at L = 8192 the
    # scores of one sequence are 3.2 GB).
    plain = {key: [] for key in got}
    for b in range(shape["B"]):
        f32 = [t[b:b + 1] if rb is not None else t[b:b + 1].float()
               for t in (q, k, v, dout)]
        out_p, lse_p = fa.flash_forward_ref(*f32[:3], scale, causal, rb)
        delta_p = fa._delta(out_p, f32[3])
        dk_p, dv_p = fa.flash_bwd_dkv_ref(*f32, lse_p, delta_p, scale, causal,
                                          rb)
        dq_p = fa.flash_bwd_dq_ref(*f32, lse_p, delta_p, scale, causal, rb)
        for key, t in zip(("out", "lse", "dq", "dk", "dv"),
                          (out_p, lse_p, dq_p, dk_p, dv_p)):
            plain[key].append(t)
        del f32, out_p, lse_p, delta_p, dk_p, dv_p, dq_p
        torch.cuda.empty_cache()
    plain = {key: torch.cat(t, dim=0) for key, t in plain.items()}
    out_k, lse_k = fa.flash_fwd(q, k, v, scale, causal, rb)
    delta_k = fa._delta(out_k, dout)
    dq_k = fa.flash_bwd_dq(q, k, v, dout, lse_k, delta_k, scale, causal, rb)
    dk_k, dv_k = fa.flash_bwd_dkv(q, k, v, dout, lse_k, delta_k, scale,
                                  causal, rb)
    torch.cuda.synchronize()
    flash = dict(out=out_k, lse=lse_k, dq=dq_k, dk=dk_k, dv=dv_k)
    assembled = {}
    for label, ref in (("plain", plain), ("k1_k3", flash)):
        for key in got:
            if key == "lse":
                assembled["%s_lse_abs_err" % label] = _m_err(got[key],
                                                            ref[key])
            else:
                assembled["%s_%s_rel_l2_err" % (label, key)] = _err(
                    got[key], ref[key])[1]
    return errs, assembled


def _ring_bound_ms(name, shape, diagonal):
    """Least time of one ring step at ``shape`` (Lq = Lk = L): the
    products over the bf16 peak (causal diagonal: the pairs it needs), or
    its bytes over the HBM rate (bf16 q, k, v, dO read once; f32 rows and
    state or accumulators read and written once)."""
    B, H, G, L, D = (shape[k] for k in "BHGLD")
    pairs = L * (L + 1) / 2 if diagonal else L * L
    t_ops = KERNELS[name][2] * 2.0 * B * H * pairs * D / PEAK_BF16_FLOPS
    act, kv = B * H * L * D * 2, B * G * L * D * 2
    rows, q_f32, kv_f32 = B * H * L * 4, B * H * L * D * 4, B * G * L * D * 4
    n_bytes = {"flash_ring_step": act + 2 * kv + 2 * q_f32 + 4 * rows,
               "flash_ring_bwd_dq": 2 * act + 2 * kv + 2 * rows + 2 * q_f32,
               "flash_ring_bwd_dkv": (2 * act + 2 * kv + 2 * rows
                                      + 4 * kv_f32)}[name]
    t_bytes = n_bytes / PEAK_BYTES
    return ((t_ops * 1e3, "operations") if t_ops >= t_bytes
            else (t_bytes * 1e3, "bytes"))


def ring_timings(seed):
    """K4-K6 timed at one ring step of the main shape, [2, 12, 2048, 64]:
    an off-diagonal step (every tile visible) and the diagonal step (causal,
    half the tiles); their plain versions at the off-diagonal step; SDPA
    forward and backward on the same block, non-causal. Then each at the
    sp phase's own launch (``sp_`` keys): [2, 12, 8192, 64], causal, one
    rank's zigzag chunks (0, 4096), K4 from a fresh state (the timed
    repeats carry it: the same tiles run), K5 and K6 on that state's lse;
    SDPA's causal forward and backward at that shape as the nearest
    yardstick."""
    import torch
    fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]
    shape = dict(RING_SHAPE, L=RING_SHAPE["L"] // RING_SHAPE["n"],
                 causal=False)
    Ls, scale = shape["L"], shape["D"] ** -0.5
    q, k, v, dout = _inputs(shape, seed)
    o, m, l = fa.flash_ring_step_ref(
        q, k, v, torch.zeros(q.shape, device=q.device),
        torch.full(q.shape[:3], float("-inf"), device=q.device),
        torch.zeros(q.shape[:3], device=q.device), (0,), (0,), scale, False)
    lse = m + torch.log(l)
    delta = fa._delta((o / l[..., None]).to(q.dtype), dout)
    dq = torch.zeros(q.shape, device=q.device)
    dk, dv = (torch.zeros(k.shape, device=q.device) for _ in range(2))
    steps = {"": ((Ls,), (0,)), "diag_": ((0,), (0,))}
    rows = {name: {} for name in RING}
    for label, (qo, ko) in steps.items():
        runs = {
            "flash_ring_step": lambda: fa.flash_ring_step(
                q, k, v, o, m, l, qo, ko, scale, True),
            "flash_ring_bwd_dq": lambda: fa.flash_ring_bwd_dq(
                q, k, v, dout, lse, delta, dq, qo, ko, scale, True),
            "flash_ring_bwd_dkv": lambda: fa.flash_ring_bwd_dkv(
                q, k, v, dout, lse, delta, dk, dv, qo, ko, scale, True),
        }
        for name, fn in runs.items():
            rows[name][label + "ms"] = time_ms(fn)
            bound, by = _ring_bound_ms(name, shape, diagonal=bool(label))
            rows[name][label + "bound_ms"] = bound
            rows[name][label + "bound_by"] = by
    qo, ko = steps[""]
    plain = {
        "flash_ring_step": lambda: fa.flash_ring_step_ref(
            q, k, v, o, m, l, qo, ko, scale, True),
        "flash_ring_bwd_dq": lambda: fa.flash_ring_bwd_dq_ref(
            q, k, v, dout, lse, delta, dq, qo, ko, scale, True),
        "flash_ring_bwd_dkv": lambda: fa.flash_ring_bwd_dkv_ref(
            q, k, v, dout, lse, delta, dk, dv, qo, ko, scale, True),
    }
    for name, fn in plain.items():
        rows[name]["plain_ms"] = time_ms(fn, n=5, reps=3, warmup=1)
    library = sdpa_times(q, k, v, dout, False, scale)
    for name in RING:
        rows[name]["library_ms"] = library["sdpa_fwd_ms" if name ==
                                           "flash_ring_step" else
                                           "sdpa_bwd_ms"]
        rows[name]["library"] = (
            "scaled_dot_product_attention %s on the same block, non-causal: "
            "the nearest yardstick, not the same function (no carried "
            "state)" % ("forward" if name == "flash_ring_step" else
                        "backward (dQ, dK, dV in one call)"))
    del q, k, v, dout, o, m, l, lse, delta, dq, dk, dv

    sp = dict(RING_SP, causal=True)
    q, k, v, dout = _inputs(sp, seed + 1)
    offs = (0, sp["L"] // 2)
    o = torch.zeros(q.shape, device=q.device)
    m = torch.full(q.shape[:3], float("-inf"), device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    fa.flash_ring_step(q, k, v, o, m, l, offs, offs, scale, True)
    lse = m + torch.log(l)
    delta = fa._delta((o / l[..., None]).to(q.dtype), dout)
    dq = torch.zeros(q.shape, device=q.device)
    dk, dv = (torch.zeros(k.shape, device=q.device) for _ in range(2))
    runs = {
        "flash_ring_step": lambda: fa.flash_ring_step(
            q, k, v, o, m, l, offs, offs, scale, True),
        "flash_ring_bwd_dq": lambda: fa.flash_ring_bwd_dq(
            q, k, v, dout, lse, delta, dq, offs, offs, scale, True),
        "flash_ring_bwd_dkv": lambda: fa.flash_ring_bwd_dkv(
            q, k, v, dout, lse, delta, dk, dv, offs, offs, scale, True),
    }
    library = sdpa_times(q, k, v, dout, True, scale)
    for name, fn in runs.items():
        r = rows[name]
        r["sp_ms"] = time_ms(fn)
        r["sp_bound_ms"], r["sp_bound_by"] = _ring_bound_ms(name, sp,
                                                            diagonal=True)
        r["sp_library_ms"] = library["sdpa_fwd_ms" if name ==
                                     "flash_ring_step" else "sdpa_bwd_ms"]
    return rows


def ring_rot_wrappers(seed):
    """K4-K6 through their wrappers with ``rotary_base`` at the lc_sp
    phase's launch (LC_SP: one rank, 6 heads of 128 on 2 kv heads, zigzag
    chunks (0, 4096), the positions 0..8191): each call (the pass over q and
    k, then the kernel without rotary on the copies) against the rotary
    plain version (one batch row at a time) from a fresh state or zero
    sums, and timed beside the same launch without rotary (``norot_ms``),
    its bound, its plain version and SDPA's causal forward and backward
    (enable_gqa) on q and k rotated beforehand, the rotation apart.
    Returns ({name_rot: errors}, {name_rot: times})."""
    import torch
    fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]
    rb, sp = ROPE_BASE, dict(LC_SP, causal=True)
    q, k, v, dout = _inputs(sp, seed)
    offs, scale = (0, sp["L"] // 2), sp["D"] ** -0.5
    o = torch.zeros(q.shape, device=q.device)
    m = torch.full(q.shape[:3], float("-inf"), device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    errs = {name + "_rot": {} for name in RING}
    ref = _by_row(fa.flash_ring_step_ref, (q, k, v, o, m, l), offs, offs,
                  scale, True, rb)
    fa.flash_ring_step(q, k, v, o, m, l, offs, offs, scale, True, rb)
    torch.cuda.synchronize()
    e = errs["flash_ring_step_rot"]
    for key, a, b in (("o", o, ref[0]), ("l", l, ref[2])):
        mx, e[key + "_rel_l2_err"] = _err(a, b)
        e["max_abs_err"] = max(e.get("max_abs_err", 0.0), mx)
    e["m_abs_err"] = _m_err(m, ref[1])
    del ref
    lse = m + torch.log(l)
    delta = fa._delta((o / l[..., None]).to(q.dtype), dout)
    dq = torch.zeros(q.shape, device=q.device)
    dk, dv = (torch.zeros(k.shape, device=q.device) for _ in range(2))
    args = (q, k, v, dout, lse, delta)
    ref_dq = _by_row(fa.flash_ring_bwd_dq_ref, (*args, dq), offs, offs,
                     scale, True, rb)
    ref_dk, ref_dv = _by_row(fa.flash_ring_bwd_dkv_ref, (*args, dk, dv),
                             offs, offs, scale, True, rb)
    got_dq = fa.flash_ring_bwd_dq(*args, dq.clone(), offs, offs, scale, True,
                                  rb)
    got_dk, got_dv = fa.flash_ring_bwd_dkv(*args, dk.clone(), dv.clone(),
                                           offs, offs, scale, True, rb)
    torch.cuda.synchronize()
    for name, pairs in (("flash_ring_bwd_dq", (("dq", got_dq, ref_dq),)),
                        ("flash_ring_bwd_dkv", (("dk", got_dk, ref_dk),
                                                ("dv", got_dv, ref_dv)))):
        e = errs[name + "_rot"]
        for key, a, b in pairs:
            mx, e[key + "_rel_l2_err"] = _err(a, b)
            e["max_abs_err"] = max(e.get("max_abs_err", 0.0), mx)
    del ref_dq, ref_dk, ref_dv, got_dq, got_dk, got_dv
    torch.cuda.empty_cache()
    # (the kernel, given a rotary base or None; the rotary plain version)
    runs = {
        "flash_ring_step": (
            lambda b: fa.flash_ring_step(q, k, v, o, m, l, offs, offs, scale,
                                         True, b),
            lambda: _by_row(fa.flash_ring_step_ref, (q, k, v, o, m, l), offs,
                            offs, scale, True, rb)),
        "flash_ring_bwd_dq": (
            lambda b: fa.flash_ring_bwd_dq(*args, dq, offs, offs, scale, True,
                                           b),
            lambda: _by_row(fa.flash_ring_bwd_dq_ref, (*args, dq), offs,
                            offs, scale, True, rb)),
        "flash_ring_bwd_dkv": (
            lambda b: fa.flash_ring_bwd_dkv(*args, dk, dv, offs, offs, scale,
                                            True, b),
            lambda: _by_row(fa.flash_ring_bwd_dkv_ref, (*args, dk, dv), offs,
                            offs, scale, True, rb)),
    }
    pos = fa.shard_positions(offs, q.shape[2], q.device)
    lib = rotated_sdpa_times(q, k, v, dout, True, scale, rb, pos, pos)
    rows = {}
    for name, (kern, plain) in runs.items():
        r = rows[name + "_rot"] = {}
        r["ms"] = time_ms(lambda: kern(rb))
        r["norot_ms"] = time_ms(lambda: kern(None))
        r["plain_ms"] = time_ms(plain, n=2, reps=3, warmup=1)
        r["bound_ms"], r["bound_by"] = _ring_bound_ms(name, sp, diagonal=True)
        r["library_ms"] = lib["sdpa_fwd_ms" if name == "flash_ring_step"
                              else "sdpa_bwd_ms"]
        r["rotate_ms"] = lib["rotate_ms"]
        r["library"] = lib["note"] + " (causal; the nearest yardstick: no "
        r["library"] += "carried state)"
    return errs, rows


def phase_ring_kernels():
    """K4-K6 through whole rings (RING_RUNS) against their plain versions,
    plain full attention and K1-K3, and K4-K6 through their wrappers with
    rotary at the lc_sp launch; then their times. Returns {name: row}."""
    import torch
    rows = {name: {} for name in RING + RING_ROT}
    assembled, bad = {}, []

    def check(label, per_launch):
        for name, errs in per_launch.items():
            log("%s %s: %s" % (name, label, ", ".join(
                "%s %.3g" % kv for kv in sorted(errs.items()))))
            for key, val in errs.items():
                rows[name]["%s_%s" % (label, key)] = val
                limit = (LSE_TOL if key == "m_abs_err" else
                         REL_TOL if key.endswith("rel_l2_err") else None)
                if limit is not None and not val <= limit:
                    bad.append("%s, %s: %s %.3g > %g"
                               % (name, label, key, val, limit))

    for seed, (tag, shape, schedule, causal, rb) in enumerate(RING_RUNS):
        label = "%s_%s_%s" % (tag, schedule, "causal" if causal else "full")
        per_launch, whole = run_ring(shape, schedule, causal, seed + 10, rb)
        torch.cuda.empty_cache()
        check(label, per_launch)
        log("ring %s assembled: %s" % (label, ", ".join(
            "%s %.3g" % kv for kv in sorted(whole.items()))))
        for key, val in whole.items():
            assembled["%s_%s" % (label, key)] = val
            limit = LSE_TOL if key.endswith("lse_abs_err") else REL_TOL
            if not val <= limit:
                bad.append("%s ring assembled: %s %.3g > %g"
                           % (label, key, val, limit))
    per_launch, rot_rows = ring_rot_wrappers(seed=21)
    torch.cuda.empty_cache()
    check("lc_sp_wrappers", per_launch)
    if bad:
        fail("ring kernels disagree: " + "; ".join(bad))
    for name in RING:
        rows[name]["odd_rel_l2_err"] = max(
            v for k, v in rows[name].items()
            if k.startswith("odd_") and k.endswith("rel_l2_err"))
    for name in ("flash_ring_step", "flash_ring_step_rot"):
        rows[name]["lse_abs_err"] = max(v for k, v in rows[name].items()
                                        if k.endswith("m_abs_err"))
    for name, timing in {**ring_timings(seed=20), **rot_rows}.items():
        rows[name].update(timing)
        if name in RING_ROT:
            log("%s at the lc_sp launch: %.4f ms (without rotary %.4f, bound "
                "%.4f, plain %.3f, SDPA causal on rotated q, k %.4f + "
                "rotation %.4f)" % (name, timing["ms"], timing["norot_ms"],
                                    timing["bound_ms"], timing["plain_ms"],
                                    timing["library_ms"],
                                    timing["rotate_ms"]))
            continue
        log("%s: off-diagonal %.4f ms (bound %.4f, plain %.3f, SDPA %.4f), "
            "diagonal %.4f ms (bound %.4f); sp launch %.4f ms (bound %.4f, "
            "SDPA causal %.4f)" % (
                name, timing["ms"], timing["bound_ms"], timing["plain_ms"],
                timing["library_ms"], timing["diag_ms"],
                timing["diag_bound_ms"], timing["sp_ms"],
                timing["sp_bound_ms"], timing["sp_library_ms"]))
    torch.cuda.empty_cache()
    print("ring_kernels: " + json.dumps(dict(
        assembled=assembled, times={n: {k: v for k, v in r.items()
                                        if "ms" in k} for n, r in
                                    rows.items()})), flush=True)
    return rows


def phase_sp(profile_dir=None, lc=False):
    """The sequence-parallel LM step (ring attention, zigzag) at full width
    on a one-rank "sp" axis; returns K4-K6's launch counts of its 7 steps.
    ``lc``: the long-context GQA LM (LC_MODEL) with fused rotary instead
    (phase lc_sp): the rotary pass over the q shard and the k shard in the
    forward, K4-K6 on the copies; 2 warm-up and 3 timed steps."""
    import dataclasses
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.ops.flash_attention import (launch_counts,
                                                       reset_launch_counts)
    from horovod_tpu_torch.parallel import (hybrid_mesh, make_train_step,
                                            shard_lm_loss, zigzag_shard)

    hvd.init()
    dev = hvd.device()
    mesh = hybrid_mesh((hvd.size(),), ("sp",))
    n, rank = mesh.size("sp"), mesh.rank("sp")
    tag = "lc_sp" if lc else "sp"
    cfg = TransformerConfig(attention="ring", sp_axis="sp",
                            sp_schedule="zigzag", dtype=torch.bfloat16,
                            max_seq_len=8192, rope_fused=lc,
                            **(LC_MODEL if lc else MODEL))
    # launches a step: one ring step a layer of each kernel; with rotary,
    # also the forward's pass over the q shard and the k shard, whose copies
    # K4, K5 and K6 read
    per_layer = dict({name: 1 for name in RING}, **({ROPE: 2} if lc else {}))
    kernels = {name: n * cfg.num_layers for name, n in per_layer.items()}
    B, L = SP_BATCH
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, L), device=dev,
                           generator=torch.Generator(device=dev
                                                     ).manual_seed(1))
    # Labels shifted in natural order, then every array laid out in zigzag
    # order and cut into the ranks' shards (examples/jax_zigzag_lm.py).
    whole = {"tokens": tokens,
             "positions": torch.arange(L, device=dev).expand(B, L),
             "labels": torch.roll(tokens, -1, dims=1)}
    batch = {key: torch.chunk(zigzag_shard(t, n), n, dim=1)[rank]
             for key, t in whole.items()}
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    # The same weights through the flash model: at one rank the shard is
    # the whole sequence in natural order (zigzag_shard at n = 1 is the
    # identity), so the first loss and every parameter's gradient must
    # agree. Dense attention is out of reach at L = 8192 (6.4 GB of scores
    # a layer).
    if n != 1:
        fail("the sp phase compares against the flash model on one rank")
    flash = Transformer(dataclasses.replace(cfg, attention="flash"),
                        device=dev)
    flash.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss_flash = shard_lm_loss(flash, batch).item()
    small = {key: t[:SP_GRAD_BATCH] for key, t in batch.items()}
    grad_gaps = gradient_gaps(model, flash, small, shard_lm_loss)
    del flash
    torch.cuda.empty_cache()
    worst = max(grad_gaps, key=grad_gaps.get)
    log("%s gradient gap ring vs flash attention at %d x %d: worst %s %.3g, "
        "median %.3g" % (tag, SP_GRAD_BATCH, L, worst, grad_gaps[worst],
                         statistics.median(grad_gaps.values())))
    if not grad_gaps[worst] <= GRAD_TOL:
        fail("gradients through the ring kernels disagree with the flash "
             "model: %s %.3g > %g" % (worst, grad_gaps[worst], GRAD_TOL))

    passes = pass_launches(model, batch, shard_lm_loss, kernels.get(ROPE, 0),
                           tag) if lc else None
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(),
                                                    lr=1e-4),
                                   model.named_parameters())
    step = make_train_step(model, shard_lm_loss, opt)
    warmup, timed = 2, 3 if lc else 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(batch).item()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log("%s step %d: loss %.5f, %.1f ms" % (tag, i, loss,
                                                 times[-1] * 1e3))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = warmup + timed

    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        fail("non-finite sp loss: %s" % losses)
    if not losses[-1] < losses[0]:
        fail("sp loss did not fall: %s" % losses)
    for name, c in counts.items():
        per_step = kernels.get(name, 0)
        if c != per_step * steps:
            fail("%s launched %d times in %d %s steps, expected %d per step"
                 % (name, c, steps, tag, per_step))
    rel = abs(losses[0] - loss_flash) / abs(loss_flash)
    log("%s first loss %.6f, flash model %.6f, rel %.3g"
        % (tag, losses[0], loss_flash, rel))
    if not rel <= 2e-2:
        fail("sp first loss %.6f vs the flash model %.6f (rel %.3g)"
             % (losses[0], loss_flash, rel))

    step_s = statistics.median(times[warmup:])
    result = dict(step_ms=step_s * 1e3, tokens_per_s=B * L / step_s,
                  peak_mem_gb=peak / 1e9,
                  tflops=lm_step_flops(cfg, B, L) / step_s / 1e12,
                  loss_first=losses[0], loss_last=losses[-1],
                  loss_flash=loss_flash, grad_gap_worst=grad_gaps[worst],
                  launches=counts, steps=steps, ranks=n)
    if passes:
        result["pass_launches_forward_backward"] = passes
    print("%s: %s" % (tag, json.dumps(result)), flush=True)
    if profile_dir:
        profile_steps(step, batch, profile_dir, tag)
    hvd.shutdown()
    return {name: counts[name] for name in kernels}


def pass_launches(model, batch, loss_fn, want, label):
    """(launches of the rotary pass in one loss's forward, in its backward)
    on ``batch``, the .grad fields left alone. The forward must launch
    ``want`` (two a layer) and the backward none: autograd keeps the
    forward's rotated q and k."""
    import torch
    fa = sys.modules["horovod_tpu_torch.ops.flash_attention"]
    before = fa.launch_counts()[ROPE]
    loss = loss_fn(model, batch)
    mid = fa.launch_counts()[ROPE]
    torch.autograd.grad(loss, [p for p in model.parameters()
                               if p.requires_grad])
    torch.cuda.synchronize()
    passes = (mid - before, fa.launch_counts()[ROPE] - mid)
    log("%s: %d launches of the rotary pass in the loss's forward, %d in "
        "its backward" % ((label,) + passes))
    if passes != (want, 0):
        fail("%s launched the rotary pass %d times in the forward and %d in "
             "the backward of one loss, expected %d and 0" % (
                 (label,) + passes + (want,)))
    return passes


def lm_step_flops(cfg, B, L):
    """FLOPs of one LM training step: 6 per matmul parameter and token
    (GQA: the k and v projections at G heads) and the flash kernels'
    analytic count (causal, forward and backward)."""
    from horovod_tpu_torch.ops import analytic_attention_flops
    E, F_, V = cfg.embed_dim, cfg.mlp_dim, cfg.vocab_size
    H = cfg.num_heads
    G = cfg.num_kv_heads or H
    D = cfg.head_dim or E // H
    matmul_params = (cfg.num_layers * (2 * E * H * D + 2 * E * G * D +
                                       2 * E * F_) + E * V)
    return (6.0 * matmul_params * B * L + cfg.num_layers *
            analytic_attention_flops(B, H, L, D, causal=True, training=True))


def phase_lc(profile_dir=None):
    """The long-context GQA LM (LC_MODEL: 6 heads of 128 on 2 kv heads,
    fused rotary through K1_rot-K3_rot, the streaming loss) at 2 x 8192
    tokens: the gradient check against dense attention with rotary outside
    at 2 x 2048, the first loss against it at 2 x 8192, the gradient check
    against rope_fused=False (rotary outside, K1-K3) at 2 x 8192, then 2
    warm-up and
    5 timed Adam steps through make_train_step and lm_loss_streaming, a
    profile of 3 more (device busy and idle), and the same step with
    rope_fused=False on the same weights (K1-K3 and rotary outside) timed
    and profiled the same way. Returns K1_rot-K3_rot's launch counts."""
    import dataclasses
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.ops.flash_attention import (launch_counts,
                                                       reset_launch_counts)
    from horovod_tpu_torch.parallel import (lm_loss_streaming,
                                            make_train_step)

    hvd.init()
    dev = hvd.device()
    cfg = TransformerConfig(attention="flash", rope_fused=True,
                            dtype=torch.bfloat16, max_seq_len=8192,
                            **LC_MODEL)
    B, L = LC_BATCH
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, L), device=dev,
                           generator=torch.Generator(device=dev
                                                     ).manual_seed(1))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    init = {k: t.clone() for k, t in model.state_dict().items()}

    # The same weights through dense attention, which rotates q and k
    # outside (rope_fused has no kernel to go into there): every
    # parameter's gradient at 2 x 2048, and the first loss at 2 x 8192 (6
    # heads: 3.2 GB of f32 scores a layer, without gradients).
    dense = Transformer(dataclasses.replace(cfg, attention="dense"),
                        device=dev)
    dense.load_state_dict(model.state_dict())
    grad_gaps = gradient_gaps(model, dense, tokens[:, :LC_GRAD_LEN],
                              lm_loss_streaming)
    worst = max(grad_gaps, key=grad_gaps.get)
    log("lc gradient gap fused-rotary flash vs dense at %d x %d: worst %s "
        "%.3g, median %.3g" % (B, LC_GRAD_LEN, worst, grad_gaps[worst],
                               statistics.median(grad_gaps.values())))
    if not grad_gaps[worst] <= GRAD_TOL:
        fail("lc gradients through K1_rot-K3_rot disagree with dense "
             "attention: %s %.3g > %g" % (worst, grad_gaps[worst], GRAD_TOL))
    with torch.no_grad():
        loss_plain = lm_loss_streaming(dense, tokens).item()
    del dense
    torch.cuda.empty_cache()
    # Every position: the same weights with rotary outside the kernels
    # (apply_rotary, then K1-K3 without rotary), every parameter's gradient
    # at 2 x 8192. At the seeded initialisation the loss is about ln(vocab)
    # whatever attention does, so only the gradients see the rotation and
    # the mask past the dense check's 2048 positions.
    unfused_model = Transformer(dataclasses.replace(cfg, rope_fused=False),
                                device=dev)
    unfused_model.load_state_dict(init)
    full_gaps = gradient_gaps(model, unfused_model, tokens,
                              lm_loss_streaming)
    full_worst = max(full_gaps, key=full_gaps.get)
    log("lc gradient gap fused vs unfused rotary at %d x %d: worst %s %.3g, "
        "median %.3g" % (B, L, full_worst, full_gaps[full_worst],
                         statistics.median(full_gaps.values())))
    if not full_gaps[full_worst] <= GRAD_TOL:
        fail("lc gradients through K1_rot-K3_rot at %d x %d disagree with "
             "rotary outside K1-K3: %s %.3g > %g"
             % (B, L, full_worst, full_gaps[full_worst], GRAD_TOL))
    del init
    torch.cuda.empty_cache()
    passes = pass_launches(model, tokens, lm_loss_streaming,
                           2 * cfg.num_layers, "lc")

    def run(m, kernels, label):
        opt = hvd.DistributedOptimizer(torch.optim.Adam(m.parameters(),
                                                        lr=1e-4),
                                       m.named_parameters())
        step = make_train_step(m, lm_loss_streaming, opt)
        warmup, timed = 2, 5
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, times = [], []
        for i in range(warmup + timed):
            t0 = time.perf_counter()
            loss = step(tokens).item()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            log("%s step %d: loss %.5f, %.1f ms" % (label, i, loss,
                                                     times[-1] * 1e3))
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = warmup + timed
        if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
            fail("non-finite %s loss: %s" % (label, losses))
        if not losses[-1] < losses[0]:
            fail("%s loss did not fall: %s" % (label, losses))
        for name, c in counts.items():
            per_step = kernels.get(name, 0)
            if c != per_step * steps:
                fail("%s launched %d times in %d %s steps, expected %d per "
                     "step" % (name, c, steps, label, per_step))
        step_s = statistics.median(times[warmup:])
        result = dict(step_ms=step_s * 1e3, tokens_per_s=B * L / step_s,
                      peak_mem_gb=peak / 1e9,
                      tflops=lm_step_flops(cfg, B, L) / step_s / 1e12,
                      loss_first=losses[0], loss_last=losses[-1],
                      launches_per_step={n: c // steps for n, c in
                                         counts.items() if c},
                      steps=steps)
        result.update(profile_steps(step, tokens, profile_dir, label))
        return result, counts

    # K1_rot-K3_rot once a layer, and the forward's pass over q and k
    fused, counts = run(model, dict({n: cfg.num_layers for n in FLASH_ROT},
                                    **{ROPE: 2 * cfg.num_layers}), "lc")
    rel = abs(fused["loss_first"] - loss_plain) / abs(loss_plain)
    log("lc first loss %.6f, dense attention %.6f, rel %.3g"
        % (fused["loss_first"], loss_plain, rel))
    if not rel <= 2e-2:
        fail("lc first loss %.6f vs dense attention %.6f (rel %.3g)"
             % (fused["loss_first"], loss_plain, rel))
    fused.update(loss_plain=loss_plain, grad_gap_worst=grad_gaps[worst],
                 grad_gap_worst_unfused_full=full_gaps[full_worst],
                 pass_launches_forward_backward=passes)
    # the same weights and step with rotary outside the kernels
    del model
    torch.cuda.empty_cache()
    unfused, _ = run(unfused_model, {n: cfg.num_layers for n in FLASH},
                     "lc_unfused")
    print("lc: " + json.dumps(dict(fused, rope_fused_false=unfused)),
          flush=True)
    hvd.shutdown()
    return {name: counts[name] for name in FLASH_ROT + (ROPE,)}


def gradient_gaps(model, dense, tokens, loss_fn):
    """{parameter: ||g_model - g_dense||_2 / ||g_dense||_2} of one loss on
    ``tokens`` (any batch ``loss_fn`` takes); the .grad fields are left
    alone."""
    import torch
    names = [n for n, _ in model.named_parameters()]
    g_model = torch.autograd.grad(loss_fn(model, tokens),
                                  list(model.parameters()))
    g_dense = torch.autograd.grad(loss_fn(dense, tokens),
                                  list(dense.parameters()))
    return {n: ((a.float() - b.float()).norm() /
                b.float().norm().clamp_min(1e-30)).item()
            for n, a, b in zip(names, g_model, g_dense)}


def _category(name, model):
    low = name.lower()
    if "rope_rotate" in low:  # hvdflash::rope_rotate_kernel
        return "rotary pass"
    # K4-K6 are the ring instantiations of the flash mainloops:
    # flash_fwd_kernel<D, true, ...>, flash_bwd_kernel<D, kDkv, true, ...>
    if re.search(r"flash_(fwd_kernel<\d+|bwd_kernel<\d+, \w+), true,", low):
        return "ring kernels"
    if "flash" in low:
        return "flash kernels"
    if "hvdbn" in low:  # K7, K8 (bn_stats_kernel) and the passes
        return ("batch-norm passes" if "apply" in low or "dx_kernel" in low
                else "batch-norm statistics")
    # cuDNN's and CUTLASS's kernels: convolutions in the ResNet, the
    # matmuls in the LM
    if any(s in low for s in ("gemm", "xmma", "nvjet", "cutlass", "sm90_",
                              "conv", "dgrad", "wgrad", "fprop")):
        return ("convolutions" if model.startswith(("resnet", "inception"))
                else "matmuls")
    if "multi_tensor_apply" in low:
        return "optimizer"
    if "nccl" in low:
        return "collectives"
    return "other kernels"


def profile_steps(step, tokens, out_dir, model, n=3):
    """Device time by kernel over ``n`` steps (torch.profiler), the device's
    busy share of the window, and the top kernels, printed and returned;
    the full table goes to ``out_dir``/chip_smoke_<model>_profile.txt when
    ``out_dir`` is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(tokens).item()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # Device-side rows only: kernels and copies. The CPU ops that launched
    # them carry the same time again, and user annotations span other rows.
    # (Kernel names may hold "#", as "{lambda(int)#1}" in PyTorch's
    # elementwise kernels: an earlier filter on "#" dropped those.)
    kernels = sorted(((dev_us(e) / 1e3 / n, e.count // n, e.key)
                      for e in avgs if dev_us(e) > 0
                      and str(e.device_type).endswith("CUDA")
                      and not getattr(e, "is_user_annotation", False)),
                     reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    cats = {}
    for ms, _, name in kernels:
        c = _category(name, model)
        cats[c] = cats.get(c, 0.0) + ms
    summary = dict(step_ms=window_ms / n, device_busy_ms=busy_ms,
                   idle_share=1.0 - busy_ms * n / window_ms,
                   by_category_ms=cats,
                   top=[dict(ms=ms, calls=c, name=name[:90])
                        for ms, c, name in kernels[:12]])
    print("profile %s: %s" % (model, json.dumps(summary)), flush=True)
    if out_dir:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / ("chip_smoke_%s_profile.txt" % model)).write_text(avgs.table(
            sort_by="self_device_time_total", row_limit=60))
    return dict(device_busy_ms=busy_ms, idle_share=summary["idle_share"],
                by_category_ms=cats)


def _same(a, b):
    """Equal tensors, NaN where NaN."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _abs_gap(a, b):
    """max |a - b| over the elements that differ (NaN in both counts as
    equal); inf where one is NaN or infinite and the other not."""
    import torch
    a, b = a.float(), b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return torch.nan_to_num(d, nan=float("inf"),
                            posinf=float("inf")).max().item()


def _wire_inputs(n, seed):
    """x f32 [n] (N(0, 1) times 1e-3, a gradient's scale) and an f32
    accumulator, on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda") * 1e-3
    acc = torch.randn(n, generator=g, device="cuda") * 1e-3
    return x, acc


def _special_blocks():
    """5 blocks of 256: one holding a NaN, one +inf and -inf, one of
    zeros, one of ties (k + 0.5 with max 127: scale 1, so x * inv is the
    tie itself), one holding a huge value."""
    import torch
    x = torch.randn(5 * 256, generator=torch.Generator().manual_seed(5))
    x[17] = float("nan")
    x[256 + 3] = float("inf")
    x[256 + 90] = float("-inf")
    x[512:768] = 0.0
    x[768:1024] = (torch.arange(256) % 9 - 4) + 0.5
    x[1000] = 127.0
    x[1100] = 3e38
    return x.cuda()


def _wire_bytes(name, mode, c):
    """Bytes a codec call must move for a chunk of c f32 elements: each
    input read once, each output written once."""
    payload = 2 * c if mode == "bf16" else c + 4 * (c // 256)
    if name == "wire_encode":
        return 4 * c + payload
    return payload + 8 * c  # decode-add reads acc and writes it


def _wire_bound_ms(name, mode, c):
    t_bytes = _wire_bytes(name, mode, c) / PEAK_BYTES * 1e3
    t_ops = KERNELS[name][2] * c / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _plain_codec(ring, wc):
    """The ring's codec on the plain versions: the same schedule, no
    kernel."""
    class Plain(ring.RingCodec):
        def encode(self, chunk):
            if self.mode.mode == 0:
                return (chunk,)
            return wc.wire_encode_ref(chunk, self.mode)

        def decode_into(self, dst, payload, add):
            if self.mode.mode == 0:
                return super().decode_into(dst, payload, add)
            return wc.wire_decode_add_ref(dst, payload, self.mode, add)

    return Plain


def _check_codec_calls(wc, label, x, rows, bad):
    """Both kernels in both modes on x (and an accumulator) against their
    plain versions: equal (NaN where NaN); the decode-add also with
    add=False."""
    acc = _wire_inputs(x.numel(), 7)[1]
    first = len(bad)
    for mode in ("bf16", "int8"):
        got, ref = wc.wire_encode(x, mode), wc.wire_encode_ref(x, mode)
        equal = all(_same(a, b) for a, b in zip(got, ref))
        gap = max(_abs_gap(a, b) for a, b in zip(got, ref))
        rows["wire_encode"]["%s_%s_max_abs_err" % (label, mode)] = gap
        if not equal:
            bad.append("wire_encode %s %s differs from its plain version "
                       "(max gap %.3g)" % (mode, label, gap))
        for add in (True, False):
            got_acc = wc.wire_decode_add(acc.clone(), ref, mode, add)
            ref_acc = wc.wire_decode_add_ref(acc.clone(), ref, mode, add)
            gap = _abs_gap(got_acc, ref_acc)
            key = "%s_%s%s_max_abs_err" % (label, mode, "" if add
                                           else "_into")
            rows["wire_decode_add"][key] = gap
            if not _same(got_acc, ref_acc):
                bad.append("wire_decode_add %s %s (add=%s) differs from its "
                           "plain version (max gap %.3g)"
                           % (mode, label, add, gap))
        del got, ref
    log("wire codec %s (%d elements): %s" % (label, x.numel(), "; ".join(
        bad[first:]) or "equal"))


def _run_rings(ring, wc, codec_cls, mode, xs, c, n):
    """The three schedules over n virtual ranks on the flat vectors xs:
    (allreduce chunks [n][n, c], reduce-scatter chunks [n][c], allgather of
    those [n][n * c]), and the codec's launches in each schedule."""
    import torch
    launches = {}

    def run(label, schedules):
        wc.reset_launch_counts()
        out = ring.drive_virtual(schedules)
        torch.cuda.synchronize()
        launches[label] = wc.launch_counts()
        return out

    chunks = [ring._padded(x, n, c) for x in xs]
    run("allreduce", [ring.allreduce_schedule(chunks[r], r, n,
                                              codec_cls(mode))
                      for r in range(n)])
    rs = [ring._padded(x, n, c) for x in xs]
    shards = [s.clone() for s in run("reduce_scatter", [
        ring.reduce_scatter_schedule(rs[r], r, n, codec_cls(mode))
        for r in range(n)])]
    del rs
    gathered = [torch.zeros(n, c, device="cuda") for _ in range(n)]
    run("allgather", [ring.allgather_schedule(shards[r], gathered[r], r, n,
                                              codec_cls(mode))
                      for r in range(n)])
    return (chunks, shards, [g.view(-1) for g in gathered]), launches


def _ring_launches(n):
    """Codec launches of each schedule over n ranks (all ranks): the
    allreduce encodes n - 1 hops and the owned chunk once and decodes n - 1
    adds, the owner's copy and n - 1 forwarded payloads; the reduce-scatter
    leg n - 1 of each; the allgather leg one encode and n decodes."""
    return {"allreduce": {"wire_encode": n * n,
                          "wire_decode_add": n * (2 * n - 1)},
            "reduce_scatter": {"wire_encode": n * (n - 1),
                               "wire_decode_add": n * (n - 1)},
            "allgather": {"wire_encode": n, "wire_decode_add": n * n}}


def _decode_add_library(acc, payload, mode):
    """The one PyTorch call that computes the decode-add: ``acc.add_(p)``
    for bf16 (p promoted to f32); for int8 ``addcmul_`` of q (promoted to
    f32) by each block's scale, acc + q * s over [blocks, 256] views."""
    if mode == "bf16":
        return lambda: acc.add_(payload[0])
    q, scales = payload
    rows = acc.view(-1, WIRE_BLOCK)
    return lambda: rows.addcmul_(q.view(-1, WIRE_BLOCK), scales.view(-1, 1))


def _check_decode_add_library(wc, acc, payload, mode, bad):
    """The library call computes the decode-add: on a copy of acc, within
    WIRE_LIBRARY_TOL of max |result| of the plain version (it may fuse the
    multiply and the add into one rounding)."""
    import torch
    want = wc.wire_decode_add_ref(acc.clone(), payload, mode)
    got = acc.clone()
    _decode_add_library(got, payload, mode)()
    err = ((got - want).abs().max() / want.abs().max()).item()
    log("wire_decode_add %s: the library call against the plain version, "
        "%.3g of max |result|" % (mode, err))
    if not err <= WIRE_LIBRARY_TOL:
        bad.append("the %s decode-add's library call is %.3g of max |result| "
                   "off the plain version (limit %g)"
                   % (mode, err, WIRE_LIBRARY_TOL))
    del want, got
    torch.cuda.empty_cache()


def phase_wire_kernels():
    """The wire codec kernels (``wire_encode``, ``wire_decode_add``) in
    both modes against their plain versions, equal (NaN where NaN), at one
    ring chunk of the LM's flat gradient over 4 ranks, at 4 blocks and on
    blocks holding NaN, +inf, zeros; timed at the LM chunk beside their
    bounds and the PyTorch call that computes the same function, where one
    does (all but the int8 encode).
    Then the three ring schedules over 4 virtual ranks on the LM's flat
    gradient size, in bf16, int8 and none, through the kernels and through
    the plain versions: equal; the allreduce within WIRE_SUM_TOL of the f32
    sum and the same on every rank; the launches counted. Returns ({name:
    row}, {name: launches of the kernel run})."""
    import torch
    from horovod_tpu_torch.ops import wire_codec as wc
    from horovod_tpu_torch.parallel import ring
    rows = {name: {} for name in WIRE}
    bad = []
    n = WIRE_RANKS
    c = ring.chunk_length(LM_PARAMS, n)
    x, acc = _wire_inputs(c, 31)
    _check_codec_calls(wc, "lm_chunk", x, rows, bad)
    _check_codec_calls(wc, "small", _wire_inputs(WIRE_SMALL, 32)[0], rows,
                       bad)
    _check_codec_calls(wc, "special", _special_blocks(), rows, bad)
    torch.cuda.synchronize()
    # times at the LM chunk
    for mode in ("int8", "bf16"):
        payload = wc.wire_encode_ref(x, mode)
        runs = {
            "wire_encode": (lambda: wc.wire_encode(x, mode),
                            lambda: wc.wire_encode_ref(x, mode),
                            (lambda: x.to(torch.bfloat16)) if mode == "bf16"
                            else None),
            "wire_decode_add": (
                lambda: wc.wire_decode_add(acc, payload, mode),
                lambda: wc.wire_decode_add_ref(acc, payload, mode),
                _decode_add_library(acc, payload, mode)),
        }
        _check_decode_add_library(wc, acc, payload, mode, bad)
        for name, (kern, plain, library) in runs.items():
            pre = "" if mode == "int8" else "bf16_"
            r = rows[name]
            r[pre + "ms"] = time_ms(kern)
            r[pre + "plain_ms"] = time_ms(plain, n=5, reps=3, warmup=1)
            r[pre + "library_ms"] = time_ms(library) if library else None
            r[pre + "bound_ms"], r[pre + "bound_by"] = _wire_bound_ms(
                name, mode, c)
            log("%s %s at the LM chunk (%d): %.4f ms (bound %.4f, plain "
                "%.4f, library %s)" % (name, mode, c, r[pre + "ms"],
                                       r[pre + "bound_ms"],
                                       r[pre + "plain_ms"],
                                       r[pre + "library_ms"]))
        del payload
    for name in WIRE:
        rows[name]["library"] = (
            "encode: int8 none (no PyTorch call computes it), bf16 "
            "x.to(torch.bfloat16); decode-add: int8 acc.view(-1, 256)"
            ".addcmul_(q.view(-1, 256), scales.view(-1, 1)), bf16 "
            "acc.add_(p)")
    del x, acc
    torch.cuda.empty_cache()
    # the three schedules over 4 virtual ranks on the LM's flat gradient
    plain_cls = _plain_codec(ring, wc)
    launches = {name: 0 for name in WIRE}
    ring_result = {}
    for mode in ("bf16", "int8", "none"):
        g = torch.Generator(device="cuda").manual_seed(40)
        xs = [torch.randn(LM_PARAMS, generator=g, device="cuda") * 1e-3
              for _ in range(n)]
        total = xs[0] + xs[1] + xs[2] + xs[3]
        got, counts = _run_rings(ring, wc, ring.RingCodec, mode, xs, c, n)
        for sched in counts.values():
            for name in WIRE:
                launches[name] += sched[name]
        ref, _ = _run_rings(ring, wc, plain_cls, mode, xs, c, n)
        equal = all(torch.equal(a, b) for k, p in zip(got, ref)
                    for a, b in zip(k, p))
        ar = [ch.view(-1)[:LM_PARAMS] for ch in got[0]]
        same = all(torch.equal(ar[0], a) for a in ar[1:])
        err = ((ar[0] - total).abs().max() / total.abs().max()).item()
        full = torch.cat([s for s in got[1]])[:LM_PARAMS]
        rs_err = ((full - total).abs().max() / total.abs().max()).item()
        same_ag = all(torch.equal(got[2][0], a) for a in got[2][1:])
        want = _ring_launches(n)
        if mode == "none":
            want = {k: {name: 0 for name in WIRE} for k in want}
        ring_result[mode] = dict(equal_plain=equal, ranks_identical=same,
                                 allgather_identical=same_ag,
                                 allreduce_err=err, reduce_scatter_err=rs_err,
                                 launches=counts)
        log("rings over %d virtual ranks, %s, %d elements a rank: kernels "
            "equal the plain versions %s; allreduce err %.3g, identical on "
            "every rank %s; reduce_scatter err %.3g; allgather identical %s; "
            "launches %s" % (n, mode, LM_PARAMS, equal, err, same, rs_err,
                             same_ag, counts))
        if counts != want:
            bad.append("the %s rings launched %s, expected %s"
                       % (mode, counts, want))
        if not (equal and same and same_ag and err <= WIRE_SUM_TOL[mode] and
                rs_err <= WIRE_SUM_TOL[mode]):
            bad.append("the %s rings: equal to the plain versions %s, "
                       "identical on every rank %s / %s, allreduce err %.3g, "
                       "reduce_scatter err %.3g (limit %g)"
                       % (mode, equal, same, same_ag, err, rs_err,
                          WIRE_SUM_TOL[mode]))
        del xs, total, got, ref, ar, full
        torch.cuda.empty_cache()
    print("wire_kernels: " + json.dumps(dict(rows=rows, rings=ring_result)),
          flush=True)
    if bad:
        fail("wire codec: " + "; ".join(bad))
    return rows, launches


def _param_gaps(params, ref):
    """{name: ||p - ref||_2 / ||ref||_2}."""
    return {k: ((params[k].float() - ref[k].float()).norm() /
                ref[k].float().norm().clamp_min(1e-30)).item() for k in ref}


def _lm_steps(step, tokens, steps, check=None):
    """Runs ``steps`` steps; returns (losses, seconds a step, the result of
    ``check()`` after ZERO1_CHECK_STEP steps)."""
    import torch
    losses, times, checked = [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(tokens).item())
        times.append(time.perf_counter() - t0)
        if i + 1 == ZERO1_CHECK_STEP and check is not None:
            checked = check()
    return losses, times, checked


def phase_zero1():
    """The LM of the train phase (MODEL, BATCH, flash attention, Adam 1e-4,
    the same seeded weights and batch) on the one-rank NCCL group: 3
    replicated steps (``make_train_step``) for the reference; then the same
    weights through ``make_train_step(zero1=True, compression="int8")``,
    7 steps, every parameter after 3 within ZERO1_TOL of the replicated
    one's, losses finite and falling, no codec launch (one rank: the ring
    applies no codec); then the same weights through
    ``make_fsdp_train_step``, 5 steps, held the same way. Step times,
    optimizer-state bytes and peak memory of each."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.ops import wire_codec as wc
    from horovod_tpu_torch.ops.flash_attention import (launch_counts,
                                                       reset_launch_counts)
    from horovod_tpu_torch.parallel import (lm_loss, make_fsdp_train_step,
                                            make_train_step)

    hvd.init()
    dev = hvd.device()
    cfg = TransformerConfig(attention="flash", dtype=torch.bfloat16,
                            max_seq_len=8192, **MODEL)
    B, L = BATCH
    tokens = torch.randint(0, cfg.vocab_size, (B, L), device=dev,
                           generator=torch.Generator(device=dev
                                                     ).manual_seed(1))

    def fresh(initial=None):
        model = Transformer(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        if initial is not None:
            model.load_state_dict(initial)
        return model

    def params_of(model):
        return {k: v.detach().clone() for k, v in model.named_parameters()}

    model = fresh()
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(model, lm_loss, torch.optim.Adam(
        model.parameters(), lr=1e-4))
    ref_losses, _, ref = _lm_steps(step, tokens, ZERO1_CHECK_STEP,
                                   lambda: params_of(model))
    ref_state = sum(v.numel() * v.element_size()
                    for st in step.optimizer.optimizer.state.values()
                    for v in st.values() if torch.is_tensor(v))
    del step, model
    torch.cuda.empty_cache()
    result = dict(params=n_params, replicated_losses=ref_losses,
                  replicated_opt_state_bytes=ref_state)
    counts = {}
    runs = (("zero1", 7, lambda m: make_train_step(
                 m, lm_loss, torch.optim.Adam(m.parameters(), lr=1e-4),
                 zero1=True, compression="int8")),
            ("fsdp", 5, lambda m: make_fsdp_train_step(
                m, lm_loss, torch.optim.Adam, dict(lr=1e-4))))
    for label, steps, make in runs:
        model = fresh(initial)
        step = make(model)
        if label == "zero1":
            def check(model=model):
                return params_of(model)
            state_bytes = lambda s=step: s.optimizer.opt_state_bytes  # noqa
        else:
            def check(model=model, step=step):
                full = step.full_parameters()
                out = params_of(model)
                return {k: full.get(k, out.get(k)) for k in ref}
            state_bytes = step.opt_state_bytes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        wc.reset_launch_counts()
        losses, times, got = _lm_steps(step, tokens, steps, check)
        run_counts = {**launch_counts(), **wc.launch_counts()}
        peak = torch.cuda.max_memory_allocated()
        gaps = _param_gaps(got, ref)
        worst = max(gaps, key=gaps.get)
        step_s = statistics.median(times[2:])
        result[label] = dict(
            step_ms=step_s * 1e3, tokens_per_s=B * L / step_s,
            peak_mem_gb=peak / 1e9, opt_state_bytes=state_bytes(),
            losses=losses, worst_param_gap=gaps[worst], worst_param=worst,
            launches=run_counts, steps=steps)
        log("%s: %d steps, %.1f ms a step, losses %s; after %d steps worst "
            "parameter gap to the replicated step %s %.3g; optimizer state "
            "%d bytes; peak %.2f GB; launches %s"
            % (label, steps, step_s * 1e3, losses, ZERO1_CHECK_STEP, worst,
               gaps[worst], state_bytes(), peak / 1e9, run_counts))
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            fail("%s: losses not finite and falling: %s" % (label, losses))
        if not gaps[worst] <= ZERO1_TOL:
            fail("%s: parameter %s after %d steps is %.3g from the "
                 "replicated step's (limit %g)" % (label, worst,
                                                    ZERO1_CHECK_STEP,
                                                    gaps[worst], ZERO1_TOL))
        if max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)) \
                > ZERO1_TOL:
            fail("%s: losses %s, replicated %s" % (label, losses,
                                                    ref_losses))
        for name, n in run_counts.items():
            want = cfg.num_layers * steps if name in FLASH else 0
            if n != want:
                fail("%s: %s launched %d times in %d steps, expected %d "
                     "(the wire codec: none, one rank applies no codec)"
                     % (label, name, n, steps, want))
        for name in FLASH:
            counts[name] = counts.get(name, 0) + run_counts[name]
        del step, model, got
        torch.cuda.empty_cache()
    print("zero1: " + json.dumps(result), flush=True)
    hvd.shutdown()
    return counts


def _moe_hooks(model):
    """Forward hooks on ``model``'s MoeMlps: returns (records, handles), one
    (input [T, D], output [T, D]) a MoE layer a forward, detached."""
    from horovod_tpu_torch.parallel import MoeMlp
    records = []

    def keep(module, inp, out):
        D = inp[0].shape[-1]
        records.append((inp[0].detach().reshape(-1, D),
                        out.detach().reshape(-1, D)))
    handles = [m.register_forward_hook(keep) for m in model.modules()
               if isinstance(m, MoeMlp)]
    return records, handles


def _top1(module, x):
    """Each token's top-1 expert and its gate, computed as the router does
    (f32 logits of the bf16 input)."""
    import torch
    probs = torch.softmax(x.float() @ module.router.float(), dim=-1)
    gate, idx = probs.max(dim=-1)
    return idx, gate


def moe_token_check(module, x, y):
    """One MoE layer's output ``y`` on its input ``x`` ([T, D]) against a
    computation that uses no one-hot contraction: each token's top-1 expert
    and gate from the router, its queue position by a stable sort of the
    tokens by expert, the tokens at positions past the capacity dropped,
    and for each kept token gate * FFN_e(x) in float32 from the same bf16
    inputs (the weights cast as the module casts them). Checks the drop
    set against y's all-zero rows, the routing and drop set of
    ``topk_dispatch`` against the same, and the kept tokens' y; returns
    the readings."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.parallel.expert import topk_dispatch
    T = x.shape[0]
    E = module.router.shape[1]
    C = max(1, math.ceil(T / E * module.capacity_factor))
    idx, gate = _top1(module, x)
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(idx)
    pos[order] = torch.arange(T, device=x.device) - starts[idx[order]]
    kept = pos < C
    w_in = module.w_in.to(module.dtype).float()
    w_out = module.w_out.to(module.dtype).float()
    ref = torch.zeros(T, x.shape[1], device=x.device)
    for e in range(E):
        sel = kept & (idx == e)
        h = F.silu(x[sel].float() @ w_in[e])
        ref[sel] = gate[sel, None] * (h @ w_out[e])
    dropped = (y == 0).all(dim=-1)
    with torch.no_grad():
        dispatch, _, _ = topk_dispatch(x.float() @ module.router.float(), C,
                                       k=1)
    flat = dispatch.view(T, -1)
    routed = flat.amax(dim=-1) > 0
    slot = flat.argmax(dim=-1)
    del dispatch, flat
    same_drops = bool(torch.equal(dropped, ~kept))
    same_routing = bool(torch.equal(routed, kept)) and bool(torch.equal(
        slot[kept], (idx * C + pos)[kept]))
    err = ((y[kept].float() - ref[kept]).norm() /
           ref[kept].norm().clamp_min(1e-30)).item()
    return dict(tokens=T, capacity=C, dropped_share=1.0 - kept.float(
        ).mean().item(), same_drop_set=same_drops,
        same_routing=same_routing, rel_l2_err=err)


def moe_split_ms(module, x):
    """Device time of one MoE layer's parts at its own launch (x [T, D],
    the layer's input), forward and backward each: the routing (router
    product, softmax and the [T, E, C] one-hot construction of
    ``topk_dispatch``), the dispatch contraction, the experts' two
    products and the combine contraction, as ``moe_ffn`` runs them."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.parallel.expert import topk_dispatch
    T, D = x.shape
    E = module.router.shape[1]
    C = max(1, math.ceil(T / E * module.capacity_factor))
    dt = x.dtype
    router = module.router.detach().clone().requires_grad_()
    w_in = module.w_in.detach().to(dt).requires_grad_()
    w_out = module.w_out.detach().to(dt).requires_grad_()
    xg = x.detach().clone().requires_grad_()
    g = torch.Generator(device=x.device).manual_seed(11)

    def rand(*shape, dtype=dt):
        return torch.randn(*shape, device=x.device, dtype=dtype, generator=g)

    with torch.no_grad():
        dispatch, combine, _ = topk_dispatch(x.float() @ router.float(), C,
                                             k=1)
        d16, c16 = dispatch.to(dt), combine.to(dt)
        expert_in = torch.einsum("tec,td->ecd", d16, x)
    c16g = c16.clone().requires_grad_()
    ein = expert_in.clone().requires_grad_()
    out = rand(E, C, D).requires_grad_()
    g_comb = rand(T, E, C, dtype=torch.float32)
    g_ecd, g_td = rand(E, C, D), rand(T, D)

    one = torch.ones((), device=x.device)

    def routing():
        _, comb, aux = topk_dispatch(x.float() @ router.float(), C, k=1)
        torch.autograd.grad([comb, aux], [router], [g_comb, one])

    def dispatch_contraction():
        y = torch.einsum("tec,td->ecd", d16, xg)
        torch.autograd.grad(y, [xg], g_ecd)

    def experts():
        h = F.silu(torch.einsum("ecd,edf->ecf", ein, w_in))
        y = torch.einsum("ecf,efd->ecd", h, w_out)
        torch.autograd.grad(y, [ein, w_in, w_out], g_ecd)

    def combine_contraction():
        y = torch.einsum("tec,ecd->td", c16g, out)
        torch.autograd.grad(y, [c16g, out], g_td)

    parts = dict(routing=routing, dispatch=dispatch_contraction,
                 experts=experts, combine=combine_contraction)
    res = {name: time_ms(fn, n=3, reps=3, warmup=1)
           for name, fn in parts.items()}
    del dispatch, combine, d16, c16, c16g, g_comb
    torch.cuda.empty_cache()
    return res


class _Routing:
    """Swaps ``parallel.expert.topk_dispatch`` (top-1) for the length of a
    ``with``: ``record`` keeps each call's top-1 experts, in call order;
    ``pin`` routes each call to the experts recorded for it (the logits
    given a large bias there, so the port's own dispatch builds the slots)
    and takes the gates and the aux loss from the logits it is given, as
    the reference does."""

    def __init__(self):
        self.choices, self.pinned = [], None

    def record(self):
        return self._swap(self._record)

    def pin(self):
        self.pinned = list(self.choices)
        return self._swap(self._pin)

    def _swap(self, fn):
        import contextlib
        from horovod_tpu_torch.parallel import expert

        @contextlib.contextmanager
        def swapped():
            orig, expert.topk_dispatch = expert.topk_dispatch, fn
            self.orig = orig
            try:
                yield
            finally:
                expert.topk_dispatch = orig
        return swapped()

    def _record(self, logits, capacity, k=1):
        self.choices.append(logits.detach().float().argmax(dim=-1))
        return self.orig(logits, capacity, k=k)

    def _pin(self, logits, capacity, k=1):
        import torch
        import torch.nn.functional as F
        idx = self.pinned.pop(0)
        E = logits.shape[1]
        oh = F.one_hot(idx, E).float()
        dispatch, _, _ = self.orig(logits.detach().float() + 1e4 * oh,
                                   capacity, k=1)
        probs = torch.softmax(logits.float(), dim=-1)
        gate = torch.sum(probs * oh, dim=-1)
        aux = E * torch.sum(oh.mean(dim=0) * probs.mean(dim=0))
        return dispatch, dispatch * gate[:, None, None], aux


def moe_gradient_gaps(cfg, state, tokens, dtype, pin=False):
    """The MoE LM in ``dtype`` through flash and through dense attention on
    the same weights: every parameter's gradient gap (``gradient_gaps``)
    and, per MoE layer, the share of tokens whose top-1 expert differs
    between the two runs. ``pin``: the dense run routes each token to the
    expert the flash run chose (``_Routing``), so a near-tie that the two
    attentions' roundings break apart moves no token."""
    import contextlib
    import dataclasses
    import torch
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.parallel import lm_loss_streaming
    models = []
    for attention in ("flash", "dense"):
        m = Transformer(dataclasses.replace(cfg, attention=attention,
                                            dtype=dtype),
                        device=tokens.device)
        m.load_state_dict(state)
        models.append(m)
    (rec_f, hf), (rec_d, hd) = (_moe_hooks(m) for m in models)
    routing = _Routing()

    def loss_fn(m, t):
        ctx = (routing.record() if m is models[0] else
               routing.pin() if pin else contextlib.nullcontext())
        with ctx:
            return lm_loss_streaming(m, t)

    gaps = gradient_gaps(models[0], models[1], tokens, loss_fn)
    for h in hf + hd:
        h.remove()
    mods = [b.moe_mlp for b in models[0].blocks if b.moe]
    flips = [(_top1(m, a[0])[0] != _top1(m, b[0])[0]).float().mean().item()
             for m, a, b in zip(mods, rec_f, rec_d)]
    del models, rec_f, rec_d
    torch.cuda.empty_cache()
    order = sorted(gaps, key=gaps.get, reverse=True)
    return dict(worst=order[0], gap=gaps[order[0]],
                median=statistics.median(gaps.values()),
                next=["%s %.3g" % (n, gaps[n]) for n in order[1:5]],
                flips=["%.5f" % f for f in flips],
                flip_share=sum(flips) / len(flips))


def phase_moe(profile_dir=None):
    """The Switch-MoE LM of bench.py's MoE row (MODEL's widths, MOE: 8
    experts in every second block, top-1, capacity factor 1.25; flash
    attention, the streaming loss, Adam 1e-4) at 8 x 2048 tokens: one MoE
    layer against the per-token computation; the model with ``ep_axis`` on
    a one-rank "ep" axis (NCCL's all-to-all) against it without, bit for
    bit; against dense attention (the first loss at 8 x 2048, every
    gradient at 2 x 2048, the share of tokens whose top-1 expert differs);
    then 2 warm-up and 5 timed steps and the MoE layer's parts timed.
    Returns K1-K3's launch counts."""
    import dataclasses
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.ops.flash_attention import (launch_counts,
                                                       reset_launch_counts)
    from horovod_tpu_torch.parallel import (hybrid_mesh, lm_loss_streaming,
                                            make_train_step)

    hvd.init()
    dev = hvd.device()
    cfg = TransformerConfig(attention="flash", dtype=torch.bfloat16,
                            max_seq_len=8192, **MODEL, **MOE)
    B, L = BATCH
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, L), device=dev,
                           generator=torch.Generator(device=dev
                                                     ).manual_seed(1))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    n_params = sum(p.numel() for p in model.parameters())
    moe_blocks = [i for i, b in enumerate(model.blocks) if b.moe]
    if moe_blocks != list(range(1, cfg.num_layers, 2)):
        fail("MoE blocks %s, expected every second one" % moe_blocks)

    # 1. the first MoE layer (block 1) on its real input at 8 x 2048
    records, handles = _moe_hooks(model)
    with torch.no_grad():
        loss_first = lm_loss_streaming(model, tokens).item()
    for h in handles:
        h.remove()
    module = model.blocks[moe_blocks[0]].moe_mlp
    x, y = records[0]
    token = moe_token_check(module, x, y)
    log("moe per-token check (block %d, %d tokens, capacity %d): dropped "
        "%.4f, same drop set %s, same routing %s, kept tokens' y rel %.3g"
        % (moe_blocks[0], token["tokens"], token["capacity"],
           token["dropped_share"], token["same_drop_set"],
           token["same_routing"], token["rel_l2_err"]))
    if not (token["same_drop_set"] and token["same_routing"]):
        fail("the MoE layer's routing or drop set differs from the "
             "per-token computation: %s" % token)
    if not token["rel_l2_err"] <= MOE_TOKEN_TOL:
        fail("the MoE layer's output is %.3g from the per-token computation "
             "(limit %g)" % (token["rel_l2_err"], MOE_TOKEN_TOL))
    split = moe_split_ms(module, x)
    del records, x, y
    torch.cuda.empty_cache()

    # 2. the same weights with experts over a one-rank "ep" axis: the
    # all-to-alls run (NCCL copies), so the loss and every gradient equal
    hybrid_mesh((1,), ("ep",))
    ep = Transformer(dataclasses.replace(cfg, ep_axis="ep"), device=dev)
    ep.load_state_dict(model.state_dict())
    same = {}
    for label, m in (("local", model), ("ep", ep)):
        loss = lm_loss_streaming(m, tokens)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        same[label] = (loss.detach(), grads)
    names = [n for n, _ in model.named_parameters()]
    diff = [n for n, a, b in zip(names, same["local"][1], same["ep"][1])
            if not torch.equal(a, b)]
    ep_loss_equal = bool(torch.equal(same["local"][0], same["ep"][0]))
    log("moe ep_axis at one rank: loss equal %s, %d of %d gradients differ "
        "%s" % (ep_loss_equal, len(diff), len(names), diff[:4]))
    if not ep_loss_equal or diff:
        fail("the model with ep_axis on a one-rank axis differs from it "
             "without: loss equal %s, gradients %s" % (ep_loss_equal,
                                                        diff[:8]))
    del ep, same
    torch.cuda.empty_cache()

    # 3. the same weights through dense attention: the first loss at
    # 8 x 2048; every gradient at 2 x 2048 in bf16 (logged) and in float32
    # (checked), with the share of tokens whose top-1 expert differs
    dense = Transformer(dataclasses.replace(cfg, attention="dense"),
                        device=dev)
    dense.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss_plain = lm_loss_streaming(dense, tokens).item()
    del dense
    torch.cuda.empty_cache()
    rel = abs(loss_first - loss_plain) / abs(loss_plain)
    log("moe first loss %.6f, dense attention %.6f, rel %.3g"
        % (loss_first, loss_plain, rel))
    if not rel <= 2e-2:
        fail("moe first loss %.6f vs dense attention %.6f (rel %.3g)"
             % (loss_first, loss_plain, rel))
    grads = {"%s%s" % (label, "_pinned" if pin else ""): moe_gradient_gaps(
        cfg, model.state_dict(), tokens[:MOE_GRAD_BATCH], dtype, pin)
        for label, dtype in (("bf16", torch.bfloat16),
                             ("f32", torch.float32))
        for pin in (False, True)}
    for label, g in grads.items():
        log("moe gradient gap flash vs dense at %d x %d, %s: worst %s %.3g, "
            "median %.3g, next %s; top-1 experts differing %.5f (by layer "
            "%s)" % (MOE_GRAD_BATCH, L, label, g["worst"], g["gap"],
                     g["median"], g["next"], g["flip_share"], g["flips"]))
    checked = grads["f32_pinned"]
    if not checked["gap"] <= GRAD_TOL:
        fail("MoE gradients through the flash kernels disagree with dense "
             "attention in float32 on the same routing: %s %.3g > %g"
             % (checked["worst"], checked["gap"], GRAD_TOL))

    # 4. the steps
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(),
                                                    lr=1e-4),
                                   model.named_parameters())
    step = make_train_step(model, lm_loss_streaming, opt)
    warmup, timed = 2, 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(tokens).item()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log("moe step %d: loss %.5f, %.1f ms" % (i, loss, times[-1] * 1e3))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = warmup + timed
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail("moe losses not finite and falling: %s" % losses)
    for name, c in counts.items():
        per_step = cfg.num_layers if name in FLASH else 0
        if c != per_step * steps:
            fail("%s launched %d times in %d moe steps, expected %d per step"
                 % (name, c, steps, per_step))
    step_s = statistics.median(times[warmup:])
    n_moe = len(moe_blocks)
    result = dict(step_ms=step_s * 1e3, tokens_per_s=B * L / step_s,
                  peak_mem_gb=peak / 1e9, params=n_params,
                  loss_first=losses[0], loss_last=losses[-1],
                  loss_plain=loss_plain,
                  grad_gap_worst={k: g["gap"] for k, g in grads.items()},
                  top1_flip_share={k: g["flip_share"]
                                   for k, g in grads.items()},
                  per_token=token,
                  ep_one_rank_bitwise=True,
                  moe_layer_ms=split,
                  moe_ms_per_step={k: v * n_moe for k, v in split.items()},
                  launches=counts, steps=steps)
    if profile_dir:
        result["profile"] = profile_steps(step, tokens, profile_dir, "moe")
    print("moe: " + json.dumps(result), flush=True)
    hvd.shutdown()
    return {name: counts[name] for name in FLASH}


def phase_ulysses(profile_dir=None):
    """The lc model (LC_MODEL, fused rotary, the streaming loss, 2 x 8192
    tokens, Adam 1e-4) with ``attention="ulysses"`` on a one-rank "sp"
    axis: its all-to-alls run (NCCL copies), so the first loss and every
    gradient must equal the lc flash model's on the same weights bit for
    bit; 24 launches of the rotary pass in one loss's forward, none in its
    backward; 2 warm-up and 3 timed steps of the flash model, then of the
    Ulysses model with 12 launches of each of K1_rot-K3_rot and 24 of the
    pass a step. Returns the Ulysses steps' launch counts."""
    import dataclasses
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.ops.flash_attention import (launch_counts,
                                                       reset_launch_counts)
    from horovod_tpu_torch.parallel import (hybrid_mesh, lm_loss_streaming,
                                            make_train_step)

    hvd.init()
    dev = hvd.device()
    hybrid_mesh((hvd.size(),), ("sp",))
    cfg = TransformerConfig(attention="ulysses", sp_axis="sp",
                            rope_fused=True, dtype=torch.bfloat16,
                            max_seq_len=8192, **LC_MODEL)
    B, L = LC_BATCH
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, L), device=dev,
                           generator=torch.Generator(device=dev
                                                     ).manual_seed(1))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    flash = Transformer(dataclasses.replace(cfg, attention="flash",
                                            sp_axis=None), device=dev)
    flash.load_state_dict(model.state_dict())
    names = [n for n, _ in model.named_parameters()]
    got = {}
    for label, m in (("flash", flash), ("ulysses", model)):
        loss = lm_loss_streaming(m, tokens)
        got[label] = (loss.detach(), torch.autograd.grad(
            loss, list(m.parameters())))
    diff = [n for n, a, b in zip(names, got["flash"][1], got["ulysses"][1])
            if not torch.equal(a, b)]
    loss_equal = bool(torch.equal(got["flash"][0], got["ulysses"][0]))
    log("ulysses at one rank vs the lc flash model: loss equal %s (%.6f), "
        "%d of %d gradients differ %s" % (loss_equal,
                                         got["ulysses"][0].item(),
                                         len(diff), len(names), diff[:4]))
    if not loss_equal or diff:
        fail("the Ulysses model on a one-rank axis differs from the lc "
             "flash model: loss equal %s, gradients %s"
             % (loss_equal, diff[:8]))
    del got
    torch.cuda.empty_cache()
    passes = pass_launches(model, tokens, lm_loss_streaming,
                           2 * cfg.num_layers, "ulysses")

    def run(m, label):
        opt = hvd.DistributedOptimizer(torch.optim.Adam(m.parameters(),
                                                        lr=1e-4),
                                       m.named_parameters())
        step = make_train_step(m, lm_loss_streaming, opt)
        warmup, timed = 2, 3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, times = [], []
        for i in range(warmup + timed):
            t0 = time.perf_counter()
            loss = step(tokens).item()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            log("%s step %d: loss %.5f, %.1f ms" % (label, i, loss,
                                                     times[-1] * 1e3))
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            fail("%s losses not finite and falling: %s" % (label, losses))
        step_s = statistics.median(times[warmup:])
        res = dict(step_ms=step_s * 1e3, tokens_per_s=B * L / step_s,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   loss_first=losses[0], loss_last=losses[-1])
        return res, step, warmup + timed

    # the flash model first, on its own weights' copy, for the step time
    # beside the Ulysses model's in the same run
    flash_res, _, _ = run(flash, "ulysses_flash")
    del flash
    torch.cuda.empty_cache()
    result, step, steps = run(model, "ulysses")
    counts = launch_counts()
    kernels = dict({n: cfg.num_layers for n in FLASH_ROT},
                   **{ROPE: 2 * cfg.num_layers})
    for name, c in counts.items():
        if c != kernels.get(name, 0) * steps:
            fail("%s launched %d times in %d ulysses steps, expected %d per "
                 "step" % (name, c, steps, kernels.get(name, 0)))
    result.update(bitwise_lc_flash=True, flash=flash_res,
                  pass_launches_forward_backward=passes,
                  launches_per_step={n: c // steps for n, c in
                                     counts.items() if c}, steps=steps)
    if profile_dir:
        result["profile"] = profile_steps(step, tokens, profile_dir,
                                          "ulysses")
    print("ulysses: " + json.dumps(result), flush=True)
    hvd.shutdown()
    return {name: counts[name] for name in kernels}

def _check_losses(name, losses):
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        fail("non-finite %s loss: %s" % (name, losses))
    if not losses[-1] < losses[0]:
        fail("%s loss did not fall: %s" % (name, losses))


def _run_steps(name, step, batch, warmup=2, timed=5):
    """``warmup + timed`` steps on ``batch`` after the peak-memory reset:
    (losses, median step seconds of the timed ones, peak bytes)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(batch).item()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log("%s step %d: loss %.5f, %.1f ms" % (name, i, loss,
                                                times[-1] * 1e3))
    _check_losses(name, losses)
    return (losses, statistics.median(times[warmup:]),
            torch.cuda.max_memory_allocated())


def _image_batch(n, size, gen, dev):
    import torch
    return {"x": torch.randn(n, 3, size, size, generator=gen, device=dev),
            "y": torch.randint(0, 1000, (n,), generator=gen, device=dev)}


def block_gradient_gaps(model, stock, batch):
    """{parameter: gap} of every ConvBN block of ``model`` against the same
    block of ``stock``, each given the input and the output cotangent that
    block has in ``stock``'s loss on ``batch``: the block's kernel, scale
    and bias gradients, ||g - g_stock||_2 / ||g_stock||_2. Taken block by
    block, the check reads each BN layer at its own launch without the
    whole model's conditioning (two sound BN paths stand 0.06 apart
    through all 94 blocks at initialisation, float32 on the CPU)."""
    import torch
    from horovod_tpu_torch.models.imagenet_extras import ConvBN
    from horovod_tpu_torch.parallel import classification_loss
    names = [n for n, m in stock.named_modules() if isinstance(m, ConvBN)]
    seen = {}

    def keep(name):
        def hook(module, args, out):
            out.register_hook(lambda g: seen[name].append(g.detach()))
            seen[name] = [args[0].detach()]
        return hook

    hooks = [stock.get_submodule(n).register_forward_hook(keep(n))
             for n in names]
    classification_loss(stock, batch).backward()
    for h in hooks:
        h.remove()
    stock.zero_grad(set_to_none=True)
    gaps = {}
    for n in names:
        x, ct = seen.pop(n)
        grads = []
        for m in (model, stock):
            block = m.get_submodule(n)
            params = [block.conv.weight, block.bn.weight, block.bn.bias]
            grads.append(torch.autograd.grad(block(x), params, ct))
        for leaf, a, b in zip(("conv.weight", "bn.weight", "bn.bias"),
                              *grads):
            gaps["%s.%s" % (n, leaf)] = ((a - b).norm() / b.norm().clamp_min(
                1e-30)).item()
    return gaps


def phase_inception(profile_dir=None):
    """bench.py's inception3pbn row: InceptionV3(norm="pallas") at 128 x 299
    x 299, SGD 0.01 momentum 0.9: 94 launches each of K7, K8 and the two BN
    passes a step; the first loss against the stock BN on the same weights
    and dropout masks, every block's gradients at batch 32 in float32
    against it (``block_gradient_gaps``). Returns the kernels' launch
    counts."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import InceptionV3
    from horovod_tpu_torch.ops import batch_norm as bn
    from horovod_tpu_torch.ops.flash_attention import (launch_counts,
                                                       reset_launch_counts)
    from horovod_tpu_torch.parallel import (classification_loss,
                                            make_train_step)

    hvd.init()
    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = InceptionV3(norm="pallas", dtype=torch.bfloat16, device=dev,
                        generator=gen)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    batch = _image_batch(INCEPTION_BATCH, INCEPTION_IMAGE, gen, dev)
    # the gradient check in float32 (as the resnet phase's: bf16 gradients
    # of two sound BN paths stand far apart at init), block by block
    # (block_gradient_gaps); the whole model's gaps, each model's dropout
    # drawing its first masks, and the bf16 ones logged beside it
    small = {k: v[:INCEPTION_GRAD_BATCH] for k, v in batch.items()}
    f32 = []
    for norm in ("pallas", "batch"):
        f32.append(InceptionV3(norm=norm, dtype=torch.float32, device=dev))
        f32[-1].load_state_dict(model.state_dict())
    whole_gaps = gradient_gaps(*f32, small, classification_loss)
    grad_gaps = block_gradient_gaps(*f32, small)
    del f32
    stock = InceptionV3(norm="batch", dtype=torch.bfloat16, device=dev)
    stock.load_state_dict(model.state_dict())
    gaps_bf16 = gradient_gaps(model, stock, small, classification_loss)
    for m in (model, stock):
        m.dropout.reset()  # the step's first masks are the stock loss's
    with torch.no_grad():
        loss_plain = classification_loss(stock, batch).item()
    del stock
    torch.cuda.empty_cache()
    for label, gaps in (("bf16, whole model, not checked", gaps_bf16),
                        ("float32, whole model, not checked", whole_gaps),
                        ("float32, block by block", grad_gaps)):
        leaf = max(gaps, key=gaps.get)
        log("inception gradient gap pallas vs stock BN at batch %d (%s): "
            "worst %s %.3g, median %.3g" % (
                INCEPTION_GRAD_BATCH, label, leaf, gaps[leaf],
                statistics.median(gaps.values())))
    leaf = max(grad_gaps, key=grad_gaps.get)
    if not grad_gaps[leaf] <= RESNET_GRAD_TOL:
        fail("Inception gradients (norm='pallas', float32) disagree with the "
             "stock BN: %s %.3g > %g" % (leaf, grad_gaps[leaf],
                                         RESNET_GRAD_TOL))

    step = make_train_step(model, classification_loss, torch.optim.SGD(
        model.parameters(), lr=0.01, momentum=0.9))
    reset_launch_counts()
    bn.reset_launch_counts()
    losses, step_s, peak = _run_steps("inception", step, batch)
    counts = dict(launch_counts(), **bn.launch_counts())
    steps = len(losses)
    for kernel, n in counts.items():
        per_step = INCEPTION_BN_LAYERS if kernel in BN else 0
        if n != per_step * steps:
            fail("%s launched %d times in %d inception steps, expected %d "
                 "per step" % (kernel, n, steps, per_step))
    rel = abs(losses[0] - loss_plain) / abs(loss_plain)
    log("inception first loss %.6f, stock BN %.6f, rel %.3g"
        % (losses[0], loss_plain, rel))
    if not rel <= RESNET_LOSS_TOL:
        fail("inception first loss %.6f vs stock BN %.6f (rel %.3g)"
             % (losses[0], loss_plain, rel))
    result = dict(step_ms=step_s * 1e3,
                  images_per_s=INCEPTION_BATCH / step_s,
                  peak_mem_gb=peak / 1e9, batch=INCEPTION_BATCH,
                  loss_first=losses[0], loss_last=losses[-1],
                  loss_plain=loss_plain, grad_gap_worst=grad_gaps[leaf],
                  grad_gap_worst_whole=max(whole_gaps.values()),
                  grad_gap_median_whole=statistics.median(
                      whole_gaps.values()),
                  grad_gap_worst_bf16=max(gaps_bf16.values()),
                  launches=counts, steps=steps)
    if profile_dir:
        result["profile"] = profile_steps(step, batch, profile_dir,
                                          "inception")
    print("inception: %s" % json.dumps(result), flush=True)
    hvd.shutdown()
    return {kernel: counts[kernel] for kernel in BN}


def agc_clip_share(model, batch, clipping):
    """The share of AGC's units (``ops/agc.py``) whose gradient of one
    loss on ``batch`` ``agc_clip`` changes."""
    import torch
    from horovod_tpu_torch.ops import agc
    from horovod_tpu_torch.parallel import classification_loss
    params = list(model.parameters())
    grads = torch.autograd.grad(classification_loss(model, batch), params)
    clipped = agc.agc_clip(list(grads), params, clipping)
    changed = [agc.unitwise_norm(c - g, agc.unit_of(p)) > 0
               for g, c, p in zip(grads, clipped, params)]
    return (sum(int(c.sum()) for c in changed) /
            sum(c.numel() for c in changed))


def phase_resnet_nf():
    """bench.py's resnet50nf row (ResNet50NF at batch 256 through
    make_train_step(agc=0.01)) and resnet50gn row (ResNet50GN at 256, no
    AGC), SGD 0.01 momentum 0.9: finite, falling losses; the share of AGC
    units clipped in the first step; step time and peak memory beside the
    resnet phase's ResNet-50 (when it ran in this call)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet50GN, ResNet50NF
    from horovod_tpu_torch.parallel import (classification_loss,
                                            make_train_step)

    hvd.init()
    dev = hvd.device()
    result = {}
    for label, cls, agc in (("nf", ResNet50NF, AGC_CLIPPING),
                            ("gn", ResNet50GN, None)):
        gen = torch.Generator(device=dev).manual_seed(0)
        model = cls(num_classes=1000, dtype=torch.bfloat16, device=dev,
                    generator=gen)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        batch = _image_batch(RESNET_BATCH, IMAGE, gen, dev)
        extra = {}
        if agc:
            extra["agc_clipped_share"] = agc_clip_share(model, batch, agc)
        step = make_train_step(model, classification_loss, torch.optim.SGD(
            model.parameters(), lr=0.01, momentum=0.9), agc=agc)
        losses, step_s, peak = _run_steps("resnet_" + label, step, batch)
        result[label] = dict(step_ms=step_s * 1e3,
                             images_per_s=RESNET_BATCH / step_s,
                             peak_mem_gb=peak / 1e9, loss_first=losses[0],
                             loss_last=losses[-1], agc=agc, **extra)
        del step, model, batch
        torch.cuda.empty_cache()
    if "resnet" in RESULTS:
        result["resnet50_pallas"] = {k: RESULTS["resnet"][k]
                                     for k in ("step_ms", "peak_mem_gb")}
    print("resnet_nf: %s" % json.dumps(result), flush=True)
    hvd.shutdown()


def phase_vgg16():
    """bench.py's vgg16 row: VGG16 at batch 64 x 224 x 224, SGD 0.01
    momentum 0.9, dropout on: finite, falling losses, step time, peak
    memory."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import VGG16
    from horovod_tpu_torch.parallel import (classification_loss,
                                            make_train_step)

    hvd.init()
    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = VGG16(dtype=torch.bfloat16, device=dev, generator=gen)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    batch = _image_batch(VGG_BATCH, IMAGE, gen, dev)
    step = make_train_step(model, classification_loss, torch.optim.SGD(
        model.parameters(), lr=0.01, momentum=0.9))
    losses, step_s, peak = _run_steps("vgg16", step, batch)
    print("vgg16: %s" % json.dumps(dict(
        step_ms=step_s * 1e3, images_per_s=VGG_BATCH / step_s,
        peak_mem_gb=peak / 1e9, loss_first=losses[0],
        loss_last=losses[-1])), flush=True)
    hvd.shutdown()


def _w2v_inputs(dev):
    """bench.py's word2vec draws (bench.py:2212-2231): Zipf-like ids from
    seed 0, tables from seed 1."""
    import numpy as np
    import torch
    V, D, B, K = (W2V_ROW[k] for k in "VDBK")
    rng = np.random.RandomState(0)
    p = 1.0 / np.arange(1, V + 1)
    p /= p.sum()
    ids = [torch.from_numpy(rng.choice(V, size=n, p=p)).to(dev)
           for n in (B, B, K)]
    r = np.random.RandomState(1)
    tables = (r.randn(V, D).astype(np.float32) * 0.1,
              r.randn(V, D).astype(np.float32) * 0.1,
              np.zeros((V,), np.float32))
    return ids, [torch.from_numpy(t).to(dev) for t in tables]


def _w2v_run(dev, sparse, ids, tables, steps):
    """``steps`` steps of one plane from ``tables``: (its numbers, the
    tables after them)."""
    import torch
    from horovod_tpu_torch.models import SkipGram
    from horovod_tpu_torch.models.word2vec import (make_dense_step,
                                                   make_sparse_step)
    V, D = W2V_ROW["V"], W2V_ROW["D"]
    model = SkipGram(V, D, device=dev)
    with torch.no_grad():
        for p, t in zip((model.embedding.weight, model.nce_weight,
                         model.nce_bias), tables):
            p.copy_(t)
    step = (make_sparse_step if sparse else make_dense_step)(
        model, W2V_ROW["lr"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(*ids).item())
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    if steps < 2:
        return None, None
    _check_losses("word2vec " + ("sparse" if sparse else "dense"), losses)
    out = dict(ms_per_step=statistics.median(times[2:]) * 1e3,
               peak_above_start_mb=peak / 1e6, loss_first=losses[0],
               loss_last=losses[-1])
    return out, [p.detach() for p in (model.embedding.weight,
                                      model.nce_weight, model.nce_bias)]


def phase_word2vec():
    """bench.py's word2vec row (V 50000, D 256, B 4096, K 512, lr 0.5) on a
    one-rank NCCL group: W2V_ROW["steps"] steps on the sparse plane
    (allreduce_sparse, apply_sparse_) and on the dense one from the same
    tables; the tables after them within W2V_TABLE_TOL; the sparse path's
    peak memory above the tables below one [V, D] table (no dense
    gradient). Then MnistCNN (5 SGD steps at batch 64) and a checkpoint
    save/restore round trip of ResNet50NF's state and its optimizer's,
    equal bit for bit."""
    import tempfile
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.models import MnistCNN, ResNet50NF
    from horovod_tpu_torch.parallel import (classification_loss,
                                            make_train_step)

    hvd.init()
    dev = hvd.device()
    ids, tables = _w2v_inputs(dev)
    result, final = {}, {}
    # one step of each first, on throwaway tables: cuBLAS takes its
    # workspaces (one a thread: the forward's and autograd's) from the
    # allocator at its first product, which would count in the peak
    for label in ("sparse", "dense"):
        _w2v_run(dev, label == "sparse", ids, tables, 1)
    for label in ("sparse", "dense"):
        result[label], final[label] = _w2v_run(dev, label == "sparse", ids,
                                               tables, W2V_ROW["steps"])
    gaps = {name: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for name, a, b in zip(("emb", "nce_w", "nce_b"),
                                  final["sparse"], final["dense"])}
    result["table_gaps"] = gaps
    table_mb = W2V_ROW["V"] * W2V_ROW["D"] * 4 / 1e6
    result["table_mb"] = table_mb
    log("word2vec: sparse %.3f ms, dense %.3f ms a step; tables after %d "
        "steps: %s" % (result["sparse"]["ms_per_step"],
                       result["dense"]["ms_per_step"], W2V_ROW["steps"],
                       gaps))
    if not max(gaps.values()) <= W2V_TABLE_TOL:
        fail("word2vec: the sparse and dense tables disagree: %s > %g"
             % (gaps, W2V_TABLE_TOL))
    if not result["sparse"]["peak_above_start_mb"] < table_mb:
        fail("word2vec: the sparse path's peak above its start (%.1f MB) "
             "holds a [V, D] table (%.1f MB)" % (
                 result["sparse"]["peak_above_start_mb"], table_mb))
    del final, tables

    gen = torch.Generator(device=dev).manual_seed(0)
    mnist = MnistCNN(device=dev, generator=gen)
    batch = {"x": torch.randn(MNIST_BATCH, 1, 28, 28, generator=gen,
                              device=dev),
             "y": torch.randint(0, 10, (MNIST_BATCH,), generator=gen,
                                device=dev)}
    step = make_train_step(mnist, classification_loss,
                           torch.optim.SGD(mnist.parameters(), lr=0.01))
    losses, _, _ = _run_steps("mnist", step, batch, warmup=0,
                              timed=MNIST_STEPS)
    result["mnist_losses"] = losses

    def nf_and_opt(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        model = ResNet50NF(num_classes=1000, device=dev, generator=g)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
            model.named_parameters(), agc=AGC_CLIPPING)
        step = make_train_step(model, classification_loss, opt)
        step(_image_batch(8, IMAGE, g, dev))
        return model, opt.optimizer

    model, opt = nf_and_opt(1)
    tree = {"model": model.state_dict(), "opt": opt.state_dict()}
    other, other_opt = nf_and_opt(2)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, tree, step=1)
        back = checkpoint.restore(d, {"model": other.state_dict(),
                                      "opt": other_opt.state_dict()}, step=1)
    other.load_state_dict(back["model"])
    other_opt.load_state_dict(back["opt"])
    bad = [k for k, v in tree["model"].items()
           if not torch.equal(other.state_dict()[k], v)]
    for i, st in tree["opt"]["state"].items():
        bad += ["opt.%s.%s" % (i, k) for k, v in st.items()
                if not torch.equal(other_opt.state_dict()["state"][i][k], v)]
    result["checkpoint_leaves"] = len(tree["model"]) + sum(
        len(st) for st in tree["opt"]["state"].values())
    if bad or other_opt.state_dict()["param_groups"] != \
            tree["opt"]["param_groups"]:
        fail("checkpoint round trip differs at %s" % bad[:5])
    result["checkpoint_equal"] = True
    print("word2vec: %s" % json.dumps(result), flush=True)
    hvd.shutdown()


LAUNCH_STEPS = 6
_LAUNCH_FINAL = {}  # run a's final state, once the launch phase ran
LAUNCH_KILL_AFTER = 3
LAUNCH_PROFILE_STEP = 5  # in run c, the restarted process's last step
LAUNCH_TIMEOUT = 420  # seconds a launched run may take
CRC_CHECK_BYTES = 4 << 20
CRC_RATE_BYTES = 256 << 20


def _launched(cmd, env, timeout=LAUNCH_TIMEOUT):
    """Runs one launcher command in its own session from the checkout's
    root; on a timeout kills its whole process group. Returns (rc, stdout,
    stderr, seconds)."""
    import os
    import signal
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail("launched run timed out after %d s: %s\n%s" % (
            timeout, " ".join(cmd), err[-4000:]))
    return proc.returncode, out, err, time.perf_counter() - t0


def _launch_reports(out):
    return [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
            if line.startswith("LAUNCH_REPORT ")]


def _max_gap(a, b):
    """max |a - b| over the saved parameters and Adam moments (f32)."""
    gap = 0.0
    for key in ("params", "exp_avg", "exp_avg_sq"):
        for name, t in a[key].items():
            gap = max(gap, (t.float() - b[key][name].float()).abs().max()
                      .item())
    return gap


def _same_state(a, b):
    """The saved parameters, Adam moments and step counts equal bit for
    bit."""
    import torch
    return a["adam_step"] == b["adam_step"] and all(
        torch.equal(t, b[key][name]) for key in ("params", "exp_avg",
                                                 "exp_avg_sq")
        for name, t in a[key].items())


def phase_launch(card):
    """The train phase's LM started by the port's launcher (a), again (b),
    and killed and restarted by the elastic driver from its durable
    checkpoint (c); the crc32c library against its plain version (d).
    Returns K1-K3's launches in runs a and c."""
    import os
    import shutil
    import tempfile
    import torch
    from horovod_tpu_torch.elastic import durable

    torch.cuda.empty_cache()  # the workers need the card's memory
    gen = torch.Generator().manual_seed(0)
    blob = torch.randint(0, 256, (CRC_CHECK_BYTES,), dtype=torch.uint8,
                         generator=gen).numpy().tobytes()
    native = durable.crc32c(blob)
    plain = durable._py_crc32c(blob)
    if native != plain:
        fail("launch: native crc32c %08x != _py_crc32c %08x on %d seeded "
             "bytes" % (native, plain, len(blob)))
    big = torch.randint(0, 256, (CRC_RATE_BYTES,), dtype=torch.uint8,
                        generator=gen)
    durable.crc32c(big[:1 << 20])
    t0 = time.perf_counter()
    durable.crc32c(big)
    crc_gbs = CRC_RATE_BYTES / (time.perf_counter() - t0) / 1e9
    del big
    log("launch: crc32c equal to _py_crc32c on %d seeded bytes; %.2f GB/s "
        "on %d MiB (%s)" % (len(blob), crc_gbs, CRC_RATE_BYTES >> 20, card))

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_launch_"))
    env = dict(os.environ)
    for key in ("MASTER_ADDR", "MASTER_PORT", "PYTHONUNBUFFERED"):
        env.pop(key, None)
    worker = [sys.executable, "tests/torch_port_launch_worker.py",
              "--steps", str(LAUNCH_STEPS)]
    profiled = ["--profile-step", str(LAUNCH_PROFILE_STEP)]
    launcher = [sys.executable, "-m", "horovod_tpu_torch.run"]
    runs, finals = {}, {}
    try:
        for label in ("a", "b", "c"):
            out_dir = tmp / label
            out_dir.mkdir()
            if label == "c":
                cmd = launcher + ["-np", "1", "--min-np", "1", "--max-np",
                                  "1", "--ckpt-dir", str(tmp / "ckpt"),
                                  "--restart-from-ckpt", "-H", "localhost:1"
                                  ] + worker + [
                    "--out", str(out_dir),
                    "--kill-after", str(LAUNCH_KILL_AFTER)] + profiled
            else:
                cmd = launcher + ["-np", "1", "-H", "localhost:1"] + \
                    worker + ["--out", str(out_dir)] + (
                        profiled if label == "a" else [])
            rc, out, err, seconds = _launched(cmd, env)
            reports = _launch_reports(out)
            log("launch %s: rc %d, %.1f s, %d report(s)" % (
                label, rc, seconds, len(reports)))
            if rc != 0 or not reports:
                fail("launch run %s exited %d:\n%s" % (label, rc,
                                                        err[-6000:]))
            for r in reports:
                if not r["device"].startswith("cuda"):
                    fail("launch run %s: a worker ran on %s" % (
                        label, r["device"]))
                if r["bad_launches"]:
                    fail("launch run %s: K1-K3 launches other than %d a "
                         "step: %s" % (label, MODEL["num_layers"],
                                       r["bad_launches"][:6]))
            runs[label] = dict(reports=reports, seconds=seconds,
                               restarts=err.count("full-job restart "))
            finals[label] = torch.load(out_dir / "final.pt")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _LAUNCH_FINAL["a"] = finals["a"]  # the fleet phase's reference

    for label in ("a", "b"):
        r = runs[label]["reports"]
        if len(r) != 1 or r[0]["start_step"] != 0 or \
                r[0]["step"] != LAUNCH_STEPS or runs[label]["restarts"]:
            fail("launch run %s: %s" % (label, r))
    killed, resumed = runs["c"]["reports"][:1], runs["c"]["reports"][1:]
    restarts = runs["c"]["restarts"]
    if restarts != 1 or len(resumed) != 1 or not killed[0]["killed"] or \
            resumed[0]["start_step"] != LAUNCH_KILL_AFTER or \
            resumed[0]["restores"] != 1 or \
            resumed[0]["step"] != LAUNCH_STEPS:
        fail("launch run c: %d restart(s), reports %s" % (
            restarts, runs["c"]["reports"]))
    ab_equal = _same_state(finals["a"], finals["b"])
    ab_gap = 0.0 if ab_equal else _max_gap(finals["a"], finals["b"])
    ac_equal = _same_state(finals["a"], finals["c"])
    ac_gap = 0.0 if ac_equal else _max_gap(finals["a"], finals["c"])
    if not (ac_equal if ab_equal else ac_gap <= ab_gap):
        fail("launch: the restarted run's final state differs from run "
             "a's by %.3g (runs a and b: %s)" % (
                 ac_gap, "equal" if ab_equal else "%.3g" % ab_gap))
    first = killed[0]
    write_s = first["write_s"] + resumed[0]["write_s"]
    crc_s = first["crc_s"] + resumed[0]["crc_s"]
    crc_bytes = first["crc_bytes"] + resumed[0]["crc_bytes"]
    shards = first["shards"] + resumed[0]["shards"]
    result = dict(
        card=card, steps=LAUNCH_STEPS, params=first["params"],
        restarts=restarts, resumed_step=resumed[0]["start_step"],
        a_b_bitwise=ab_equal, a_b_max_abs_gap=ab_gap,
        a_c_bitwise=ac_equal, a_c_max_abs_gap=ac_gap,
        checkpoint_bytes=first["durable_bytes"] // max(
            1, first["durable_writes"]),
        durable_writes=[first["durable_writes"],
                        resumed[0]["durable_writes"]],
        write_s=write_s, median_write_s=statistics.median(write_s),
        crc32c_gb_s=crc_gbs,
        writer_crc32c_gb_s=crc_bytes / sum(crc_s) / 1e9 if crc_s else None,
        median_step_ms={k: runs[k]["reports"][0]["median_step_ms"]
                        for k in ("a", "b")},
        median_commit_ms={k: runs[k]["reports"][0]["median_commit_ms"]
                          for k in ("a", "b")},
        c_median_step_ms=[r["median_step_ms"] for r in runs["c"]["reports"]],
        c_median_commit_ms=[r["median_commit_ms"]
                            for r in runs["c"]["reports"]],
        step_ms={k: [r["step_ms"] for r in runs[k]["reports"]]
                 for k in runs},
        enqueue_ms={k: [r["enqueue_ms"] for r in runs[k]["reports"]]
                    for k in runs},
        profiled_step={k: [r["profile"] for r in runs[k]["reports"]
                           if r["profile"]] for k in ("a", "c")},
        shards=shards,
        shard_profile_median_s={
            part: statistics.median(sh[part] for sh in shards)
            for part in ("seconds", "stage_seconds", "pickle_seconds",
                         "crc_seconds", "write_seconds", "fsync_seconds")},
        peak_device_gib={k: [r["peak_device_bytes"] / 2 ** 30
                             for r in runs[k]["reports"]] for k in runs},
        losses={k: [x for r in runs[k]["reports"] for x in r["losses"]]
                for k in runs},
        seconds={k: runs[k]["seconds"] for k in runs})
    print("launch: " + json.dumps(result), flush=True)
    counts = {}
    for label in ("a", "c"):
        for r in runs[label]["reports"]:
            for name, n in r["launches"].items():
                counts[name] = counts.get(name, 0) + n
    return counts


# The core phase (ROADMAP A8c1, A8c2): the port's build of the negotiation
# core on this machine's host, two CPU ranks of the asynchronous API under
# the launcher (one H100 holds one NCCL rank), and CUDA tensors through the
# core's device op on a one-rank NCCL group in this process
CORE_WORKER = "tests/torch_port_core_worker.py"
CORE_NP = 2
CORE_F32_TOL = 1e-5         # a float32 sum of CORE_NP ranks against numpy's
CORE_TIMEOUT_S = 180
CORE_SCALES = (2.0, 0.25)   # the pre- and postscale of the CUDA checks
CORE_LONG_SLEEP = 1 << 31   # cycles of the side stream's long kernel (~1 s)
# the core's counters of its CPU ops: none may move on CUDA tensors
CORE_HOST_COUNTERS = ("net_ring_bytes_sent_total", "net_ring_bytes_recv_total",
                      "allreduce_uncompressed_total", "allreduce_bf16_total",
                      "allreduce_int8_total", "reduce_scatter_total")


def _core_scaled(x, factor):
    """``x`` scaled as the core scales a buffer: the product in double,
    cast back (an integer truncates)."""
    import torch
    if factor == 1.0:
        return x.clone()
    if x.dtype == torch.float64:
        return x * factor
    return (x.to(torch.float64) * factor).to(x.dtype)


def _core_counters(core):
    c = json.loads(core.get_core().metrics_json())["counters"]
    return {k: c.get(k, 0) for k in CORE_HOST_COUNTERS}


def core_cuda_checks():
    """CUDA tensors through the core's device op on a one-rank NCCL group
    (ROADMAP A8c2), each result held with ``torch.equal`` to what one rank
    implies, computed in the same order; returns (checks, the names that
    failed)."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import async_ops, core, device_plane
    sync = async_ops.synchronize
    t0 = time.perf_counter()
    c = core.init()
    plane = device_plane.current()
    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(21)
    checks, bad = {}, []

    def check(name, ok):
        checks[name] = bool(ok)
        if not ok:
            bad.append(name)

    # a host name first, then the same name on the GPU (the cache key)
    host = np.arange(12, dtype=np.float32)
    check("host_name_on_host", np.array_equal(
        sync(async_ops.allreduce_async(host, "core.reuse")), host))
    before, responses0 = _core_counters(core), plane.responses
    x_reuse = torch.arange(12, dtype=torch.float32, device=dev)
    for i in range(2):  # a fresh negotiation, then a cache hit
        check("host_name_on_gpu_%d" % i, torch.equal(sync(
            async_ops.allreduce_async(x_reuse, "core.reuse")), x_reuse))
    pre, post = CORE_SCALES
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        if dtype == torch.int64:
            x = torch.randint(-1000, 1000, (1000, 33), device=dev,
                              generator=gen)
        else:
            x = torch.randn(1000, 33, device=dev, generator=gen).to(dtype)
        tag = str(dtype).replace("torch.", "")
        want = _core_scaled(_core_scaled(x, pre), post)
        got = sync(async_ops.allreduce_async(
            x, "core.ar." + tag, prescale_factor=pre, postscale_factor=post))
        check("allreduce_" + tag, got.is_cuda and torch.equal(got, want))
        y = x.clone()
        out = sync(async_ops.allreduce_async(
            y, "core.ar_out." + tag, prescale_factor=pre,
            postscale_factor=post, out=y))
        check("allreduce_out_aliasing_" + tag, out is y and
              torch.equal(y, want))
        got = sync(async_ops.reduce_scatter_async(
            x, "core.rs." + tag, prescale_factor=pre, postscale_factor=post))
        check("reduce_scatter_" + tag, torch.equal(
            got, _core_scaled(_core_scaled(x.reshape(-1), pre), post)))
        got = sync(async_ops.allgather_async(x, "core.ag." + tag))
        check("allgather_" + tag, got.is_cuda and torch.equal(got, x))
        y = x.clone()
        out = sync(async_ops.broadcast_async(y, 0, "core.bc." + tag, out=y))
        check("broadcast_out_aliasing_" + tag, out is y and
              torch.equal(y, x))
    x53 = torch.randn(5, 3, device=dev, generator=gen)
    got = sync(async_ops.allgather_async(x53, "core.ag53"))
    check("allgather_5x3", got.shape == (5, 3) and torch.equal(got, x53))
    group = hvd.new_group([0])
    check("group_core_id", group.core_id == group.id)
    got = sync(async_ops.allreduce_async(x53, "core.grp", group=group))
    check("allreduce_group", torch.equal(got, x53))
    # 16 small allreduces enqueued together: fused into fewer responses
    r0, t0_ = c.perf_counters()
    small = [torch.full((256,), float(i), device=dev) for i in range(16)]
    handles = [async_ops.allreduce_async(t, "core.fuse.%d" % i)
               for i, t in enumerate(small)]
    check("fusion_equal", all(torch.equal(sync(h), t)
                              for h, t in zip(handles, small)))
    r1, t1_ = c.perf_counters()
    checks["fusion_tensors"], checks["fusion_responses"] = t1_ - t0_, r1 - r0
    if not (t1_ - t0_ == 16 > r1 - r0 >= 1):
        bad.append("fusion counters")
    # an input a long kernel on a side stream writes; the result read on a
    # third stream after synchronize
    side, third = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    z = torch.zeros(1 << 20, device=dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(CORE_LONG_SLEEP)
        z.fill_(3.0)
        h = async_ops.allreduce_async(z, "core.long", postscale_factor=0.5)
    polled = [async_ops.poll(h)]
    time.sleep(0.05)
    polled.append(async_ops.poll(h))
    with torch.cuda.stream(third):
        got = sync(h)
        read = (got * 2.0).sum()
    third.synchronize()
    check("long_kernel_poll_false_before", polled == [False, False])
    check("long_kernel_result", float(read) == 3.0 * z.numel())
    torch.cuda.synchronize()
    after = _core_counters(core)
    moved = {k: after[k] - before[k] for k in CORE_HOST_COUNTERS}
    checks["host_plane_deltas"] = moved
    if any(moved.values()):
        bad.append("host plane moved %s" % moved)
    checks["device_responses"] = plane.responses - responses0
    checks["ring_bytes"] = moved["net_ring_bytes_sent_total"] + \
        moved["net_ring_bytes_recv_total"]
    checks["cuda_seconds"] = time.perf_counter() - t0
    core.shutdown()
    return checks, bad


def phase_core(card):
    """The negotiation core: built with g++ in the build phase, the
    asynchronous API of ``python -m horovod_tpu_torch.run -np 2`` CPU
    ranks held against numpy (sums, gathers, broadcasts, a reduce-scatter,
    bfloat16, an out-of-order enqueue, the fusion counters), and CUDA
    tensors in this process on a one-rank NCCL group through the core's
    device op (``core_cuda_checks``). Deterministic checks only: nothing
    is timed against a limit."""
    import os
    import subprocess
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import async_ops, core
    t0 = time.perf_counter()
    build_s = CORE_BUILD.get("seconds", 0.0) + core.build()
    lib = core.get_core()
    if lib.build_id != core.digest() or lib.crc32c(b"123456789") != \
            0xE3069283:
        fail("core: the library %s answers as build %s (want %s)"
             % (lib.path, lib.build_id, core.digest()))
    env = dict(os.environ)
    for key in list(env):
        if key.startswith("HVD_TPU_") or key in (
                "MASTER_ADDR", "MASTER_PORT", "PYTHONUNBUFFERED"):
            env.pop(key)
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    t1 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np",
             str(CORE_NP), sys.executable, str(ROOT / CORE_WORKER),
             "smoke"], env=env, cwd=str(ROOT), capture_output=True,
            text=True, timeout=CORE_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        fail("core: the %d-rank worker ran past %d s:\n%s" % (
            CORE_NP, CORE_TIMEOUT_S, (e.stderr or "")[-2000:]))
    job_s = time.perf_counter() - t1
    docs = [json.loads(line.split(" ", 1)[1])
            for line in proc.stdout.splitlines()
            if line.startswith("CORE_SMOKE ")]
    if proc.returncode != 0 or sorted(d["rank"] for d in docs) != \
            list(range(CORE_NP)):
        fail("core: the %d-rank worker exited %d with %d reports:\n%s\n%s"
             % (CORE_NP, proc.returncode, len(docs), proc.stdout[-2000:],
                proc.stderr[-3000:]))
    for d in docs:
        bad = [k for k in ("allreduce_int64_equal", "allreduce_bf16_equal",
                           "allgather_equal", "broadcast_equal",
                           "fusion_equal") if d[k] is not True]
        if d["allreduce_f32_max_err"] > CORE_F32_TOL:
            bad.append("allreduce_f32_max_err")
        if d["reduce_scatter_max_err"] > CORE_F32_TOL:
            bad.append("reduce_scatter_max_err")
        if d["out_of_order_jobs"] != 24 or d["size"] != CORE_NP:
            bad.append("out_of_order_jobs")
        if not d["fusion_tensors"] == 16 > d["fusion_responses"] >= 1:
            bad.append("fusion counters")
        if bad:
            fail("core: rank %d: %s: %s" % (d["rank"], bad, json.dumps(d)))
    # CUDA tensors through the device op, on a one-rank NCCL group
    own = not hvd.is_initialized()
    if own:
        hvd.init()
    try:
        if torch.distributed.get_backend(hvd.process_group()) != "nccl":
            fail("core: the process group is not NCCL")
        cuda, bad = core_cuda_checks()
    finally:
        if own:
            hvd.shutdown()
    log("core cuda: %s" % json.dumps(cuda))
    if bad:
        fail("core: CUDA tensors through the device op: %s" % bad)
    if async_ops._handle_map or core.is_initialized():
        fail("core: handles left behind, or the core still running")
    seconds = time.perf_counter() - t0
    out = dict(card=card, build_s=build_s, job_s=job_s, seconds=seconds,
               library=lib.path.name, ranks=docs, cuda=cuda,
               nccl_built=hvd.nccl_built())
    log("core: %s" % json.dumps(out))
    print(json.dumps({"core": out}), flush=True)


# The serve phase: bench.py --serve's curve (bench.py:676-699: the affine
# model at dim 16 on 2 replicas, 3 s at each rate, load seed 12) and its
# traffic step (:721-722: the mlp at dim 2048, 280 rps, load seed 13) in
# three windows: 5 s with a swap, 4 s with a kill, 3 s after the respawn
SERVE_CURVE = dict(model="affine", dim=16, rates=(20, 40, 80), seconds=3.0,
                   seed=12)
SERVE_STEP = dict(model="mlp", dim=2048, rate=280, swap_s=5.0, kill_s=4.0,
                  after_s=3.0, seed=13)
SERVE_MAX_BATCH = 16        # the replica's default --max-batch
SERVE_FWD_TOL = 1e-4        # make_forward against the numpy forward
SERVE_BOOT_S = 60           # each replica imports torch, makes a CUDA
                            # context and loads the lineage (bench.py:660)
SERVE_LOAD_PROCS = 4        # load processes
SERVE_LOAD_THREADS = 128    # sender threads in each
SERVE_MIN_SHARE = 0.9       # achieved over offered rate, at the least


def _free_port_block(n):
    """A base port with n consecutive free ports on the loopback, below
    the kernel's range of ephemeral ports where it can: there the load's
    own outgoing connections take no replica's port, and a connection to
    a replica that is down cannot meet itself (a TCP self-connect)."""
    import random
    import socket
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 0
    lo, hi = (10000, low - n) if low - n > 12000 else (20000, 55000)
    for _ in range(64):
        base = random.randint(lo, hi)
        socks = []
        try:
            for i in range(n):
                sock = socket.socket()
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                sock.bind(("127.0.0.1", base + i))
                socks.append(sock)
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
        return base
    fail("serve: no block of %d free ports" % n)


def _get_json(url, timeout=2.0):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _serve_env(model, dim, port_base, ckpt_dir):
    """The replicas' env: the card (no HVD_TPU_SERVE_DEVICE), this
    checkout first on PYTHONPATH."""
    import os
    env = dict(os.environ)
    for key in ("HVD_TPU_SERVE_DEVICE", "MASTER_ADDR", "MASTER_PORT",
                "PYTHONUNBUFFERED"):
        env.pop(key, None)
    env.update({"PYTHONPATH": str(ROOT), "HVD_TPU_SERVE_MODEL": model,
                "HVD_TPU_SERVE_DIM": str(dim),
                "HVD_TPU_SERVE_PORT": str(port_base),
                "HVD_TPU_CKPT_DIR": str(ckpt_dir),
                "HVD_TPU_SERVE_SWAP_INTERVAL": "0.2"})
    return env


def _wait_replicas(endpoints, n, label):
    """{endpoint: /healthz} of n serving replicas, each on the GPU."""
    deadline = time.monotonic() + SERVE_BOOT_S
    while True:
        docs = {}
        for ep in endpoints():
            try:
                doc = _get_json("http://%s/healthz" % ep, timeout=1.0)
            except (OSError, ValueError):
                continue
            if doc.get("ok") and not doc.get("draining"):
                docs[ep] = doc
        if len(docs) >= n:
            break
        if time.monotonic() > deadline:
            fail("serve %s: %d of %d replicas answered within %d s" % (
                label, len(docs), n, SERVE_BOOT_S))
        time.sleep(0.1)
    off = {ep: d.get("device") for ep, d in docs.items()
           if not str(d.get("device")).startswith("cuda")}
    if off:
        fail("serve %s: replicas off the GPU: %s" % (label, off))
    return docs


def _serve_load_slice(task):
    """One load process's share of an open-loop schedule: request k
    (rid ``rid_base + k``) is sent at ``start + k / rate`` by process
    ``k mod procs``, from one of its sender threads, through the port's
    ``ServeClient`` (its rotation, retries and causes). A request's body
    is encoded before its time and its answer parsed after the window, so
    that the load's own JSON (about 3.5 ms a request at dim 2048) is off
    the clock. Returns the answers unchecked (the parent checks them) and
    the errors."""
    import http.client
    import threading
    import numpy as np
    if task["root"] not in sys.path:
        sys.path.insert(0, task["root"])
    from horovod_tpu_torch.serve.client import ServeClient, ServeError
    from horovod_tpu_torch.serve.loadgen import request_input

    class Client(ServeClient):
        body = b""

        def __init__(self, endpoints, first, **kwargs):
            super().__init__(endpoints, **kwargs)
            self._rr = first  # the senders start on different replicas

        def _post(self, endpoint, doc, timeout):
            host, port = endpoint.rsplit(":", 1)
            conn = http.client.HTTPConnection(host, int(port),
                                              timeout=timeout)
            try:
                conn.request("POST", "/infer", body=self.body, headers={
                    "Content-Type": "application/json"})
                resp = conn.getresponse()
                status, raw = resp.status, resp.read()
            finally:
                conn.close()
            if status == 200:
                return {"y": raw}  # parsed after the window
            try:
                doc = json.loads(raw.decode("utf-8"))
            except ValueError:
                doc = {"error": "HTTP %d" % status}
            doc.setdefault("cause", "http")
            doc["_status"] = status
            return doc

    def endpoints():  # the parent rewrites the file as the pool changes
        with open(task["endpoints_file"]) as f:
            return json.load(f)
    mine = list(range(task["slice"], task["n"], task["procs"]))
    interval = 1.0 / task["rate"]
    lock = threading.Lock()
    answers, errors = [], []

    def sender(j, ks):
        client = Client(endpoints, j, total_deadline=task["deadline"])
        for k in ks:
            rid = task["rid_base"] + k
            x = request_input(task["seed"], rid, task["dim"])
            client.body = json.dumps({"id": str(rid), "x": [
                float(v) for v in x]}).encode("utf-8")
            wake = task["start"] + k * interval
            delay = wake - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            sent = time.monotonic()
            try:
                raw = client.infer((), rid=str(rid))["y"]
            except ServeError as e:
                with lock:
                    errors.append((rid, e.cause, str(e)))
                continue
            except Exception as e:  # anything else the client let out
                with lock:
                    errors.append((rid, type(e).__name__, str(e)))
                continue
            done = time.monotonic()
            with lock:
                answers.append((rid, sent - wake, done - wake, done, raw))

    threads = [threading.Thread(target=sender,
                                args=(j, mine[j::task["threads"]]))
               for j in range(task["threads"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rows = []
    for rid, lag, latency, done, raw in answers:
        try:
            doc = json.loads(raw.decode("utf-8"))
            rows.append((rid, lag, latency, done, doc.get("weights_crc"),
                         np.asarray(doc["y"], np.float32)))
        except (ValueError, KeyError, TypeError) as e:
            errors.append((rid, "bad-answer", str(e)))
    return rows, errors


def _serve_load_ready(root):
    """Imports a load process's modules before its first window."""
    if root not in sys.path:
        sys.path.insert(0, root)
    import horovod_tpu_torch.serve.client  # noqa: F401
    import horovod_tpu_torch.serve.loadgen  # noqa: F401
    time.sleep(0.2)  # so that every process of the pool takes one
    return True


class _ServeLoad:
    """The serve phase's load generator: SERVE_LOAD_PROCS processes (each
    its own interpreter, so a slow answer or a check holds no sender
    back), started once; the endpoints they send to are a file that
    ``set_endpoints`` rewrites."""

    def __init__(self, tmp):
        import multiprocessing
        self.endpoints_file = tmp / "endpoints.json"
        self.set_endpoints([])
        self.pool = multiprocessing.get_context("spawn").Pool(
            SERVE_LOAD_PROCS)
        self.pool.map(_serve_load_ready, [str(ROOT)] * SERVE_LOAD_PROCS,
                      chunksize=1)

    def set_endpoints(self, endpoints):
        import os
        part = self.endpoints_file.with_suffix(".part")
        part.write_text(json.dumps(list(endpoints)))
        os.replace(part, self.endpoints_file)

    def start(self, rate, seconds, dim, seed, rid_base, deadline):
        """Starts one window in the background; ``finish`` collects it."""
        n = max(1, int(rate * seconds))
        start = time.monotonic() + 0.25
        tasks = [dict(root=str(ROOT), endpoints_file=str(
            self.endpoints_file), slice=i, procs=SERVE_LOAD_PROCS,
            threads=SERVE_LOAD_THREADS, n=n, rate=rate, start=start,
            dim=dim, seed=seed, rid_base=rid_base, deadline=deadline)
            for i in range(SERVE_LOAD_PROCS)]
        return dict(rate=rate, seconds=seconds, n=n, start=start, dim=dim,
                    seed=seed, rid_base=rid_base, job=self.pool.map_async(
                        _serve_load_slice, tasks, chunksize=1))

    def run(self, *args, **kwargs):
        return self.finish(self.start(*args, **kwargs))

    def finish(self, window, timeout=120):
        """The window's answers and errors, once every sender is done."""
        rows, errors = [], []
        for r, e in window["job"].get(timeout=timeout):
            rows += r
            errors += e
        window.update(rows=rows, errors=errors)
        return window

    def close(self):
        self.pool.terminate()
        self.pool.join()


def _check_window(w, model, leaves_by_crc, label, bar="answers"):
    """Checks one window's answers, each against the numpy forward of the
    weight set its fingerprint names (one batched forward a set, then
    ``check_response``'s test a row: ``np.allclose``, atol 1e-3), and
    summarises it. Fails on an error, a wrong or missing answer, or a
    rate under SERVE_MIN_SHARE of the offered one: of the answers (``bar``
    "answers", the pool whole), or of the sends (``bar`` "sends": the
    window of the kill, where the survivor alone is past its capacity
    until the respawn serves, and only the load offered is held; None:
    no rate is held)."""
    import numpy as np
    from horovod_tpu_torch.serve import model as smodel
    from horovod_tpu_torch.serve.loadgen import request_input
    rows, rate = w["rows"], w["rate"]
    rids = sorted(r[0] for r in rows)
    expected = list(range(w["rid_base"], w["rid_base"] + w["n"]))
    mismatches, by_crc = [], {}
    for crc in sorted({r[4] for r in rows}, key=str):
        mine = [r for r in rows if r[4] == crc]
        by_crc[crc] = len(mine)
        if crc not in leaves_by_crc:
            mismatches += [(r[0], "unknown weights %r" % (crc,))
                           for r in mine]
            continue
        got = [r[5] for r in mine]
        bad = [r[0] for r, y in zip(mine, got) if y.shape != (w["dim"],)]
        if bad:
            mismatches += [(rid, "shape") for rid in bad]
            continue
        x = np.stack([request_input(w["seed"], r[0], w["dim"])
                      for r in mine])
        expect = smodel.forward(model, leaves_by_crc[crc], x)
        got = np.stack(got)
        good = np.isclose(got, expect, atol=1e-3).all(axis=1)
        mismatches += [
            (r[0], "answer does not match the %s weights it claims (max "
             "err %.3g)" % (crc, float(np.abs(g - e).max())))
            for r, g, e, ok in zip(mine, got, expect, good) if not ok]
    span = max((r[3] for r in rows), default=w["start"]) - w["start"]
    achieved = len(rows) / span if span > 0 else 0.0
    lat = sorted(r[2] for r in rows)
    # the last send's time past the window's start, over the schedule
    last_send = max(((r[0] - w["rid_base"]) / rate + r[1] for r in rows),
                    default=0.0)
    sent = len(rows) / last_send if last_send > 0 else float(rate)

    def q(p):
        return lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3 if lat \
            else None
    row = dict(offered_rps=rate, requests=w["n"], ok=len(rows),
               errors=len(w["errors"]), mismatches=len(mismatches),
               achieved_rps=achieved, sent_rps=sent, p50_ms=q(0.50),
               p99_ms=q(0.99),
               max_send_lag_ms=max((r[1] for r in rows), default=0) * 1e3,
               wall_s=span, by_crc=by_crc, host=w.get("host"))
    if w["errors"] or mismatches or rids != expected:
        fail("serve %s at %s rps: %d of %d answered (%d distinct), errors "
             "%s, mismatches %s" % (label, rate, len(rows), w["n"],
                                    len(set(rids)), w["errors"][:5],
                                    mismatches[:5]))
    held = achieved if bar == "answers" else sent
    if bar is not None and held < SERVE_MIN_SHARE * rate:
        fail("serve %s: %.1f rps %s of %s offered (at least %.0f %% "
             "needed): %s" % (label, held, "achieved" if bar == "answers"
                              else "sent", rate, 100 * SERVE_MIN_SHARE,
                              json.dumps(row)))
    return row


def _serve_forward():
    """make_forward on cuda:0 against the numpy forward in every bucket,
    timed as the replica calls it and its products alone."""
    import numpy as np
    import torch
    from horovod_tpu_torch.serve import model as smodel
    from horovod_tpu_torch.serve.batcher import BUCKETS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for name, dim in (("affine", SERVE_CURVE["dim"]),
                      ("mlp", SERVE_STEP["dim"])):
        leaves = smodel.init_leaves(name, dim, seed=1)
        fwd = smodel.make_forward(name, leaves)
        if fwd.device != torch.device("cuda", 0):
            fail("serve: make_forward ran on %s" % fwd.device)
        products = smodel._entry(name)[1]
        on_card = {k: torch.from_numpy(v).cuda() for k, v in leaves.items()}
        weight_bytes = sum(v.nbytes for v in leaves.values())
        macs = sum(v.size for v in leaves.values() if v.ndim == 2)
        rng = np.random.RandomState(dim)
        err, buckets = 0.0, {}
        for bucket in (b for b in BUCKETS if b <= SERVE_MAX_BATCH):
            x = rng.standard_normal((bucket, dim)).astype(np.float32)
            y = fwd(x)
            if y.shape != (bucket, dim) or not np.isfinite(y).all():
                fail("serve: %s forward gave %s" % (name, y.shape))
            err = max(err, float(np.abs(
                y - smodel.forward(name, leaves, x)).max()))
            xt = torch.from_numpy(x).cuda()
            t_bytes = (weight_bytes + 2 * x.nbytes) / PEAK_BYTES
            t_ops = 2 * bucket * macs / PEAK_F32_FLOPS
            buckets[bucket] = dict(
                forward_ms=time_ms(lambda: fwd(x)),
                products_ms=time_ms(lambda: products(on_card, xt)),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
        if err > SERVE_FWD_TOL:
            fail("serve: %s at dim %d: forward %.3g from the numpy one "
                 "(limit %g)" % (name, dim, err, SERVE_FWD_TOL))
        out[name] = dict(dim=dim, max_abs_err=err, buckets=buckets)
        del fwd, on_card
    torch.cuda.synchronize()
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return out


def _serve_curve(tmp, load):
    """bench.py --serve's curve through ``python -m horovod_tpu_torch.serve``;
    SIGTERM drains it."""
    import os
    import signal
    from horovod_tpu_torch.elastic.state import EXIT_DRAINED
    from horovod_tpu_torch.serve import model as smodel
    from horovod_tpu_torch.serve.swap import publish_leaves
    c = SERVE_CURVE
    leaves = smodel.init_leaves(c["model"], c["dim"], seed=1)
    crc = smodel.fingerprint(leaves)
    ckpt = tmp / "curve"
    publish_leaves(str(ckpt), 10, leaves)
    base = _free_port_block(5)  # replicas from base, the status port last
    status = "http://127.0.0.1:%d/serve" % (base + 4)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.serve", "-np", "2",
           "--model", c["model"], "--dim", str(c["dim"]), "--ckpt-dir",
           str(ckpt), "--port-base", str(base), "--status-port",
           str(base + 4), "--no-autoscale", "--drain-grace", "30"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=_serve_env(
        c["model"], c["dim"], base, ckpt), start_new_session=True)
    try:
        def endpoints():
            try:
                return _get_json(status, timeout=1.0)["endpoints"]
            except (OSError, ValueError, KeyError):
                return []
        health = _wait_replicas(endpoints, 2, "curve")
        boot_s = time.perf_counter() - t0
        load.set_endpoints(sorted(health))
        rows = []
        for i, rate in enumerate(c["rates"]):
            w = load.run(rate, c["seconds"], c["dim"], c["seed"],
                         rid_base=i * 100000, deadline=10.0)
            rows.append(_check_window(w, c["model"], {crc: leaves},
                                      "curve"))
            log("serve curve: %s" % json.dumps(rows[-1]))
        pool = _get_json(status)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != EXIT_DRAINED:
            fail("serve curve: the supervisor exited %s after SIGTERM, "
                 "not EXIT_DRAINED (%d)" % (rc, EXIT_DRAINED))
    finally:
        if proc.poll() is None:  # a failure above: tear the pool down
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return dict(boot_s=boot_s, rows=rows, rc=rc,
                # admission to answer inside the replicas over the three
                # rates (the histogram's bucket bounds, the worse replica)
                replica_quantiles_ms=[pool["p50_ms"], pool["p99_ms"]],
                devices={str(d["replica"]): d["device"]
                         for d in health.values()},
                batches=pool["batches_total"],
                responses=pool["responses_total"])


def _host_cpu():
    """The machine's busy and total CPU jiffies and each process's CPU
    jiffies and command line, from /proc."""
    import os
    with open("/proc/stat") as f:
        vals = [int(v) for v in f.readline().split()[1:]]
    procs = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % d) as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open("/proc/%s/cmdline" % d, "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(
                    "utf-8", "replace").strip()
            procs[int(d)] = (int(fields[11]) + int(fields[12]), cmd[-90:])
        except (OSError, IndexError, ValueError):
            continue
    idle = vals[3] + vals[4]
    return sum(vals) - idle, sum(vals), procs


def _host_share(before, after, seconds):
    """Over a window: the machine's busy share of its CPUs, and the six
    processes that used the most, in cores."""
    import os
    tick = os.sysconf("SC_CLK_TCK")
    used = sorted(((cpu - before[2].get(pid, (0, ""))[0]) / tick / seconds,
                   cmd) for pid, (cpu, cmd) in after[2].items())
    return dict(busy=(after[0] - before[0]) / max(1, after[1] - before[1]),
                cpus=os.cpu_count(),
                top=[[round(c, 2), cmd] for c, cmd in reversed(used[-6:])
                     if c > 0.005])


def _replica_pid(middleman_pid):
    """The replica process under the driver's middleman (killing it, not
    the middleman, leaves no orphan replica on its port)."""
    from horovod_tpu_torch.run.exec_middleman import _ppid_map
    for _ in range(100):
        kids = [p for p, pp in _ppid_map().items() if pp == middleman_pid]
        if kids:
            return kids[0]
        time.sleep(0.05)
    fail("serve step: no replica under middleman %d" % middleman_pid)


def _model_steps(endpoints):
    """The lineage steps the replicas serve, sorted; None for one that
    did not answer."""
    steps = []
    for ep in endpoints:
        try:
            steps.append(_get_json("http://%s/serve" % ep)["model_step"])
        except (OSError, ValueError, KeyError):
            steps.append(None)
    return sorted(steps, key=lambda v: (v is None, v))


def _respawned(sup, initial):
    """True once a replica the driver started after ``initial`` (worker
    ids) answers its health check."""
    for wid, ep in sup._replica_addrs():
        if wid not in initial:
            try:
                return bool(_get_json("http://%s/healthz" % ep,
                                      timeout=0.5).get("ok"))
            except (OSError, ValueError):
                return False
    return False


def _serve_step(tmp, load):
    """The traffic step on 2 replicas of the mlp at 2048, three windows at
    280 rps: a swap to step 20 during the first, a SIGKILL during the
    second, and the pool after the respawn, all on step 20, in the third.
    """
    import os
    import signal
    import threading
    from horovod_tpu_torch.elastic.state import EXIT_DRAINED
    from horovod_tpu_torch.serve import model as smodel
    from horovod_tpu_torch.serve.supervisor import ServeSupervisor
    from horovod_tpu_torch.serve.swap import publish_leaves
    s = SERVE_STEP
    old = smodel.init_leaves(s["model"], s["dim"], seed=2)
    new = smodel.init_leaves(s["model"], s["dim"], seed=3)
    crc_old, crc_new = smodel.fingerprint(old), smodel.fingerprint(new)
    ckpt = tmp / "step"
    publish_leaves(str(ckpt), 10, old)
    base = _free_port_block(4)  # 2 replicas and a respawn's id
    saved = os.environ.get("HVD_TPU_ELASTIC_COOLDOWN")
    os.environ["HVD_TPU_ELASTIC_COOLDOWN"] = "1"  # the respawn's wait
    try:
        sup = ServeSupervisor(
            [sys.executable, "-m", "horovod_tpu_torch.serve.replica"],
            {"localhost": 2}, min_replicas=1, max_replicas=2, np_initial=2,
            port_base=base, env=_serve_env(s["model"], s["dim"], base,
                                           ckpt))
    finally:
        if saved is None:
            os.environ.pop("HVD_TPU_ELASTIC_COOLDOWN")
        else:
            os.environ["HVD_TPU_ELASTIC_COOLDOWN"] = saved
    box = {}
    driver = threading.Thread(target=lambda: box.update(
        rc=sup.driver.run(install_signal_handlers=False)), daemon=True)
    t0 = time.monotonic()
    driver.start()

    def window(seconds, rid_base):
        load.set_endpoints(sup.endpoints())
        w = load.start(s["rate"], seconds, s["dim"], s["seed"],
                       rid_base=rid_base, deadline=30.0)
        w["host0"] = (time.monotonic(), _host_cpu())
        return w

    def finish(w, label):
        """The window's answers, and the host's CPU over it, logged
        before the window is checked."""
        done = load.finish(w)
        t0, before = done.pop("host0")
        done["host"] = _host_share(before, _host_cpu(),
                                   time.monotonic() - t0)
        log("serve %s window host: %s" % (label, json.dumps(done["host"])))
        return done
    try:
        health = _wait_replicas(sup.endpoints, 2, "step")
        boot_s = time.monotonic() - t0
        # the swap: step 20 published 1 s into the window
        w = window(s["swap_s"], 900000)
        time.sleep(max(0.0, w["start"] + 1.0 - time.monotonic()))
        publish_leaves(str(ckpt), 20, new)
        t_pub = time.monotonic()
        while _model_steps(sup.endpoints()) != [20, 20]:
            if time.monotonic() - t_pub > 15:
                fail("serve step: the replicas did not swap to step 20")
            time.sleep(0.05)
        swapped_s = time.monotonic() - t_pub
        done = finish(w, "swap")
        # each replica's swap: the seconds of its stages and the batch
        # loop's longest gap around it, printed before the window's checks
        swap_profiles = {}
        for ep in sup.endpoints():
            try:
                view = _get_json("http://%s/serve" % ep)
                swap_profiles[str(view["replica"])] = dict(
                    view.get("swap_profile") or {},
                    replica_p50_ms=view.get("p50_ms"),
                    replica_p99_ms=view.get("p99_ms"))
            except (OSError, ValueError, KeyError):
                swap_profiles[ep] = None
        log("serve swap profiles: %s" % json.dumps(swap_profiles))
        if swapped_s > s["swap_s"] - 1.5:
            fail("serve step: the swap took %.2f s of the %.0f s window" %
                 (swapped_s, s["swap_s"]))
        swap = _check_window(done, s["model"],
                             {crc_old: old, crc_new: new}, "swap")
        swap["replicas"] = swap_profiles
        if not swap["by_crc"].get(crc_old) or \
                not swap["by_crc"].get(crc_new):
            fail("serve step: answers by weights %s do not cross the swap"
                 % swap["by_crc"])
        # the kill, 1 s into the window; every answer by step 20's weights
        initial = set(sup.driver.live_workers())
        victim = min(initial)
        w = window(s["kill_s"], 910000)
        time.sleep(max(0.0, w["start"] + 1.0 - time.monotonic()))
        os.kill(_replica_pid(sup.driver.worker_pid(victim)), signal.SIGKILL)
        t_kill = time.monotonic()
        respawn_s = None
        while not w["job"].ready() or respawn_s is None:
            load.set_endpoints(sup.endpoints())  # the pool as it changes
            if respawn_s is None and _respawned(sup, initial):
                respawn_s = time.monotonic() - t_kill
            if time.monotonic() - t_kill > 120:
                fail("serve step: %s 120 s after the kill" % (
                    "the load hung" if not w["job"].ready() else
                    "no replica replaced the killed one"))
            time.sleep(0.05)
        kill = _check_window(finish(w, "kill"), s["model"], {crc_new: new},
                             "kill", bar="sends")
        after = _wait_replicas(
            lambda: [ep for wid, ep in sup._replica_addrs()
                     if wid != victim], 2, "respawn")
        if _model_steps(after) != [20, 20]:
            fail("serve step: after the respawn the replicas serve steps "
                 "%s" % _model_steps(after))
        before = {ep: _get_json("http://%s/serve" % ep)["responses_total"]
                  for ep in after}
        # the pool whole again
        w = window(s["after_s"], 920000)
        respawned = _check_window(finish(w, "respawned"), s["model"],
                                  {crc_new: new}, "respawned")
        views = {ep: _get_json("http://%s/serve" % ep) for ep in after}
        served = {ep: views[ep]["responses_total"] - before[ep]
                  for ep in after}
        if not all(served.values()):
            fail("serve step: a replica answered nothing after the "
                 "respawn: %s" % served)
        sup.driver.request_drain("all")
        driver.join(timeout=60)
        if driver.is_alive() or box.get("rc") != EXIT_DRAINED:
            fail("serve step: the pool did not drain (rc %s)" %
                 box.get("rc"))
    finally:
        if driver.is_alive():
            sup.driver.terminate()
            driver.join(timeout=30)
    return dict(boot_s=boot_s, swap=swap, kill=kill, respawned=respawned,
                swapped_s=swapped_s, killed_worker=victim,
                respawn_s=respawn_s, rc=box["rc"],
                # admission to answer inside each replica (the histogram's
                # bucket bounds), the killed one's lost with it
                replica_quantiles_ms={
                    str(v["replica"]): [v["p50_ms"], v["p99_ms"]]
                    for v in views.values()},
                devices={str(d["replica"]): d["device"]
                         for d in list(health.values()) +
                         list(after.values())},
                responses_after_respawn=served)


def check_negotiated_gone(phase):
    """Before a phase that is timed against a limit (serve, fleet): what
    this process still runs of the negotiated runs (the core and its
    thread, the device plane, its executor and finalizer threads, a
    ``torch.distributed`` group and with it the executor's communicators)
    must be nothing; prints the live threads beside it."""
    import threading
    import torch.distributed as dist
    from horovod_tpu_torch.common import core, device_plane
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("hvd-device-")]
    if core.is_initialized():
        left.append("the negotiation core")
    if device_plane.current() is not None:
        left.append("the device plane")
    if dist.is_initialized():
        left.append("a torch.distributed group")
    log("%s start: threads %s, left of the negotiated runs %s" % (
        phase, sorted(t.name for t in threading.enumerate()), left))
    if left:
        fail("%s: the negotiated runs left %s running" % (phase, left))


def phase_serve(card):
    """The serve plane on the card: the forward in process, the curve
    through the CLI, the traffic step with a swap and a kill."""
    import shutil
    import tempfile
    check_negotiated_gone("serve")
    t0 = time.perf_counter()
    forward = _serve_forward()
    for name in ("affine", "mlp"):
        log("serve forward %s: %s" % (name, json.dumps(forward[name])))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    load = _ServeLoad(tmp)
    try:
        curve = _serve_curve(tmp, load)
        step = _serve_step(tmp, load)
    finally:
        load.close()
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    # also on stderr: after every phase the kernels line can push this
    # line out of a kept tail of stdout
    log("serve step: %s; the phase %.1f s" % (json.dumps(step), seconds))
    print(json.dumps({"serve": dict(
        card=card, forward=forward, curve=curve, step=step,
        seconds=seconds)}), flush=True)


# The fleet phase: the launch phase's LM as job train0 under the fleet
# controller on a pool of one slot (the card), preempted by graceful drain
# for a serve pool of the serve phase's mlp at 2048 (serve0), then restored
# from its durable lineage
FLEET_WORKER = "tests/torch_port_launch_worker.py"
FLEET_STEPS = LAUNCH_STEPS  # the launch phase's run a is the reference
FLEET_HOLD_AFTER = 2        # train0 holds after this step's commit
FLEET_ARRIVAL_S = 25.0      # serve0 arrives this long after the start
FLEET_DRAIN_GRACE = 120     # seconds before a drain escalates to SIGKILL
FLEET_SERVE = dict(model="mlp", dim=2048, rate=100, seconds=3.0, seed=14,
                   exit_after=12.0)
FLEET_TIMEOUT = 420         # the controller's --timeout
FLEET_LINE = re.compile(
    r"job (\S+) worker (\S+) (start|commit|done) step (\d+) "
    r"crc ([0-9a-f]{8})(?: size (\d+) pid (\d+))?")


def _fleet_lineage(text):
    """train0's lineage lines: (kind, step, crc, pid) in order."""
    return [(m.group(3), int(m.group(4)), m.group(5),
             int(m.group(7)) if m.group(7) else None)
            for m in FLEET_LINE.finditer(text) if m.group(1) == "train0"]


def _prometheus_samples(text):
    """{sample (with its labels): value} of a Prometheus text page."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def _gpu_pids():
    """The pids ``nvidia-smi --query-compute-apps=pid`` lists."""
    proc = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        fail("fleet: nvidia-smi --query-compute-apps failed: %s" %
             proc.stderr)
    return sorted(int(x) for x in proc.stdout.split() if x.isdigit())


def _alive(pid):
    import os
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    return True


def _fleet_top(port, env):
    """``python -m horovod_tpu_torch.run.top --fleet --once`` against the
    controller: (rc, stdout, stderr)."""
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run.top", "--fleet",
         "--once", "localhost:%d" % port], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=60)
    return proc.returncode, proc.stdout, proc.stderr


class _Timeline:
    """Stamps each new line of the controller's log with the seconds since
    ``start`` (a thread reads the file every 0.1 s)."""

    def __init__(self, path, start):
        import threading
        self.path, self.start, self.lines = path, start, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        seen = 0
        while not self._stop.wait(0.1):
            lines = self.path.read_text().splitlines()
            t = time.monotonic() - self.start
            self.lines += [(t, line) for line in lines[seen:]]
            seen = len(lines)

    def first(self, needle):
        return next((round(t, 1) for t, line in self.lines if needle in line),
                    None)

    def stop(self):
        self._stop.set()
        self._thread.join()


def _fleet_reference(env, tmp):
    """train0's uninterrupted twin: the launch phase's run a when it ran
    in this invocation (the same worker for the same steps), else one run
    of it here."""
    import torch
    if "a" in _LAUNCH_FINAL:
        return _LAUNCH_FINAL["a"], "launch run a"
    out_dir = tmp / "reference"
    out_dir.mkdir()
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1", "-H",
           "localhost:1", sys.executable, FLEET_WORKER, "--steps",
           str(FLEET_STEPS), "--out", str(out_dir)]
    rc, out, err, seconds = _launched(cmd, env)
    reports = _launch_reports(out)
    if rc != 0 or len(reports) != 1 or reports[0]["bad_launches"] or \
            reports[0]["step"] != FLEET_STEPS:
        fail("fleet: the uninterrupted run exited %d, reports %s:\n%s" % (
            rc, reports, err[-6000:]))
    log("fleet: the uninterrupted run took %.1f s" % seconds)
    return torch.load(out_dir / "final.pt"), "its own run (%.1f s)" % seconds


def phase_fleet(card):
    """train0 (the LM) preempted on the card by serve0 through the fleet
    controller and restored bit for bit; returns train0's K1-K3
    launches."""
    import os
    import shutil
    import signal
    import tempfile
    import urllib.request
    import torch
    from horovod_tpu_torch.elastic.durable import last_durable_step
    from horovod_tpu_torch.elastic.state import EXIT_DRAINED
    from horovod_tpu_torch.serve import model as smodel
    from horovod_tpu_torch.serve.swap import publish_leaves
    check_negotiated_gone("fleet")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the jobs need the card's memory
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for key in ("MASTER_ADDR", "MASTER_PORT", "PYTHONUNBUFFERED",
                "HVD_TPU_SERVE_DEVICE"):
        env.pop(key, None)
    s = FLEET_SERVE
    proc, load, timeline, live, final = None, None, None, {}, {}
    free, total = torch.cuda.mem_get_info()
    used_before = total - free  # this process's own, and nothing else's
    try:
        reference, reference_from = _fleet_reference(env, tmp)
        leaves = smodel.init_leaves(s["model"], s["dim"], seed=4)
        crc = smodel.fingerprint(leaves)
        serve_ckpt, train_ckpt = tmp / "serve", tmp / "train"
        publish_leaves(str(serve_ckpt), 10, leaves)
        base = _free_port_block(2)  # the replica and a respawn's id
        serve_env = {k: v for k, v in _serve_env(
            s["model"], s["dim"], base, serve_ckpt).items()
            if env.get(k) != v and k != "HVD_TPU_CKPT_DIR"}
        serve_env["HVD_TPU_SERVE_EXIT_AFTER"] = str(s["exit_after"])
        out_dir = tmp / "out"
        out_dir.mkdir()
        jobfile = {"hosts": "localhost:1", "drain_grace": FLEET_DRAIN_GRACE,
                   "jobs": [
                       {"name": "train0", "command": [
                           sys.executable, str(ROOT / FLEET_WORKER),
                           "--steps", str(FLEET_STEPS), "--out", str(out_dir),
                           "--job", "train0", "--hold-after",
                           str(FLEET_HOLD_AFTER)],
                        "np": 1, "min_np": 1, "priority": 0,
                        "ckpt_dir": str(train_ckpt)},
                       {"name": "serve0", "kind": "serve", "command": [
                           sys.executable, "-m",
                           "horovod_tpu_torch.serve.replica"],
                        "np": 1, "min_np": 1, "priority": 10,
                        "arrival": FLEET_ARRIVAL_S,
                        "ckpt_dir": str(serve_ckpt), "env": serve_env}]}
        (tmp / "jobs.json").write_text(json.dumps(jobfile))
        load = _ServeLoad(tmp)
        load.set_endpoints(["127.0.0.1:%d" % base])
        log_path = tmp / "fleet.log"
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "horovod_tpu_torch.fleet.cli",
                 "--port", "0", "--linger", "60", "--timeout",
                 str(FLEET_TIMEOUT), str(tmp / "jobs.json")],
                cwd=str(ROOT), env=env, stdout=logf,
                stderr=subprocess.STDOUT, start_new_session=True)
        t_start = time.monotonic()
        timeline = _Timeline(log_path, t_start)

        def wait_for(pattern, what, timeout):
            deadline = time.monotonic() + timeout
            while True:
                m = re.search(pattern, log_path.read_text())
                if m:
                    return m
                if proc.poll() is not None or time.monotonic() > deadline:
                    fail("fleet: %s (controller rc %s):\n%s" % (
                        what, proc.poll(), log_path.read_text()[-8000:]))
                time.sleep(0.1)
        port = int(wait_for(r"metrics at http://localhost:(\d+)",
                            "no metrics endpoint", 60).group(1))
        wait_for(r"job serve0 admitted", "serve0 was never admitted",
                 FLEET_ARRIVAL_S + FLEET_DRAIN_GRACE + 120)
        live["serve0_admitted_s"] = time.monotonic() - t_start
        ep = "127.0.0.1:%d" % base
        live["health"] = _wait_replicas(lambda: [ep], 1, "fleet")
        w = load.start(s["rate"], s["seconds"], s["dim"], s["seed"],
                       rid_base=930000, deadline=10.0)
        # while serve0 answers: train0's state on disk and on the card
        text = log_path.read_text()
        live["lineage"] = _fleet_lineage(text)
        live["durable_step"] = last_durable_step(str(train_ckpt))[0]
        live["gpu_pids"] = _gpu_pids()
        free, total = torch.cuda.mem_get_info()
        live["used_above_start"] = total - free - used_before
        live["view"] = _get_json("http://localhost:%d/fleet" % port,
                                 timeout=5)
        live["top"] = _fleet_top(port, env)
        window = _check_window(load.finish(w), s["model"], {crc: leaves},
                               "fleet")
        wait_for(r"final view served", "the fleet did not finish",
                 FLEET_TIMEOUT + 60)
        with urllib.request.urlopen("http://localhost:%d/metrics" % port,
                                    timeout=5) as resp:
            final["metrics"] = _prometheus_samples(resp.read().decode())
        final["view"] = _get_json("http://localhost:%d/fleet" % port,
                                  timeout=5)
        final["top"] = _fleet_top(port, env)
        proc.send_signal(signal.SIGINT)  # ends the linger
        final["rc"] = proc.wait(timeout=60)
        final["seconds"] = time.monotonic() - t_start
        final["log"] = log_path.read_text()
        final["state"] = torch.load(out_dir / "final.pt")
    finally:
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        if timeline is not None:
            timeline.stop()
        if load is not None:
            load.close()
        shutil.rmtree(tmp, ignore_errors=True)
    for at, line in timeline.lines:
        if line.startswith(("[fleet]", "[elastic]", "[durable]")) or \
                "holding" in line or "start step" in line:
            log("fleet log %6.1f s: %s" % (at, line[:240]))

    text = final["log"]
    bad = []
    if final["rc"] != 0:
        bad.append("the controller exited %d" % final["rc"])
    for needle in ("preempting job train0", "job train0 preempted",
                   "job train0 restored",
                   "fleet finished: all 2 job(s) completed"):
        if needle not in text:
            bad.append("the log lacks %r" % needle)
    if not re.search(r"worker \d+ on \S+ drained \(rc=%d\)" % EXIT_DRAINED,
                     text) or "escalat" in text:
        bad.append("train0's worker did not exit EXIT_DRAINED unescalated")
    reports = _launch_reports(text)
    drained = [r for r in reports if r["drained"]]
    rest = [r for r in reports if not r["drained"]]
    step = drained[0]["step"] if len(drained) == 1 else None
    if len(drained) != 1 or len(rest) != 1 or \
            drained[0]["start_step"] != 0 or not 0 < step < FLEET_STEPS or \
            rest[0]["start_step"] != step or rest[0]["restores"] != 1 or \
            rest[0]["step"] != FLEET_STEPS:
        bad.append("train0's processes: %s" % [
            {k: r[k] for k in ("drained", "start_step", "step", "restores")}
            for r in reports])
    for r in reports:
        n = len(r["steps"])
        if not r["device"].startswith("cuda") or r["bad_launches"] or \
                r["launches"] != {k: n * MODEL["num_layers"] for k in FLASH}:
            bad.append("train0 (from step %s) on %s launched %s in %d "
                       "steps, off by %s" % (r["start_step"], r["device"],
                                             r["launches"], n,
                                             r["bad_launches"][:6]))
    # the drain: durable at the highest committed step, the process gone
    committed = [(st, c) for kind, st, c, _ in live["lineage"]
                 if kind == "commit"]
    pids = [pid for kind, _, _, pid in live["lineage"] if kind == "start"]
    if step is None or max((st for st, _ in committed), default=None) != \
            step or live["durable_step"] != step:
        bad.append("drained at step %s; committed %s, durable %s" % (
            step, [st for st, _ in committed], live["durable_step"]))
    # (nvidia-smi may list the pids of another namespace: the memory in
    # use is the check that holds there, against train0's own peak)
    on_card = sorted(set(pids) & set(live["gpu_pids"]))
    peak = min(r["peak_device_bytes"] for r in reports) if reports else 0
    if len(pids) != 1 or on_card or _alive(pids[0]) or \
            live["used_above_start"] >= peak:
        bad.append("train0's process %s on the card while serve0 serves "
                   "(nvidia-smi lists %s; %.2f GiB in use above the "
                   "phase's start, train0's peak %.2f GiB)" % (
                       pids, live["gpu_pids"],
                       live["used_above_start"] / 2 ** 30, peak / 2 ** 30))
    # the restore: from a state train0 committed at the drained step
    lineage = _fleet_lineage(text)
    starts = [(st, c) for kind, st, c, _ in lineage if kind == "start"]
    commit_crcs = {}
    for kind, st, c, _ in lineage:
        if kind == "commit":
            commit_crcs.setdefault(st, set()).add(c)
    done = [(st, c) for kind, st, c, _ in lineage if kind == "done"]
    if len(starts) != 2 or starts[0][0] != 0 or starts[1][0] != step or \
            starts[1][1] not in commit_crcs.get(step, ()) or \
            done != [(FLEET_STEPS, c) for c in
                     commit_crcs.get(FLEET_STEPS, ())]:
        bad.append("train0's lineage: starts %s, done %s, commits %s" % (
            starts, done, sorted(commit_crcs.items())))
    bitwise = _same_state(final["state"], reference)
    if not bitwise:
        bad.append("train0's final state is %.3g from %s's" % (
            _max_gap(final["state"], reference), reference_from))
    # the controller's views
    jobs = live["view"]["jobs"]
    want = {"train0": ("train", "pack", "preempted"),
            "serve0": ("serve", "spread", "running")}
    got = {n: (j.get("kind"), j.get("placement"), j.get("state"))
           for n, j in jobs.items()}
    if got != want:
        bad.append("/fleet while serve0 serves: %s" % got)
    if {n: j["state"] for n, j in final["view"]["jobs"].items()} != {
            "train0": "done", "serve0": "done"}:
        bad.append("/fleet at the end: %s" % final["view"]["jobs"])
    for label, (rc, out, err) in (("live", live["top"]),
                                  ("final", final["top"])):
        if rc != 0 or not all(re.search(r"^%s\s" % n, out, re.M)
                              for n in ("train0", "serve0")):
            bad.append("run.top --fleet --once (%s) exited %d:\n%s%s" % (
                label, rc, out, err))
    m = final["metrics"]
    counts = {k: m.get("hvdtpu_fleet_%s_total" % k) for k in (
        "preemptions", "restores", "job_completions")}
    if counts != {"preemptions": 1, "restores": 1, "job_completions": 2} or \
            not m.get("hvdtpu_fleet_drain_seconds_count") or \
            not m.get("hvdtpu_fleet_restore_seconds_count"):
        bad.append("/metrics: %s" % {k: v for k, v in m.items()
                                     if "total" in k or "count" in k})
    if bad:
        fail("fleet: %s\n%s" % ("\n".join(bad), text[-8000:]))

    def latency(name):
        return m["hvdtpu_fleet_%s_sum" % name] / \
            m["hvdtpu_fleet_%s_count" % name]
    result = dict(
        card=card, steps=FLEET_STEPS, drained_step=step,
        held_s=drained[0]["held_s"],
        drain_s=latency("drain_seconds"), restore_s=latency("restore_seconds"),
        serve_answered=window["ok"], serve_p50_ms=window["p50_ms"],
        serve_p99_ms=window["p99_ms"], serve_achieved_rps=window["achieved_rps"],
        serve_device=[d.get("device") for d in live["health"].values()],
        serve0_admitted_s=live["serve0_admitted_s"],
        warm_step_ms=[drained[0]["median_step_ms"], rest[0]["median_step_ms"]],
        step_ms=[r["step_ms"] for r in reports],
        crc_ms=[r["crc_ms"] for r in reports],
        restores=rest[0]["restores"],
        durable_step_at_drain=live["durable_step"],
        gpu_pids_while_serving=live["gpu_pids"],
        used_gib_while_serving=live["used_above_start"] / 2 ** 30,
        train0_peak_gib=peak / 2 ** 30,
        timeline_s={k: timeline.first(k) for k in (
            "job train0 admitted", "holding after", "preempting job train0",
            "job train0 preempted", "job serve0 admitted",
            "job serve0 completed", "job train0 restored",
            "job train0 completed")},
        bitwise=bitwise,
        reference=reference_from, counters=counts,
        controller_s=final["seconds"],
        seconds=time.perf_counter() - t_phase)
    log("fleet: %s" % json.dumps(result))
    print(json.dumps({"fleet": result}), flush=True)
    launches = {}
    for r in reports:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("api", "kernels", "train",
                                       "bn_kernels", "resnet", "resnet_lean",
                                       "ring_kernels", "sp", "lc", "lc_sp",
                                       "wire_kernels", "zero1", "moe",
                                       "ulysses", "inception", "resnet_nf",
                                       "vgg16", "word2vec", "core",
                                       "launch", "serve", "fleet"),
                    help="run the device and build phases and this one")
    ap.add_argument("--profile", metavar="DIR",
                    help="after the train, resnet, resnet_lean (and its "
                    "bn_remat steps), sp, lc_sp, moe, ulysses and inception "
                    "phases, profile 3 more steps each (lc always profiles) "
                    "and write the kernel tables to DIR/chip_smoke_{lm,"
                    "lm_negotiated,"
                    "resnet,resnet_lean,resnet_lean_remat,sp,lc,lc_unfused,"
                    "lc_sp,moe,ulysses,inception}_profile.txt")
    args = ap.parse_args()
    card = phase_device()
    if not (ROOT / "horovod_tpu_torch").is_dir():
        fail("horovod_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import torch
    # The plain versions are the float32 reference: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    def run(phase):
        return args.only in (None, phase)

    rows, library, counts = {}, {}, {}

    def add(launches):  # a kernel's launches over every main path
        for name, n in launches.items():
            counts[name] = counts.get(name, 0) + n
    if run("api"):
        phase_api()
    if run("kernels"):
        rows, library = phase_kernels()
    if run("train"):
        add(phase_train(profile_dir=args.profile))
    if run("bn_kernels"):
        rows.update(phase_bn_kernels())
    if run("resnet"):
        add(phase_resnet(profile_dir=args.profile))
    if run("resnet_lean"):
        add(phase_resnet(profile_dir=args.profile, lean=True))
    if run("ring_kernels"):
        rows.update(phase_ring_kernels())
    if run("sp"):
        add(phase_sp(profile_dir=args.profile))
    if run("lc"):
        add(phase_lc(profile_dir=args.profile))
    if run("lc_sp"):
        add(phase_sp(profile_dir=args.profile, lc=True))
    if run("wire_kernels"):
        wire_rows, wire_launches = phase_wire_kernels()
        rows.update(wire_rows)
        add(wire_launches)
    if run("zero1"):
        add(phase_zero1())
    if run("moe"):
        add(phase_moe(profile_dir=args.profile))
    if run("ulysses"):
        add(phase_ulysses(profile_dir=args.profile))
    if run("inception"):
        add(phase_inception(profile_dir=args.profile))
    if run("resnet_nf"):
        phase_resnet_nf()
    if run("vgg16"):
        phase_vgg16()
    if run("word2vec"):
        phase_word2vec()
    if run("core"):
        phase_core(card)
    if run("launch"):
        add(phase_launch(card))
    if run("serve"):
        phase_serve(card)
    if run("fleet"):
        add(phase_fleet(card))
    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        row = rows.get(name, {})
        abs_errs = [v for k, v in row.items() if k.endswith("max_abs_err")]
        rel_errs = [v for k, v in row.items() if k.endswith("_l2_err")
                    and not k.startswith("odd_")]
        if name in FLASH:
            # K2 and K3 together do what the one fused backward call does
            lib_ms = library.get("sdpa_fwd_ms" if name == "flash_fwd"
                                 else "sdpa_bwd_ms")
        else:
            lib_ms = row.get("library_ms")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts.get(name, 0),
            "max_abs_err": max(abs_errs) if abs_errs else None,
            "ms": row.get("ms"), "plain_ms": row.get("plain_ms"),
            "bound_ms": row.get("bound_ms"), "bound_by": row.get("bound_by"),
            "library_ms": lib_ms, "library_note": row.get("library"),
            # the rotary kernels: the same launch without rotary, and the
            # rotation of q and k that library_ms leaves out; the rotary
            # pass: one layer's pass, K1, K2_rot and K3_rot, and K1-K3
            # without rotary
            **{key: row[key] for key in ("norot_ms", "rotate_ms",
                                         "layer_ms", "norot_layer_ms",
                                         "event_ms")
               if key in row},
            **({"runs": RUNS[name]} if name in RUNS else {}),
            "rel_l2_err": max(rel_errs) if rel_errs else None,
            "odd_rel_l2_err": row.get("odd_rel_l2_err"),
            "lse_abs_err": row.get("lse_abs_err"),
            # the ring kernels at the sp phase's own launch
            **{key: row[key] for key in ("sp_ms", "sp_bound_ms",
                                         "sp_bound_by", "sp_library_ms")
               if key in row},
            # the wire codec: the row is int8's, these bf16's
            **{key: row[key] for key in ("bf16_ms", "bf16_plain_ms",
                                         "bf16_bound_ms", "bf16_bound_by",
                                         "bf16_library_ms")
               if key in row},
            # the BN kernels: device times (CUDA graphs), the lean calls at
            # the stem, the launches at Inception's shapes
            # (INCEPTION_BN_SHAPES), the passes' cost an Inception step and
            # one call's device activity under the profiler
            **{key: row[key] for key in row if name in BN
               and key.endswith(("_ms", "_bound_by", "_max_ulp",
                                 "trace_device_activity"))}})
    print(json.dumps({"kernels": kernels, "library": library}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
