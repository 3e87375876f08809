#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is not 0):

1. env     torch / CUDA versions and the card's name and power limit.
2. build   compile the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels each kernel against its plain PyTorch version on the card, at the
           smollm-360m main-path shapes plus ragged cases (and K1-K4 at
           phase 10's qwen2-moe-a2.7b shapes, K3 and K4 at phase 11's
           paligemma-3b shapes: head dim 256, MQA 8:1, K4 with its 256-row
           prefix, f32 cases timed; K3 and K4 at phase 12's zamba2-2.7b
           shapes: MHA 32 x 80, K4 causal over 3,072 tokens and a B = 2
           ragged case, K3 at kv_len 3,073 in a 3,104-slot cache and 4
           ragged rows, f32 cases timed, the output's columns 64-79 zeroed
           planted; K4 and K3 at phase 13's seamless-m4t-large-v2 shapes:
           MHA 16 x 64, K4 bidirectional over 2 x 3,072 frames and a ragged
           2 x 3,000, causal over the 2 x 1,024 prompt, K3 at kv_len 1,025
           and 1,056 in a 1,056-slot cache and 4 ragged rows, f32 cases
           timed, a skipped key tile, a causal mask, keys read past Tk and a
           dropped ragged tile planted), under the bf16
           rule of ``kernels.ops.BF16_TOL`` (K2, K5 and K6 bit for bit);
           planted faults (K1 one group's anchor off by one bin or two
           neighbouring channels swapped, K3 skipping one split, masking one
           key short or dropping a ragged last tile, K4 skipping one key
           tile for the last query rows or letting every query see its next
           key, K4 at D = 256 with the prefix one key short or ignored,
           K6 one group's anchor off by one bin) must fail that rule;
           K1, K2, K5 and K6 also at C = 36 (4 channels an access) and on
           inputs misaligned by one element (V = 1); K4 is also timed at the
           store's 6144-token shape; K5 on exact half-bin deltas (half to
           even) and clipped ones; kernel, plain and library-yardstick times
           (CUDA events), each kernel's device time (profiler, by exact
           name; the run fails without one) and the least time the card
           could take (bytes over 3.35 TB/s vs flops over 989 TFLOP/s).
           The rANS coder's K7 (decode) and K8 (encode) on random skewed
           tables built on the card, held with ``torch.equal`` (symbols,
           words with their unused tail, word counts, final states and
           pointers), K7 on the wire's compact payload: a stacked wave of 4
           smollm-360m chunks at levels 0-3 (81,920 lanes; anchors 154
           steps, deltas 1,382 steps over the padded delta stack), K8 over
           ``encode_all_levels``' lossy delta stack, qwen2-moe-a2.7b's
           768-token chunk (98,304 lanes, tables at 2.0e9 slots), a lane
           whose cum row starts past 2^31 bytes, 20,481 lanes, n_sym = 1 (an
           empty payload); planted faults (a word flipped, where
           ``check=True`` must raise too; a lane's table off by one; one
           emit dropped from K8's stream; one staged cum entry off by one,
           in K7 and in K8) must break the equality; their bound counts the
           table entries this run's data reads once, and beside it the time
           at one 32-byte sector a table gather (``rans_bound``, no bound);
           each kernel's registers, shared memory a block and blocks an SM.
           The wide K7 and K8 (alphabets past the staged rows' caps) at the
           codec's delta_qmax 1023: the wave over its 2,047-symbol padded
           decode stack, K8 over its lossy stack, and 4,096 and 16,384
           (precision 14) symbols, held with ``torch.equal``, with planted
           faults (a word flipped, a table off by one, a cum entry off by
           one, a lane's payload offset moved, an emitted word dropped);
           both also on the staged kernels' wave and timed beside them.  K3
           and K4 across the reference's domain: Phi-3-mini's attention (MHA
           32 x 96), K3 at Falcon-7B's 71 query heads on one KV head and at
           32:1, both at head dims 48, 96, 100, 160 and 192 and past 256
           (300, 512, 1000: the wide path's output panels; K4 also at 3,072
           tokens with a prefix and K3 at 32:1, D = 512), each held and
           timed, SDPA's backends named past 256.
4. serve   smollm-360m at full width (random bf16 weights from a seed):
           four requests go through ``calculate_kv`` (K4), their KV is
           profiled and encoded at every level in 1536-token chunks (K5),
           one ``decode_chunk_runs`` call rebuilds all four requests' runs at
           mixed levels (K1 + K2, bf16 out) and is held to the unfused
           ``decode_chunk`` (K6), ``insert_runs`` lands them in a 4-row cache
           and ``generate_with_kv`` produces 32 tokens (K3).
5. text    one request loads chunk 0 from its bitstream (``decode_to_cache``),
           recomputes chunk 1 as TEXT (``prefill_extend``) and generates.
6. store   CacheGen's offline + online flow on the same model and tables:
           a 6144-token context (``calculate_kv``) is stored as four
           1536-token chunks at every level (``CacheGenStreamer.
           store_from_caches`` -> ``KVStore.store_kv``, K5); ``stream()``
           plans it under a bandwidth dip with an SLO (Algorithm 1, stated
           rates); the plan must hold two levels and a TEXT chunk; it is
           materialized fused (K1/K2; TEXT through plain attention) and
           ``fused=False`` (K6), the two caches compared chunk by chunk, and
           each generates 32 tokens (K3).  The plan Algorithm 1 gives from
           the card's own rates (serve phase) is printed beside it.
7. session CacheGen's live adaptive loop over phase 6's store and context:
           ``ServeSession.run`` over the default ``SimTransport`` under the
           same dip and stated rates must make the plan's decisions (at
           full width ``[0, 1, TEXT, TEXT]``) with its TTFT, and hold a
           cache equal to the fused ``materialize`` (level 0 and TEXT bit
           for bit, lossy chunks within K1's rule; decode K1/K2); the same
           session under a ``RetryPolicy`` and a seeded ``FaultPlan``
           (``FaultyTransport`` over ``SimTransport``) whose draw truncates
           chunk 0's first fetch must finish ``ok`` with retries, a salvaged
           and resumed prefix, and a reconciled byte ledger;
           ``generate_with_kv`` runs
           from the clean session's cache (K3).  The session's wall times
           and its realized decode rate (bitstream bytes over wall decode
           seconds) are printed beside the stated rate.
8. serving multi-request serving over phase 6's engine, store and context:
           a ``ConcurrentScheduler`` wave of four requests under an idealized
           ``ContentionModel`` must make phase 7's decisions and TTFT each,
           with caches equal to phase 7's (level 0 and lossy chunks bit for
           bit — one stacked ``decode_chunk_runs``, K1/K2 — and TEXT chunks,
           from one batch-4 ``prefill_extend_rows``, within
           ``TEXT_BATCH_REL`` relative); ``ContinuousScheduler`` over the same
           requests at t = 0 must equal the wave bit for bit; an open loop of
           four staggered arrivals on two rows must recycle rows and generate
           32 tokens a request in stacked ``decode_step_rows`` steps (K3),
           some of width 2, each token the argmax of a batch-1 oracle fed
           the same tokens from the request's result cache, or within
           ``GEN_BATCH_REL`` of it; on a copy of the wave's pool
           ``save_row`` -> ``reset_rows`` -> ``restore_row`` must be
           bit-exact and ``decode_step_rows`` must leave ragged inactive
           rows (one at capacity) bit for bit; K3 is held to its plain
           version on a 4-row and a 2-row pool at the lengths those steps
           give it (a full row's ``kv_len`` past the capacity; launches not
           counted); an N = 1 generation must equal ``generate_with_kv``'s
           tokens.  It prints the stacked decode rate beside phase 7's and
           the wall ms of a stacked step (with its logits read) at widths 1
           and 2 on a 2-row pool.
9. launcher the port's serving launcher, ``repro_torch.launch.serve.run``
           (``python -m repro_torch.launch.serve``), with ``--full-width`` at
           ``--ctx-len 3072``, three times (each draws its weights, prefills
           the context (K4), profiles it and stores it at every level (K5)):
           A. a closed wave of four on the sim transport and the flat store
              with ``--check-sim``: every request must make the simulator's
              decisions, and every request's cache must equal ``materialize``
              of its configs under phase 7's rules (lossy within K1's rule,
              TEXT within ``TEXT_BATCH_REL`` relative);
           B. waves of two over TCP on the tiered store (cold tier on disk,
              hot tier half a context's bytes) pinned to level 1 (K1), with
              server-side truncation faults and ``--retry 3``: no request may
              fail, faults must be injected and the cold tier used; the
              fault seed truncates chunk 0's first fetch and no chunk's fetch
              more than twice in the attempts four requests can make, so no
              interleaving of the waves' attempts can exhaust a chunk's
              retries;
           C. an open loop of four Poisson arrivals on two rows pinned to
              level 0 (K2) with ``--preempt`` at the default margin and an SLO
              every load misses, and ``--generate 16`` at a virtual step
              long enough that loads land while the other row generates:
              both rows must be busy at once, some arrival must preempt a
              load (and it must resume), some generation step must stack
              both rows (K3), and every request's cache must equal
              ``materialize`` of its configs (level 0 bit for bit).
           The ``materialize`` checks' launches are not counted.  It prints
           each run's lines, the chunks compared by kind, C's tokens per
           wall second and the phase's wall time.
10. moe    the MoE family, qwen2-moe-a2.7b at full width (24 layers, d 2048,
           16/16 heads of 128, 60 routed experts top-4 and 4 shared; random
           bf16 weights from a seed, 28.6 GB, drawn one expert layer at a
           time), after phases 4-9's engines and caches are freed:
           A. the engine: ``calculate_kv`` of a 3072-token context (K4, 24
              launches; each layer's dropped slots printed), ``profile`` and
              every level of four 768-token chunks (K5), one
              ``decode_chunk_runs`` of a level-0 and a level-1 run (K2, K1 at
              C = 2048) into a 2-row cache, held to the unfused
              ``decode_chunk`` (K6, uncounted: level 0 bit for bit, level 1
              within K1's rule); 32 greedy tokens from the fused level-0
              cache must equal those from the oracle's (K3; the oracle's and
              the prefill cache's generations are uncounted); one decode step
              with the kernels must equal itself bit for bit and lie within
              2e-2 of its largest |logit| of the same step on the plain
              versions routed to the same experts (the layers where the plain
              step's own router would choose otherwise are printed); its wall
              and device ms are printed;
           B. ``serve.run --arch qwen2-moe-a2.7b --full-width --check-sim``
              three times, each freed before the next: a wave of
              ``--requests 4 --concurrency 4`` as the simulator decides at
              ``--ctx-len 3072``, then waves of 2 at ``--ctx-len 1536``
              pinned with ``--fixed-level 0`` and ``--fixed-level 1`` (level
              0 and lossy chunks load through the launcher's batched
              decode); every request must make the
              simulator's decisions and equal ``materialize`` of its configs
              (level 0 bit for bit, lossy within K1's rule); each batched
              TEXT call is replayed on a copy of its input cache and must
              give the same bits, and each TEXT chunk must equal its replay
              (an MoE layer's capacity is set by every row of its call, so
              ``materialize``'s batch-1 recompute is only compared for
              information).  The replays run inside the launcher's timed
              calls, so B's wall times include them.
           The kernels phase also holds K1/K2 (C = 2048), K3 and K4 to their
           plain versions at this model's shapes, with their times.
11. vlm    the vlm family, paligemma-3b at full width (18 layers, d 2048,
           8 query heads and 1 KV head of 256, geglu ff 16384, vocab
           257,216, 256 image rows of 1152-wide patch embeddings through
           ``frontend_proj``; random bf16 weights from a seed, 5.0 GB),
           after phase 10's state is freed:
           A. the engine: ``calculate_kv`` of 256 image rows and a
              3072-token context (K4 at head dim 256 with a 256-row
              prefix), ``profile`` and every level of its 3328 rows in
              768-row chunks (K5), one ``decode_chunk_runs`` of a level-0
              and a level-1 run (K2, K1 at C = 256) held to the unfused
              ``decode_chunk`` (K6, uncounted: level 0 bit for bit, level 1
              within K1's rule); 32 greedy tokens from the fused level-0
              cache must equal those from the oracle's and from the prefill
              cache's (K3 at head dim 256); one decode step with the kernels must equal itself
              bit for bit and lie within 2e-2 of its largest |logit| of the
              same step on the plain versions; its wall and device ms;
           B. ``serve.run --arch paligemma-3b --full-width --ctx-len 3072
              --check-sim`` twice: a wave of 4 as the simulator decides and
              a wave of 2 pinned to level 1; no chunk may be TEXT (the image
              rows have no tokens), every request must make the simulator's
              decisions and equal ``materialize`` of its configs (level 0 bit
              for bit, lossy within K1's rule).
12. ssm, hybrid  the ssm and hybrid families at full width (random bf16
           weights from a seed), after phase 11's state is freed, each
           through the engine (``drive_recurrent_path``): ``calculate_kv``
           of 3,072 tokens, 32 greedy tokens by ``generate_with_kv``, equal
           in a second run, and one decode step after the prefill against
           the prefill of 3,073 tokens on an f32 copy of the weights (logits
           and states within 2e-4 of their largest |value|; the bf16
           model's own distance is printed), a step's wall and device ms.
           A. mamba2-370m (48 Mamba-2 layers, d 1024, 32 SSM heads of 64,
              state 128, chunk 256, vocab 50,280; 0.84 GB): no attention, so
              no kernel may launch; the chunked SSD scan is held to the
              sequential recurrence at layer 0's real shapes in f32.
           B. zamba2-2.7b (54 Mamba-2 layers, d 2560, 80 SSM heads of 64,
              state 64, a weight-shared attention + gelu MLP block after
              every 6 layers at MHA 32 x 80; 2.40 B parameters, 4.8 GB): the
              prefill launches K4 9 times and the 32 tokens K3 288 times;
              one decode step with the kernels equals itself bit for bit and
              lies within 2e-2 of its largest |logit| of the same step on
              their plain versions.
13. encdec the encdec family, seamless-m4t-large-v2 at full width (24
           encoder + 24 decoder layers, d 1024, MHA 16 x 64, gelu ff 8,192
           with biases, layernorm, vocab 256,206 padded to 256,256,
           ``frontend_dim`` 1,024; random bf16 weights from a seed, 1.63 B
           parameters, 3.3 GB), after phase 12's state is freed, through
           ``models.build(cfg)`` (``drive_encdec_path``): 2 rows of 3,072
           f32 source-frame embeddings and a 1,024-token prompt;
           ``prefill`` (K4 48 times: 24 bidirectional in the encoder, 24
           causal in the decoder) and 32 greedy ``decode_step`` calls (K3
           768 times), a second run with the same launches and tokens and
           every kernel call in it held to its plain version; the kernel
           path against the plain attention (logits within 2e-2, memory and
           caches no farther from the f32 model than twice the plain path);
           prefill then a step against the longer prefill on an f32 copy of
           the weights (within 2e-4); ``loss_fn`` at one row (K4 48 times)
           within 2e-3 of the plain path's; encode, prefill and step wall ms,
           a step's device ms and each step's peak memory.
14. train  training through ``repro_torch.training`` after phase 13's state
           is freed:
           A. smollm-360m at full width (361.8 M parameters, remat "full" as
              registered), ``Trainer.init_or_restore(SEED + 15)`` (random bf16
              weights, f32 moments), AdamW (lr 1e-3, warmup 4) on batches of
              8 x 1,024 tokens of ``MarkovLM(49152, seed=2,
              stickiness=0.6)`` seeded per step, checkpoints every 6 steps
              (keep 2) in a temporary directory: 12 steps under
              deterministic algorithms, each launching K4 exactly 64 times
              (32 layers' forwards and their recomputes; the backward is the
              plain version's VJP) and nothing else, the mean loss of the
              last 3 below step 1's; a new ``Trainer`` over a copy of the
              step-6 checkpoint resumes (the restored state bit for bit the
              saved one) and runs to 12 with the same losses and final
              parameters bit for bit; one step with its 64 K4 calls held to
              their plain versions; the kernel path's loss within 2e-3 of
              the plain attention's and each gradient leaf no farther from
              the f32 model's (plain attention) than twice the plain path;
              one ``apply_updates`` with those gradients on the card against
              the same on the CPU (moments within 1e-6 of their scale,
              bf16 weights within one bf16 step); a step's wall and device ms, tokens per wall second, K4's
              forward ms against the plain VJP's within the step, the peak
              memory, and the checkpoints' save and restore ms.
           B. every registry arch at ``.tiny()`` in bf16: one
              ``make_train_step``, finite, a nonzero gradient norm, the loss
              within 2e-2 of the plain attention's; K4 launched once an
              attention layer (the same count in two runs), none by
              mamba2-370m.
           C. ``python -m repro_torch.launch.train --arch smollm-360m --steps
              20 --grad-compression --ckpt-dir <tmp>`` as a subprocess that
              prints its kernel launches at exit: exit 0 with the loss
              falling, K4 once an attention layer a step; again:
              ``[trainer] resumed from step 20``, exit 0 and no launch.
           The kernels phase also times K4 under autograd at A's shape: its
           forward, the plain VJP and SDPA's forward + backward, and holds
           the Function's gradients to the f32 plain version's.
15. mesh   row-sharded serving (``serving.mesh_engine.ShardedEngine``) on
           phase 6's weights, store and context; it runs right after phase
           9, while phases 6-8's state is alive:
           A. one shard (``make_serving_mesh(1)``): phase 8's wave of four
              and its open loop on two rows, every request's decisions,
              virtual TTFT, cache, timeline and greedy tokens bit-equal to
              phase 8's;
           B. two shards on the one card (``Mesh([dev, dev], ("data",))``):
              the same runs make A's decisions and TTFTs, level-0 and lossy
              chunks bit-equal, TEXT chunks within ``TEXT_BATCH_REL`` and
              every token within ``GEN_BATCH_REL`` of the batch-1 oracle's
              best (a shard's batch is 2 rows); K3 launched once a layer a
              shard in every stacked step (counted per shard); on copies of
              the wave's pool, ``insert_runs``, ``prefill_extend_rows``,
              ``decode_step_rows`` and save -> reset -> restore across the
              shards bit-equal to the plain Engine's same call on each
              shard's two rows, ``prefill_extend_gather`` to the plain
              Engine's on the same rows, and within the drift rules of the
              4-row calls; K3 held to its plain version at a shard's rows
              (uncounted); the wall ms of a stacked step of four rows at 1
              and 2 shards (one card: no scaling claimed);
           C. the baselines on the card: ``uniform_quantize_kv`` at 8 and 4
              bits on phase 6's context KV bit-equal to the CPU's, its wire
              bytes beside CacheGen's bytes per level, ``kv_nbytes_fp16``
              and ``kv_nbytes_int8`` (sizes only: random weights);
              ``attention_scores_for_h2o`` with keys as queries over one
              1,536-token chunk within 1e-9 relative of the CPU's f64, and
              ``h2o_select(0.5)`` equal or apart only at the cut.
16. distributed  the collectives on ``torch.distributed``, one spawned
           process a rank (``launch.mesh.run_ranks``), all ranks on the one
           card, after phase 14's state is freed; the parent builds the
           kernels once and every rank loads that library; the parent runs
           the single-process references (uncounted) and prints one JSON
           line a sub-phase from the ranks' reports:
           A. one rank, NCCL, mesh (1, 1): a 2-step run of B and D's
              ``compressed_psum``;
           B. two ranks (gloo: ranks that share a card), mesh (1, 2),
              smollm-360m at full width under ``{"embed": None,
              "kv_seq_decode": "model"}``: the prefill (K4 on each rank)
              writes each rank's 4,096-slot block of an 8,192-slot cache,
              row 0 holds 6,144 tokens and row 1 3,000 (the first shard
              only); 16 steps fed the single-process K3 path's greedy
              tokens through the sequence-parallel decode, each token equal
              to that path's (or apart at a near tie, printed) and the
              logits within ``DIST_STEP_TOL`` of the plain decode's; wall
              ms a step, host ms in collectives;
           C. the same ranks, granite-moe-3b-a800m at full width, grouped:
              each layer's MoE on 2 x 1,024 tokens through the sharded
              combine (ff 512 split in two) within 2e-2 of its largest
              |value| of the single-process layer, with the same dropped
              slots;
           D. the same ranks: ``compressed_psum`` of a smollm-360m gradient
              tree within one bin of the exact mean on every leaf, the int8
              bytes gathered printed;
           E. four ranks, mesh (2, 2), ``{"embed": None}``: two smollm-360m
              train steps on 8 x 1,024 tokens (remat "full"), the losses
              within 5e-3 and the parameters after step 1 within 5e-2 of the
              single-process steps (the reference test's bounds), K4 on
              every rank, the second step's K4 calls held to their plain
              version.
           A gloo group on the card stages DTensor's gathers through pinned
           host memory (``launch.mesh.STAGED`` counts the bytes).
17. dryrun the dry-run tooling (``launch/specs.py``, ``dryrun.py``,
           ``hlo_stats.py``), after phase 16; its host-only children start
           after phase 10 and run beside phases 11-16 (no card, one thread
           each):
           A. ``python -m repro_torch.launch.dryrun`` on ``DRYRUN_CELLS``
              (smollm-360m train_4k on both meshes, qwen2-moe-a2.7b
              decode_32k, mamba2-370m long_500k), each in a child process
              as rank 0 of a fake group of 256 or 512 ranks on meta
              tensors: every record ``ok``; one JSON line a cell (FLOPs,
              collective counts, wire bytes, a rank's argument bytes, the
              activation peak);
           B. smollm-360m at full width on a (1, 1) mesh: three
              ``make_cell`` cells (train at 8 x 1,024, prefill at 2 x 4,096,
              decode at 8 x 8,192) run on meta (a fake group of world 1, in
              a child) and for real on one NCCL rank of the card (the
              model's initialisation from a seed; K4 under autograd and in
              the prefill, K3 in the decode): FLOPs, collective counts and a
              rank's argument bytes equal; the dry run's
              ``temp_size_in_bytes`` printed beside the card's
              ``max_memory_allocated`` (recorded, not held).
18. examples the four ``examples/torch`` scripts, each in a child process at
           ``EXAMPLES``' arguments (``bandwidth_adaptation`` on the host,
           started after phase 10; the others together on the card, started
           beside phase 17): each
           exits 0 and prints its reference example's lines
           (``EXAMPLE_LINES``; ``bandwidth_adaptation`` the reference's
           timeline line for line), launching ``EXAMPLE_KERNELS``.

19. wide codec  the codec at delta_qmax 1023 (2,047-symbol delta tables)
           on phase 4's weights, right after phase 6: a 1,536-token
           context's ``calculate_kv``, ``profile``, ``encode_all_levels`` of
           it as one chunk (K5, K8 staged and wide) with its level-0 and
           level-1 blobs byte-identical to the CPU route's, ``decode_chunks``
           at levels 0 and 2 (exactly one staged and one wide K7 a call, K2,
           K1), level 0 bit for bit against ``decode_chunk`` and the CPU
           route, level 2 within K1's rule, and 32 greedy tokens from the
           level-0 cache (K3).
20. shapes three 2-layer models the registry lacks (Phi-3-mini's MHA 32 x
           96, Falcon-7B's 71:1 x 64 with its parallel block, and a GQA 8:2
           model at head dim 512, K3's and K4's wide path), random weights
           from a seed: a 1,024-token prefill (K4)
           and 16 greedy steps (K3) with the plain versions refusing any
           call, the launches counted exactly, then every call held to its
           plain version, and the prefill's and first step's logits within
           2e-2 of the plain attention's.

The kernels' launch counters are zeroed before phase 4 and read after phase
5, then zeroed before each of phases 6, 19, 20, 7, 8, 9, 15, 10, 11, 12 A,
12 B, 13, 14 A, 14 B, 16, 17 and 18 and read after it (14 C's
subprocesses, 16's and 17 B's ranks and 18's examples count their own,
read by the parent); the run fails if a kernel that a path runs was not
launched in it (the eight staged ones on the serve + text and store paths;
K5, K8 staged and wide, K7 staged and wide, K2, K1 and K3 on the wide codec
path; K3 and K4 on the shapes path; K7, K1, K2 and K3 on the session,
serving and mesh paths; K1-K5, K7 and K8 on the launcher, moe and vlm
paths; K3 and K4 on the hybrid, encdec and dryrun paths; K4 on the train,
train sweep, train launcher and distributed paths; K3, K4, K5 and K8 on the
examples path), or if the ssm path launched any.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels,
with launches summed over the paths.  Needs
one CUDA card; exits 2 with no result when there is none.
"""
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# deterministic algorithms (phase 14's resume) need cuBLAS's workspace fixed
# before the first CUDA call; on Hopper this is PyTorch's default size
# (8 buffers of 4 MiB), so the other phases run as before
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import codec, quant, rans  # noqa: E402
from repro_torch.kernels import _build, flash_attention, ops, timing  # noqa: E402
from repro_torch.kernels.timing import bound_ms as bound  # noqa: E402
from repro_torch.kernels.timing import device_ms, time_ms  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    TILE,
    decode_attention_cuda,
    decode_attention_plain,
    split_size,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda,
    flash_attention_magnitude,
    flash_attention_plain,
    flash_attention_vjp,
)
from repro_torch.kernels.kvquant import (  # noqa: E402
    kv_dequant_cuda,
    kv_dequant_plain,
    kv_dequant_tokens_cuda,
    kv_dequant_tokens_plain,
    kv_lossless_tokens_cuda,
    kv_lossless_tokens_plain,
    kv_quant_cuda,
    kv_quant_plain,
    vector_width,
)
from repro_torch.kernels import rans as krans  # noqa: E402
from repro_torch.kernels.rans import kernel_info as rans_kernel_info  # noqa: E402
from repro_torch.kernels.rans import (  # noqa: E402
    rans_decode_cuda,
    rans_decode_plain,
    rans_decode_wide_cuda,
    rans_encode_cuda,
    rans_encode_plain,
    rans_encode_wide_cuda,
)
from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_map  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import MarkovLM  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build, encdec, lm, mamba2, moe  # noqa: E402
from repro_torch.models.common import apply_norm  # noqa: E402
from repro_torch.models.lm import Caches  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.generation import GenerationSpec  # noqa: E402
from repro_torch import baselines  # noqa: E402
from repro_torch.baselines.context_compression import attention_scores_for_h2o  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_serving_mesh  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.attention import attn_prefill  # noqa: E402
from repro_torch.models.common import specs_from_plan  # noqa: E402
from repro_torch.training.grad_compress import compressed_psum  # noqa: E402
from repro_torch.training.trainer import distribute_state  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from repro_torch.serving import kv_layout  # noqa: E402
from repro_torch.serving.kv_layout import ShardedCaches, caches_to_codec_kv, extract_row  # noqa: E402
from repro_torch.serving.mesh_engine import ShardedEngine  # noqa: E402
from repro_torch.serving.scheduler import ConcurrentScheduler, ContinuousScheduler, SessionRequest  # noqa: E402
from repro_torch.serving.session import ServeSession  # noqa: E402
from repro_torch.training import AdamWConfig, Trainer, apply_updates, make_train_step  # noqa: E402
from repro_torch.training.trainer import init_train_state, loss_and_grads  # noqa: E402
from repro_torch.streaming import (  # noqa: E402
    TEXT,
    BandwidthTrace,
    CacheGenStreamer,
    ContentionModel,
    FaultPlan,
    FaultyTransport,
    FetchPlan,
    KVStore,
    NetworkModel,
    RetryPolicy,
    SimTransport,
)

SEED = 0
CONTEXTS = (3072, 3000, 2048, 1536)
CHUNK = 1536
CAPACITY = 4096
GEN_TOKENS = 32
TEXT_TOKENS = 8
# phase 6: four chunks, and the stated scenario Algorithm 1 plans under.  The
# link's nominal rate (the prior estimate) is LINK_GBPS, but it dips to
# DIP_GBPS for the first DIP_S seconds, so chunk 0 (level 0, from the prior)
# lands late; the throughput measured on it rules out the finer levels for
# chunk 1, and once chunk 1 is in, the recompute of the two remaining chunks
# fits the SLO, so both go as TEXT.  The decisions depend on these constants
# alone, not on the chunks' byte counts: the dip moves under 1 KB, and at
# LINK_GBPS every chunk lands within milliseconds.
STORE_CHUNKS = 4
SLO_S = 3.2
DIP_S, DIP_GBPS, LINK_GBPS = 1.0, 1e-6, 100.0
RECOMPUTE_S_PER_CHUNK = 0.9  # 3 chunks (2.7 s) miss the 2.2 s left, 2 (1.8 s) fit
DECODE_BYTES_PER_S = 1e9
# phase 7's faulted run: keyed draws of this plan truncate chunk 0's first
# level-0 fetch after 67% of its bytes, and no (chunk, level) key of the
# context more than twice in a row, so three attempts always land a chunk
FAULT_PLAN = dict(seed=18, truncate_p=0.5)
FAULT_RETRY = dict(max_attempts=3, backoff_s=0.01)
# phase 8: an idealized engine (stacking costs nothing), so every request of
# a wave decides exactly as phase 7's lone session; the open loop's virtual
# arrivals (two at once, two while their rows are busy)
IDEAL_CONTENTION = {1: 1.0, 8: 1.0}
ARRIVALS = (0.0, 0.01, 0.5, 0.6)
# phase 8's TEXT chunks come from a batch-4 prefill_extend_rows, phase 7's
# from a batch-1 prefill_extend: a product may sum in another order at
# another batch, which moves a result by one bf16 rounding (2^-9 relative)
# per layer; over 32 layers that drifts ~sqrt(32) x 2^-9 ~ 2^-6.5 when the
# roundings fall at random and 32 x 2^-9 = 2^-4 if all added up.  A chunk of
# the wrong tokens, row or offset is off by ~1.  The rule sits between.
TEXT_BATCH_REL = 2.0 ** -5
# the open loop's tokens come from width-1 and width-2 steps, the oracle's
# from batch-1 ones: the same drift moves each logit by about the rule
# times its spread, so a near tie may flip.  The oracle's logit of each
# picked token must lie within this share of its largest |logit| below its
# best; a token picked from another row's state lands at a random rank of
# the vocabulary, a few spreads below the best.
GEN_BATCH_REL = TEXT_BATCH_REL
STEP_SAMPLES = 8
# the kernels each path runs: every path needs each of its kernels launched
# (the codec's default alphabets run the staged rANS kernels; the wide ones
# run on phase 19's wide alphabet)
WIDE_KERNELS = ("rans_decode_wide", "rans_encode_wide")
ALL_KERNELS = tuple(name for name in ops.KERNELS if name not in WIDE_KERNELS)
SESSION_KERNELS = ("rans_decode", "kv_dequant_tokens", "kv_lossless_tokens", "decode_attention")
SERVING_KERNELS = SESSION_KERNELS
LAUNCHER_KERNELS = SESSION_KERNELS + ("flash_attention", "kv_quant", "rans_encode")
MOE_KERNELS = LAUNCHER_KERNELS  # the unfused K6 runs only in its checks
# phase 15: row-sharded serving runs the serving path's kernels on every shard
MESH_KERNELS = SERVING_KERNELS
# phase 19: the codec at delta_qmax 1023, whose delta tables have 2,047
# symbols (past the staged K7's and K8's caps), on one smollm-360m chunk:
# profile, encode_all_levels (K5, K8 staged for the anchors and the lossless
# deltas, wide for the lossy stack), decode_chunks at levels 0 and 2 (K7
# staged for the anchors, wide for the deltas: two launches a call; K2, K1)
# and greedy generation (K3)
WIDE_CODEC = dict(delta_qmax=1023, precision=12)
WIDE_CTX = 1536
WIDE_LEVELS = (0, 2)
WIDE_CODEC_KERNELS = ("kv_quant", "rans_encode", "rans_encode_wide", "rans_decode", "rans_decode_wide",
                      "kv_lossless_tokens", "kv_dequant_tokens", "decode_attention")
# the kernels phase's head dims off the compiled plans, and past them (the
# wide path; 300 in bf16 takes the element loads)
SHAPE_HEAD_DIMS = (48, 96, 100, 160, 192)
WIDE_HEAD_DIMS = (300, 512, 1000)
# phase 20: two 2-layer models at public widths the registry lacks (random
# weights from a seed): Phi-3-mini's (MHA 32 x 96, microsoft/Phi-3-mini-4k-
# instruct) and Falcon-7B's (71 query heads on one KV head x 64, parallel
# attention and MLP, layernorm, gelu; tiiuae/falcon-7b); a prompt through
# K4, then greedy steps through K3, held to the plain path
SHAPES_PROMPT = 1024
SHAPES_STEPS = 16
SHAPES_STEP_TOL = 2e-2
SHAPES_KERNELS = ("decode_attention", "flash_attention")
# phase 9: the launcher's context, B's fault rate and attempts, C's arrivals
LAUNCH_CTX = 3072
LAUNCH_REQUESTS = 4
LAUNCH_TRUNCATE_P = 0.3
LAUNCH_RETRY = 3
# B's keyed truncation draws hit chunk 0's first level-1 fetch and no chunk's
# fetches more than LAUNCH_RETRY - 1 times among the 12 attempts the server
# can count for it, so no interleaving of the waves' attempts exhausts a
# chunk's retries (tests/test_torch_smoke.py checks this for the seed)
LAUNCH_FAULT_SEED = 1864
LAUNCH_RATE = 50.0  # Poisson arrivals per second of C's open loop
# C's SLO is below any load's fetch time at either size, so every load is
# doomed and the arrivals that find both rows busy preempt; each token's
# virtual step stretches a request's generation over seconds, longer than
# the gaps between two loads landing, so the two rows' steps stack
LAUNCH_SLO_MS = 20.0
LAUNCH_GEN = 16
LAUNCH_GEN_STEP_MS = 500.0
# phase 10: the MoE family at full width; its context, chunks, the lossy
# level of its second run, the launcher's requests in its decided wave and
# in each pinned one.  A decode step with
# the kernels against the same step on their plain versions, routed to the
# same experts: bf16 logits after 24 layers within the bf16 rule of the
# reference's kernel tests, 2e-2, of the step's largest |logit| (an error
# that enters the residual stream reaches every logit at about the same
# absolute size)
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_CTX = 3072
MOE_CHUNK = 768
MOE_LOSSY = 1
MOE_REQUESTS = 4
MOE_PINNED = 2
# the pinned waves' context: half the decided wave's, still 4 chunks a
# request (each full-width run profiles and encodes its own context)
MOE_PINNED_CTX = MOE_CTX // 2
MOE_STEP_TOL = 2e-2
# phase 11: the vlm family at full width; its text context (after its 256
# image rows), the chunks of its cached rows, the lossy level of its second
# run and of the launcher's pinned wave, the requests of the decided wave
# and of the pinned one; a decode step against its plain version under
# phase 10's rule
VLM_ARCH = "paligemma-3b"
VLM_CTX = 3072
VLM_CHUNK = 768
VLM_LOSSY = 1
VLM_REQUESTS = 4
VLM_PINNED = 2
VLM_STEP_TOL = MOE_STEP_TOL
VLM_KERNELS = LAUNCHER_KERNELS  # the unfused K6 runs only in its checks
# phase 12: the ssm and hybrid families at full width: the context, the
# hybrid's kernels (its shared attention blocks; mamba2-370m has no
# attention and launches none) and the rules: the bf16 steps within 2e-2 of
# their largest |logit| (phase 10's rule), the chunked SSD scan within 2e-4
# of the sequential recurrence's largest |value| in f32 (tests/test_kernels.py's
# SSD rule)
SSM_ARCH = "mamba2-370m"
HYBRID_ARCH = "zamba2-2.7b"
SSM_CTX = 3072
SSM_STEP_TOL = MOE_STEP_TOL
SSD_TOL = 2e-4
SSM_KERNELS = ()
HYBRID_KERNELS = ("decode_attention", "flash_attention")
# phase 13: the encdec family at full width: rows, source frames, decoder
# prompt and generated tokens; its kernels (the encoder's bidirectional K4,
# the decoder's causal K4 and K3); the rules against the plain attention:
# logits within 2e-2 of their largest |logit| (phase 10's rule), the
# encoder memory and the caches no farther from the f32 model than twice
# the plain path's distance from it (random bf16 layers amplify rounding:
# both paths lie about 2% of their scale from the f32 model after 24
# layers), the loss within 2e-3 of itself; prefill then a step against the
# longer prefill in f32 within 2e-4 of the largest |value| (phase 12's rule)
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_BATCH = 2
ENCDEC_SRC = 3072
ENCDEC_PROMPT = 1024
ENCDEC_STEP_TOL = MOE_STEP_TOL
ENCDEC_YARDSTICK = 2.0
ENCDEC_LOSS_TOL = 2e-3
ENCDEC_KERNELS = ("decode_attention", "flash_attention")
# phase 14: training.  A: smollm-360m at full width, batches of TRAIN_BATCH
# rows of TRAIN_SEQ tokens, TRAIN_STEPS steps checkpointed every
# TRAIN_CKPT_EVERY (keep TRAIN_KEEP), resumed from the first checkpoint; the
# kernel path against the plain attention: the loss within TRAIN_LOSS_TOL
# relative, each gradient leaf no farther from the f32 model's than
# TRAIN_YARDSTICK times the plain path (phase 13's rule for deep tensors).
# B: one step of every arch's .tiny() in bf16, the loss within
# TRAIN_TINY_LOSS_TOL of the plain attention's.  C: the launcher's steps.
TRAIN_ARCH = "smollm-360m"
TRAIN_BATCH = 8
TRAIN_SEQ = 1024
TRAIN_STEPS = 12
TRAIN_CKPT_EVERY = 6
TRAIN_KEEP = 2
TRAIN_OPT = dict(lr=1e-3, warmup_steps=4)
TRAIN_LOSS_TOL = 2e-3
TRAIN_YARDSTICK = ENCDEC_YARDSTICK
TRAIN_TINY_LOSS_TOL = 2e-2
TRAIN_TINY_BATCH, TRAIN_TINY_SEQ = 2, 32
TRAIN_LAUNCH_STEPS = 20
TRAIN_KERNELS = ("flash_attention",)
# phase 16: the collectives on torch.distributed, one process a rank.  B:
# smollm-360m's S-split decode cache and two rows (row 1's 3,000 tokens lie
# in the first 4,096-slot shard only), greedy steps against the
# single-process K3 path (tokens) and the plain decode (logits, phase 8's
# rule), and the same decode on f32 weights against the plain f32 decode;
# C: granite-moe-3b-a800m's grouped MoE layers on rows of tokens; E: train
# steps under the reference test's bounds, and step 1's moments and update
DIST_ARCH = TRAIN_ARCH
DIST_MOE_ARCH = "granite-moe-3b-a800m"
DIST_CAP = 8192
DIST_LENGTHS = (6144, 3000)
DIST_STEPS = 16
DIST_SP_RULES = {"embed": None, "kv_seq_decode": "model"}
# the sharded decode rounds otherwise than one process (each rank's bf16
# partial sum of a split product, other product shapes): held to the
# repo's rule for two bf16 paths that round differently (phase 8's)
DIST_STEP_TOL = GEN_BATCH_REL
# on f32 weights the sharded and the single-process decode differ only in
# the order of f32 sums: the repo's f32 rule (of the largest |logit|)
DIST_F32_STEPS = 2
DIST_F32_TOL = 2e-5
DIST_MOE_TOKENS = (2, 1024)
DIST_MOE_TOL = 2e-2
DIST_PSUM_TOKENS = (2, 1024)
DIST_TRAIN_RULES = {"embed": None}
DIST_TRAIN_STEPS = 2
DIST_LOSS_TOL = 5e-3  # tests/test_distributed.py's bounds
DIST_PARAM_TOL = 5e-2
# after step 1 against the single process's step (``step_held``): each
# first moment (0.1 of the clipped gradient) within a rule of its leaf's
# largest |value|, and at most a share of the parameters apart (their
# update off by more than half the single process's: AdamW's first update
# is lr * sign(g), so an element whose gradient is rounding noise may move
# the other way).  On f32 weights the repo's f32 rule and the CPU
# trajectory rule's thousandth; on bf16 weights phase 8's rule for two bf16
# paths that round differently, for both
DIST_F32_MU_TOL, DIST_F32_UPDATE_SHARE = DIST_F32_TOL, 1e-3
# E's f32 step runs smollm-360m at full width cut to this depth (the f32
# step of all 32 layers took 20 s a rank and 6.3 GB of staged gathers)
DIST_F32_TRAIN_LAYERS = 4
DIST_MU_TOL = DIST_UPDATE_SHARE = GEN_BATCH_REL
DIST_KERNELS = ("flash_attention",)
# the host's profiler events that are collectives (gloo's and NCCL's calls,
# the c10d dispatcher ops that issue them and wait for them)
COLLECTIVE_EVENTS = ("c10d", "gloo", "nccl")
# phase 17: the dry-run tooling (``launch/specs.py``, ``dryrun.py``,
# ``hlo_stats.py``).  A: ``python -m repro_torch.launch.dryrun`` on these
# cells, one child process each, on meta tensors as rank 0 of a fake group of
# 256 or 512 ranks (host only: started after phase 10); each record must be
# ``ok``.  B: smollm-360m at full width on a (1, 1) mesh, three
# ``launch.specs.make_cell`` cells at these shapes (train at phase 14's),
# each run on meta (a fake group of world 1, a host-only child started after
# phase 10) and on the card (one NCCL rank, random weights from a
# seed): FLOPs, collective counts and a rank's argument bytes equal, and the
# kernels of ``GROUND_KERNELS`` launched on the card
DRYRUN_CELLS = (("smollm-360m", "train_4k", "single"), ("smollm-360m", "train_4k", "multi"),
                ("qwen2-moe-a2.7b", "decode_32k", "single"), ("mamba2-370m", "long_500k", "single"))
GROUND_ARCH = TRAIN_ARCH
GROUND_SHAPES = {"train": dict(kind="train", seq=TRAIN_SEQ, batch=TRAIN_BATCH),
                 "prefill": dict(kind="prefill", seq=4096, batch=2),
                 "decode": dict(kind="decode", seq=8192, batch=8)}
GROUND_KERNELS = {"train": ("flash_attention",), "prefill": ("flash_attention",), "decode": ("decode_attention",)}
# the meta half of B in a child process (a fake group is one a process):
# argv = [the repo's root, the JSON to write, "tiny" or "full", kinds...]
GROUND_META = """import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
out = chip_smoke.ground_meta(tiny=sys.argv[3] == "tiny", kinds=sys.argv[4:])
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""
# phase 18: the port's examples (``examples/torch``), one child process each
# (``bandwidth_adaptation`` plans on the host only: started after phase 10),
# at these arguments; each must exit 0 and print its reference
# example's lines (``EXAMPLE_LINES``: every line one of its patterns, every
# pattern some line), ``bandwidth_adaptation`` the reference's timeline line
# for line (``BANDWIDTH_TIMELINE``), and launch the kernels of
# ``EXAMPLE_KERNELS`` (the tiny model's plans are all TEXT: no K1 or K2)
EXAMPLES = {"quickstart": [], "serve_batched": [], "train_100m": ["--steps", "20"], "bandwidth_adaptation": []}
EXAMPLE_KERNELS = {"quickstart": ("flash_attention", "kv_quant", "rans_encode", "decode_attention"),
                   "serve_batched": ("flash_attention", "kv_quant", "rans_encode", "decode_attention"),
                   "train_100m": ("flash_attention",), "bandwidth_adaptation": ()}
_NUM = r"[\d.]+"
EXAMPLE_LINES = {
    "quickstart": [
        r"\[1\] context: \d+ tokens",
        rf"\[2\] KV cache: \(\d+, 2, \d+, \d+\) = {_NUM} MB fp16",
        rf"\[3\] level \d: {_NUM} MB  \({_NUM}x vs fp16\)",
        rf"\[4\] per-chunk configs: \[('(L\d|TEXT)'(, )?)+\]  TTFT={_NUM} ms \(SLO 200 ms, violated=(True|False)\)",
        r"\[5\] greedy tokens \(exact cache\):    \[[\d, ]+\]",
        r"    greedy tokens \(CacheGen cache\): \[[\d, ]+\]",
        rf"    agreement: {_NUM}%",
    ],
    "serve_batched": [
        rf"\[pool\] \d+ contexts stored \({_NUM} KB each @ level 1\)",
        rf"\[req \d+\] ctx\d+ configs=\[('(L\d|TEXT)'(, )?)+\] ttft_sim= *{_NUM} ms \(SLO ok=(True|False)\) "
        rf"wall={_NUM}s agree=\d+%",
    ],
    "train_100m": [
        rf"\[train\] \S+: ~{_NUM}M params",
        rf"\[trainer\] step \d+/\d+ loss={_NUM} gnorm={_NUM} \({_NUM} it/s\)",
        rf"\[train\] done: loss {_NUM} -> {_NUM}",
    ],
    "bandwidth_adaptation": [r".*"],
}
# ``examples/bandwidth_adaptation.py``'s output (the reference's, host only)
BANDWIDTH_TIMELINE = """chunk  config          fetch          compute      MB
    0      L1   0.00-  0.49    0.49-   0.52  122.10
    1      L1   0.49-  0.98    0.98-   1.01  122.10
    2      L1   0.98-  1.47    1.47-   1.50  122.10
    3      L1   1.47-  1.95    1.95-   1.98  122.10
    4    TEXT   1.95-  1.95    1.98-   2.88    0.01
    5    TEXT   1.95-  1.95    2.88-   3.78    0.01
    6    TEXT   1.95-  1.95    3.78-   4.68    0.01
TTFT = 4.68s (SLO 5.0s, violated=False)"""
# an example run with its launch counts and wall seconds printed at exit
# (``[launch counts]``):
# argv = [the example's path, its arguments...]
EXAMPLE_COUNTED = """import json, runpy, sys, time
from repro_torch.kernels import ops
sys.argv = sys.argv[1:]
t0 = time.perf_counter()
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    print("[launch counts] " + json.dumps(dict(ops.launch_counts(), wall_s=time.perf_counter() - t0)), flush=True)
"""

# ``python -m repro_torch.launch.train`` with its arguments, printing the
# subprocess's kernel launches as ``[launch counts] {...}`` at exit
TRAIN_LAUNCH_COUNTED = """import json, runpy
from repro_torch.kernels import ops
try:
    runpy.run_module("repro_torch.launch.train", run_name="__main__", alter_sys=True)
finally:
    print("[launch counts] " + json.dumps(ops.launch_counts()), flush=True)
"""


class Phase:
    """Prints a phase's banner and records its wall time with CUDA events
    (after a synchronize) into ``times``."""

    def __init__(self, name, times):
        self.name, self.times = name, times

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        torch.cuda.synchronize()
        self.a = torch.cuda.Event(enable_timing=True)
        self.b = torch.cuda.Event(enable_timing=True)
        self.a.record()

    def __exit__(self, *exc):
        self.b.record()
        torch.cuda.synchronize()
        self.times[self.name] = self.a.elapsed_time(self.b)
        return False


class Laps:
    """Host wall time between successive ``lap`` calls, each taken after the
    device's queued work has finished, to split a phase into its steps; on
    the card also each step's peak of allocated device memory (GB)."""

    def __init__(self, device):
        self.device = device
        self.ms, self.peak_gb = {}, {}
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self.t = time.perf_counter()

    def lap(self, name):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peak_gb[name] = round(torch.cuda.max_memory_allocated(self.device) / 1e9, 2)
            torch.cuda.reset_peak_memory_stats(self.device)
        now = time.perf_counter()
        self.ms[name] = round(1e3 * (now - self.t), 1)
        self.t = now


@contextlib.contextmanager
def uncounted():
    """Launches inside the block compare a kernel with its plain version:
    they leave the paths' launch counts as they were."""
    held = ops.launch_counts()
    try:
        yield
    finally:
        for name, fn in ops.KERNELS.items():
            fn.launches = held[name]


def device_by_event(fn, iters=3):
    """Device ms per call of ``fn`` for each event of the profiler's CUDA
    trace of ``iters`` calls (kernels, copies and fills), largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {e.key: e.device_time_total / iters / 1e3 for e in prof.key_averages()}
    return dict(sorted(ms.items(), key=lambda kv: -kv[1]))


def device_total_ms(fn, iters=3):
    """Device time per call of ``fn``: every event of its CUDA trace, summed."""
    return sum(device_by_event(fn, iters).values())


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def coder_stack(sets, k, dev, gen, fill=None):
    """Random skewed rANS tables built on the card: one set of ``n`` tables
    over alphabet ``A`` for each ``(n, A)`` of ``sets``, stacked as
    ``rans.stack_tables(..., pad_alphabet=True)`` stacks them (freqs
    zero-padded, cums edge-padded to the widest alphabet).  Every frequency
    is >= 1 and each row sums to 2**k.  ``fill`` lists the ``(start, stop)``
    rows to draw (the others stay zero and must not be read); all by
    default."""
    M = 1 << k
    n_t, A_max = sum(n for n, _ in sets), max(A for _, A in sets)
    freqs = torch.zeros((n_t, A_max), dtype=torch.int64, device=dev)
    cums = torch.full((n_t, A_max + 1), M, dtype=torch.int64, device=dev)
    s2s = torch.zeros((n_t, M), dtype=torch.int16, device=dev)
    slots = torch.arange(M, device=dev)
    base, rows_a = 0, []
    for n, A in sets:
        rows_a.append((base, base + n, A))
        base += n
    for start, stop in fill or [(0, n_t)]:
        for lo, hi, A in rows_a:
            for r0 in range(max(lo, start), min(hi, stop), 8192):
                r1 = min(r0 + 8192, hi, stop)
                w = torch.rand((r1 - r0, A), generator=gen, device=dev) ** 4
                f = 1 + torch.floor(w / w.sum(1, keepdim=True) * (M - A)).long()
                f[:, 0] += M - f.sum(1)
                freqs[r0:r1, :A] = f
                cums[r0:r1, 0] = 0
                cums[r0:r1, 1:A + 1] = f.cumsum(1)
                s2s[r0:r1] = torch.searchsorted(cums[r0:r1, 1:A + 1].contiguous(), slots.expand(r1 - r0, M).contiguous(),
                                                right=True).to(torch.int16)
    return rans.CoderTables(freqs, cums, s2s, k)


def coder_symbols(stack, t_idx, n_sym, gen):
    """(n_lanes, n_sym) int32 symbols, each lane's drawn from its table's
    distribution (so within its set's alphabet)."""
    M = 1 << stack.precision
    slots = torch.randint(0, M, (t_idx.shape[0], n_sym), generator=gen, device=t_idx.device)
    return stack.slot2sym[t_idx.long()[:, None], slots].to(torch.int32)


def table_pairs(t_idx, syms, alphabet):
    """The distinct (table, symbol) pairs of this run's data: the freqs and
    cums entries a K7 or K8 launch must read."""
    return int(torch.unique(t_idx.long()[:, None] * alphabet + syms.long()).numel())


def rans_bound(kind, n_lanes, n_sym, pairs, n_words_read=0):
    """The least time of one K7 or K8 launch, and beside it the time at one
    32-byte sector a table gather.  Bytes, each input read once and each
    output written once: K7 the words it consumes, the symbols it writes,
    n_words, state, table_idx, x and ptr; K8 the symbols, the whole
    (n_sym, n_lanes) word buffer, table_idx, n_words and x; and the table
    entries this run's data reads, ``pairs`` distinct (table, symbol)
    pairs (``table_pairs``) of one 8-byte freq and one 8-byte cum each, and
    for K7 one 2-byte slot2sym entry a pair (a lower bound: a symbol is
    read from at least one of its slots; the slots a lane visits are not
    counted one by one).  Operations at the card's int32 rate (about 12 a
    K7 step, 30 a K8 step with its 32-bit division).  The sector time
    charges instead one 32-byte sector for each table gather a step makes
    (K7: slot2sym, freqs, cums; K8: freqs, cums), as if no gather hit a
    cache: what the scattered gathers cost when every one goes to HBM, not
    a bound.  Returns ``(bound_ms, by), sector_ms``."""
    steps = n_lanes * n_sym
    if kind == "decode":
        base, n_ops, gathers, table = (n_words_read * 2 + steps * 4 + n_lanes * (4 + 4 + 4 + 8 + 8), 12 * steps, 3,
                                       pairs * (2 + 8 + 8))
    else:
        base, n_ops, gathers, table = (steps * 4 + n_lanes * max(n_sym, 1) * 4 + n_lanes * (4 + 4 + 8), 30 * steps,
                                       2, pairs * (8 + 8))
    return (bound(base + table, n_ops, timing.INT32_OPS),
            bound(base + 32 * gathers * steps, n_ops, timing.INT32_OPS)[0])


def sdpa_backends(call):
    """The names of SDPA's backends that take ``call`` when each is the only
    one allowed (SDPA picks among them).  A yardstick's note only: the port
    never calls SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    accepts = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")
                call()
            torch.cuda.synchronize()
            accepts.append(backend.name.lower())
        except RuntimeError:
            pass
    return accepts


def compact_stream(w, n, x):
    """A coded stream as the wire holds it and K7 takes it: the valid words
    lane-major (int16 bits), the word counts, each lane's offset into the
    payload (made on the card, as ``rans.decode_payload`` makes them) and
    the states (int32 bits)."""
    payload = rans.wire_bits(w, 16, w.device)[torch.arange(w.shape[1], device=w.device)[None, :] < n[:, None]]
    held = n.long().clamp_min(0)
    return payload, n, torch.cumsum(held, 0) - held, rans.wire_bits(x, 32, x.device)


def held_rans(stack, t_idx, syms, what):
    """K8 then K7 on the card against their plain versions (torch.equal on
    every output), K7 inverting K8 to the initial state, each the kernel
    ``kernels.ops`` picks for the alphabet (staged or wide).  Returns K7's
    arguments (the compact stream as the wire hands it over:
    ``compact_stream``), K8's and K7's plain outputs."""
    encode, decode = krans.encode_kernel(stack.alphabet), krans.decode_kernel(stack.alphabet)
    got, enc = encode(syms, t_idx, stack), rans_encode_plain(syms, t_idx, stack)
    require(all(torch.equal(a, b) for a, b in zip(got, enc)), f"K8 differs from its plain version ({what})")
    require(got[0].is_contiguous(), f"K8's words are not lane-major ({what})")
    args = (*compact_stream(*got), t_idx, stack, syms.shape[1])
    got, dec = decode(*args), rans_decode_plain(*args)
    require(all(torch.equal(a, b) for a, b in zip(got, dec)), f"K7 differs from its plain version ({what})")
    require(torch.equal(got[0], syms) and bool((got[1] == 1 << 16).all()) and bool((got[2] == -1).all()),
            f"K7 does not invert K8 ({what})")
    return args, enc, dec


def drive_main_path(cfg, dev, gen, phase=lambda name: contextlib.nullcontext(),
                    lengths=CONTEXTS, chunk=CHUNK, capacity=CAPACITY):
    """Phases 4 and 5: the port's entry points as a user calls them.

    ``phase(name)`` gives the context manager that times each phase.
    ``lengths``/``chunk``/``capacity`` default to the main-path sizes; the
    port's tests run the same function at a tiny size on the CPU (with the
    kernels' plain versions) to rehearse it without a card.
    """
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    C = Hkv * D
    k1_tol = ops.BF16_TOL["kv_dequant_tokens"]

    # ---------------------------------------------------------------- 4 serve
    with phase("serve"):
        laps = Laps(dev)
        gen.manual_seed(SEED)
        params = lm.init_params(cfg, gen, dev)
        engine = Engine(cfg, params, cache_capacity=capacity, device=dev)
        contexts = [torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=dev) for T in lengths]
        laps.lap("init")
        firsts, exact, kvs = [], [], []
        for ctx in contexts:
            logits, caches = engine.calculate_kv({"tokens": ctx})
            require(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
            firsts.append(int(torch.argmax(logits[0, -1])))
            exact.append(caches)
            kvs.append(caches_to_codec_kv(caches, 0, ctx.shape[1]))
        laps.lap("calculate_kv x4")
        ct = codec.profile([kvs[0]], codec.CodecConfig(), device=dev)
        laps.lap("profile")
        blobs = [[codec.encode_all_levels(kv[:, :, s:s + chunk], ct, chunk_idx=j)
                  for j, s in enumerate(range(0, kv.shape[2], chunk))] for kv in kvs]
        laps.lap("encode_all_levels")
        n_tokens = sum(lengths)
        fp16 = codec.kv_nbytes_fp16(L, n_tokens, C)
        for lvl in range(ct.config.n_levels):
            size = sum(len(c[lvl]) for req in blobs for c in req)
            print(f"level {lvl}: {size} bytes for {n_tokens} tokens ({fp16 / size:.2f}x smaller than fp16)")
        # request 3 has one chunk, so the mixed-level run is request 2's
        levels = [[0, 0], [1, 1], [0, 2], [4]]
        runs = [[blobs[r][j][lvl] for j, lvl in enumerate(lv)] for r, lv in enumerate(levels)]
        kv_run, spans = codec.decode_chunk_runs(runs, ct, out_dtype=torch.bfloat16)
        laps.lap("decode_chunk_runs")
        require([n for _, n in spans] == list(lengths), f"spans {spans}")
        # the fused decode against the unfused oracle, chunk by chunk
        for (off, _), run, lv in zip(spans, runs, levels):
            for blob, lvl in zip(run, lv):
                oracle = codec.decode_chunk(blob, ct)
                got = kv_run[:, :, off:off + oracle.shape[2]]
                if lvl == 0:
                    require(torch.equal(got, oracle.to(torch.bfloat16)), "level-0 decode is not bit-exact")
                else:
                    x = ops.bf16_ulp_excess(got, oracle, **k1_tol)
                    require(x <= 1, f"level-{lvl} decode is {x:.3g} times its tolerance off the oracle")
                off += oracle.shape[2]
        laps.lap("decode_chunk oracle checks")
        caches = engine.insert_runs(engine.empty_caches(len(lengths)), kv_run, list(range(len(lengths))),
                                    [0] * len(lengths), [n for _, n in spans])
        laps.lap("insert_runs")
        require(caches.length.tolist() == list(lengths), f"cache lengths {caches.length.tolist()}")
        for r, (off, n) in enumerate(spans):
            require(torch.equal(caches.kv_k[:, r, :n], kv_run[:, 0, off:off + n].reshape(L, n, Hkv, D)),
                    f"row {r} does not hold its run")
            err = (kv_run[:, :, off:off + n].float() - kvs[r]).abs().max().item()
            print(f"request {r}: levels {levels[r]}  max |decoded - exact KV| {err:.4f}")
        first = torch.tensor(firsts, device=dev)
        laps.lap("checks")
        gen_cg = engine.generate_with_kv(caches, first, GEN_TOKENS)
        laps.lap(f"generate_with_kv {GEN_TOKENS} tokens, batch {len(lengths)}")
        ref_caches = engine.empty_caches(len(lengths))
        for r, c in enumerate(exact):
            ref_caches.kv_k[:, r] = c.kv_k[:, 0]
            ref_caches.kv_v[:, r] = c.kv_v[:, 0]
        ref_caches = ref_caches._replace(length=torch.tensor(lengths, dtype=torch.int32, device=dev))
        gen_ref = engine.generate_with_kv(ref_caches, first, GEN_TOKENS)
        laps.lap("generate from the exact caches")
        require(gen_cg.shape == (len(lengths), GEN_TOKENS), f"generated {gen_cg.shape}")
        require(((gen_cg >= 0) & (gen_cg < cfg.padded_vocab_size)).all(), "token ids out of range")
        for r in range(len(lengths)):
            print(f"request {r}: token agreement with the exact cache {(gen_cg[r] == gen_ref[r]).mean():.2%} "
                  "(random weights: informational)")
        print("serve steps ms:", laps.ms)

    # ----------------------------------------------------------------- 5 text
    with phase("text"):
        c1 = engine.decode_to_cache(engine.empty_caches(1),
                                    codec.decode_chunks([blobs[0][0][1]], ct, out_dtype=torch.bfloat16), 0)
        logits, c1 = engine.prefill_extend(contexts[0][:, chunk:2 * chunk], c1)
        require(bool(torch.isfinite(logits).all()), "TEXT recompute logits are not finite")
        require(c1.length.tolist() == [2 * chunk], f"length after TEXT {c1.length.tolist()}")
        err = (c1.kv_k[:, 0, chunk:2 * chunk].float() - exact[0].kv_k[:, 0, chunk:2 * chunk].float()).abs().max()
        out = engine.generate_with_kv(c1, torch.argmax(logits[:, -1], dim=-1), TEXT_TOKENS)
        print(f"TEXT chunk K vs exact prefill: max abs diff {err.item():.4f}; generated {out[0].tolist()}")

    # this device's own rates, for the plan Algorithm 1 gives from them
    wire = sum(len(b) for run in runs for b in run)
    return {
        "params": params,
        "tables": ct,
        "decode_bytes_per_s": wire / (laps.ms["decode_chunk_runs"] / 1e3),
        "prefill_s_per_token": laps.ms["calculate_kv x4"] / 1e3 / sum(lengths),
    }


def drive_store_path(cfg, dev, gen, served, phase=lambda name: contextlib.nullcontext(),
                     chunk=CHUNK, n_chunks=STORE_CHUNKS, gen_tokens=GEN_TOKENS):
    """Phase 6: store -> stream -> materialize -> generate_with_kv.

    ``served`` is what :func:`drive_main_path` returns: the model's weights,
    the profiled tables and the serve phase's measured rates.  The port's
    tests run it at a tiny size on the CPU, as they do the main path.
    """
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    n_ctx = n_chunks * chunk
    k1_tol = ops.BF16_TOL["kv_dequant_tokens"]
    with phase("store"):
        laps = Laps(dev)
        engine = Engine(cfg, served["params"], cache_capacity=n_ctx + gen_tokens, device=dev)
        gen.manual_seed(SEED + 6)
        tokens = torch.randint(0, cfg.vocab_size, (1, n_ctx), generator=gen, device=dev)
        logits, exact = engine.calculate_kv({"tokens": tokens})
        require(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
        laps.lap(f"calculate_kv {n_ctx} tokens")
        store = KVStore(served["tables"])
        streamer = CacheGenStreamer(store, cfg)
        metas = streamer.store_from_caches("ctx", exact, n_ctx, chunk_tokens=chunk)
        laps.lap("store_from_caches")
        require([(m.start, m.end) for m in metas] == [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)],
                f"chunks {[(m.start, m.end) for m in metas]}")
        for lvl in range(served["tables"].config.n_levels):
            print(f"stored level {lvl}: {store.total_bytes('ctx', lvl)} bytes for {n_ctx} tokens")
        net = NetworkModel(BandwidthTrace.steps(DIP_S, [DIP_GBPS, LINK_GBPS]))
        own = streamer.stream(
            "ctx", net, slo_s=SLO_S, decode_bytes_per_s=served["decode_bytes_per_s"],
            recompute_s=lambda n, p: served["prefill_s_per_token"] * n, prior_throughput_gbps=LINK_GBPS)
        print(f"plan from this device's own rates (decode {served['decode_bytes_per_s']:.4g} B/s, "
              f"recompute {served['prefill_s_per_token'] * chunk:.4g} s per chunk): "
              f"configs {own.result.configs}, TTFT {own.result.ttft_s:.4f} s (informational)")
        plan = streamer.stream(
            "ctx", net, slo_s=SLO_S, decode_bytes_per_s=DECODE_BYTES_PER_S,
            recompute_s=lambda n, p: RECOMPUTE_S_PER_CHUNK * n / chunk, prior_throughput_gbps=LINK_GBPS)
        configs = plan.result.configs
        laps.lap("stream x2")
        print(f"plan from the stated rates: configs {configs}, TTFT {plan.result.ttft_s:.4f} s "
              f"(SLO {SLO_S} s)")
        for t in plan.result.timelines:
            print(f"  chunk {t.chunk_idx}: config {t.config}  {t.nbytes:.0f} bytes  fetch "
                  f"{t.fetch_start:.4f}-{t.fetch_end:.4f} s  compute {t.compute_start:.4f}-{t.compute_end:.4f} s")
        require(len({c for c in configs if c != TEXT}) >= 2 and TEXT in configs,
                f"the plan {configs} does not hold two levels and a TEXT chunk")
        fused = streamer.materialize(plan, engine, tokens)
        laps.lap("materialize fused")
        unfused = streamer.materialize(plan, engine, tokens, fused=False)
        laps.lap("materialize fused=False")
        for c in (fused, unfused):
            require(c.length.tolist() == [n_ctx], f"materialized length {c.length.tolist()}")
        for m, cfg_i in zip(metas, configs):
            sl = slice(m.start, m.end)
            a = torch.stack([fused.kv_k[:, 0, sl], fused.kv_v[:, 0, sl]])
            b = torch.stack([unfused.kv_k[:, 0, sl], unfused.kv_v[:, 0, sl]])
            want = torch.stack([exact.kv_k[:, 0, sl], exact.kv_v[:, 0, sl]]).float()
            diff = (a.float() - b.float()).abs().max().item()
            if cfg_i == 0:
                require(torch.equal(a, b), f"chunk {m.chunk_idx}: level-0 materialize modes differ")
            elif cfg_i != TEXT:
                x = ops.bf16_ulp_excess(a, b, **k1_tol)
                require(x <= 1, f"chunk {m.chunk_idx}: level-{cfg_i} modes are {x:.3g} times K1's rule apart")
            print(f"chunk {m.chunk_idx} ({'TEXT' if cfg_i == TEXT else f'level {cfg_i}'}): fused vs fused=False "
                  f"max abs diff {diff:.4g}; fused vs exact KV {(a.float() - want).abs().max().item():.4f}")
        laps.lap("checks")
        first = torch.argmax(logits[:, -1], dim=-1)
        outs = [engine.generate_with_kv(c, first, gen_tokens) for c in (fused, unfused)]
        laps.lap(f"generate_with_kv {gen_tokens} tokens x2")
        for o in outs:
            require(o.shape == (1, gen_tokens), f"generated {o.shape}")
            require(((o >= 0) & (o < cfg.padded_vocab_size)).all(), "token ids out of range")
        # greedy tokens of two caches that differ by bf16 ulps part where the
        # random-weight model's top two logits (nearly) tie: say where
        agree = outs[0] == outs[1]
        note = ""
        if not agree.all():
            k = int(np.argmin(agree[0]))
            lg, _ = engine.logits_with_kv(fused, np.concatenate([first.cpu().numpy()[:, None], outs[0][:, :k]], 1))
            top = np.sort(lg[0, -1])[-2:]
            note = f"; they part at step {k}, where the fused path's top-2 logit gap is {top[1] - top[0]:.4g}"
        print(f"token agreement fused vs fused=False {agree.mean():.2%} (informational{note})")
        print("store steps ms:", laps.ms)
    return {"engine": engine, "streamer": streamer, "tokens": tokens, "plan": plan, "fused": fused,
            "first": first, "fused_tokens": outs[0], "chunk": chunk, "exact": exact}


def codec_tables_to(ct, device):
    """``ct`` with its coder tables on ``device`` (the same tables on another
    route); the lossy delta stack, which only ``encode_all_levels`` reads,
    is left to be rebuilt there."""
    def move(t):
        return rans.CoderTables(t.freqs.to(device), t.cums.to(device), t.slot2sym.to(device), t.precision)

    return ct._replace(anchor=move(ct.anchor), deltas={lvl: move(t) for lvl, t in ct.deltas.items()},
                       ll_anchor=move(ct.ll_anchor), ll_delta=move(ct.ll_delta), anchor_stack=move(ct.anchor_stack),
                       lossy_delta_stack=None, delta_decode_stack=move(ct.delta_decode_stack))


def drive_wide_codec_path(cfg, dev, gen, served, phase=lambda name: contextlib.nullcontext(), ctx_len=WIDE_CTX,
                          gen_tokens=GEN_TOKENS, levels=WIDE_LEVELS):
    """Phase 19: the codec at ``WIDE_CODEC`` (delta_qmax 1023: 2,047-symbol
    delta tables, past the staged rANS kernels' caps) on ``served``'s
    weights: a ``ctx_len``-token context's KV (K4), ``profile``, and
    ``encode_all_levels`` of it as one chunk (K5; K8 staged for the anchors
    and the lossless deltas, wide for the lossy stack), its level-0 and
    level-1 blobs byte-identical to the CPU route's; ``decode_chunks`` of
    each of ``levels`` (K7 staged for the anchors and wide for the deltas,
    one each a call; K2 at level 0, K1 at a lossy level), level 0 bit for bit
    against the unfused ``decode_chunk`` and the CPU route's decode, a lossy
    level within K1's rule of ``decode_chunk``; the level-0 KV through
    ``decode_to_cache`` and ``gen_tokens`` greedy tokens (K3).  The port's
    tests run it at ``.tiny()`` on the CPU."""
    k1_tol = ops.BF16_TOL["kv_dequant_tokens"]
    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    wcfg = codec.CodecConfig(**WIDE_CODEC)
    with phase("wide codec"):
        laps = Laps(dev)
        engine = Engine(cfg, served["params"], cache_capacity=ctx_len + gen_tokens, device=dev)
        gen.manual_seed(SEED + 19)
        tokens = torch.randint(0, cfg.vocab_size, (1, ctx_len), generator=gen, device=dev)
        logits, exact = engine.calculate_kv({"tokens": tokens})
        kv = caches_to_codec_kv(exact, 0, ctx_len)
        laps.lap(f"calculate_kv {ctx_len} tokens")
        ct = codec.profile([kv], wcfg, device=dev)
        A = ct.delta_decode_stack.alphabet
        require(A == wcfg.delta_alphabet > krans.MAX_ALPHABET["decode"] and
                ct.lossy_delta_stack.alphabet > krans.MAX_ALPHABET["encode"],
                f"the decode stack's alphabet {A} does not take the wide kernels")
        laps.lap("profile")
        before = ops.launch_counts()
        blobs = codec.encode_all_levels(kv, ct, chunk_idx=0)
        enc = {n: c - before[n] for n, c in ops.launch_counts().items() if c != before[n]}
        laps.lap("encode_all_levels")
        if on_card:
            require(enc.get("rans_encode_wide") == 1 and enc.get("rans_encode", 0) >= 1,
                    f"encode_all_levels at alphabet {A} launched {enc}")
        fp16 = codec.kv_nbytes_fp16(cfg.n_layers, ctx_len, cfg.n_kv_heads * cfg.d_head)
        print(f"wide codec: delta_qmax {wcfg.delta_qmax}, precision {wcfg.precision}: delta alphabet {A} "
              f"(K7 staged up to {krans.MAX_ALPHABET['decode']}, K8 to {krans.MAX_ALPHABET['encode']}); bytes per "
              f"level {[len(blobs[lvl]) for lvl in sorted(blobs)]} for {ctx_len} tokens ({fp16} in fp16); "
              f"encode_all_levels launched {enc}")
        ct_cpu = codec_tables_to(ct, cpu)
        kv_cpu = kv.cpu()
        for lvl in (0, 1):
            require(codec.encode_chunk(kv_cpu, ct_cpu, lvl, chunk_idx=0) == blobs[lvl],
                    f"the level-{lvl} blob differs from the CPU route's")
        laps.lap("CPU route's encode of levels 0 and 1")
        decoded = {}
        for lvl in levels:
            before = ops.launch_counts()
            got = codec.decode_chunks([blobs[lvl]], ct)
            calls = {n: c - before[n] for n, c in ops.launch_counts().items() if c != before[n]}
            if on_card:
                k7 = {n: calls.get(n, 0) for n in ("rans_decode", "rans_decode_wide")}
                require(k7 == {"rans_decode": 1, "rans_decode_wide": 1},
                        f"decode_chunks at level {lvl} made the K7 launches {k7}, not one staged and one wide")
            with uncounted():
                oracle = codec.decode_chunk(blobs[lvl], ct)
            if lvl == 0:
                require(torch.equal(got, oracle), "the level-0 decode differs from decode_chunk")
            else:
                x = ops.bf16_ulp_excess(got.to(torch.bfloat16), oracle, **k1_tol)
                require(x <= 1, f"the level-{lvl} decode is {x:.3g} times K1's rule off decode_chunk")
            decoded[lvl] = got
            print(f"wide codec: decode_chunks at level {lvl} launched {calls}; max |decoded - exact KV| "
                  f"{(got - kv).abs().max().item():.4g}")
        laps.lap("decode_chunks and the oracle")
        if on_card:  # the wide kernels' device time a call on this path
            with uncounted():
                wide_ms = {"rans_decode_wide a decode_chunks": device_ms(
                    lambda: codec.decode_chunks([blobs[levels[-1]]], ct), "rans_decode_wide_kernel", iters=3),
                    "rans_encode_wide an encode_all_levels": device_ms(
                    lambda: codec.encode_all_levels(kv, ct, chunk_idx=0), "rans_encode_wide_kernel", iters=2)}
            print(f"wide codec: device ms {wide_ms}")
            laps.lap("the wide kernels' device times")
        require(torch.equal(codec.decode_chunks([blobs[0]], ct_cpu), decoded[0].cpu()),
                "the level-0 decode differs from the CPU route's")
        del ct_cpu, kv_cpu
        laps.lap("CPU route's level-0 decode")
        first = torch.argmax(logits[:, -1], dim=-1)
        c0 = engine.decode_to_cache(engine.empty_caches(1), decoded[0].to(torch.bfloat16), 0)
        toks = engine.generate_with_kv(c0, first, gen_tokens)
        require(toks.shape == (1, gen_tokens) and ((toks >= 0) & (toks < cfg.padded_vocab_size)).all(),
                f"generated {toks.shape} tokens out of range")
        with uncounted():
            want = engine.generate_with_kv(exact, first, gen_tokens)
        laps.lap(f"generate_with_kv {gen_tokens} tokens")
        print(f"wide codec: {gen_tokens} greedy tokens from the level-0 cache, {(toks == want).mean():.2%} equal to "
              f"the prefill cache's (informational)")
        print("wide codec steps ms:", laps.ms)
        if on_card:
            print("wide codec steps' peak allocated GB:", laps.peak_gb)


def shapes_configs(tiny=False):
    """Phase 20's three 2-layer models, derived from smollm-360m's config:
    two at published attention widths the registry lacks, and one at head
    dim 512 (K3's and K4's wide path; no published model has one); ``tiny``
    shrinks d_model, d_ff and the vocab and keeps the heads."""
    base = dataclasses.replace(registry.get("smollm-360m"), n_layers=2, tie_embeddings=False, remat=False)
    phi3 = dataclasses.replace(base, name="phi-3-mini-2l", d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
                               d_ff=8192, vocab_size=32064)
    falcon = dataclasses.replace(base, name="falcon-7b-2l", d_model=4544, n_heads=71, n_kv_heads=1, d_head=64,
                                 d_ff=18176, vocab_size=65024, norm="layernorm", mlp="gelu", parallel_block=True)
    wide = dataclasses.replace(base, name="gqa-8-2-d512-2l", d_model=2048, n_heads=8, n_kv_heads=2, d_head=512,
                               d_ff=8192, vocab_size=32000)
    out = {"Phi-3-mini MHA 32 x 96": phi3, "Falcon-7B 71:1 x 64": falcon, "GQA 8:2 x 512": wide}
    if tiny:
        out = {k: dataclasses.replace(c, d_model=128, d_ff=256, vocab_size=512) for k, c in out.items()}
    return out


@contextlib.contextmanager
def no_plain_attention():
    """K3's and K4's plain versions raise if ``kernels.ops`` picks them: on the
    card no call may reach them."""
    def refuse(*args, **kwargs):
        raise RuntimeError("a card call reached an attention kernel's plain version")

    saved = ops.decode_attention_plain, ops.flash_attention_plain
    ops.decode_attention_plain = ops.flash_attention_plain = refuse
    try:
        yield
    finally:
        ops.decode_attention_plain, ops.flash_attention_plain = saved


def drive_shapes_path(dev, gen, phase=lambda name: contextlib.nullcontext(), prompt=SHAPES_PROMPT,
                      steps=SHAPES_STEPS, tiny=False):
    """Phase 20: the two models of :func:`shapes_configs` (random bf16
    weights from a seed), each through the engine: a ``prompt``-token
    ``calculate_kv`` (K4 once a layer) and ``steps`` greedy tokens (K3 once a
    layer a step), on the card with K3's and K4's plain versions refusing
    every call and the launches counted exactly; run again with every K3 and
    K4 call held to its plain version under ``BF16_TOL`` (``held_calls``,
    uncounted: the same tokens); the prefill's and the first step's logits
    within ``SHAPES_STEP_TOL`` of their largest |logit| of the same calls on
    the plain attention (``plain_attention()``, uncounted).  The port's tests
    run it at ``tiny`` widths on the CPU."""
    on_card = dev.type == "cuda"
    with phase("shapes"):
        for i, (name, cfg) in enumerate(shapes_configs(tiny).items()):
            laps = Laps(dev)
            gen.manual_seed(SEED + 20 + i)
            params = lm.init_params(cfg, gen, dev)
            engine = Engine(cfg, params, cache_capacity=prompt + steps + 1, device=dev)
            tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen, device=dev)
            laps.lap("init")
            before = ops.launch_counts()
            with no_plain_attention() if on_card else contextlib.nullcontext():
                logits, caches = engine.calculate_kv({"tokens": tokens})
                first = torch.argmax(logits[:, -1], dim=-1)
                toks = engine.generate_with_kv(caches, first, steps)
            calls = {n: c - before[n] for n, c in ops.launch_counts().items() if c != before[n]}
            laps.lap(f"calculate_kv {prompt} tokens and {steps} steps")
            if on_card:
                want = {"flash_attention": cfg.n_layers, "decode_attention": cfg.n_layers * steps}
                require(calls == want, f"{name}: launches {calls}, not {want}")
            require(bool(torch.isfinite(logits).all()) and ((toks >= 0) & (toks < cfg.padded_vocab_size)).all(),
                    f"{name}: prefill logits not finite or tokens out of range")
            excess = []  # off the card the "kernel" is the plain version itself: nothing to hold
            with uncounted(), held_calls(excess) if on_card else contextlib.nullcontext():
                h_logits, h_caches = engine.calculate_kv({"tokens": tokens})
                h_toks = engine.generate_with_kv(h_caches, first, steps)
            worst = {k: max(x for n, x in excess if n == k) for k in {n for n, _ in excess}}
            if on_card:
                require(len(excess) == cfg.n_layers * (steps + 1) and max(worst.values()) <= 1,
                        f"{name}: held calls {len(excess)}, worst excess {worst}")
            require(torch.equal(h_logits, logits) and (h_toks == toks).all(),
                    f"{name}: the held run differs from the counted one")
            with uncounted():
                s_logits, _ = engine.logits_with_kv(caches, first.cpu().numpy()[:, None])
                with plain_attention():
                    p_logits, p_caches = engine.calculate_kv({"tokens": tokens})
                    ps_logits, _ = engine.logits_with_kv(p_caches, first.cpu().numpy()[:, None])
            rel = {}
            for what, a, b in (("prefill", logits[:, -1], p_logits[:, -1]),
                               ("first step", torch.as_tensor(s_logits), torch.as_tensor(ps_logits))):
                a, b = a.float().cpu(), b.float().cpu()
                rel[what] = ((a - b).abs().max() / (SHAPES_STEP_TOL * b.abs().max())).item()
                require(rel[what] <= 1, f"{name}: the {what} logits are {rel[what]:.3g} times {SHAPES_STEP_TOL} of "
                        "their largest |logit| off the plain attention's")
            laps.lap("held and plain runs")
            print(f"shapes {name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
                  f"{cfg.d_head}; launches {calls}; {len(excess)} held calls, worst {worst}; against the plain "
                  f"attention {({k: round(v, 4) for k, v in rel.items()})} of the {SHAPES_STEP_TOL} rule; steps ms "
                  f"{laps.ms}")
            del params, engine, caches, h_caches, p_caches


def drive_session_path(cfg, stored, phase=lambda name: contextlib.nullcontext(), gen_tokens=GEN_TOKENS):
    """Phase 7: the live session over phase 6's store and context.

    ``stored`` is what :func:`drive_store_path` returns.  A clean
    ``ServeSession`` run must reproduce phase 6's plan, TTFT and fused cache;
    a faulted run must recover through retries and a resumed prefix; the
    clean run's cache generates.  The port's tests run it at a tiny size on
    the CPU.
    """
    engine, streamer, tokens = stored["engine"], stored["streamer"], stored["tokens"]
    plan, fused, chunk = stored["plan"], stored["fused"], stored["chunk"]
    metas, n_ctx = plan.metas, plan.metas[-1].end
    k1_tol = ops.BF16_TOL["kv_dequant_tokens"]
    with phase("session"):
        laps = Laps(engine.device)
        network = lambda: NetworkModel(BandwidthTrace.steps(DIP_S, [DIP_GBPS, LINK_GBPS]))  # noqa: E731

        def session(**kw):
            return ServeSession(streamer, engine, slo_s=SLO_S, decode_bytes_per_s=DECODE_BYTES_PER_S,
                                recompute_s=lambda n, p: RECOMPUTE_S_PER_CHUNK * n / chunk, **kw)

        clean = session().run("ctx", tokens, network(), prior_throughput_gbps=LINK_GBPS)
        laps.lap("clean run")
        require(clean.status == "ok" and clean.caches.length.tolist() == [n_ctx],
                f"clean session: status {clean.status}, length {clean.caches.length.tolist()}")
        require(clean.configs == plan.result.configs,
                f"clean session configs {clean.configs}, phase 6's plan {plan.result.configs}")
        require(clean.ttft_s == plan.result.ttft_s, f"session TTFT {clean.ttft_s} != plan's {plan.result.ttft_s}")
        equal = True
        for m, cfg_i in zip(metas, clean.configs):
            sl = slice(m.start, m.end)
            a = torch.stack([clean.caches.kv_k[:, 0, sl], clean.caches.kv_v[:, 0, sl]])
            b = torch.stack([fused.kv_k[:, 0, sl], fused.kv_v[:, 0, sl]])
            same = torch.equal(a, b)
            equal &= same
            if cfg_i in (0, TEXT):  # the same calls on the same inputs as materialize's
                require(same, f"chunk {m.chunk_idx} ({cfg_i}): the session's cache differs from materialize's")
            else:
                x = ops.bf16_ulp_excess(a, b, **k1_tol)
                require(x <= 1, f"chunk {m.chunk_idx}: level-{cfg_i} session cache is {x:.3g} times K1's rule off")
            print(f"session chunk {m.chunk_idx} ({'TEXT' if cfg_i == TEXT else f'level {cfg_i}'}): "
                  f"{'equal to' if same else 'within K1 rule of'} materialize's cache")
        laps.lap("checks")
        bitstream = sum(t.nbytes for t in clean.timelines if t.config != TEXT)
        print(f"session (clean): configs {clean.configs}, TTFT {clean.ttft_s:.4f} s (plan {plan.result.ttft_s:.4f} s, "
              f"SLO {SLO_S} s), {clean.n_runs} decode run(s), bitstream bytes {bitstream:.0f}, "
              f"wall decode {clean.wall_decode_s:.4f} s, recompute {clean.wall_recompute_s:.4f} s, "
              f"total {clean.wall_total_s:.4f} s")
        print(f"session realized decode rate {bitstream / clean.wall_decode_s:.4g} B/s (bitstream bytes / wall "
              f"decode s) vs the stated {DECODE_BYTES_PER_S:.4g} B/s (informational)")
        # where a decode's wall time goes: the session's decoded chunks once
        # more through decode_chunks (uncounted), its host steps apart, K7's
        # two launches by the profiler
        blobs = [streamer.store.get_kv("ctx", m.chunk_idx, c) for m, c in zip(metas, clean.configs) if c != TEXT]
        ct, split = streamer.store.tables, Laps(engine.device)
        with uncounted():
            parsed = [codec.bitstream.unpack(b) for b in blobs]
            split.lap("unpack")
            joined = [codec._join_streams(parsed, p, engine.device) for p in ("a", "d")]
            for _, n_w, x in joined:  # the states and counts follow the payloads to the card
                rans.wire_bits(x, 32, engine.device), torch.as_tensor(n_w, device=engine.device)
            split.lap("copy the payloads to the card and join them there")
            del joined
            codec.decode_chunks(blobs, ct, out_dtype=torch.bfloat16)
            split.lap("decode_chunks")
            k7 = device_ms(lambda: codec.decode_chunks(blobs, ct, out_dtype=torch.bfloat16), "rans_decode_kernel",
                           iters=2) if engine.device.type == "cuda" else None
        laps.lap("decode breakdown")
        print(f"session decode of {len(blobs)} chunks ({sum(map(len, blobs))} bytes), wall ms {split.ms}; K7 "
              f"{k7} ms a launch on the device (two a call; informational)")

        fault_plan = FaultPlan(**FAULT_PLAN)
        first_fault = fault_plan.draw("ctx", 0, 0, 0)
        require(first_fault is not None and first_fault.kind == "truncate",
                f"the fault plan's first draw for chunk 0 is {first_fault}, not a truncation")
        net = network()
        ft = FaultyTransport(SimTransport(streamer.store, net), fault_plan)
        faulted = session(retry_policy=RetryPolicy(**FAULT_RETRY)).run(
            "ctx", tokens, net, prior_throughput_gbps=LINK_GBPS, transport=ft)
        laps.lap("faulted run")
        require(faulted.status == "ok" and faulted.caches.length.tolist() == [n_ctx],
                f"faulted session: status {faulted.status} ({faulted.failure}), "
                f"length {faulted.caches.length.tolist()}")
        require(faulted.n_retries > 0 and faulted.salvaged_bytes > 0 and faulted.n_resumes > 0,
                f"faulted session: {faulted.n_retries} retries, {faulted.salvaged_bytes} salvaged bytes, "
                f"{faulted.n_resumes} resumes")
        for t in faulted.timelines:
            if t.wire_bytes > 0:
                require(abs(t.salvaged_bytes + t.refetched_bytes - t.wire_bytes) < 1e-6,
                        f"chunk {t.chunk_idx}: salvaged {t.salvaged_bytes} + refetched {t.refetched_bytes} "
                        f"!= wire {t.wire_bytes}")
        require(abs(faulted.salvaged_bytes + faulted.refetched_bytes - faulted.wire_bytes) < 1e-6,
                "faulted session: the byte ledger does not reconcile")
        # a resumed blob is the stored blob, so chunks decided alike decode alike
        for m, c0, c1 in zip(metas, clean.configs, faulted.configs):
            if c0 != c1:
                break
            sl = slice(m.start, m.end)
            require(torch.equal(faulted.caches.kv_k[:, 0, sl], clean.caches.kv_k[:, 0, sl])
                    and torch.equal(faulted.caches.kv_v[:, 0, sl], clean.caches.kv_v[:, 0, sl]),
                    f"chunk {m.chunk_idx}: the faulted session's cache differs from the clean one's")
        print(f"session (faulted, {FAULT_PLAN}): configs {faulted.configs}, TTFT {faulted.ttft_s:.4f} s, "
              f"injected {ft.n_injected}, retries {faulted.n_retries}, failed attempts "
              f"{faulted.n_failed_attempts} {faulted.fault_counts}, resumes {faulted.n_resumes}, salvaged "
              f"{faulted.salvaged_bytes:.0f} + refetched {faulted.refetched_bytes:.0f} = wire "
              f"{faulted.wire_bytes:.0f} bytes, wall total {faulted.wall_total_s:.4f} s")
        laps.lap("faulted checks")

        out = engine.generate_with_kv(clean.caches, stored["first"], gen_tokens)
        laps.lap(f"generate_with_kv {gen_tokens} tokens")
        require(out.shape == (1, gen_tokens), f"generated {out.shape}")
        require(((out >= 0) & (out < cfg.padded_vocab_size)).all(), "token ids out of range")
        agree = (out == stored["fused_tokens"]).mean()
        if equal:  # the same cache and first token: K3 must give the same tokens
            require(agree == 1.0, f"tokens from the session's cache agree {agree:.2%} with materialize's")
        print(f"session tokens agree {agree:.2%} with those of phase 6's fused cache")
        print("session steps ms:", laps.ms)
    return {"clean": clean, "faulted": faulted, "tokens": out}


def scheduled_request(stored, engine, start_t=0.0, generation=None):
    """A request for phase 6's context on ``engine`` under phase 6's stated
    dip and rates (phases 8 and 15)."""
    session = ServeSession(stored["streamer"], engine, slo_s=SLO_S, decode_bytes_per_s=DECODE_BYTES_PER_S,
                           recompute_s=lambda n, p: RECOMPUTE_S_PER_CHUNK * n / stored["chunk"])
    return SessionRequest(session, "ctx", stored["tokens"],
                          NetworkModel(BandwidthTrace.steps(DIP_S, [DIP_GBPS, LINK_GBPS])),
                          prior_throughput_gbps=LINK_GBPS, start_t=start_t, generation=generation)


def drive_serving_path(cfg, stored, sessioned, phase=lambda name: contextlib.nullcontext(), n_requests=4, rows=2,
                       gen_tokens=GEN_TOKENS):
    """Phase 8: multi-request serving on phase 6's engine, store and context.

    ``sessioned`` is what :func:`drive_session_path` returns.  A wave of
    ``n_requests`` loads (``ConcurrentScheduler``) must decide and cache as
    phase 7's clean session; the continuous loop over the same requests at
    t = 0 must equal the wave; an open loop on ``rows`` rows must recycle
    them and generate ``gen_tokens`` tokens per request in stacked steps
    that a batch-1 oracle confirms; the row primitives must round-trip bit
    for bit on a copy of the wave's pool, and K3 must match its plain
    version at the pools' shapes.  The results it returns are left as the
    schedulers made them.  The port's tests run it at a tiny size on the
    CPU.
    """
    engine, plan = stored["engine"], stored["plan"]
    metas, n_ctx, cap = plan.metas, plan.metas[-1].end, engine.capacity
    clean = sessioned["clean"]
    first = int(stored["first"][0])
    k1_tol = ops.BF16_TOL["kv_dequant_tokens"]
    dev = engine.device

    def request(start_t=0.0, generation=None):
        return scheduled_request(stored, engine, start_t=start_t, generation=generation)

    def chunk_kv(caches, m):
        sl = slice(m.start, m.end)
        return torch.stack([caches.kv_k[:, 0, sl], caches.kv_v[:, 0, sl]])

    def bitstream_bytes(results):
        return sum(t.nbytes for r in results for t in r.timelines if t.config != TEXT)

    with phase("serving"):
        laps = Laps(dev)
        # ---- 1. the wave: every request decides and caches as phase 7's session
        wave = ConcurrentScheduler(engine, contention=ContentionModel(IDEAL_CONTENTION)).run(
            [request() for _ in range(n_requests)])
        laps.lap(f"wave of {n_requests}")
        worst_text = 0.0
        for i, s in enumerate(wave.sessions):
            require(s.status == "ok" and s.caches.length.tolist() == [n_ctx],
                    f"wave request {i}: status {s.status}, length {s.caches.length.tolist()}")
            require(s.configs == clean.configs and s.ttft_s == plan.result.ttft_s,
                    f"wave request {i}: configs {s.configs}, TTFT {s.ttft_s}; phase 7's {clean.configs}, "
                    f"the plan's TTFT {plan.result.ttft_s}")
            for m, c in zip(metas, s.configs):
                a, b = chunk_kv(s.caches, m), chunk_kv(clean.caches, m)
                if c == TEXT:
                    rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
                    require(rel <= TEXT_BATCH_REL, f"wave request {i} chunk {m.chunk_idx}: the batch-{n_requests} TEXT "
                            f"recompute is {rel:.3g} off the batch-1 one (relative), over {TEXT_BATCH_REL:.3g}")
                    worst_text = max(worst_text, rel)
                elif not torch.equal(a, b):
                    # reconstruction is per element, so stacking lanes should change no bit
                    x = ops.bf16_ulp_excess(a, b, **k1_tol)
                    require(c != 0 and x <= 1, f"wave request {i} chunk {m.chunk_idx} (level {c}) differs from "
                            f"phase 7's cache ({x:.3g} of K1's rule)")
                    print(f"wave request {i} chunk {m.chunk_idx} (level {c}): within K1's rule of phase 7's, not equal")
        wire = bitstream_bytes(wave.sessions)
        print(f"serving wave: {n_requests} requests, configs {wave.sessions[0].configs} each, TTFT "
              f"{wave.sessions[0].ttft_s:.4f} s each; rounds {wave.n_rounds}, decode batches {wave.n_decode_batches}, "
              f"runs {wave.n_runs}, text batches {wave.n_text_batches}; wall decode {wave.wall_decode_s:.4f} s, "
              f"recompute {wave.wall_recompute_s:.4f} s, total {wave.wall_total_s:.4f} s; level-0 and lossy chunks "
              f"equal phase 7's, TEXT chunks within {worst_text:.3g} relative of them")
        single = bitstream_bytes([clean])
        print(f"stacked decode rate {wire / wave.wall_decode_s:.4g} B/s ({wire:.0f} bitstream bytes of "
              f"{n_requests} requests / wall decode s) vs phase 7's single request "
              f"{single / clean.wall_decode_s:.4g} B/s")

        # ---- 2. the continuous loop at t = 0 on as many rows: the wave exactly
        cont = ContinuousScheduler(engine, contention=ContentionModel(IDEAL_CONTENTION)).run(
            [request() for _ in range(n_requests)])
        laps.lap("continuous at t = 0")
        for name in ("n_rounds", "n_decode_batches", "n_text_batches", "n_runs"):
            require(getattr(cont, name) == getattr(wave, name),
                    f"continuous {name} {getattr(cont, name)} != the wave's {getattr(wave, name)}")
        for i, (a, b) in enumerate(zip(cont.sessions, wave.sessions)):
            require(a.configs == b.configs and a.ttft_s == b.ttft_s,
                    f"continuous request {i}: configs {a.configs}, TTFT {a.ttft_s}; the wave's {b.configs}, {b.ttft_s}")
            require(torch.equal(a.caches.kv_k, b.caches.kv_k) and torch.equal(a.caches.kv_v, b.caches.kv_v)
                    and torch.equal(a.caches.length, b.caches.length),
                    f"continuous request {i}: the cache differs from the wave's")
        print(f"continuous at t = 0: the wave's {cont.n_rounds} rounds, dispatches, decisions and caches, bit for bit")

        # ---- 3. the open loop: arrivals over virtual time on fewer rows, generating
        spec = GenerationSpec(n_tokens=gen_tokens, first_token=first)
        arrivals = [ARRIVALS[i % len(ARRIVALS)] + 0.5 * (i // len(ARRIVALS)) for i in range(n_requests)]
        loop = ContinuousScheduler(engine, rows=rows, contention=ContentionModel(IDEAL_CONTENTION)).run(
            [request(start_t=a, generation=spec) for a in arrivals])
        laps.lap(f"open loop of {n_requests} on {rows} rows")
        seen, recycled = set(), 0
        for tl in sorted(loop.timeline, key=lambda tl: tl.admit_t):
            recycled += sum(1 for r in tl.rows_used if r in seen)
            seen.update(tl.rows_used)
        require(loop.n_rows == rows and recycled >= 2, f"the pool of {loop.n_rows} rows recycled {recycled} times")
        for i, (s, tl) in enumerate(zip(loop.sessions, loop.timeline)):
            require(s.status == "ok" and tl.n_tokens_out == gen_tokens,
                    f"open-loop request {i}: status {s.status}, {tl.n_tokens_out} tokens")
            require(all(0 <= t < cfg.padded_vocab_size for t in tl.tokens_out), f"request {i}: token ids out of range")
        require(loop.n_gen_tokens == n_requests * gen_tokens, f"{loop.n_gen_tokens} tokens generated")
        require(max(m for _, m in loop.gen_occupancy) >= 2, f"no stacked step of width 2: {loop.gen_occupancy}")
        # each request's tokens against a batch-1 oracle fed the same tokens
        # from the cache its load left (the result's own copy)
        exact, worst_gen = 0, 0.0
        for i, (s, tl) in enumerate(zip(loop.sessions, loop.timeline)):
            z, _ = engine.logits_with_kv(s.caches, np.array([[first] + tl.tokens_out[:-1]]))
            z, picked = z[0], np.array(tl.tokens_out)
            gap = (z.max(-1) - z[np.arange(gen_tokens), picked]) / np.abs(z).max(-1)
            exact += int((gap == 0).sum())
            worst_gen = max(worst_gen, float(gap.max()))
            require(gap.max() <= GEN_BATCH_REL, f"open-loop request {i}: token {int(gap.argmax())} lies "
                    f"{gap.max():.3g} (of the largest |logit|) below the batch-1 oracle's best, "
                    f"over {GEN_BATCH_REL:.3g}")
        laps.lap(f"batch-1 oracle of {n_requests} x {gen_tokens} tokens")
        print(f"open loop: arrivals {arrivals}, admitted at "
              f"{[round(float(tl.admit_t), 4) for tl in loop.timeline]}, rows "
              f"{[tl.rows_used for tl in loop.timeline]} ({recycled} recycled), TTFT "
              f"{[round(float(s.ttft_s), 4) for s in loop.sessions]}, configs {[s.configs for s in loop.sessions]}")
        occupancy = [m for _, m in loop.gen_occupancy]
        widths = {w: occupancy.count(w) for w in sorted(set(occupancy))}
        print(f"open loop generation: {loop.n_gen_tokens} tokens in {loop.n_gen_steps} stacked steps "
              f"(widths {widths}), "
              f"wall {loop.wall_gen_s:.4f} s, {1e3 * loop.wall_gen_s / loop.n_gen_steps:.2f} ms a step, "
              f"{loop.n_gen_tokens / loop.wall_gen_s:.4g} tokens per wall s; {exact} of {loop.n_gen_tokens} tokens "
              f"are the batch-1 oracle's argmax, the rest within {worst_gen:.3g} of its best logit")

        # ---- 4. the row primitives and K3, on pools this phase owns, at full width
        def k3_at(pool, what):
            # K3 as decode_step_rows calls it (kv_len = length + 1, a full
            # row's past the capacity) on one layer of the pool
            mid = pool.kv_k.shape[0] // 2
            k, v = pool.kv_k[mid], pool.kv_v[mid]
            q = torch.randn((k.shape[0], cfg.n_heads, cfg.d_head), generator=qgen, device=dev).to(k.dtype)
            kv_len = (pool.length + 1).to(torch.int32)
            exact = (q.float(), k.float(), v.float())
            with uncounted():
                # off the card the wrapper is the plain version, whose bf16
                # weights K3 does not round to: it runs on the f32 inputs
                got = ops.decode_attention(*((q, k, v) if dev.type == "cuda" else exact), kv_len)
            want = decode_attention_plain(*exact, kv_len)
            x = ops.bf16_ulp_excess(got, want, **ops.BF16_TOL["decode_attention"])
            require(x <= 1, f"K3 on the {what} is {x:.3g} times its tolerance off its plain version")
            print(f"K3 on the {what}: q {tuple(q.shape)} vs cache {tuple(k.shape)}, kv_len {kv_len.tolist()}: "
                  f"{x:.3g} of its tolerance")

        qgen = torch.Generator(device=dev)
        qgen.manual_seed(SEED + 8)
        pool = wave.caches.clone()
        snap = engine.save_row(pool, 0, n_ctx)
        pool = engine.reset_rows(pool, [1])
        require(pool.length[1].item() == 0 and not pool.kv_k[:, 1].any(), "reset_rows left row 1 dirty")
        pool = engine.restore_row(pool, snap, 1)
        require(torch.equal(pool.kv_k[:, 1], pool.kv_k[:, 0]) and torch.equal(pool.kv_v[:, 1], pool.kv_v[:, 0])
                and pool.length[1].item() == pool.length[0].item() == n_ctx,
                "save_row -> reset_rows -> restore_row is not bit-exact")
        # ragged inactive rows: the restored one at the context, the middle
        # ones mid-context (their next slot holds a real token), the last at
        # length == capacity
        last = pool.length.shape[0] - 1
        length = pool.length.clone()
        length[2:last] = n_ctx // 2 + 1
        length[last] = cap
        pool = pool._replace(length=length)
        kept = [(pool.kv_k[:, r].clone(), pool.kv_v[:, r].clone()) for r in range(1, last + 1)]
        lengths = pool.length.tolist()
        tok = np.zeros((last + 1, 1), np.int32)
        tok[0, 0] = first
        active = np.zeros(last + 1, bool)
        active[0] = True
        for _ in range(2):
            _, pool = engine.decode_step_rows(tok, pool, active)
        for r, (k, v) in enumerate(kept, start=1):
            require(torch.equal(pool.kv_k[:, r], k) and torch.equal(pool.kv_v[:, r], v),
                    f"decode_step_rows changed inactive row {r} (length {lengths[r]} of {cap})")
        require(pool.length.tolist() == [lengths[0] + 2] + lengths[1:], f"lengths {pool.length.tolist()}")
        del kept
        k3_at(pool, f"{last + 1}-row pool")
        del pool
        laps.lap("row primitives")

        # wall time of a stacked step as gen_step runs it (the step, then
        # the logits read), at each width of a pool of ``rows`` rows
        pool = Caches(wave.caches.kv_k[:, :rows].clone(), wave.caches.kv_v[:, :rows].clone(),
                      wave.caches.length[:rows].clone())
        n_ctx_len = pool.length.clone()
        samples = min(STEP_SAMPLES, cap - n_ctx - 1)
        per_width = {}
        for w in range(1, rows + 1):
            pool = pool._replace(length=n_ctx_len.clone())
            tok = np.full((rows, 1), first, np.int32)
            active = np.arange(rows) < w
            dts = []
            for _ in range(samples + 1):  # the first is a warm-up
                t0 = time.perf_counter()
                logits, pool = engine.decode_step_rows(tok, pool, active)
                logits[:, -1].float().cpu().numpy()
                dts.append(time.perf_counter() - t0)
            per_width[w] = round(1e3 * sum(dts[1:]) / samples, 2)
        pool.length[rows - 1] = cap
        k3_at(pool, f"{rows}-row pool")
        del pool
        laps.lap(f"step times at widths 1..{rows}")
        solo = ContinuousScheduler(engine, contention=ContentionModel(IDEAL_CONTENTION)).run(
            [request(generation=GenerationSpec(n_tokens=gen_tokens, first_token=first))])
        got = solo.timeline[0].tokens_out
        want = engine.generate_with_kv(solo.sessions[0].caches, torch.tensor([first], device=dev), gen_tokens)[0]
        require(got == want.tolist(), f"N = 1 continuous generation {got} != generate_with_kv's {want.tolist()}")
        laps.lap(f"N = 1 generation, {gen_tokens} tokens, and its oracle")
        print(f"stacked step wall ms by width on a {rows}-row pool ({samples} steps each, logits read): {per_width}")
        print(f"row primitives: save -> reset -> restore bit-exact, inactive rows (one at length {cap} = capacity) "
              f"untouched by decode_step_rows, N = 1 generation equals generate_with_kv's {gen_tokens} tokens")
        print("serving steps ms:", laps.ms)
    return {"wave": wave, "continuous": cont, "open_loop": loop, "step_ms": per_width}


def same_timeline(a, b):
    """Every field of two ``RequestTimeline``s equal (an unset instant is NaN
    in both)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not (x == y or (isinstance(x, float) and isinstance(y, float) and x != x and y != y)):
            return False
    return True


def drive_mesh_path(cfg, stored, served_rows, phase=lambda name: contextlib.nullcontext(), n_requests=4, rows=2,
                    gen_tokens=GEN_TOKENS, card=None):
    """Phase 15: row-sharded serving (``ShardedEngine``) on phase 6's
    weights, store and context, against phase 8's runs (``served_rows``,
    what :func:`drive_serving_path` returns).

    A. ``ShardedEngine`` over ``make_serving_mesh(1)``: phase 8's wave of
    ``n_requests`` and its open loop on ``rows`` rows, each request's
    decisions, virtual TTFT, cache and greedy tokens bit-equal to phase
    8's.  B. Two shards on one card (``Mesh([dev, dev])``): the same runs
    make A's decisions and TTFT; level-0 and lossy chunks equal A's, TEXT
    chunks and tokens within phase 8's drift rules (each shard's batch is
    2 rows, A's 4); K3 launches once a layer a shard in every stacked step;
    each row primitive on a shard is bit-equal to the plain Engine's same
    call on a cache of that shard's rows and within the drift rules of the
    4-row call; K3 holds to its plain version at a shard's rows.  C. The
    baselines on the card: ``uniform_quantize_kv`` at 8 and 4 bits on the
    context's KV bit-equal to the CPU's, its wire bytes beside CacheGen's
    levels, and ``attention_scores_for_h2o`` over one chunk within 1e-9 of
    the CPU's f64 with the same ``h2o_select``.  Prints the wall ms of a
    stacked step at 1 and 2 shards.  The port's tests run it at a tiny size
    on the CPU.
    """
    engine, streamer, plan, chunk = stored["engine"], stored["streamer"], stored["plan"], stored["chunk"]
    metas, n_ctx, cap = plan.metas, plan.metas[-1].end, engine.capacity
    first = int(stored["first"][0])
    dev = engine.device
    L = cfg.n_layers
    k3 = ops.KERNELS["decode_attention"]
    spec = GenerationSpec(n_tokens=gen_tokens, first_token=first)
    arrivals = [ARRIVALS[i % len(ARRIVALS)] + 0.5 * (i // len(ARRIVALS)) for i in range(n_requests)]

    def run(eng):
        wave = ConcurrentScheduler(eng, contention=ContentionModel(IDEAL_CONTENTION)).run(
            [scheduled_request(stored, eng) for _ in range(n_requests)])
        before = k3.launches
        loop = ContinuousScheduler(eng, rows=rows, contention=ContentionModel(IDEAL_CONTENTION)).run(
            [scheduled_request(stored, eng, start_t=a, generation=spec) for a in arrivals])
        # the loads launch no K3: every launch of the loop is a stacked step's
        return wave, loop, k3.launches - before

    def chunk_kv(caches, m):
        sl = slice(m.start, m.end)
        return torch.stack([caches.kv_k[:, 0, sl], caches.kv_v[:, 0, sl]])

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def near_tie(z, picked):
        # how far below the best logit the picked token lies, per row, as a
        # share of the largest |logit| (phase 8's rule for batch drift)
        z = z.float()
        best = z.max(-1).values
        return ((best - z.gather(-1, picked[:, None])[:, 0]) / z.abs().max(-1).values).max().item()

    mesh_device = None if dev.type == "cuda" else "cpu"
    wave8, loop8 = served_rows["wave"], served_rows["open_loop"]
    with phase("mesh"):
        laps = Laps(dev)
        # ---- A. one shard: phase 8 bit for bit
        one = ShardedEngine(cfg, engine.params, cache_capacity=cap, mesh=make_serving_mesh(1, device=mesh_device))
        wave1, loop1, k3_1 = run(one)
        laps.lap("A: wave and open loop, 1 shard")
        for what, got, want in (("wave", wave1, wave8), ("open loop", loop1, loop8)):
            for i, (a, b) in enumerate(zip(got.sessions, want.sessions)):
                require(a.configs == b.configs and a.ttft_s == b.ttft_s,
                        f"1-shard {what} request {i}: configs {a.configs}, TTFT {a.ttft_s}; phase 8's {b.configs}, "
                        f"{b.ttft_s}")
                require(all(torch.equal(x, y) for x, y in zip(a.caches[:3], b.caches[:3])),
                        f"1-shard {what} request {i}: the cache differs from phase 8's")
        for i, (a, b) in enumerate(zip(loop1.timeline, loop8.timeline)):
            require(same_timeline(a, b), f"1-shard open-loop request {i}: timeline {a} != phase 8's {b}")
        require(loop1.n_gen_steps == loop8.n_gen_steps, f"{loop1.n_gen_steps} steps, phase 8 {loop8.n_gen_steps}")
        require(dev.type != "cuda" or k3_1 == loop1.n_gen_steps * L,
                f"1 shard: {k3_1} K3 launches in {loop1.n_gen_steps} stacked steps of {L} layers")
        print(f"mesh A (1 shard): the wave's and the open loop's decisions, TTFTs, caches, timelines and "
              f"{loop1.n_gen_tokens} tokens equal phase 8's bit for bit; K3 {k3_1} launches in "
              f"{loop1.n_gen_steps} steps")

        # ---- B. two shards on the one card
        two = ShardedEngine(cfg, engine.params, cache_capacity=cap, mesh=Mesh([dev, dev], ("data",)))
        require(two.n_shards == 2 and two.cache_rows(3) == 4, f"{two.n_shards} shards")
        wave2, loop2, k3_2 = run(two)
        laps.lap("B: wave and open loop, 2 shards")
        require(isinstance(wave2.caches, ShardedCaches) and len(wave2.caches.shards) == 2, "the wave's pool")
        worst_text = 0.0
        for what, got, want in (("wave", wave2, wave1), ("open loop", loop2, loop1)):
            for i, (a, b) in enumerate(zip(got.sessions, want.sessions)):
                require(a.status == "ok" and a.configs == b.configs and a.ttft_s == b.ttft_s,
                        f"2-shard {what} request {i}: configs {a.configs}, TTFT {a.ttft_s}; 1 shard's {b.configs}, "
                        f"{b.ttft_s}")
                for m, c in zip(metas, a.configs):
                    x, y = chunk_kv(a.caches, m), chunk_kv(b.caches, m)
                    if c == TEXT:
                        r = rel(x, y)
                        require(r <= TEXT_BATCH_REL, f"2-shard {what} request {i} chunk {m.chunk_idx}: TEXT "
                                f"{r:.3g} off the 4-row call's (relative), over {TEXT_BATCH_REL:.3g}")
                        worst_text = max(worst_text, r)
                    else:
                        require(torch.equal(x, y), f"2-shard {what} request {i} chunk {m.chunk_idx} (level {c}) "
                                f"differs from the 1-shard run's")
        for i, (a, b) in enumerate(zip(loop2.timeline, loop1.timeline)):
            require(a.admit_t == b.admit_t and a.finish_t == b.finish_t and len(a.tokens_out) == gen_tokens,
                    f"2-shard open-loop request {i}: admitted {a.admit_t}, finished {a.finish_t}")
        require(dev.type != "cuda" or k3_2 == loop2.n_gen_steps * L * 2,
                f"2 shards: {k3_2} K3 launches in {loop2.n_gen_steps} stacked steps of {L} layers")
        worst_gen = 0.0
        with uncounted():
            for i, (s, tl) in enumerate(zip(loop2.sessions, loop2.timeline)):
                z, _ = engine.logits_with_kv(s.caches, np.array([[first] + tl.tokens_out[:-1]]))
                gap = near_tie(torch.as_tensor(z[0]), torch.as_tensor(tl.tokens_out))
                worst_gen = max(worst_gen, gap)
                require(gap <= GEN_BATCH_REL, f"2-shard open-loop request {i}: a token lies {gap:.3g} below the "
                        f"batch-1 oracle's best, over {GEN_BATCH_REL:.3g}")
        same_tokens = sum(a.tokens_out == b.tokens_out for a, b in zip(loop2.timeline, loop1.timeline))
        laps.lap("B: checks and the batch-1 oracle")
        print(f"mesh B (2 shards on one card): decisions and TTFTs equal A's; level-0 and lossy chunks bit-equal, "
              f"TEXT within {worst_text:.3g} relative; {same_tokens} of {n_requests} token streams equal A's, every "
              f"token within {worst_gen:.3g} of the batch-1 oracle's best; K3 {k3_2} launches in "
              f"{loop2.n_gen_steps} steps ({k3_2 // 2} a shard)")

        # ---- B. the row primitives on a shard vs the plain Engine on its rows
        with uncounted():
            pool = wave2.caches.clone()
            halves = [c.clone() for c in pool.shards]
            full = pool.gather()
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED + 15)
            kv = caches_to_codec_kv(extract_row(pool, 0), 0, n_ctx)
            t_run = min(48, n_ctx // 4)

            def check(what, sharded, plain_halves, plain_full=None, logits=None):
                for s, (part, half) in enumerate(zip(sharded.shards, plain_halves)):
                    require(all(torch.equal(x, y) for x, y in zip(part[:3], half[:3])),
                            f"{what}: shard {s} differs from the plain Engine's call on its rows")
                if logits is not None:
                    got, per_half = logits
                    require(torch.equal(got, torch.cat(per_half)), f"{what}: logits differ from the shards' plain calls")

            # insert_runs: one run a shard, rows 1 and 2
            runs, starts = (t_run, t_run // 2), (chunk // 2, 3)
            kv_new = torch.cat([kv[:, :, :runs[0]], kv[:, :, -runs[1]:]], dim=2)
            pool = two.insert_runs(pool, kv_new, [1, 2], starts, runs)
            halves[0] = engine.insert_runs(halves[0], kv_new[:, :, :runs[0]], [1], starts[:1], runs[:1])
            halves[1] = engine.insert_runs(halves[1], kv_new[:, :, runs[0]:], [0], starts[1:], runs[1:])
            full = engine.insert_runs(full, kv_new, [1, 2], starts, runs)
            check("insert_runs", pool, halves)
            require(all(torch.equal(x, y) for x, y in zip(pool.gather()[:3], full[:3])),
                    "insert_runs differs from the 4-row call")
            # prefill_extend_rows: rows 0, 2 and 3 recompute a TEXT chunk
            text = torch.randint(0, cfg.vocab_size, (4, TEXT_TOKENS), generator=gen, device=dev)
            widths = np.array([TEXT_TOKENS, 0, TEXT_TOKENS, TEXT_TOKENS])
            lx, pool = two.prefill_extend_rows(text, pool, widths)
            per_half = []
            for s in range(2):
                lg, halves[s] = engine.prefill_extend_rows(text[2 * s:2 * s + 2], halves[s], widths[2 * s:2 * s + 2])
                per_half.append(lg)
            lf, full = engine.prefill_extend_rows(text, full, widths)
            check("prefill_extend_rows", pool, halves, logits=(lx, per_half))
            gathered = pool.gather()
            text_rel = max(rel(gathered.kv_k[:, r], full.kv_k[:, r]) for r in (0, 2, 3))
            require(text_rel <= TEXT_BATCH_REL, f"prefill_extend_rows {text_rel:.3g} off the 4-row call (relative)")
            # prefill_extend_gather across the shards: rows 3 and 0
            text2 = text[[3, 0]]
            _, pool = two.prefill_extend_gather(text2, pool, [3, 0])
            glued = pool.gather()
            _, ref_gather = engine.prefill_extend_gather(text2, gathered, [3, 0])
            require(all(torch.equal(x, y) for x, y in zip(glued[:3], ref_gather[:3])),
                    "prefill_extend_gather differs from the plain Engine's on the same rows")
            _, full = engine.prefill_extend_gather(text2, full, [3, 0])
            halves = [c.clone() for c in pool.shards]
            # decode_step_rows: rows 0, 2 and 3 step; row 1 inactive
            tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen, device=dev)
            active = np.array([True, False, True, True])
            ld, pool = two.decode_step_rows(tok, pool, active)
            per_half = []
            for s in range(2):
                lg, halves[s] = engine.decode_step_rows(tok[2 * s:2 * s + 2], halves[s], active[2 * s:2 * s + 2])
                per_half.append(lg)
            lf, full = engine.decode_step_rows(tok, full, active)
            check("decode_step_rows", pool, halves, logits=(ld, per_half))
            on = torch.as_tensor(active, device=dev)
            step_gap = near_tie(lf[on, -1], ld[on, -1].float().argmax(-1))
            require(step_gap <= GEN_BATCH_REL, f"decode_step_rows: a 2-row shard's pick lies {step_gap:.3g} below the "
                    f"4-row call's best")
            # save -> reset -> restore across the shards: row 1 into row 2
            n1 = int(extract_row(pool, 1).length[0])
            snap = two.save_row(pool, 1, n1)
            pool = two.reset_rows(pool, [1, 2])
            pool = two.restore_row(pool, snap, 2)
            snap_h = engine.save_row(halves[0], 1, n1)
            halves[0] = engine.reset_rows(halves[0], [1])
            halves[1] = engine.reset_rows(halves[1], [0])
            halves[1] = engine.restore_row(halves[1], snap_h, 0)
            check("save_row -> reset_rows -> restore_row", pool, halves)
            require(int(extract_row(pool, 2).length[0]) == n1 and int(extract_row(pool, 1).length[0]) == 0,
                    "the row did not move to the other shard")
            # K3 at one shard's rows, one layer, a full row's kv_len past the capacity
            part = pool.shards[1]
            part.length[1] = cap
            k, v = part.kv_k[L // 2], part.kv_v[L // 2]
            q = torch.randn((k.shape[0], cfg.n_heads, cfg.d_head), generator=gen, device=dev).to(k.dtype)
            kv_len = (part.length + 1).to(torch.int32)
            exact = (q.float(), k.float(), v.float())
            got = ops.decode_attention(*((q, k, v) if dev.type == "cuda" else exact), kv_len)
            x = ops.bf16_ulp_excess(got, decode_attention_plain(*exact, kv_len), **ops.BF16_TOL["decode_attention"])
            require(x <= 1, f"K3 at a shard's rows is {x:.3g} times its tolerance off its plain version")
            del pool, halves, full, gathered, glued, ref_gather, part, k, v, kv
        laps.lap("B: row primitives per shard")
        print(f"mesh B row primitives: insert_runs, prefill_extend_rows, prefill_extend_gather, decode_step_rows, "
              f"save -> reset -> restore across shards bit-equal to the plain Engine on each shard's rows; against "
              f"the 4-row calls TEXT {text_rel:.3g} relative, the step's picks within {step_gap:.3g}; K3 at q "
              f"{tuple(q.shape)} vs a shard's cache {tuple(exact[1].shape)}, kv_len {kv_len.tolist()}: {x:.3g} of its "
              f"tolerance")

        # ---- wall ms of a stacked step of all 4 rows at 1 and 2 shards
        samples = min(STEP_SAMPLES, cap - n_ctx - 1)
        step_ms = {}
        for n_sh, eng, w in ((1, one, wave1), (2, two, wave2)):
            pool = w.caches.clone()
            tok = np.full((kv_layout.cache_batch(pool), 1), first, np.int32)
            act = np.ones(kv_layout.cache_batch(pool), bool)
            dts = []
            for _ in range(samples + 1):  # the first is a warm-up
                t0 = time.perf_counter()
                logits, pool = eng.decode_step_rows(tok, pool, act)
                logits[:, -1].float().cpu().numpy()
                dts.append(time.perf_counter() - t0)
            step_ms[n_sh] = round(1e3 * sum(dts[1:]) / samples, 2)
            del pool
        laps.lap("step times at 1 and 2 shards")
        print(f"mesh stacked step wall ms, 4 rows all active, logits read ({samples} steps each): 1 shard "
              f"{step_ms[1]}, 2 shards {step_ms[2]} (both shards on one card: no scaling is claimed){f'; {card}' if card else ''}")

        # ---- C. the baselines on the card against the CPU
        ctx_kv = caches_to_codec_kv(stored["exact"], 0, n_ctx)  # (L, 2, T, C) f32
        L_, _, T_, C_ = ctx_kv.shape
        wires = {}
        for bits in (8, 4):
            got, wires[bits] = baselines.uniform_quantize_kv(ctx_kv, bits=bits)
            want, wire_cpu = baselines.uniform_quantize_kv(ctx_kv.cpu(), bits=bits)
            require(wire_cpu == wires[bits] and torch.equal(got.cpu(), want),
                    f"uniform_quantize_kv at {bits} bits differs from the CPU's")
            err = (got - ctx_kv).abs().max().item()
            print(f"baseline uniform {bits}-bit quantization (group 64): {wires[bits]} wire bytes, bit-equal to the "
                  f"CPU's, max abs error {err:.4g}")
            del got, want
        store = streamer.store
        levels = {lvl: store.total_bytes("ctx", lvl) for lvl in range(store.tables.config.n_levels)}
        print(f"wire bytes for {T_} tokens: CacheGen by level {levels}; uniform 8-bit {wires[8]}, 4-bit {wires[4]}; "
              f"kv_nbytes_fp16 {codec.kv_nbytes_fp16(L_, T_, C_)}, kv_nbytes_int8 {codec.kv_nbytes_int8(L_, T_, C_)} "
              f"(random weights: sizes only, no quality claim)")
        del ctx_kv
        keys = stored["exact"].kv_k[:, 0, :chunk]  # (L, T, Hkv, D): keys as queries over one chunk
        scores = attention_scores_for_h2o(keys, keys)
        scores_cpu = attention_scores_for_h2o(keys.cpu(), keys.cpu())
        h2o_rel = ((scores.cpu() - scores_cpu).abs() / scores_cpu.abs()).max().item()
        require(h2o_rel <= 1e-9, f"attention_scores_for_h2o {h2o_rel:.3g} off the CPU's f64 (relative)")
        keep = baselines.h2o_select(scores, 0.5)
        keep_cpu = baselines.h2o_select(scores_cpu, 0.5)
        s_cpu = scores_cpu.numpy()
        # the lowest score the CPU's selection kept outside the recent window
        cut = min((s_cpu[i] for i in keep_cpu if i < len(s_cpu) - 32), default=np.inf)
        moved = set(keep.tolist()) ^ set(keep_cpu.tolist())
        require(all(abs(s_cpu[i] - cut) <= 1e-9 * abs(cut) for i in moved),
                f"h2o_select differs from the CPU's at indices {sorted(moved)} away from the cut")
        laps.lap("C: baselines")
        print(f"baseline H2O scores over {keys.shape[1]} tokens x {keys.shape[0]} layers x {keys.shape[2]} heads: "
              f"{h2o_rel:.3g} relative of the CPU's f64; h2o_select(0.5) keeps {len(keep)}, "
              f"{len(moved)} indices apart at the cut")
        print("mesh steps ms:", laps.ms)
    return {"one": (wave1, loop1), "two": (wave2, loop2), "step_ms": step_ms, "k3": (k3_1, k3_2)}


def match_materialize(run, results, what, ctx_len, replayed=None):
    """Holds each result's cache to ``streamer.materialize`` of its own
    configs on ``run``'s engine and store, under phase 7's rules: level 0
    bit for bit, lossy levels within K1's rule, TEXT within
    ``TEXT_BATCH_REL`` relative.  With ``replayed`` (phase 10: row -> start
    -> the K/V a replayed batched TEXT call wrote there) a TEXT chunk must
    equal its replay bit for bit instead, and its distance from
    ``materialize``'s batch-1 recompute is only reported: an MoE layer's
    capacity depends on every row of its call.  The launches these decodes
    make are not counted.  Returns the chunks compared by kind and the worst
    TEXT error (relative, against ``materialize``)."""
    streamer, engine = run["streamer"], run["engine"]
    metas = streamer.store.meta("ctx")
    k1_tol = ops.BF16_TOL["kv_dequant_tokens"]
    kinds, worst_text = {"level 0": 0, "lossy": 0, "TEXT": 0}, 0.0
    with uncounted():
        for r, res in enumerate(results):
            plan = FetchPlan(context_id="ctx", result=res.stream_result(), metas=metas)
            mat = streamer.materialize(plan, engine, run["tokens"])
            require(res.caches.length.tolist() == mat.length.tolist() == [ctx_len],
                    f"{what}: request {r}'s length {res.caches.length.tolist()}, materialize's "
                    f"{mat.length.tolist()}")
            for m, c in zip(metas, res.configs):
                sl = slice(m.start, m.end)
                x = torch.stack([res.caches.kv_k[:, 0, sl], res.caches.kv_v[:, 0, sl]])
                y = torch.stack([mat.kv_k[:, 0, sl], mat.kv_v[:, 0, sl]])
                where = f"{what}: request {r}'s chunk {m.chunk_idx}"
                if c == 0:
                    require(torch.equal(x, y), f"{where} (level 0) differs from materialize's")
                    kinds["level 0"] += 1
                elif c != TEXT:
                    e = ops.bf16_ulp_excess(x, y, **k1_tol)
                    require(e <= 1, f"{where} (level {c}) is {e:.3g} times K1's rule off materialize's")
                    kinds["lossy"] += 1
                else:
                    rel = ((x.float() - y.float()).norm() / y.float().norm()).item()
                    if replayed is None:
                        require(rel <= TEXT_BATCH_REL, f"{where} (TEXT) is {rel:.3g} off materialize's (relative)")
                    else:
                        require(torch.equal(x, replayed[r][m.start]),
                                f"{where} (TEXT) differs from its batched call replayed")
                    kinds["TEXT"] += 1
                    worst_text = max(worst_text, rel)
    return kinds, worst_text


def drive_launcher_path(dev, phase=lambda name: contextlib.nullcontext(), ctx_len=LAUNCH_CTX, full_width=True):
    """Phase 9: the port's serving launcher as a user runs it.

    Three ``serve.run`` calls (A: a checked wave on the sim transport, B:
    TCP on the tiered store under faults, C: an open loop that preempts and
    generates; see the module docstring).  ``full_width`` adds
    ``--full-width``; the port's tests run it without, at ``.tiny()`` and a
    small ``ctx_len``, on the CPU.
    """
    base = ["--ctx-len", str(ctx_len), "--requests", str(LAUNCH_REQUESTS), "--device", str(dev)]
    base += ["--full-width"] if full_width else []
    with phase("launcher"):
        laps = Laps(dev)
        # ---- A: a wave of four on the sim transport, held to the simulator
        print("launcher A:", " ".join(base + ["--concurrency", "4", "--check-sim"]))
        a = serve.run(base + ["--concurrency", "4", "--check-sim"])
        laps.lap("A")
        require(a["sim_match"] == {r: True for r in range(LAUNCH_REQUESTS)},
                f"A: the requests' decisions against the simulator's: {a['sim_match']}")
        require(all(w.n_failed == 0 for w in a["waves"]), "A: a request failed")
        kinds, worst_text = match_materialize(a, a["sessions"], "A", ctx_len)
        laps.lap("A: materialize check")
        print(f"launcher A: {LAUNCH_REQUESTS} requests made the simulator's decisions "
              f"({[s.configs for s in a['sessions']]}) and equal materialize of their configs "
              f"(chunks compared: {kinds}; TEXT within {worst_text:.3g} relative)")

        # ---- B: TCP, tiered store with a cold tier on disk, faults, retries
        hot = a["store"].storage_bytes("ctx") // 2
        with tempfile.TemporaryDirectory(prefix="cachegen-cold-") as cold:
            argv = base + ["--concurrency", "2", "--store", "tiered", "--store-dir", cold, "--hot-bytes", str(hot),
                           "--transport", "tcp", "--tcp-pace-gbps", "10", "--retry", str(LAUNCH_RETRY),
                           "--fault-truncate", str(LAUNCH_TRUNCATE_P), "--fault-seed", str(LAUNCH_FAULT_SEED),
                           "--fixed-level", "1"]
            print("launcher B:", " ".join(argv))
            b = serve.run(argv)
        laps.lap("B")
        tc, srv = b["tier_counters"], b["tcp_server"]
        n_chunks = len(b["streamer"].store.meta("ctx"))
        require(all(w.n_failed == 0 for w in b["waves"]), "B: a request failed")
        require(srv["n_injected_faults"] > 0, "B: the server injected no fault")
        require(tc["cold_hits"] + tc["demotions"] > 0, f"B: the cold tier was not used: {tc}")
        require(all(s.configs == [1] * n_chunks for s in b["sessions"]), "B: a chunk left level 1")
        retries = sum(s.n_retries for s in b["sessions"])
        print(f"launcher B: hot tier {hot} bytes; {retries} retries, "
              f"{sum(s.n_resumes for s in b['sessions'])} resumes, "
              f"{sum(s.salvaged_bytes for s in b['sessions']):.0f} salvaged bytes; server {srv}; "
              f"client {b['tcp_client']}")

        # ---- C: an open loop on two rows that preempts and generates
        argv = base + ["--arrivals", f"poisson:{LAUNCH_RATE}", "--rows", "2", "--slo-ms", str(LAUNCH_SLO_MS),
                       "--preempt", "--generate", str(LAUNCH_GEN), "--gen-step-ms", str(LAUNCH_GEN_STEP_MS),
                       "--fixed-level", "0"]
        print("launcher C:", " ".join(argv))
        c = serve.run(argv)
        laps.lap("C")
        loop = c["open_loop"]
        require(loop.n_failed == 0, "C: a request failed")
        require(max(n for _, n in loop.occupancy) == 2, "C: the two rows were never busy at once")
        require(loop.n_preemptions > 0 and loop.n_resumes == loop.n_preemptions,
                f"C: {loop.n_preemptions} preemptions, {loop.n_resumes} resumes")
        require([tl.n_tokens_out for tl in loop.timeline] == [LAUNCH_GEN] * LAUNCH_REQUESTS,
                f"C: tokens out {[tl.n_tokens_out for tl in loop.timeline]}")
        peak_gen = max(n for _, n in loop.gen_occupancy)
        require(peak_gen == 2, f"C: no generation step stacked both rows (widest {peak_gen})")
        rows = sorted({r for tl in loop.timeline for r in tl.rows_used})
        require(rows == [0, 1], f"C: rows used {rows}")
        require(any(line.startswith(f"[generation tokens={LAUNCH_GEN * LAUNCH_REQUESTS}]") for line in c["lines"]),
                "C: no generation line")
        kinds_c, _ = match_materialize(c, loop.sessions, "C", ctx_len)
        laps.lap("C: materialize check")
        stacked = sum(1 for _, n in loop.gen_occupancy if n == 2)
        print(f"launcher C: {loop.n_preemptions} preemptions; {loop.n_gen_tokens} tokens in {loop.n_gen_steps} "
              f"steps ({stacked} of width 2), {loop.n_gen_tokens / loop.wall_gen_s:.4g} tokens per wall s, "
              f"{1e3 * loop.wall_gen_s / loop.n_gen_steps:.2f} ms a step; every request equals materialize of "
              f"its configs (chunks compared: {kinds_c})")
        print("launcher steps ms:", laps.ms)
    return {"A": a, "B": b, "C": c}


@contextlib.contextmanager
def counting_drops(drops):
    """Appends, for each MoE layer the block runs, the slots its dispatch
    drops for lack of capacity (a device scalar; the router is run a second
    time to count them)."""
    apply = lm.moe_apply

    def counted(cfg, p, x):
        drops.append(moe.dropped_slots(cfg, p, x))
        return apply(cfg, p, x)

    lm.moe_apply = counted
    try:
        yield
    finally:
        lm.moe_apply = apply


@contextlib.contextmanager
def routing(record=None, pinned=None, flips=None):
    """Each MoE layer's routing, in call order: appended to ``record``, or
    taken from ``pinned`` (the experts a recorded run chose, weighted by
    this run's own gates), with ``flips`` counting the tokens whose own
    top-k would have chosen other experts."""
    route = moe.route
    calls = iter(pinned or ())

    def routed(cfg, p, x):
        r = route(cfg, p, x)
        if pinned is None:
            record.append(r.topi)
            return r
        topi = next(calls)
        flips.append(int((topi.sort(-1)[0] != r.topi.sort(-1)[0]).any(-1).sum()))
        topv = r.gates.gather(-1, topi)
        return moe.Routing(r.gates, topv / topv.sum(-1, keepdim=True).clamp_min(1e-9), topi)

    moe.route = routed
    try:
        yield
    finally:
        moe.route = route


@contextlib.contextmanager
def plain_attention():
    """The model's attention through K3's and K4's plain versions on any
    device: f32 arithmetic from the same inputs, the result in their dtype;
    under autograd it differentiates (the plain path of phase 14's grads)."""
    saved = ops.decode_attention, ops.flash_attention

    def decode(q, k, v, kv_len, *, scale=None):
        return decode_attention_plain(q.float(), k.float(), v.float(), kv_len, scale=scale).to(q.dtype)

    def flash(q, k, v, prefix_len=None, *, causal=True, scale=None):
        return flash_attention_plain(q.float(), k.float(), v.float(), prefix_len, causal=causal,
                                     scale=scale).to(q.dtype)

    ops.decode_attention, ops.flash_attention = decode, flash
    try:
        yield
    finally:
        ops.decode_attention, ops.flash_attention = saved


@contextlib.contextmanager
def held_calls(excess):
    """Every K3 and K4 call in the block is also computed by its plain
    version from the same inputs in f32 and held to its kernel's bf16 rule
    (``kernels.ops.BF16_TOL``); appends (kernel name, excess) to ``excess``.
    The plain versions launch nothing, and run outside autograd: under a
    training step each would build an f32 graph of its own."""
    decode_k, flash_k = ops.decode_attention, ops.flash_attention

    def decode(q, k, v, kv_len, *, scale=None):
        out = decode_k(q, k, v, kv_len, scale=scale)
        with torch.no_grad():
            want = decode_attention_plain(q.float(), k.float(), v.float(), kv_len, scale=scale)
            excess.append(("decode_attention",
                           ops.bf16_ulp_excess(out, want, **ops.BF16_TOL["decode_attention"])))
        return out

    def flash(q, k, v, prefix_len=None, *, causal=True, scale=None):
        out = flash_k(q, k, v, prefix_len, causal=causal, scale=scale)
        with torch.no_grad():
            want = flash_attention_plain(q.float(), k.float(), v.float(), prefix_len, causal=causal, scale=scale)
            mag = flash_attention_magnitude(q, k, v, prefix_len, causal=causal, scale=scale)
            excess.append(("flash_attention",
                           ops.bf16_ulp_excess(out, want, scale=mag, **ops.BF16_TOL["flash_attention"])))
        return out

    ops.decode_attention, ops.flash_attention = decode, flash
    try:
        yield
    finally:
        ops.decode_attention, ops.flash_attention = decode_k, flash_k


def _plain_grads(q, k, v, do, prefix_len=None, causal=True):
    """(dq, dk, dv) by autograd through K4's whole plain version."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    return torch.autograd.grad(flash_attention_plain(q, k, v, prefix_len, causal=causal), (q, k, v), do)


def flash_grad_check(q, k, v, do, prefix_len=None, causal=True):
    """K4 under autograd (``ops.flash_attention`` with grad on: K4 forward,
    the plain version's VJP backward) on bf16 inputs: returns (its (dq, dk,
    dv); the largest ratio over them of their distance from the f32 plain
    version's gradients to that of autograd through the plain version on
    the same bf16 inputs, which they must equal where the query chunks are
    at most two, whose sums commute; their largest |error| against f32)."""
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(ops.flash_attention(qq, kk, vv, prefix_len, causal=causal), (qq, kk, vv), do)
    plain = _plain_grads(q, k, v, do, prefix_len, causal)
    f32 = _plain_grads(q.float(), k.float(), v.float(), do.float(), prefix_len, causal)
    worst = err = 0.0
    for g, p, w in zip(got, plain, f32):
        require(g.dtype == q.dtype and g.shape == p.shape and bool(torch.isfinite(g).all()),
                f"K4 under autograd: a gradient {g.dtype} {tuple(g.shape)} is not finite")
        if -(-q.shape[1] // flash_attention.Q_CHUNK) <= 2:
            require(torch.equal(g, p), "K4 under autograd: the gradients differ from the plain version's")
        scale = w.abs().max()
        dg, dp = ((g.float() - w).abs().max() / scale).item(), ((p.float() - w).abs().max() / scale).item()
        worst = max(worst, dg / dp if dp else (0.0 if dg == 0 else float("inf")))
        err = max(err, (g.float() - w).abs().max().item())
    return got, worst, err


@contextlib.contextmanager
def replaying_text(replayed):
    """``serve.run``'s engine replays each batched TEXT call
    (``prefill_extend_rows`` / ``prefill_extend_gather``) on a copy of its
    input cache, uncounted, and fails unless the two give the same bits;
    ``replayed[row][start]`` keeps the K/V each written row got."""

    class ReplayEngine(serve.Engine):
        def prefill_extend_rows(self, tokens, caches, widths):
            return self._replay(super().prefill_extend_rows, tokens, caches, widths,
                                [r for r, w in enumerate(np.asarray(widths)) if int(w) > 0])

        def prefill_extend_gather(self, tokens, caches, rows):
            return self._replay(super().prefill_extend_gather, tokens, caches, rows, list(rows))

        def _replay(self, call, tokens, caches, arg, rows):
            starts = caches.length.tolist()
            copy = caches.clone()
            logits, out = call(tokens, caches, arg)
            with uncounted():
                logits2, again = call(tokens, copy, arg)
            require(torch.equal(logits, logits2) and torch.equal(out.length, again.length)
                    and torch.equal(out.kv_k, again.kv_k) and torch.equal(out.kv_v, again.kv_v),
                    f"a batched TEXT call on rows {rows} replayed on the same inputs gave other bits")
            for r in rows:
                sl = slice(starts[r], int(again.length[r]))
                replayed.setdefault(r, {})[starts[r]] = torch.stack([again.kv_k[:, r, sl], again.kv_v[:, r, sl]])
            return logits, out

    engine = serve.Engine
    serve.Engine = ReplayEngine
    try:
        yield
    finally:
        serve.Engine = engine


def drive_moe_path(cfg, dev, gen, phase=lambda name: contextlib.nullcontext(), ctx_len=MOE_CTX,
                   chunk=MOE_CHUNK, gen_tokens=GEN_TOKENS, launcher_ctx=MOE_CTX, full_width=True,
                   pinned_ctx=None):
    """Phase 10: the MoE family (``cfg``, qwen2-moe-a2.7b at full width on
    the card) through the engine and the launcher.

    A: seeded bf16 weights; ``calculate_kv`` of a ``ctx_len``-token context
    (K4; each layer's dropped slots printed); ``profile`` and every level of
    its ``chunk``-token chunks (K5); one ``decode_chunk_runs`` of a level-0
    and a level-``MOE_LOSSY`` run (K2, K1) into a 2-row cache, held to the
    unfused per-chunk ``decode_chunk`` (K6, uncounted): level 0 bit for bit,
    the lossy run within K1's rule; ``gen_tokens`` greedy tokens from the
    fused level-0 cache equal to those from the oracle's (K3; the oracle's
    and the prefill cache's generations uncounted); one decode step with
    the kernels against the same step on their plain versions, routed to
    the kernel step's experts (within ``MOE_STEP_TOL``; the tokens the plain
    step's own router would send elsewhere are counted), and against itself
    (bit for bit), with its wall and device time.  (Off the card the
    "kernels" are the plain versions in the inputs' dtype, whose bf16
    attention weights differ more from the f32 plain step than K3 does.)
    B: ``serve.run`` with ``--check-sim`` (``--full-width`` if
    ``full_width``): one wave of ``MOE_REQUESTS`` as the simulator decides
    at ``launcher_ctx`` tokens, then one of ``MOE_PINNED`` at level 0 and
    one at level ``MOE_LOSSY`` at ``pinned_ctx`` (``launcher_ctx`` if
    None); every request must make the simulator's decisions
    and equal ``materialize`` of its configs (level 0 bit for bit, lossy
    within K1's rule, TEXT chunks bit for bit to their batched call
    replayed), and the runs together must load level-0 and lossy chunks.
    The port's tests run it at ``.tiny()`` on the CPU.
    """
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    k1_tol = ops.BF16_TOL["kv_dequant_tokens"]
    on_card = dev.type == "cuda"
    with phase("moe"):
        laps = Laps(dev)
        # ---- A: the engine
        gen.manual_seed(SEED + 10)
        params = lm.init_params(cfg, gen, dev)
        laps.lap("init")
        resident = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        peak = f"{laps.peak_gb['init']} GB" if on_card else "not measured"
        print(f"moe: {cfg.name} weights {resident / 1e9:.2f} GB resident ({cfg.dtype}); peak allocated during "
              f"the draw {peak}")
        engine = Engine(cfg, params, cache_capacity=ctx_len + gen_tokens + 1, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (1, ctx_len), generator=gen, device=dev)
        drops = []
        with counting_drops(drops):
            logits, exact = engine.calculate_kv({"tokens": tokens})
        require(bool(torch.isfinite(logits).all()), "moe prefill logits are not finite")
        laps.lap(f"calculate_kv {ctx_len} tokens")
        require(len(drops) == L, f"{len(drops)} MoE layers ran, not {L}")
        print(f"moe prefill: dropped slots by layer {[int(x) for x in drops]} of {ctx_len * cfg.moe_topk} a layer")
        kv = caches_to_codec_kv(exact, 0, ctx_len)
        ct = codec.profile([kv], codec.CodecConfig(), device=dev)
        laps.lap("profile")
        starts = list(range(0, ctx_len, chunk))
        blobs = [codec.encode_all_levels(kv[:, :, s:s + chunk], ct, chunk_idx=j) for j, s in enumerate(starts)]
        laps.lap(f"encode_all_levels {len(starts)} chunks")
        fp16 = codec.kv_nbytes_fp16(L, ctx_len, Hkv * D)
        for lvl in range(ct.config.n_levels):
            size = sum(len(b[lvl]) for b in blobs)
            print(f"moe level {lvl}: {size} bytes for {ctx_len} tokens ({fp16 / size:.2f}x smaller than fp16)")
        runs = [[b[0] for b in blobs], [b[MOE_LOSSY] for b in blobs]]
        kv_run, spans = codec.decode_chunk_runs(runs, ct, out_dtype=torch.bfloat16)
        laps.lap("decode_chunk_runs")
        require([n for _, n in spans] == [ctx_len, ctx_len], f"spans {spans}")
        caches = engine.insert_runs(engine.empty_caches(2), kv_run, [0, 1], [0, 0], [ctx_len, ctx_len])
        laps.lap("insert_runs")
        # the unfused per-chunk oracle, and a 1-row cache of its level 0
        oracle = engine.empty_caches(1)
        worst = 0.0
        with uncounted():
            for j, s in enumerate(starts):
                want = codec.decode_chunk(blobs[j][0], ct)
                n = want.shape[2]
                require(torch.equal(kv_run[:, :, s:s + n], want.to(torch.bfloat16)),
                        f"moe chunk {j}: the fused level-0 decode is not bit-equal to decode_chunk's")
                oracle = engine.decode_to_cache(oracle, want.to(torch.bfloat16), s)
                lossy = codec.decode_chunk(blobs[j][MOE_LOSSY], ct)
                x = ops.bf16_ulp_excess(kv_run[:, :, ctx_len + s:ctx_len + s + n], lossy, **k1_tol)
                require(x <= 1, f"moe chunk {j}: level {MOE_LOSSY} is {x:.3g} times K1's rule off decode_chunk's")
                worst = max(worst, x)
        require(oracle.length.tolist() == [ctx_len], f"oracle length {oracle.length.tolist()}")
        laps.lap("decode_chunk oracle")
        err = (caches.kv_k[:, 0, :ctx_len].float() - exact.kv_k[:, 0, :ctx_len].float()).abs().max().item()
        print(f"moe decode: level 0 bit-equal to the unfused oracle, level {MOE_LOSSY} within {worst:.3g} of K1's "
              f"rule; max |level 0 - prefill K| {err:.4f} (8-bit quantization)")
        fused = Caches(caches.kv_k[:, :1].clone(), caches.kv_v[:, :1].clone(), caches.length[:1].clone())
        del caches, kv_run, kv
        first = torch.argmax(logits[:, -1], dim=-1)
        outs = {"fused": engine.generate_with_kv(fused, first, gen_tokens)}
        with uncounted():  # the oracle's and the prefill cache's tokens are comparisons
            outs.update((name, engine.generate_with_kv(c, first, gen_tokens))
                        for name, c in (("oracle", oracle), ("prefill", exact)))
        laps.lap(f"generate_with_kv {gen_tokens} tokens x3")
        for o in outs.values():
            require(o.shape == (1, gen_tokens) and ((o >= 0) & (o < cfg.padded_vocab_size)).all(),
                    f"moe generated {o.shape} tokens out of range")
        require((outs["fused"] == outs["oracle"]).all(),
                f"moe greedy tokens from the fused cache {outs['fused'][0].tolist()} differ from the oracle's "
                f"{outs['oracle'][0].tolist()}")
        print(f"moe greedy: {gen_tokens} tokens equal from the fused and the oracle cache; agreement with the "
              f"prefill cache's {(outs['fused'] == outs['prefill']).mean():.2%} (informational)")

        # ---- one whole-model step: kernels against plain, and against itself
        tok = first[:, None]

        def step():
            return lm.decode_step(cfg, params, tok, fused.clone())[0]

        # the plain step takes the kernel step's experts: a router near tie
        # that an ulp of attention output tips would change the function,
        # not measure the kernels; the tokens it tips are counted, and the
        # plain step with its own routing is reported beside
        routes, flips = [], []
        with uncounted():
            with routing(record=routes):
                a = step()
            b = step()
            with plain_attention():
                with routing(pinned=routes, flips=flips):
                    p = step()
                free = step()
        require(torch.equal(a, b), "the same moe decode step run twice gave other logits")

        def off(z):
            return ((a.float() - z.float()).abs().max() / (MOE_STEP_TOL * z.float().abs().max())).item()

        x = off(p)
        require(x <= 1, f"the moe step with the kernels is {x:.3g} times {MOE_STEP_TOL} of its largest |logit| off "
                "its plain version (routing pinned)")
        agree = int(torch.argmax(a[0, -1])) == int(torch.argmax(p[0, -1]))
        tipped = [l for l, f in enumerate(flips) if f]
        print(f"moe step: the plain attention would route other experts at layers {tipped}; with its own routing "
              f"it is {off(free):.3g} of the rule off, argmax "
              f"{'equal' if int(torch.argmax(a[0, -1])) == int(torch.argmax(free[0, -1])) else 'different'} "
              "(informational)")
        samples, c = [], fused.clone()
        with uncounted():
            for _ in range(STEP_SAMPLES + 1):  # the first is a warm-up
                t0 = time.perf_counter()
                z, c = lm.decode_step(cfg, params, tok, c)
                z[:, -1].float().cpu()
                samples.append(1e3 * (time.perf_counter() - t0))
            # each call writes the same slot of c (its length stays)
            dev_ms = f"{device_total_ms(lambda: lm.decode_step(cfg, params, tok, c)):.3f} ms" if on_card \
                else "not measured"
        del c
        laps.lap("step checks and times")
        print(f"moe step: logits bit-identical run twice; {x:.3g} of the {MOE_STEP_TOL} rule off the plain step "
              f"(its experts pinned to the kernel step's), argmax {'equal' if agree else 'different'}; "
              f"wall {sum(samples[1:]) / STEP_SAMPLES:.2f} ms a step (logits read), device {dev_ms}")
        print("moe engine steps ms:", laps.ms)
        if on_card:
            print("moe engine steps' peak allocated GB:", laps.peak_gb)
        # the codec tables are per lane (98,304 lanes at this width): tens
        # of GB on the card, freed with the engine before the launcher
        # profiles its own
        del params, engine, exact, oracle, fused, logits, blobs, ct
        if on_card:
            torch.cuda.empty_cache()
            print(f"moe: {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated after the engine is freed")

        # ---- B: the launcher: a wave of MOE_REQUESTS as the simulator
        # decides, then waves of MOE_PINNED pinned to level 0 and to level
        # MOE_LOSSY, so that stored levels load through it too; each run is
        # freed before the next draws its weights and profiles its tables
        laps = Laps(dev)
        base = ["--arch", MOE_ARCH, "--check-sim", "--device", str(dev)]
        base += ["--full-width"] if full_width else []
        pinned_ctx = launcher_ctx if pinned_ctx is None else pinned_ctx
        waves = {"decided": (MOE_REQUESTS, None, launcher_ctx), "level 0": (MOE_PINNED, 0, pinned_ctx),
                 f"level {MOE_LOSSY}": (MOE_PINNED, MOE_LOSSY, pinned_ctx)}
        launched, totals = {}, {"level 0": 0, "lossy": 0, "TEXT": 0}
        for name, (n_req, level, ctx) in waves.items():
            argv = base + ["--ctx-len", str(ctx), "--requests", str(n_req), "--concurrency", str(n_req)]
            argv += [] if level is None else ["--fixed-level", str(level)]
            print(f"moe launcher {name}:", " ".join(argv))
            replayed = {}
            with replaying_text(replayed):
                run = serve.run(argv)
            laps.lap(f"serve.run {name}")
            what = f"moe launcher {name}"
            require(run["sim_match"] == {r: True for r in range(n_req)},
                    f"{what}: the requests' decisions against the simulator's: {run['sim_match']}")
            require(len(run["waves"]) == 1 and run["waves"][0].n_failed == 0, f"{what}: not one clean wave")
            configs = [s.configs for s in run["sessions"]]
            n_chunks = len(run["streamer"].store.meta("ctx"))
            if level is not None:
                require(configs == [[level] * n_chunks] * n_req, f"{what}: configs {configs}")
            kinds, worst_text = match_materialize(run, run["sessions"], what, ctx, replayed)
            laps.lap(f"materialize check {name}")
            wave = run["waves"][0]
            if level is not None:
                require(wave.n_decode_batches > 0, f"{what}: no batched decode")
            totals = {k: totals[k] + kinds[k] for k in totals}
            print(f"{what}: {n_req} requests made the simulator's decisions ({configs}); "
                  f"{wave.n_decode_batches} batched decodes, {wave.n_text_batches} batched TEXT calls replayed bit "
                  f"for bit; every request equals materialize of its configs (chunks compared: {kinds}; TEXT chunks "
                  f"{worst_text:.3g} relative from materialize's batch-1 recompute, informational)")
            launched[name] = {"cfg": run["cfg"], "configs": configs, "kinds": kinds}
            del run, replayed
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        require(totals["level 0"] > 0 and totals["lossy"] > 0, f"moe launcher: chunks compared {totals}")
        print("moe launcher steps ms (the serve.run laps include the TEXT calls' replays):", laps.ms)
        if on_card:
            print("moe launcher steps' peak allocated GB:", laps.peak_gb)
    return {"drops": [int(x) for x in drops], "tokens": outs, "launcher": launched}


def drive_vlm_path(cfg, dev, gen, phase=lambda name: contextlib.nullcontext(), ctx_len=VLM_CTX,
                   chunk=VLM_CHUNK, gen_tokens=GEN_TOKENS, launcher_ctx=VLM_CTX, full_width=True):
    """Phase 11: the vlm family (``cfg``, paligemma-3b at full width on the
    card) through the engine and the launcher.

    A: seeded bf16 weights; ``calculate_kv`` of ``cfg.n_prefix_tokens``
    image rows (seeded f32 patch embeddings through ``frontend_proj``) and a
    ``ctx_len``-token context, the image rows attended bidirectionally (K4
    with its prefix); ``profile`` and every level of the cached rows in
    ``chunk``-row chunks (K5); one ``decode_chunk_runs`` of a level-0 and a
    level-``VLM_LOSSY`` run (K2, K1) into a 2-row cache, held to the unfused
    per-chunk ``decode_chunk`` (K6, uncounted): level 0 bit for bit, the
    lossy run within K1's rule; ``gen_tokens`` greedy tokens from the fused
    level-0 cache equal to those from the oracle's and from the prefill
    cache's (K3; those two generations uncounted); one decode step with the kernels against
    the same step on their plain versions (within ``VLM_STEP_TOL`` of its
    largest |logit|) and against itself (bit for bit), with its wall and
    device time.
    B: ``serve.run --arch paligemma-3b --check-sim`` at ``launcher_ctx``
    tokens (``--full-width`` if ``full_width``): a wave of ``VLM_REQUESTS``
    as the simulator decides, then one of ``VLM_PINNED`` pinned to level
    ``VLM_LOSSY``; every request must make the simulator's decisions (no
    chunk is TEXT: the image rows have no tokens) and equal ``materialize``
    of its configs (level 0 bit for bit, lossy within K1's rule).
    The port's tests run it at ``.tiny()`` on the CPU.
    """
    L, Hkv, D, n_img = cfg.n_layers, cfg.n_kv_heads, cfg.d_head, cfg.n_prefix_tokens
    n_rows = n_img + ctx_len
    k1_tol = ops.BF16_TOL["kv_dequant_tokens"]
    on_card = dev.type == "cuda"
    with phase("vlm"):
        laps = Laps(dev)
        # ---- A: the engine
        gen.manual_seed(SEED + 11)
        params = lm.init_params(cfg, gen, dev)
        laps.lap("init")
        resident = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        print(f"vlm: {cfg.name} weights {resident / 1e9:.2f} GB resident ({cfg.dtype}), "
              f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B parameters")
        engine = Engine(cfg, params, cache_capacity=n_rows + gen_tokens + 1, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (1, ctx_len), generator=gen, device=dev)
        patches = torch.randn((1, n_img, cfg.frontend_dim), generator=gen, device=dev)
        logits, exact = engine.calculate_kv({"tokens": tokens, "patch_embeds": patches})
        require(bool(torch.isfinite(logits).all()), "vlm prefill logits are not finite")
        require(exact.length.tolist() == [n_rows], f"vlm prefill length {exact.length.tolist()}, not {n_rows}")
        laps.lap(f"calculate_kv {n_img} + {ctx_len} rows")
        kv = caches_to_codec_kv(exact, 0, n_rows)
        ct = codec.profile([kv], codec.CodecConfig(), device=dev)
        laps.lap("profile")
        starts = list(range(0, n_rows, chunk))
        blobs = [codec.encode_all_levels(kv[:, :, s:s + chunk], ct, chunk_idx=j) for j, s in enumerate(starts)]
        laps.lap(f"encode_all_levels {len(starts)} chunks")
        fp16 = codec.kv_nbytes_fp16(L, n_rows, Hkv * D)
        for lvl in range(ct.config.n_levels):
            size = sum(len(b[lvl]) for b in blobs)
            print(f"vlm level {lvl}: {size} bytes for {n_rows} rows ({fp16 / size:.2f}x smaller than fp16)")
        runs = [[b[0] for b in blobs], [b[VLM_LOSSY] for b in blobs]]
        kv_run, spans = codec.decode_chunk_runs(runs, ct, out_dtype=torch.bfloat16)
        laps.lap("decode_chunk_runs")
        require([n for _, n in spans] == [n_rows, n_rows], f"spans {spans}")
        caches = engine.insert_runs(engine.empty_caches(2), kv_run, [0, 1], [0, 0], [n_rows, n_rows])
        laps.lap("insert_runs")
        oracle = engine.empty_caches(1)
        worst = 0.0
        with uncounted():
            for j, s in enumerate(starts):
                want = codec.decode_chunk(blobs[j][0], ct)
                n = want.shape[2]
                require(torch.equal(kv_run[:, :, s:s + n], want.to(torch.bfloat16)),
                        f"vlm chunk {j}: the fused level-0 decode is not bit-equal to decode_chunk's")
                oracle = engine.decode_to_cache(oracle, want.to(torch.bfloat16), s)
                lossy = codec.decode_chunk(blobs[j][VLM_LOSSY], ct)
                x = ops.bf16_ulp_excess(kv_run[:, :, n_rows + s:n_rows + s + n], lossy, **k1_tol)
                require(x <= 1, f"vlm chunk {j}: level {VLM_LOSSY} is {x:.3g} times K1's rule off decode_chunk's")
                worst = max(worst, x)
        require(oracle.length.tolist() == [n_rows], f"oracle length {oracle.length.tolist()}")
        laps.lap("decode_chunk oracle")
        err = (caches.kv_k[:, 0, :n_rows].float() - exact.kv_k[:, 0, :n_rows].float()).abs().max().item()
        print(f"vlm decode: level 0 bit-equal to the unfused oracle, level {VLM_LOSSY} within {worst:.3g} of K1's "
              f"rule; max |level 0 - prefill K| {err:.4f} (8-bit quantization)")
        fused = Caches(caches.kv_k[:, :1].clone(), caches.kv_v[:, :1].clone(), caches.length[:1].clone())
        del caches, kv_run, kv
        first = torch.argmax(logits[:, -1], dim=-1)
        outs = {"fused": engine.generate_with_kv(fused, first, gen_tokens)}
        with uncounted():  # the oracle's and the prefill cache's tokens are comparisons
            outs.update((name, engine.generate_with_kv(c, first, gen_tokens))
                        for name, c in (("oracle", oracle), ("prefill", exact)))
        laps.lap(f"generate_with_kv {gen_tokens} tokens x3")
        for o in outs.values():
            require(o.shape == (1, gen_tokens) and ((o >= 0) & (o < cfg.padded_vocab_size)).all(),
                    f"vlm generated {o.shape} tokens out of range")
        for name in ("oracle", "prefill"):
            require((outs["fused"] == outs[name]).all(),
                    f"vlm greedy tokens from the fused cache {outs['fused'][0].tolist()} differ from the {name} "
                    f"cache's {outs[name][0].tolist()}")
        print(f"vlm greedy: {gen_tokens} tokens equal from the fused, the oracle and the prefill cache")

        # ---- one whole-model step: kernels against plain, and against itself
        tok = first[:, None]

        def step():
            return lm.decode_step(cfg, params, tok, fused.clone())[0]

        with uncounted():
            a, b = step(), step()
            with plain_attention():
                p = step()
        require(torch.equal(a, b), "the same vlm decode step run twice gave other logits")
        x = ((a.float() - p.float()).abs().max() / (VLM_STEP_TOL * p.float().abs().max())).item()
        require(x <= 1, f"the vlm step with the kernels is {x:.3g} times {VLM_STEP_TOL} of its largest |logit| "
                "off its plain version")
        agree = int(torch.argmax(a[0, -1])) == int(torch.argmax(p[0, -1]))
        samples, c = [], fused.clone()
        with uncounted():
            for _ in range(STEP_SAMPLES + 1):  # the first is a warm-up
                t0 = time.perf_counter()
                z, c = lm.decode_step(cfg, params, tok, c)
                z[:, -1].float().cpu()
                samples.append(1e3 * (time.perf_counter() - t0))
            # each call writes the same slot of c (its length stays)
            dev_ms = f"{device_total_ms(lambda: lm.decode_step(cfg, params, tok, c)):.3f} ms" if on_card \
                else "not measured"
        del c
        laps.lap("step checks and times")
        print(f"vlm step: logits bit-identical run twice; {x:.3g} of the {VLM_STEP_TOL} rule off the plain step, "
              f"argmax {'equal' if agree else 'different'}; wall {sum(samples[1:]) / STEP_SAMPLES:.2f} ms a step "
              f"(logits read), device {dev_ms}")
        print("vlm engine steps ms:", laps.ms)
        if on_card:
            print("vlm engine steps' peak allocated GB:", laps.peak_gb)
        del params, engine, exact, oracle, fused, logits, blobs, ct
        if on_card:
            torch.cuda.empty_cache()

        # ---- B: the launcher: a wave of VLM_REQUESTS as the simulator
        # decides, then a wave of VLM_PINNED pinned to level VLM_LOSSY
        laps = Laps(dev)
        base = ["--arch", VLM_ARCH, "--ctx-len", str(launcher_ctx), "--check-sim", "--device", str(dev)]
        base += ["--full-width"] if full_width else []
        waves = {"decided": (VLM_REQUESTS, None), f"level {VLM_LOSSY}": (VLM_PINNED, VLM_LOSSY)}
        launched, totals = {}, {"level 0": 0, "lossy": 0, "TEXT": 0}
        for name, (n_req, level) in waves.items():
            argv = base + ["--requests", str(n_req), "--concurrency", str(n_req)]
            argv += [] if level is None else ["--fixed-level", str(level)]
            print(f"vlm launcher {name}:", " ".join(argv))
            run = serve.run(argv)
            laps.lap(f"serve.run {name}")
            what = f"vlm launcher {name}"
            rows = launcher_ctx + run["cfg"].n_prefix_tokens
            require(run["sim_match"] == {r: True for r in range(n_req)},
                    f"{what}: the requests' decisions against the simulator's: {run['sim_match']}")
            require(len(run["waves"]) == 1 and run["waves"][0].n_failed == 0, f"{what}: not one clean wave")
            configs = [s.configs for s in run["sessions"]]
            require(all(TEXT not in c for c in configs), f"{what}: a TEXT chunk in {configs}")
            n_chunks = len(run["streamer"].store.meta("ctx"))
            if level is not None:
                require(configs == [[level] * n_chunks] * n_req, f"{what}: configs {configs}")
            kinds, _ = match_materialize(run, run["sessions"], what, rows)
            laps.lap(f"materialize check {name}")
            totals = {k: totals[k] + kinds[k] for k in totals}
            print(f"{what}: {n_req} requests made the simulator's decisions ({configs}); "
                  f"{run['waves'][0].n_decode_batches} batched decodes; every request equals materialize of its "
                  f"configs (chunks compared: {kinds}); engine capacity {run['engine'].capacity} for {rows} rows")
            launched[name] = {"cfg": run["cfg"], "configs": configs, "kinds": kinds}
            del run
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        require(totals["lossy"] > 0, f"vlm launcher: chunks compared {totals}")
        print("vlm launcher steps ms:", laps.ms)
        if on_card:
            print("vlm launcher steps' peak allocated GB:", laps.peak_gb)
    return {"tokens": outs, "launcher": launched}


def _ssd_layer0(cfg, params, tokens):
    """Layer 0's SSD inputs on ``tokens``, as the prefill computes them:
    (x, dt, A, B, C)."""
    p = lm._unstack(params["layers"], cfg.n_layers)[0]
    h = apply_norm(cfg.norm, p["ln1"], lm._embed_tokens(cfg, params, tokens))
    return mamba2.ssd_inputs(cfg, p["mamba"], h)[1:6]


def drive_recurrent_path(cfg, dev, gen, phase=lambda name: contextlib.nullcontext(), ctx_len=SSM_CTX,
                         gen_tokens=GEN_TOKENS):
    """Phase 12: the ssm family (A, mamba2-370m) or the hybrid family (B,
    zamba2-2.7b), ``cfg`` at full width on the card, through the engine.

    Seeded bf16 weights; ``calculate_kv`` of ``ctx_len`` tokens (the
    hybrid: K4 once a shared-block application) and ``gen_tokens`` greedy
    tokens by ``generate_with_kv`` (the hybrid: K3 once a token and
    application), equal in a second, uncounted run; one decode step after
    the prefill against the prefill of ``ctx_len + 1`` tokens at its last
    position, on an f32 copy of the weights (logits, Mamba-2 states and the
    step's shared K/V within ``SSD_TOL`` of their largest |value|; in bf16
    the two differ by the model's own rounding noise, which its random
    layers amplify past ``SSM_STEP_TOL``: printed, not held).  A
    also holds the chunked SSD scan to the sequential recurrence at layer
    0's real shapes in f32 (within ``SSD_TOL`` of its largest |value|); B
    holds one decode step with the kernels to itself (bit for bit) and to
    the same step on their plain versions (within ``SSM_STEP_TOL`` of its
    largest |logit|).  Prints a step's wall and device ms and each step's
    peak memory.  The port's tests run it at ``.tiny()`` on the CPU.
    """
    hybrid = cfg.family == "hybrid"
    name = "hybrid" if hybrid else "ssm"
    on_card = dev.type == "cuda"
    cap = ctx_len + gen_tokens + 1
    with phase(name):
        laps = Laps(dev)
        gen.manual_seed(SEED + (13 if hybrid else 12))
        params = lm.init_params(cfg, gen, dev)
        laps.lap("init")
        resident = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        print(f"{name}: {cfg.name} weights {resident / 1e9:.2f} GB resident ({cfg.dtype}), "
              f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B parameters")
        engine = Engine(cfg, params, cache_capacity=cap, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (1, ctx_len + 1), generator=gen, device=dev)
        n_apps = cfg.n_layers // cfg.shared_block_every if hybrid else 0
        before = ops.launch_counts()
        logits, caches = engine.calculate_kv({"tokens": tokens[:, :ctx_len]})
        laps.lap(f"calculate_kv {ctx_len} tokens")
        prefill_k4 = ops.launch_counts()["flash_attention"] - before["flash_attention"]
        require(bool(torch.isfinite(logits).all()), f"{name} prefill logits are not finite")
        require(caches.length.tolist() == [ctx_len], f"{name} prefill length {caches.length.tolist()}")
        require(caches.kv_k is None and caches.mamba_ssm.shape[0] == cfg.n_layers,
                f"{name} caches: kv_k {caches.kv_k is not None}, states {tuple(caches.mamba_ssm.shape)}")
        require(bool(torch.isfinite(caches.mamba_ssm).all()), f"{name} prefill states are not finite")
        if hybrid:
            require(tuple(caches.shared_k.shape) == (n_apps, 1, cap, cfg.n_kv_heads, cfg.d_head),
                    f"hybrid shared K {tuple(caches.shared_k.shape)}")
            if on_card:
                require(prefill_k4 == n_apps, f"hybrid prefill launched K4 {prefill_k4} times, not {n_apps}")
        else:
            require(caches.shared_k is None, "ssm caches hold shared K/V")
        first = torch.argmax(logits[:, -1], dim=-1)
        before = ops.launch_counts()
        out = engine.generate_with_kv(caches, first, gen_tokens)
        laps.lap(f"generate_with_kv {gen_tokens} tokens")
        gen_k3 = ops.launch_counts()["decode_attention"] - before["decode_attention"]
        if on_card:
            require(gen_k3 == gen_tokens * n_apps, f"{name}: {gen_k3} K3 launches for {gen_tokens} tokens")
        with uncounted():
            again = engine.generate_with_kv(caches, first, gen_tokens)
        require(out.shape == (1, gen_tokens) and ((out >= 0) & (out < cfg.padded_vocab_size)).all(),
                f"{name} generated {out.shape} tokens out of range")
        require((out == again).all(), f"{name}: two greedy runs gave {out[0].tolist()} and {again[0].tolist()}")
        print(f"{name} greedy: {gen_tokens} tokens equal in two runs ({gen_k3} K3 launches, K4 {prefill_k4} in the "
              f"prefill): {out[0].tolist()}")

        # ---- prefill of T and one step against the prefill of T + 1, on an
        # f32 copy of the weights (the chunked scan against the recurrence;
        # in bf16 the two differ by the model's own rounding noise, which
        # its random-weight layers amplify: printed beside it)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = tree_map(lambda t: t.float(), params)
        with uncounted():
            _, c32 = lm.prefill(cfg32, params32, {"tokens": tokens[:, :ctx_len]}, pad_to=cap)
            step, stepped = lm.decode_step(cfg32, params32, tokens[:, ctx_len:], c32)
            longer, full = lm.prefill(cfg32, params32, {"tokens": tokens}, pad_to=cap)
            bstep, _ = lm.decode_step(cfg, params, tokens[:, ctx_len:], caches.clone())
            blonger, _ = lm.prefill(cfg, params, {"tokens": tokens}, pad_to=cap)
        del params32, c32

        x = _rel(step[:, -1], longer[:, -1]) / SSD_TOL
        xb = _rel(bstep[:, -1], blonger[:, -1]) / SSM_STEP_TOL
        states = {"ssm": _rel(stepped.mamba_ssm, full.mamba_ssm), "conv": _rel(stepped.mamba_conv, full.mamba_conv)}
        if hybrid:
            states["shared K at T"] = _rel(stepped.shared_k[:, :, ctx_len], full.shared_k[:, :, ctx_len])
        agree = int(torch.argmax(step[0, -1])) == int(torch.argmax(longer[0, -1]))
        print(f"{name} prefill then step (f32 weights): {x:.3g} of the {SSD_TOL} rule off the prefill of "
              f"{ctx_len + 1} tokens, argmax {'equal' if agree else 'different'}; states' worst layer off by "
              + ", ".join(f"{k} {v:.3g}" for k, v in states.items()) + f" of its largest |value|; in bf16 {xb:.3g} "
              f"of the {SSM_STEP_TOL} rule")
        require(x <= 1 and max(states.values()) <= SSD_TOL,
                f"{name}: prefill then a step is {x:.3g} times {SSD_TOL} of its largest |logit| off the prefill of "
                f"{ctx_len + 1} tokens (states {states})")
        del stepped, full, longer, bstep, blonger
        laps.lap("prefill then step check")

        if not hybrid:
            # ---- the chunked SSD scan against the recurrence at layer 0's shapes
            ssd_in = [t.float() for t in _ssd_layer0(cfg, params, tokens[:, :ctx_len])]
            y, h = mamba2.ssd_chunked(*ssd_in, cfg.ssm_chunk)
            y_ref, h_ref = mamba2.ssd_sequential(*ssd_in)
            xs_ = [((a - b).abs().max() / (SSD_TOL * b.abs().max())).item() for a, b in ((y, y_ref), (h, h_ref))]
            require(max(xs_) <= 1, f"ssm: the chunked SSD scan is {xs_} times {SSD_TOL} of the recurrence's largest "
                    "|value| off it")
            print(f"ssm SSD at layer 0's shapes x {tuple(ssd_in[0].shape)}, B/C {tuple(ssd_in[3].shape)} f32, chunk "
                  f"{cfg.ssm_chunk}: y {xs_[0]:.3g}, final state {xs_[1]:.3g} of the {SSD_TOL} rule off the "
                  "sequential recurrence")
            del ssd_in, y, h, y_ref, h_ref
            laps.lap("SSD oracle")

        # ---- one whole-model step: with the kernels against itself (and
        # against their plain versions, the hybrid), and its times
        tok = first[:, None]

        def one_step():
            return lm.decode_step(cfg, params, tok, caches.clone())[0]

        with uncounted():
            a, b = one_step(), one_step()
            require(torch.equal(a, b), f"the same {name} decode step run twice gave other logits")
            line = f"{name} step: logits bit-identical run twice"
            if hybrid:
                with plain_attention():
                    p = one_step()
                x = ((a.float() - p.float()).abs().max() / (SSM_STEP_TOL * p.float().abs().max())).item()
                require(x <= 1, f"the hybrid step with the kernels is {x:.3g} times {SSM_STEP_TOL} of its largest "
                        "|logit| off its plain version")
                agree = int(torch.argmax(a[0, -1])) == int(torch.argmax(p[0, -1]))
                line += f"; {x:.3g} of the {SSM_STEP_TOL} rule off the plain step, argmax " + \
                    ("equal" if agree else "different")
            samples, c = [], caches.clone()
            for _ in range(STEP_SAMPLES + 1):  # the first is a warm-up
                t0 = time.perf_counter()
                z, c = lm.decode_step(cfg, params, tok, c)
                z[:, -1].float().cpu()
                samples.append(1e3 * (time.perf_counter() - t0))
            c = caches.clone()
            dev_ms = f"{device_total_ms(lambda: lm.decode_step(cfg, params, tok, c)):.3f} ms" if on_card \
                else "not measured"
        del c
        laps.lap("step checks and times")
        print(f"{line}; wall {sum(samples[1:]) / STEP_SAMPLES:.2f} ms a step (logits read), device {dev_ms}")
        print(f"{name} steps ms:", laps.ms)
        if on_card:
            print(f"{name} steps' peak allocated GB:", laps.peak_gb)
        del params, engine, caches, logits
        if on_card:
            torch.cuda.empty_cache()
    return {"tokens": out, "prefill_k4": prefill_k4, "gen_k3": gen_k3}


def _rel(a, b):
    """max over the leading index (a row, a layer) of |a - b| over the
    largest |b| there."""
    a, b = a.float(), b.float()
    return max(((a[i] - b[i]).abs().max() / b[i].abs().max()).item() for i in range(b.shape[0]))


def drive_encdec_path(cfg, dev, gen, phase=lambda name: contextlib.nullcontext(), batch=ENCDEC_BATCH,
                      src_len=ENCDEC_SRC, prompt=ENCDEC_PROMPT, gen_tokens=GEN_TOKENS, card="cpu"):
    """Phase 13: the encdec family (``cfg``, seamless-m4t-large-v2 at full
    width on the card) through ``models.build(cfg)``, as a user calls it.

    Seeded bf16 weights; ``batch`` rows of ``src_len`` f32 source-frame
    embeddings (the stubbed speech frontend's output) and a ``prompt``-token
    decoder prompt.  ``prefill`` (``pad_to`` = prompt + gen_tokens; the
    encoder's layers run K4 bidirectionally, the decoder's K4 causally) and
    ``gen_tokens`` greedy ``decode_step`` calls (K3 once a decoder layer and
    token), counted; a second run, uncounted, must launch as many kernels
    and give the same tokens, with every K3 and K4 call in it held to its
    plain version from the same inputs (``held_calls``).  Against the plain
    attention (``plain_attention()``) on the same weights: the prefill's and
    one step's logits within ``ENCDEC_STEP_TOL`` of their largest |logit|,
    the encoder memory and the four K/V caches no farther (relative to each
    row's or layer's largest |value|) from the f32 model than
    ``ENCDEC_YARDSTICK`` times the plain path's distance; on an f32 copy of
    the weights, ``decode_step`` after ``prefill`` of the prompt against
    ``prefill`` of prompt + 1 tokens at its last position (logits and the
    step's self K/V within ``SSD_TOL`` of their largest |value|).
    ``loss_fn`` at one row (its f32 logits are 1 GB at full width), counted,
    within ``ENCDEC_LOSS_TOL`` of the plain path's, and run again uncounted:
    the same launches and loss, every K4 call held to its plain version.  Prints the encode,
    prefill and step wall ms, a step's device ms and each step's peak
    memory beside ``card``.  The port's tests run it at ``.tiny()`` on the
    CPU.
    """
    on_card = dev.type == "cuda"
    model = build(cfg)
    cap = prompt + gen_tokens
    counts = {}

    def launched(before):
        now = ops.launch_counts()
        return {k: now[k] - before[k] for k in ENCDEC_KERNELS}

    with phase("encdec"):
        laps = Laps(dev)
        gen.manual_seed(SEED + 14)
        params = model.init_params(gen, dev)
        laps.lap("init")
        leaves = tree_leaves(params)
        print(f"encdec: {cfg.name} weights {sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB "
              f"resident ({cfg.dtype}), {sum(t.numel() for t in leaves) / 1e9:.3f} B parameters; "
              f"{batch} rows of {src_len} source frames, a {prompt}-token prompt")
        src = torch.randn(batch, src_len, cfg.frontend_dim, generator=gen, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (batch, prompt + 1), generator=gen, device=dev)
        inputs = {"src_embeds": src, "tokens": tokens[:, :prompt]}

        def generate(caches, first):
            tok, out = first[:, None], []
            for _ in range(gen_tokens):
                logits, caches = model.decode_step(params, tok, caches)
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                out.append(tok)
            return torch.cat(out, dim=1)

        # ---- the path, counted: prefill, then greedy generation
        before = ops.launch_counts()
        logits, caches = model.prefill(params, inputs, pad_to=cap)
        laps.lap(f"prefill {src_len} frames + {prompt} tokens")
        counts["prefill"] = launched(before)
        require(logits.shape == (batch, 1, cfg.padded_vocab_size) and bool(torch.isfinite(logits).all()),
                f"encdec prefill logits {tuple(logits.shape)} are not finite")
        require(caches.self_k.shape == (cfg.dec_layers, batch, cap, cfg.n_kv_heads, cfg.d_head)
                and caches.cross_k.shape == (cfg.dec_layers, batch, src_len, cfg.n_kv_heads, cfg.d_head),
                f"encdec caches: self {tuple(caches.self_k.shape)}, cross {tuple(caches.cross_k.shape)}")
        require(caches.length.tolist() == [prompt] * batch and caches.src_len.tolist() == [src_len] * batch,
                f"encdec prefill lengths {caches.length.tolist()}, src_len {caches.src_len.tolist()}")
        prefilled = caches.clone()
        first = torch.argmax(logits[:, -1], dim=-1)
        before = ops.launch_counts()
        out = generate(caches, first)
        laps.lap(f"{gen_tokens} greedy steps")
        counts["generate"] = launched(before)
        require(caches.self_k[:, :, prompt:].float().abs().sum(-1).gt(0).all(),
                "encdec generation left self K slots unwritten")
        if on_card:
            want = {"prefill": {"flash_attention": cfg.enc_layers + cfg.dec_layers, "decode_attention": 0},
                    "generate": {"flash_attention": 0, "decode_attention": cfg.dec_layers * gen_tokens}}
            for stage, w in want.items():
                require(counts[stage] == w, f"encdec {stage} launched {counts[stage]}, not {w}")

        # ---- a second run, uncounted: the same launches and tokens, each
        # kernel call held to its plain version from the same inputs
        calls = []
        with uncounted():
            before = ops.launch_counts()
            with held_calls(calls) if on_card else contextlib.nullcontext():
                logits2, caches2 = model.prefill(params, inputs, pad_to=cap)
                again = generate(caches2, torch.argmax(logits2[:, -1], dim=-1))
            second = launched(before)
        del caches2
        require(torch.equal(out, again), f"encdec: two greedy runs gave {out.tolist()} and {again.tolist()}")
        total = {k: counts["prefill"][k] + counts["generate"][k] for k in ENCDEC_KERNELS}
        require(second == total, f"encdec: the second run launched {second}, the first {total}")
        worst = {}
        for name, x in calls:
            worst[name] = max(worst.get(name, 0.0), x)
        require(not calls or max(worst.values()) <= 1, f"encdec: a kernel call is off its plain version: {worst}")
        laps.lap("second run, calls held")
        print(f"encdec greedy: {gen_tokens} tokens a row equal in two runs, launches {counts} (second run {second}); "
              f"{len(calls)} kernel calls held to their plain versions, worst of each rule {worst}; "
              f"tokens {out.tolist()}")

        # ---- the plain attention and the f32 model on the same weights
        tok = tokens[:, prompt:]
        with uncounted():
            mem = encdec.encode(cfg, params, src)
            step, _ = model.decode_step(params, tok, prefilled.clone())
            with plain_attention():
                mem_p = encdec.encode(cfg, params, src)
                logits_p, caches_p = model.prefill(params, inputs, pad_to=cap)
                step_p, _ = model.decode_step(params, tok, caches_p.clone())
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            params32 = tree_map(lambda t: t.float(), params)
            m32 = build(cfg32)
            mem32 = encdec.encode(cfg32, params32, src)
            logits32, caches32 = m32.prefill(params32, inputs, pad_to=cap + 1)
            step32, stepped32 = m32.decode_step(params32, tok, caches32.clone())
            longer32, full32 = m32.prefill(params32, {"src_embeds": src, "tokens": tokens}, pad_to=cap + 1)
        del params32
        direct = {"prefill logits": _rel(logits, logits_p), "step logits": _rel(step, step_p)}
        x = max(direct.values()) / ENCDEC_STEP_TOL
        print(f"encdec kernels vs plain attention: logits {', '.join(f'{k} {v:.3g}' for k, v in direct.items())} "
              f"of their largest |logit| ({x:.3g} of the {ENCDEC_STEP_TOL} rule)")
        require(x <= 1, f"encdec: the kernel path's logits are {x:.3g} times {ENCDEC_STEP_TOL} off the plain path's")
        pairs = {"memory": (mem, mem_p, mem32)}
        for f in ("self_k", "self_v"):
            pairs[f] = (getattr(prefilled, f)[:, :, :prompt], getattr(caches_p, f)[:, :, :prompt],
                        getattr(caches32, f)[:, :, :prompt])
        for f in ("cross_k", "cross_v"):
            pairs[f] = (getattr(prefilled, f), getattr(caches_p, f), getattr(caches32, f))
        ratios = {}
        for name, (k_, p_, f_) in pairs.items():
            dk, dp, dd = _rel(k_, f_), _rel(p_, f_), _rel(k_, p_)
            ratios[name] = dk / dp if dp else (0.0 if dk == 0 else float("inf"))
            print(f"encdec {name}: kernel path {dk:.3g}, plain path {dp:.3g} of the largest |value| off the f32 "
                  f"model ({ratios[name]:.3g}x); kernel vs plain {dd:.3g}")
        require(max(ratios.values()) <= ENCDEC_YARDSTICK,
                f"encdec: the kernel path is farther from the f32 model than {ENCDEC_YARDSTICK}x the plain path: "
                f"{ratios}")
        tf = {"logits": _rel(step32[:, -1], longer32[:, -1]),
              "self K at T": _rel(stepped32.self_k[:, :, prompt], full32.self_k[:, :, prompt]),
              "self V at T": _rel(stepped32.self_v[:, :, prompt], full32.self_v[:, :, prompt])}
        agree = bool((torch.argmax(step32[:, -1], -1) == torch.argmax(longer32[:, -1], -1)).all())
        print(f"encdec prefill then step (f32 weights): off the prefill of {prompt + 1} tokens by "
              + ", ".join(f"{k} {v:.3g}" for k, v in tf.items()) + f" of the largest |value| (rule {SSD_TOL}), "
              f"argmax {'equal' if agree else 'different'}")
        require(max(tf.values()) <= SSD_TOL, f"encdec: prefill then a step is {tf} off the longer prefill in f32")
        del mem, mem_p, mem32, caches_p, caches32, stepped32, full32, prefilled, logits2
        laps.lap("plain and f32 checks")

        # ---- loss_fn at one row, counted, against the plain path
        labels = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen, device=dev)
        lbatch = {"src_embeds": src[:1], "tokens": tokens[:1, :prompt], "labels": labels}
        before = ops.launch_counts()
        loss, metrics = model.loss_fn(params, lbatch)
        counts["loss_fn"] = launched(before)
        laps.lap(f"loss_fn 1 x {prompt}")
        with plain_attention():
            loss_p, _ = model.loss_fn(params, lbatch)
        xl = abs(loss.item() - loss_p.item()) / (ENCDEC_LOSS_TOL * abs(loss_p.item()))
        require(bool(torch.isfinite(loss)) and loss.shape == () and float(metrics["aux"]) == 0.0,
                f"encdec loss {loss} (aux {metrics['aux']})")
        require(xl <= 1, f"encdec: loss {loss.item()} is {xl:.3g} times {ENCDEC_LOSS_TOL} off the plain path's "
                f"{loss_p.item()}")
        if on_card:
            w = {"flash_attention": cfg.enc_layers + cfg.dec_layers, "decode_attention": 0}
            require(counts["loss_fn"] == w, f"encdec loss_fn launched {counts['loss_fn']}, not {w}")
        # a second run, uncounted: the same launches and loss, each K4 call
        # (bidirectional and causal, at B = 1) held to its plain version
        calls = []
        with uncounted():
            before = ops.launch_counts()
            with held_calls(calls) if on_card else contextlib.nullcontext():
                loss2, _ = model.loss_fn(params, lbatch)
            second = launched(before)
        require(second == counts["loss_fn"], f"encdec loss_fn: the second run launched {second}, "
                f"the first {counts['loss_fn']}")
        require(torch.equal(loss2, loss), f"encdec loss_fn: two runs gave {loss.item()} and {loss2.item()}")
        worst = {}
        for name, x in calls:
            worst[name] = max(worst.get(name, 0.0), x)
        require(not calls or max(worst.values()) <= 1, f"encdec loss_fn: a kernel call is off its plain version: "
                f"{worst}")
        print(f"encdec loss_fn: {loss.item():.6g} (plain attention {loss_p.item():.6g}, {xl:.3g} of the "
              f"{ENCDEC_LOSS_TOL} rule), launches {counts['loss_fn']}; second run {second}, {len(calls)} kernel "
              f"calls held to their plain versions, worst of each rule {worst}")
        laps.lap("loss_fn plain check")

        # ---- wall times (warm) and a step's device time
        samples = {}
        with uncounted():
            for name, fn in (("encode", lambda: encdec.encode(cfg, params, src)),
                             ("prefill", lambda: model.prefill(params, inputs, pad_to=cap)[0])):
                for i in range(3):  # the first is a warm-up
                    t0 = time.perf_counter()
                    fn()[:, -1].float().cpu()
                    if i:
                        samples.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
            # steps at the first generated token's position: ``caches`` still
            # has length = prompt (``generate`` rebinds its own), so each step
            # reads prompt + 1 keys and rewrites slot ``prompt`` with what the
            # first greedy step wrote there
            step_ms, c = [], caches
            for i in range(STEP_SAMPLES + 1):  # the first is a warm-up
                t0 = time.perf_counter()
                z, _ = model.decode_step(params, first[:, None], c)
                z[:, -1].float().cpu()
                if i:
                    step_ms.append(1e3 * (time.perf_counter() - t0))
            events = device_by_event(lambda: model.decode_step(params, first[:, None], c)) if on_card else {}
            dev_ms = f"{sum(events.values()):.3f} ms" if on_card else "not measured"
        laps.lap("times")
        wall = {k: sum(v) / len(v) for k, v in samples.items()}
        print(f"encdec on {card}: encode {wall['encode']:.2f} ms, prefill {wall['prefill']:.2f} ms (counted run "
              f"{laps.ms[f'prefill {src_len} frames + {prompt} tokens']} ms) of wall; a step "
              f"{sum(step_ms) / STEP_SAMPLES:.2f} ms of wall (logits read), {dev_ms} of device")
        if on_card:
            top = ", ".join(f"{timing.kernel_name(k)[:60]} {v:.3f}" for k, v in list(events.items())[:6])
            print(f"encdec step's device ms by event on {card}, largest first: {top}")
        print(f"encdec steps ms on {card}:", laps.ms)
        if on_card:
            print(f"encdec steps' peak allocated GB on {card}:", laps.peak_gb)
        del params, caches, c, logits
        if on_card:
            torch.cuda.empty_cache()
    return {"tokens": out, "counts": counts}


class TimedCheckpoints(CheckpointManager):
    """Phase 14's checkpoint manager: records each save's and restore's wall
    ms and keeps each saved state (the tree itself: the trainer's updates
    are out of place, so it stays as it was saved)."""

    def __init__(self, directory, keep):
        super().__init__(directory, keep=keep)
        self.save_ms, self.restore_ms, self.saved = [], [], {}

    def save(self, step, tree):
        t0 = time.perf_counter()
        out = super().save(step, tree)
        self.save_ms.append(round(1e3 * (time.perf_counter() - t0), 1))
        self.saved[step] = tree
        return out

    def restore(self, step, target_like):
        t0 = time.perf_counter()
        out = super().restore(step, target_like)
        if out.step.is_cuda:
            torch.cuda.synchronize()
        self.restore_ms.append(round(1e3 * (time.perf_counter() - t0), 1))
        return out


@contextlib.contextmanager
def deterministic(refused):
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for the
    block: an op without a deterministic implementation warns; the
    warnings' texts are appended to ``refused``."""
    was, warn_was = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_was)
    refused.extend(sorted({str(w.message).split("\n")[0] for w in caught if "determinis" in str(w.message)}))


@contextlib.contextmanager
def ranged_vjp(name="flash_attention_vjp"):
    """Each backward of K4 under autograd (the plain version's VJP) inside a
    profiler range ``name``, so a trace can attribute its device time."""
    vjp = ops.flash_attention_vjp

    def ranged(*args, **kw):
        with torch.profiler.record_function(name):
            return vjp(*args, **kw)

    ops.flash_attention_vjp = ranged
    try:
        yield
    finally:
        ops.flash_attention_vjp = vjp


def step_device_ms(fn, vjp_range="flash_attention_vjp"):
    """One call of ``fn`` (a train step) under the profiler, after a warm-up:
    (device ms by event, largest first; the device ms of the kernels
    launched inside ``vjp_range``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with ranged_vjp(vjp_range), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.device_time_total and e.key != vjp_range:
            events[e.key] = events.get(e.key, 0.0) + e.device_time_total / 1e3
    vjp_ms = sum(e.device_time_total for e in prof.events()
                 if e.name == vjp_range and e.device_type == DeviceType.CPU) / 1e3
    return dict(sorted(events.items(), key=lambda kv: -kv[1])), vjp_ms


def _bf16_steps(a, b):
    """The largest distance of two bf16 tensors in representable steps."""
    i, j = (t.contiguous().view(torch.int16).int() for t in (a, b))
    i, j = (torch.where(x < 0, -(x & 0x7FFF), x) for x in (i, j))
    return int((i - j).abs().max())


def held_adamw(got, want):
    """``apply_updates``' (params, state, metrics) on the card against the
    CPU's on copies of the same inputs, under ``tests/test_torch_training.py``'s
    rule for the reference: ``grad_norm``, ``lr`` and the f32 moments and
    parameters within 1e-6 relative (of each leaf's largest |value|; the
    global norm's sums run in another order), bf16 parameters within one
    bf16 step (an f32 update one ulp apart rounds to either neighbour)."""
    (p1, o1, m1), (p2, o2, m2) = got, want
    rel = {k: abs(float(m1[k]) - float(m2[k])) / abs(float(m2[k])) for k in ("grad_norm", "lr")}
    for name, a, b in (("mu", o1.mu, o2.mu), ("nu", o1.nu, o2.nu), ("params", p1, p2)):
        for (path, x), y in zip(tree_flatten_with_path(a), tree_leaves(b)):
            x = x.cpu()
            if x.dtype == torch.bfloat16:
                rel[f"{name} (bf16 steps)"] = max(rel.get(f"{name} (bf16 steps)", 0), _bf16_steps(x, y))
            else:
                r = ((x.float() - y.float()).abs().max() / y.float().abs().max().clamp_min(1e-30)).item()
                rel[name] = max(rel.get(name, 0.0), r)
    print(f"train AdamW step on the card against the CPU's on the same inputs: {rel}")
    for k, v in rel.items():
        require(v <= (1 if "steps" in k else 1e-6), f"train AdamW on the card: {k} off the CPU's by {v}")
    require(int(o1.step) == int(o2.step), "train AdamW on the card: the step count")


def _same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _train_batch(lm_data, step, batch, seq):
    """The per-step seeded batch (``tests/test_system.py``'s seeding)."""
    rng = np.random.default_rng(500 + step)
    toks = np.stack([lm_data.sample(rng, seq + 1) for _ in range(batch)])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def drive_train_path(cfg, dev, phase=lambda name: contextlib.nullcontext(), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY, opt=TRAIN_OPT, card="cpu"):
    """Phase 14 A: ``cfg`` (smollm-360m at full width on the card) trained
    through ``repro_torch.training.Trainer`` as a user runs it.

    ``Trainer.init_or_restore(SEED + 15)`` draws the weights; ``steps``
    steps of ``batch`` x ``seq`` tokens (``MarkovLM(vocab, seed=2,
    stickiness=0.6)``, seeded per step; AdamW with ``opt``) with checkpoints every
    ``ckpt_every`` steps, under deterministic algorithms, counted: K4 must
    launch ``n_layers`` times a step (twice that with remat: the forward
    and its recompute) and nothing else, and the mean loss of the last 3
    steps must lie below step 1's.  A new ``Trainer`` over a copy of the
    first checkpoint resumes (the restored state must equal the saved one
    bit for bit) and runs to ``steps``: its losses and final state must
    equal the first run's bit for bit (if an op refuses deterministic mode
    it is printed and the resumed losses are held within 1e-3 instead).
    Then, uncounted: one step with every K4 call held to its plain version
    (``held_calls``); the loss and gradients against the plain attention
    and an f32 copy of the weights (``TRAIN_LOSS_TOL``,
    ``TRAIN_YARDSTICK``); one ``apply_updates`` on the card against the
    CPU's (``held_adamw``); a step's wall and device ms, tokens per wall
    second, K4's and the plain VJP's device ms within the step, the peak
    memory, and the checkpoints' save and restore ms, beside ``card``.  The
    port's tests run it at ``.tiny()`` on the CPU.
    """
    on_card = dev.type == "cuda"
    model = build(cfg)
    opt_cfg = AdamWConfig(**opt)
    lm_data = MarkovLM(vocab_size=cfg.vocab_size, seed=2, stickiness=0.6)
    marks = []  # the launch counts at each step's start

    def batch_fn(step):
        marks.append(ops.launch_counts())
        return _train_batch(lm_data, step, batch, seq)

    def per_step(end):
        ticks = marks + [end]
        return [{k: b[k] - a[k] for k in a} for a, b in zip(ticks, ticks[1:])]

    want_step = {k: (k4_calls_a_step(cfg) if k == "flash_attention" else 0) for k in ops.KERNELS}
    log, refused = [], []
    with phase("train"), tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        laps = Laps(dev)
        ck = TimedCheckpoints(os.path.join(tmp, "run"), TRAIN_KEEP)
        tr = Trainer(model=model, opt_cfg=opt_cfg, batch_fn=batch_fn, ckpt=ck, ckpt_every=ckpt_every, log_every=1,
                     log_fn=log.append, device=dev)
        with deterministic(refused):
            state = tr.init_or_restore(SEED + 15)
            laps.lap("init")
            params = tree_leaves(state.params)
            print(f"train: {cfg.name} (remat {cfg.remat_policy if cfg.remat else 'off'}), "
                  f"{sum(t.numel() for t in params) / 1e6:.1f} M parameters, "
                  f"{sum(t.numel() * t.element_size() for t in params) / 1e9:.2f} GB of {cfg.dtype} weights and "
                  f"{sum(t.numel() * t.element_size() for t in tree_leaves(state.opt)) / 1e9:.2f} GB of f32 moments; "
                  f"{steps} steps of {batch} x {seq} tokens, a checkpoint every {ckpt_every}")
            del params
            state, hist = tr.run(state, steps)
            ticks = per_step(ops.launch_counts())
            laps.lap(f"{steps} steps")
        losses = hist["loss"]
        require(hist["step"] == list(range(1, steps + 1)) and all(np.isfinite(losses)),
                f"train: steps {hist['step']}, losses {losses}")
        require(int(state.step) == steps and ck.all_steps() == list(range(steps, 0, -ckpt_every))[:TRAIN_KEEP][::-1],
                f"train: step {int(state.step)}, checkpoints {ck.all_steps()}")
        last3 = float(np.mean(losses[-3:]))
        print(f"train losses: {[round(x, 4) for x in losses]}; the last 3 average {last3:.4f} against step 1's "
              f"{losses[0]:.4f}; launches a step {[t['flash_attention'] for t in ticks]}")
        require(last3 < losses[0], f"train: the loss did not fall: {losses}")
        if on_card:
            require(all(t == want_step for t in ticks), f"train: a step launched {ticks}, not {want_step} each")

        # ---- resume from the first checkpoint in a directory of its own
        first = f"step_{ckpt_every:010d}"
        shutil.copytree(os.path.join(ck.dir, first), os.path.join(tmp, "resume", first), copy_function=os.link)
        ck2 = TimedCheckpoints(os.path.join(tmp, "resume"), TRAIN_KEEP)
        tr2 = Trainer(model=model, opt_cfg=opt_cfg, batch_fn=batch_fn, ckpt=ck2, ckpt_every=ckpt_every,
                      log_every=1, log_fn=log.append, device=dev)
        marks.clear()
        log.clear()
        with deterministic(refused):
            restored = tr2.init_or_restore(SEED + 15)
            require(log == [f"[trainer] resumed from step {ckpt_every}"], f"train resume: {log}")
            require(_same_tree(restored, ck.saved[ckpt_every]),
                    f"train resume: the state restored from step {ckpt_every} differs from the one saved")
            resumed, hist2 = tr2.run(restored, steps)
            ticks2 = per_step(ops.launch_counts())
        del restored
        laps.lap(f"resume at {ckpt_every}, {steps - ckpt_every} steps")
        if on_card:
            require(all(t == want_step for t in ticks2), f"train resume: a step launched {ticks2}")
        if refused:
            x = max(abs(a - b) / abs(b) for a, b in zip(hist2["loss"], losses[ckpt_every:]))
            print(f"train resume: ops without a deterministic implementation: {refused}; the resumed losses within "
                  f"{x:.3g} relative of the first run's (rule 1e-3)")
            require(x <= 1e-3, f"train resume: losses {hist2['loss']} against {losses[ckpt_every:]}")
        else:
            require(hist2["loss"] == losses[ckpt_every:] and _same_tree(resumed, state),
                    f"train resume: losses {hist2['loss']} against {losses[ckpt_every:]}, or the final states differ")
            print(f"train resume: the state restored from step {ckpt_every} equals the saved one bit for bit; steps "
                  f"{ckpt_every + 1}-{steps} give the first run's losses and final state bit for bit (deterministic "
                  f"algorithms, no op refused)")
        del resumed

        # ---- the kernel path against its plain versions, uncounted
        step_fn = make_train_step(model, opt_cfg)
        tb = {k: torch.as_tensor(v, device=dev) for k, v in _train_batch(lm_data, steps, batch, seq).items()}
        calls = []
        with uncounted():
            before = ops.launch_counts()
            with held_calls(calls) if on_card else contextlib.nullcontext():
                _, held_m = step_fn(state, tb)
            held_n = ops.launch_counts()["flash_attention"] - before["flash_attention"]
            worst = max((x for _, x in calls), default=0.0)
            require(not calls or (len(calls) == want_step["flash_attention"] and worst <= 1),
                    f"train: {len(calls)} held K4 calls, worst {worst:.3g} of the rule")
            print(f"train held step: {len(calls)} K4 calls ({held_n} launches) held to the plain version, worst "
                  f"{worst:.3g} of the rule; loss {float(held_m['loss']):.6g}")
            laps.lap("held step")
            loss_k, _, g_k = loss_and_grads(model, state.params, tb)
            with plain_attention():
                loss_p, _, g_p = loss_and_grads(model, state.params, tb)
                params32 = tree_map(lambda t: t.float(), state.params)
                loss_32, _, g_32 = loss_and_grads(build(dataclasses.replace(cfg, dtype="float32")), params32, tb)
            del params32
        xl = abs(loss_k.item() - loss_p.item()) / (TRAIN_LOSS_TOL * abs(loss_p.item()))
        ratios = {}
        for (path, gk), gp, g32 in zip(tree_flatten_with_path(g_k), tree_leaves(g_p), tree_leaves(g_32)):
            scale = g32.abs().max()
            dk, dp = ((gk.float() - g32).abs().max() / scale).item(), ((gp.float() - g32).abs().max() / scale).item()
            ratios["/".join(path)] = dk / dp if dp else (0.0 if dk == 0 else float("inf"))
        top = max(ratios, key=ratios.get)
        print(f"train kernel path vs plain attention: loss {loss_k.item():.6g} against {loss_p.item():.6g} ({xl:.3g} "
              f"of the {TRAIN_LOSS_TOL} rule; f32 {loss_32.item():.6g}); gradients off the f32 model's at most "
              f"{ratios[top]:.3g}x the plain path's ({top}), median {float(np.median(list(ratios.values()))):.3g}x")
        require(xl <= 1, f"train: the kernel path's loss is {xl:.3g} times {TRAIN_LOSS_TOL} off the plain path's")
        require(ratios[top] <= TRAIN_YARDSTICK,
                f"train: a gradient is farther from the f32 model than {TRAIN_YARDSTICK}x the plain path: {top} "
                f"{ratios[top]:.3g}")
        del g_p, g_32
        laps.lap("plain and f32 checks")

        # ---- one AdamW step on the card against the same step on the CPU
        cpu = functools.partial(tree_map, lambda t: t.cpu())
        got = apply_updates(state.params, g_k, state.opt, opt_cfg)
        want = apply_updates(cpu(state.params), cpu(g_k), cpu(state.opt), opt_cfg)
        del g_k
        held_adamw(got, want)
        del got, want
        laps.lap("AdamW against the CPU")

        # ---- times (uncounted): a step's wall and device ms, memory, checkpoints
        with uncounted():
            step_ms = []
            for i in range(4):  # the first is a warm-up
                if on_card:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                _, m = step_fn(state, tb)
                float(m["loss"])
                if on_card:
                    torch.cuda.synchronize()
                if i:
                    step_ms.append(1e3 * (time.perf_counter() - t0))
            peak = f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB" if on_card else "not measured"
            events, vjp_ms = step_device_ms(lambda: step_fn(state, tb)) if on_card else ({}, None)
        laps.lap("times")
        wall = sum(step_ms) / len(step_ms)
        if on_card:
            k4 = sum(v for k, v in events.items() if timing.kernel_name(k) == "flash_tc_kernel")
            require(k4 > 0 and vjp_ms > 0, f"train: the step's trace holds K4 {k4} ms, the plain VJP {vjp_ms} ms")
            dev_ms = f"{sum(events.values()):.3f} ms of device (K4 forward {k4:.3f} ms in {want_step['flash_attention']} " \
                     f"launches, the plain VJP backward {vjp_ms:.3f} ms)"
        else:
            dev_ms = "device time not measured"
        print(f"train on {card}: a step {wall:.2f} ms of wall ({[round(x, 2) for x in step_ms]}), {dev_ms}; "
              f"{batch * seq / (wall / 1e3):.0f} tokens per wall s; peak allocated {peak}; checkpoint save ms "
              f"{ck.save_ms + ck2.save_ms}, restore ms {ck2.restore_ms}")
        if on_card:
            top6 = ", ".join(f"{timing.kernel_name(k)[:60]} {v:.3f}" for k, v in list(events.items())[:6])
            print(f"train step's device ms by event on {card}, largest first: {top6}")
        print(f"train steps ms on {card}:", laps.ms)
        if on_card:
            print(f"train steps' peak allocated GB on {card}:", laps.peak_gb)
        del state, ck, ck2
        if on_card:
            torch.cuda.empty_cache()
    return {"history": hist}


def _tiny_train_batch(cfg, rng, batch=TRAIN_TINY_BATCH, seq=TRAIN_TINY_SEQ):
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    if cfg.family == "encdec":
        out["src_embeds"] = rng.normal(size=(batch, seq, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(size=(batch, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def k4_calls_a_step(cfg):
    """K4 launches of one train step of ``cfg``: one an attention layer's
    forward, twice that with remat (its recompute)."""
    n = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.shared_block_every, 1),
         "encdec": cfg.enc_layers + cfg.dec_layers}.get(cfg.family, cfg.n_layers)
    return n * (2 if cfg.remat else 1)


def drive_train_sweep(dev, phase=lambda name: contextlib.nullcontext(), archs=None):
    """Phase 14 B: one ``make_train_step`` of every registry arch's
    ``.tiny()`` in bf16 (remat off, as ``.tiny()`` sets it), counted, twice
    from the same state: finite, a nonzero gradient norm, the same launches
    both times (K4 once an attention layer, none for mamba2-370m), the loss
    within ``TRAIN_TINY_LOSS_TOL`` of the plain attention's."""
    on_card = dev.type == "cuda"
    out = {}
    with phase("train sweep"):
        for arch in archs or registry.names():
            cfg = registry.get(arch).tiny()
            model = build(cfg)
            state = init_train_state(model, torch.Generator(dev).manual_seed(SEED + 16), dev)
            tb = {k: torch.as_tensor(v, device=dev)
                  for k, v in _tiny_train_batch(cfg, np.random.default_rng(SEED + 16)).items()}
            step_fn = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1))
            runs = []
            for _ in range(2):
                before = ops.launch_counts()
                new, m = step_fn(state, tb)
                runs.append(({k: v - before[k] for k, v in ops.launch_counts().items()}, float(m["loss"]),
                             float(m["grad_norm"])))
            with uncounted(), plain_attention():
                loss_p = float(step_fn(state, tb)[1]["loss"])
            (n1, loss, gnorm), (n2, _, _) = runs
            finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(new.params))
            x = abs(loss - loss_p) / (TRAIN_TINY_LOSS_TOL * abs(loss_p))
            print(f"train sweep {cfg.name}: loss {loss:.5g} (plain attention {loss_p:.5g}, {x:.3g} of the "
                  f"{TRAIN_TINY_LOSS_TOL} rule), grad norm {gnorm:.4g}, K4 launches {n1['flash_attention']} and "
                  f"{n2['flash_attention']}")
            require(np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0 and finite,
                    f"train sweep {arch}: loss {loss}, grad norm {gnorm}, finite weights {finite}")
            require(x <= 1, f"train sweep {arch}: the loss is {x:.3g} times {TRAIN_TINY_LOSS_TOL} off the plain path's")
            require(n1 == n2, f"train sweep {arch}: two runs launched {n1} and {n2}")
            if on_card:
                want = {k: (k4_calls_a_step(cfg) if k == "flash_attention" else 0) for k in ops.KERNELS}
                require(n1 == want, f"train sweep {arch}: a step launched {n1}, not {want}")
            out[arch] = runs[0]
    return out


def drive_train_launcher(dev, phase=lambda name: contextlib.nullcontext(), steps=TRAIN_LAUNCH_STEPS):
    """Phase 14 C: ``python -m repro_torch.launch.train --arch smollm-360m
    --steps <steps> --grad-compression --ckpt-dir <tmp>`` as a subprocess on
    ``dev`` (``.tiny()``, as the launcher always trains), run through
    ``runpy`` by ``TRAIN_LAUNCH_COUNTED`` so that the subprocess prints its
    kernel launches at exit: exit 0 with its ``[launch.train]`` line's loss
    falling; the same command again must resume from step ``steps`` and
    exit 0.  Returns the two runs' output lines and their launches, summed
    (on the card, K4 once an attention layer a step and nothing else)."""
    cfg = registry.get(TRAIN_ARCH).tiny()
    with phase("train launcher"), tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        cmd = [sys.executable, "-c", TRAIN_LAUNCH_COUNTED, "--arch", TRAIN_ARCH, "--steps", str(steps),
               "--grad-compression", "--ckpt-dir", tmp] + ([] if dev.type == "cuda" else ["--device", str(dev)])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT / "src"),
                                                                         os.environ.get("PYTHONPATH")])))
        outs, launches = [], dict.fromkeys(ops.KERNELS, 0)
        for _ in range(2):
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
            lines = r.stdout.strip().splitlines()
            print(f"train launcher ({1e3 * (time.perf_counter() - t0):.0f} ms, exit {r.returncode}): "
                  + " | ".join(lines[-4:]))
            require(r.returncode == 0, f"train launcher exited {r.returncode}: {r.stderr[-2000:]}")
            counted = [json.loads(x[len("[launch counts] "):]) for x in lines if x.startswith("[launch counts] ")]
            require(len(counted) == 1, f"train launcher: no launch counts in {lines[-4:]}")
            launches = {k: launches[k] + counted[0][k] for k in launches}
            outs.append([x for x in lines if not x.startswith("[launch counts] ")])
        m = re.fullmatch(r"\[launch\.train\] \S+: loss (\S+) -> (\S+)", outs[0][-1])
        require(m is not None and float(m.group(2)) < float(m.group(1)), f"train launcher: {outs[0][-1]!r}")
        require(f"[trainer] resumed from step {steps}" in outs[1], f"train launcher, second run: {outs[1]}")
        if dev.type == "cuda":
            want = {k: (steps * k4_calls_a_step(cfg) if k == "flash_attention" else 0) for k in ops.KERNELS}
            require(launches == want, f"train launcher: the two runs launched {launches}, not {want}")
    return {"lines": outs, "launches": launches}


def _dist_mesh(dev, shape):
    """A ``("data", "model")`` mesh of ``shape`` whose every rank runs on ``dev``."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    devices = np.empty(int(np.prod(shape)), dtype=object)
    for i in range(devices.size):
        devices[i] = dev
    return Mesh(devices.reshape(shape), ("data", "model"))


def _dist_args(tmp, name):
    return torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)


def _dist_rank_start(args):
    """A rank's first step: the card's ranks load the library the parent
    built (no rank runs nvcc), and every rank's launch counts start at 0.
    Returns the rank's device."""
    lib = args["lib"]
    if lib is None:
        dev = torch.device("cpu")
    else:
        require(os.path.exists(lib), f"distributed: the parent did not build {lib}")
        require(_build.load_library()._name == lib, "distributed: a rank loaded another kernel library")
        dev = torch.device("cuda", torch.cuda.current_device())
    ops.reset_launch_counts()
    mesh_lib.STAGED.update(calls=0, bytes=0)
    return dev


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _collective_ms(fn, dev):
    """(``fn()``, host ms inside collective calls): the profiler's self CPU
    time of the c10d, gloo and NCCL events of one call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
        _sync(dev)
    ms = sum(e.self_cpu_time_total for e in prof.key_averages()
             if any(t in e.key.lower() for t in COLLECTIVE_EVENTS)) / 1e3
    return out, ms


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def dist_sp_rank(rank, dm, tmp, name="sp"):
    """16 A and B on each rank: ``DIST_SP_RULES``; the prefill (K4 on each
    rank through ``local_map``) writes each rank's S block of the caches,
    then greedy steps through the sequence-parallel decode, each token and
    the logits held to the parent's single-process runs; the wall ms of
    each step and the host ms inside collectives of one.  Each step is fed
    the single-process path's token, so every step compares one input.
    ``name`` picks the arguments: ``"sp"`` (bf16) or ``"sp32"`` (the same
    decode on f32 weights)."""
    a = _dist_args(tmp, name)
    dev = _dist_rank_start(a)
    cfg = a["cfg"]
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(a["seed"]), dev)
    tokens = torch.as_tensor(a["tokens"], device=dev)
    out = {"backend": torch.distributed.get_backend(), "step_ms": [], "tokens": [], "rel": []}
    with sharding.use_rules(dm, DIST_SP_RULES):
        dp = sharding.distribute_tree(params, lm.param_specs(cfg))
        del params
        _sync(dev)
        t0 = time.perf_counter()
        _, caches = lm.prefill(cfg, dp, {"tokens": tokens}, pad_to=a["cap"])
        _sync(dev)
        out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        out["placements"] = str(caches.kv_k.placements)
        caches = caches._replace(length=torch.tensor(a["lengths"], dtype=torch.int32, device=dev))
        tok = torch.as_tensor(a["tok0"], device=dev)
        for s in range(len(a["want_tokens"])):
            t0 = time.perf_counter()
            if s == 1:
                (logits, caches), out["collective_ms"] = _collective_ms(
                    lambda: lm.decode_step(cfg, dp, tok, caches), dev)
            else:
                logits, caches = lm.decode_step(cfg, dp, tok, caches)
            logits = _full(logits)[:, -1].float()
            out["tokens"].append(logits.argmax(-1).tolist())
            _sync(dev)
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
            want = torch.as_tensor(a["plain_logits"][s], device=dev)
            out["rel"].append(float((logits - want).abs().max() / want.abs().max()))
            tok = torch.as_tensor(a["want_tokens"][s], device=dev)[:, None]  # the single process's token next
    out["launches"], out["staged"] = ops.launch_counts(), dict(mesh_lib.STAGED)
    return out


def dist_psum_rank(rank, dm, tmp):
    """16 A and D on each rank: a smollm-360m gradient tree at full width
    (this rank's own batch), cast to f32, mean-reduced leaf by leaf over
    ``"model"`` by ``compressed_psum`` and held within one bin of the
    exact mean (an f32 ``all_reduce``); the int8 bytes gathered."""
    a = _dist_args(tmp, "psum")
    dev = _dist_rank_start(a)
    cfg = a["cfg"]
    model = build(cfg)
    params = model.init_params(torch.Generator(dev).manual_seed(a["seed"]), dev)
    rng = np.random.default_rng(a["seed"] + 1 + rank)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, a["tokens"]), device=dev)
             for k in ("tokens", "labels")}
    _, _, grads = loss_and_grads(model, params, batch)
    del params
    group = dm.get_group("model")
    n = torch.distributed.get_world_size(group)
    worst, gathered = 0.0, 0
    t0 = time.perf_counter()
    with sharding.use_rules(dm):
        for g in tree_leaves(grads):
            x = g.float()
            y = compressed_psum(x, "model")
            exact = x.clone()
            torch.distributed.all_reduce(exact, group=group)
            exact /= n
            absmax = x.abs().max()
            torch.distributed.all_reduce(absmax, op=torch.distributed.ReduceOp.MAX, group=group)
            bin_ = float(absmax) / 127.0
            worst = max(worst, float((y - exact).abs().max()) / (bin_ * 1.01 + 1e-7))
            gathered += n * x.numel()
    _sync(dev)
    return {"backend": torch.distributed.get_backend(), "worst": worst, "int8_bytes": gathered,
            "leaves": len(tree_leaves(grads)), "psum_ms": 1e3 * (time.perf_counter() - t0),
            "launches": ops.launch_counts(), "staged": dict(mesh_lib.STAGED)}


def dist_moe_rank(rank, dm, tmp):
    """16 C on each rank: the model's layers single-process (uncounted) to
    each MoE layer's input, then that layer's ``moe_apply`` with its weights
    and input on the mesh (the sharded combine); each layer's output within
    ``DIST_MOE_TOL`` of its largest |value| of the single-process one, and
    the same dropped slots."""
    a = _dist_args(tmp, "moe")
    dev = _dist_rank_start(a)
    cfg = a["cfg"]
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(a["seed"]), dev)
    tokens = torch.as_tensor(a["tokens"], device=dev)
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    specs = specs_from_plan(moe.moe_plan(cfg))
    out = {"backend": torch.distributed.get_backend(), "rel": [], "drops": [], "drops_one": [], "layer_ms": []}
    with uncounted():
        x = lm._embed_tokens(cfg, params, tokens)
    for p in lm._unstack(params["layers"], cfg.n_layers):
        with uncounted():
            h = apply_norm(cfg.norm, p["ln1"], x)
            x = x + attn_prefill(cfg, p["attn"], h, positions)[0]
            h2 = apply_norm(cfg.norm, p["ln2"], x)
            want, _ = moe.moe_apply(cfg, p["moe"], h2)
            out["drops_one"].append(int(moe.dropped_slots(cfg, p["moe"], h2)))
        with sharding.use_rules(dm, {"embed": None}):
            dp = sharding.distribute_tree(p["moe"], specs)
            hd = sharding.distribute(h2, ("batch", "seq", "act_embed"))
            _sync(dev)
            t0 = time.perf_counter()
            got = _full(moe.moe_apply(cfg, dp, hd)[0])
            _sync(dev)
            out["layer_ms"].append(1e3 * (time.perf_counter() - t0))
            out["drops"].append(int(moe.dropped_slots(cfg, dp, hd)))
        out["rel"].append(float((got.float() - want.float()).abs().max() / want.float().abs().max()))
        x = x + want
    out["launches"], out["staged"] = ops.launch_counts(), dict(mesh_lib.STAGED)
    return out


def step_agreement(p0, p1, mu1, want_p1, want_mu1):
    """How far one AdamW step from parameters ``p0`` (to ``p1``, first
    moments ``mu1``) lies from the single process's step (``want_p1``,
    ``want_mu1``), leaf lists in one order: the largest first-moment
    difference over its leaf's largest |value| (and that leaf's index),
    the share of parameter elements whose update is apart from the single
    process's (off by more than half of it; any change of an element that
    one did not move), and the shares each step moved."""
    mu_rel, worst, apart, moved, want_moved, n = 0.0, None, 0, 0, 0, 0
    for i, (a, b, m, wb, wm) in enumerate(zip(p0, p1, mu1, want_p1, want_mu1)):
        a, wb, wm = a.to(b.device), wb.to(b.device), wm.to(m.device).float()
        rel = float((m.float() - wm).abs().max() / wm.abs().max().clamp_min(1e-30))
        if worst is None or rel > mu_rel:
            mu_rel, worst = rel, i
        d, wd = b.float() - a.float(), wb.float() - a.float()
        apart += int(((d - wd).abs() > 0.5 * wd.abs()).sum())
        moved += int((b != a).sum())
        want_moved += int((wb != a).sum())
        n += a.numel()
    return {"mu_rel": mu_rel, "mu_worst_leaf": worst, "apart": apart / n, "moved": moved / n,
            "want_moved": want_moved / n}


def step_held(agreement, f32=False) -> bool:
    """16 E's rule on :func:`step_agreement`: the moments within
    ``DIST_MU_TOL``, at most ``DIST_UPDATE_SHARE`` of the parameters apart
    (``DIST_F32_*`` on f32 weights), and some moved."""
    mu_tol, share = (DIST_F32_MU_TOL, DIST_F32_UPDATE_SHARE) if f32 else (DIST_MU_TOL, DIST_UPDATE_SHARE)
    return agreement["mu_rel"] <= mu_tol and agreement["apart"] <= share and agreement["moved"] > 0


def dist_train_rank(rank, dm, tmp, name="train"):
    """16 E on each rank: ``DIST_TRAIN_RULES``; the parent's initial state
    (the same seed) on the mesh (``distribute_state``), the same batches:
    each step's loss within ``DIST_LOSS_TOL`` of the single-process
    step's; rank 0's parameters after step 1 within ``DIST_PARAM_TOL`` of
    the single-process ones and its step 1 measured by
    :func:`step_agreement`; the second step with every K4 call held to its
    plain version (``held_calls``).  ``name`` picks the arguments:
    ``"train"`` (bf16) or ``"train32"`` (one step on f32 weights)."""
    a = _dist_args(tmp, name)
    dev = _dist_rank_start(a)
    cfg = a["cfg"]
    model = build(cfg)
    step_fn = make_train_step(model, AdamWConfig(**a["opt"]))
    state = init_train_state(model, torch.Generator(dev).manual_seed(a["seed"]), dev)
    p0 = tree_leaves(state.params) if rank == 0 else None  # the step is out of place
    out = {"backend": torch.distributed.get_backend(), "losses": [], "step_ms": [], "excess": []}
    with sharding.use_rules(dm, DIST_TRAIN_RULES):
        state = distribute_state(model, state)
        for s, batch in enumerate(a["batches"]):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            _sync(dev)
            t0 = time.perf_counter()
            with held_calls(out["excess"]) if s == 1 else contextlib.nullcontext():
                state, m = step_fn(state, batch)
            loss = float(_full(m["loss"]))
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
            out["losses"].append(loss)
            if s == 0:
                after = [_full(t) for t in tree_leaves(state.params)]
                mu = [_full(t) for t in tree_leaves(state.opt.mu)]
                if rank == 0:
                    want = torch.load(os.path.join(tmp, f"{name}_step1.pt"), weights_only=True)
                    out["param_diff"] = max(float((g.float() - w.to(dev).float()).abs().max())
                                            for g, w in zip(after, want["p"]))
                    out["step1"] = step_agreement(p0, after, mu, want["p"], want["mu"])
                    del want, p0
                del after, mu
    out["excess"] = max((x for _, x in out["excess"]), default=None)
    out["launches"], out["staged"] = ops.launch_counts(), dict(mesh_lib.STAGED)
    return out


DIST_SCENARIOS = {"sp": dist_sp_rank, "sp32": functools.partial(dist_sp_rank, name="sp32"), "psum": dist_psum_rank,
                  "moe": dist_moe_rank, "train": dist_train_rank,
                  "train32": functools.partial(dist_train_rank, name="train32")}


def dist_rank(rank, dm, tmp, names):
    """The scenarios ``names`` one after the other in one spawned group (a
    spawn costs each rank its start); each reports the launches it made."""
    out = {}
    for name in names:
        out[name] = DIST_SCENARIOS[name](rank, dm, tmp)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def drive_distributed_path(dev, phase=lambda name: contextlib.nullcontext(), card="cpu", arch=DIST_ARCH,
                           moe_arch=DIST_MOE_ARCH, lengths=DIST_LENGTHS, cap=DIST_CAP, steps=DIST_STEPS,
                           moe_tokens=DIST_MOE_TOKENS, psum_tokens=DIST_PSUM_TOKENS, train_batch=TRAIN_BATCH,
                           train_seq=TRAIN_SEQ, tiny=False):
    """Phase 16: the collectives on ``torch.distributed``, one spawned
    process a rank (``launch.mesh.run_ranks``), every rank on ``dev``.  The
    parent builds the kernels once (``_build.load_library``) and every rank
    loads that library; the parent runs the single-process references
    (uncounted), the ranks report their launch counts and checks, and the
    parent prints a JSON line a sub-phase and holds every check.  Returns
    the ranks' launches, summed.

    A. one rank, mesh (1, 1): on the card NCCL (each rank a card of its
       own); ``compressed_psum`` of a gradient tree and ``DIST_SP_RULES``'s
       decode (a 2-step run of B);
    B. two ranks on the card, mesh (1, 2) (gloo: the ranks share the card):
       ``arch`` at full width under ``DIST_SP_RULES``: the caches hold
       ``cap`` slots split over the two ranks, row 0 ``lengths[0]`` tokens,
       row 1 ``lengths[1]`` (in the first shard only); ``steps`` steps fed
       the single-process K3 path's greedy tokens, each step's token equal
       to that path's (or apart at a near tie, printed) and its logits
       within ``DIST_STEP_TOL`` of the plain single-process decode's; wall
       ms a step, host ms in collectives; then ``DIST_F32_STEPS`` steps of
       the same decode on f32 weights, each token the plain f32 decode's
       and the logits within ``DIST_F32_TOL`` of it (a rank's dropped or
       doubled partial moves them by far more);
    C. the same two ranks, ``moe_arch`` at full width, grouped dispatch: each
       layer's MoE on ``moe_tokens`` rows through the sharded combine
       (``ff`` split over ``"model"``), within ``DIST_MOE_TOL`` of the
       single-process layer and with its dropped slots;
    D. the same two ranks: ``compressed_psum`` over ``"model"`` of a
       gradient tree of ``arch`` within one bin of the exact mean on every
       leaf; the int8 bytes gathered;
    E. four ranks, mesh (2, 2), ``DIST_TRAIN_RULES``: ``DIST_TRAIN_STEPS``
       steps of ``arch`` on ``train_batch`` x ``train_seq`` tokens (remat as
       registered), losses within ``DIST_LOSS_TOL`` of the single-process
       steps, parameters after step 1 within ``DIST_PARAM_TOL``, and step
       1 held by :func:`step_held` (its moments and its update against the
       single process's; the rule must reject a step that changes nothing
       and the single process's step on half the batch); K4 counted on every
       rank, the second step's calls held to the plain version; then one
       step of the same on f32 weights (``DIST_F32_TRAIN_LAYERS`` deep),
       held by the f32 rules."""
    on_card = dev.type == "cuda"
    cfg_of = (lambda name: registry.get(name).tiny()) if tiny else registry.get

    def same_tokens(name, got, want, plain, tol=DIST_STEP_TOL):
        """Each step's token (from the same inputs) equal to the single
        process's, or apart only at a near tie: the two tokens' plain logits
        within ``tol`` of the row's largest |logit|.  Returns the ties."""
        ties = []
        for s, (g, w) in enumerate(zip(got, want)):
            for row, (x, y) in enumerate(zip(g, w)):
                if x != y:
                    gap = float(plain[s][row, y] - plain[s][row, x]) / float(np.abs(plain[s][row]).max())
                    require(gap <= tol, f"{name}: step {s} row {row} chose {x}, the single process {y}: "
                            f"{gap:.3g} of the largest |logit| apart (rule {tol})")
                    ties.append((s, row, gap))
        return ties

    lib = _build.load_library()._name if on_card else None
    launches = dict.fromkeys(ops.KERNELS, 0)
    lm_data_cfg = cfg_of(arch)

    def report(name, per_rank, **extra):
        for r in per_rank:
            for k in launches:
                launches[k] += r["launches"][k]
        line = {"phase": f"16 {name}", "ranks": len(per_rank), "backend": per_rank[0].get("backend"),
                "launches": [r["launches"]["flash_attention"] for r in per_rank],
                "staged": [r["staged"] for r in per_rank], "card": card, **extra}
        print(json.dumps(line), flush=True)

    with phase("distributed"), tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        def save(name, args):
            torch.save(dict(args, lib=lib), os.path.join(tmp, f"{name}.pt"))

        # ---- the single-process references of A and B (uncounted)
        cfg = lm_data_cfg
        rng = np.random.default_rng(SEED + 16)
        tokens = rng.integers(0, cfg.vocab_size, (len(lengths), max(lengths)))
        tok0 = tokens[:, :1]
        with uncounted():
            params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED + 16), dev)
            _, caches = lm.prefill(cfg, params, {"tokens": torch.as_tensor(tokens, device=dev)}, pad_to=cap)
            caches = caches._replace(length=torch.tensor(lengths, dtype=torch.int32, device=dev))
            plain_caches = caches.clone()
            want_tokens, k3_logits, tok = [], [], torch.as_tensor(tok0, device=dev)
            for _ in range(steps):
                logits, caches = lm.decode_step(cfg, params, tok, caches)
                tok = logits[:, -1].argmax(-1)[:, None]
                want_tokens.append(tok[:, 0].tolist())
                k3_logits.append(logits[:, -1].float().cpu().numpy())
            plain_logits, tok = [], torch.as_tensor(tok0, device=dev)
            with plain_attention():
                for s in range(steps):
                    logits, plain_caches = lm.decode_step(cfg, params, tok, plain_caches)
                    plain_logits.append(logits[:, -1].float().cpu().numpy())
                    tok = torch.as_tensor(want_tokens[s], device=dev)[:, None]
        k3_rel = max(float(np.abs(k - p).max() / np.abs(p).max()) for k, p in zip(k3_logits, plain_logits))
        del params, caches, plain_caches, logits
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        sp = dict(cfg=cfg, seed=SEED + 16, tokens=tokens, tok0=tok0, lengths=lengths, cap=cap,
                  want_tokens=want_tokens, plain_logits=plain_logits)

        # ---- the f32 reference of B's f32 run: K4's f32 prefill, then the
        # plain decode's own greedy tokens (uncounted)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        with uncounted():
            params = lm.init_params(cfg32, torch.Generator(dev).manual_seed(SEED + 16), dev)
            _, caches = lm.prefill(cfg32, params, {"tokens": torch.as_tensor(tokens, device=dev)}, pad_to=cap)
            caches = caches._replace(length=torch.tensor(lengths, dtype=torch.int32, device=dev))
            f32_tokens, f32_logits, tok = [], [], torch.as_tensor(tok0, device=dev)
            with plain_attention():
                for _ in range(DIST_F32_STEPS):
                    logits, caches = lm.decode_step(cfg32, params, tok, caches)
                    f32_logits.append(logits[:, -1].cpu().numpy())
                    tok = logits[:, -1].argmax(-1)[:, None]
                    f32_tokens.append(tok[:, 0].tolist())
        del params, caches, logits
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        psum = dict(cfg=cfg, seed=SEED + 16, tokens=psum_tokens)

        # ---- A: one rank (NCCL on the card)
        save("sp", dict(sp, want_tokens=want_tokens[:2], plain_logits=plain_logits[:2]))
        save("psum", psum)
        a = mesh_lib.run_ranks(dist_rank, _dist_mesh(dev, (1, 1)), (tmp, ("sp", "psum")))
        a_sp, a_psum = [r["sp"] for r in a], [r["psum"] for r in a]
        for r in a_sp:
            same_tokens("16 A", r["tokens"], want_tokens[:2], plain_logits)
            require(max(r["rel"]) <= DIST_STEP_TOL, f"16 A: logits {max(r['rel']):.3g} off the plain decode")
        require(a_psum[0]["worst"] <= 1, f"16 A: compressed_psum {a_psum[0]['worst']:.3g} bins off the mean")
        want_backend = "nccl" if on_card else "gloo"
        require(a_sp[0]["backend"] == a_psum[0]["backend"] == want_backend,
                f"16 A: backend {a_sp[0]['backend']}, not {want_backend}")
        report("A", a_sp + a_psum, ranks=1, step_ms=[r["step_ms"] for r in a_sp], rel=[max(r["rel"]) for r in a_sp],
               psum_worst=a_psum[0]["worst"])

        # ---- B, C and D: one group of two ranks on the card
        save("sp", sp)
        save("sp32", dict(sp, cfg=cfg32, want_tokens=f32_tokens, plain_logits=f32_logits))
        mcfg = dataclasses.replace(cfg_of(moe_arch), moe_dispatch="grouped")
        mtok = np.random.default_rng(SEED + 17).integers(0, mcfg.vocab_size, moe_tokens)
        save("moe", dict(cfg=mcfg, seed=SEED + 17, tokens=mtok))
        bcd = mesh_lib.run_ranks(dist_rank, _dist_mesh(dev, (1, 2)), (tmp, ("sp", "sp32", "moe", "psum")))
        b, b32, c, d = ([r[name] for r in bcd] for name in ("sp", "sp32", "moe", "psum"))
        ties = []
        for r in b:
            ties.append(same_tokens("16 B", r["tokens"], want_tokens, plain_logits))
            require(max(r["rel"]) <= DIST_STEP_TOL, f"16 B: logits {max(r['rel']):.3g} of their largest |value| "
                    f"off the plain decode (rule {DIST_STEP_TOL})")
            require(r["launches"]["decode_attention"] == 0, "16 B: K3 ran on the mesh path")
        report("B", b, near_ties=ties, k3_rel=k3_rel, placements=b[0]["placements"], prefill_ms=[r["prefill_ms"] for r in b],
               step_ms=[r["step_ms"] for r in b], collective_ms=[r["collective_ms"] for r in b],
               rel=[max(r["rel"]) for r in b])
        for r in b32:
            same_tokens("16 B f32", r["tokens"], f32_tokens, f32_logits, tol=DIST_F32_TOL)
            require(r["launches"]["decode_attention"] == 0, "16 B f32: K3 ran on the mesh path")
            require(max(r["rel"]) <= DIST_F32_TOL, f"16 B f32: logits {max(r['rel']):.3g} of their largest "
                    f"|value| off the plain f32 decode (rule {DIST_F32_TOL})")
        report("B f32", b32, rel=[max(r["rel"]) for r in b32], tokens=b32[0]["tokens"],
               step_ms=[r["step_ms"] for r in b32])

        # ---- C: the same two ranks, the grouped MoE's sharded combine
        for r in c:
            require(max(r["rel"]) <= DIST_MOE_TOL, f"16 C: a layer's output {max(r['rel']):.3g} of its largest "
                    f"|value| off the single-process one")
            require(r["drops"] == r["drops_one"], f"16 C: dropped slots {r['drops']} != {r['drops_one']}")
        report("C", c, rel=[max(r["rel"]) for r in c], drops=c[0]["drops"],
               layer_ms=[round(float(np.mean(r["layer_ms"])), 3) for r in c])

        # ---- D: the same two ranks, compressed_psum of a gradient tree
        for r in d:
            require(r["worst"] <= 1, f"16 D: compressed_psum {r['worst']:.3g} bins off the exact mean")
        report("D", d, worst=[r["worst"] for r in d], leaves=d[0]["leaves"],
               int8_bytes=[r["int8_bytes"] for r in d], psum_ms=[r["psum_ms"] for r in d])

        # ---- E: four ranks, mesh (2, 2), the sharded train step
        tcfg = cfg
        lm_data = MarkovLM(vocab_size=tcfg.vocab_size, seed=2, stickiness=0.6)
        batches = [_train_batch(lm_data, s, train_batch, train_seq) for s in range(DIST_TRAIN_STEPS)]
        model = build(tcfg)
        with uncounted():
            state = init_train_state(model, torch.Generator(dev).manual_seed(SEED + 18), dev)
            step_fn = make_train_step(model, AdamWConfig(**TRAIN_OPT))
            want_losses = []
            for s, batch in enumerate(batches):
                batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
                new, m = step_fn(state, batch)
                want_losses.append(float(m["loss"]))
                if s == 0:
                    # the rule's planted faults: a step that changes nothing,
                    # and the step on half the batch
                    p0, want = tree_leaves(state.params), (tree_leaves(new.params), tree_leaves(new.opt.mu))
                    half, _ = step_fn(state, {k: v[: len(v) // 2] for k, v in batch.items()})
                    controls = {"no update": step_agreement(p0, p0, [torch.zeros_like(x) for x in want[1]], *want),
                                "half the batch": step_agreement(p0, tree_leaves(half.params),
                                                                 tree_leaves(half.opt.mu), *want)}
                    require(not any(step_held(x) for x in controls.values()),
                            f"16 E: the step rule misses a planted fault: {controls}")
                    torch.save({"p": [t.cpu() for t in want[0]], "mu": [t.cpu() for t in want[1]]},
                               os.path.join(tmp, "train_step1.pt"))
                    del p0, want, half
                state = new
            # E f32: step 1 on f32 weights, held to the f32 rules
            tcfg32 = dataclasses.replace(tcfg, dtype="float32",
                                         n_layers=min(tcfg.n_layers, DIST_F32_TRAIN_LAYERS))
            model = build(tcfg32)
            state = init_train_state(model, torch.Generator(dev).manual_seed(SEED + 18), dev)
            new, _ = make_train_step(model, AdamWConfig(**TRAIN_OPT))(
                state, {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()})
            torch.save({"p": [t.cpu() for t in tree_leaves(new.params)],
                        "mu": [t.cpu() for t in tree_leaves(new.opt.mu)]}, os.path.join(tmp, "train32_step1.pt"))
        del state, new, model, m
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        save("train", dict(cfg=tcfg, seed=SEED + 18, opt=TRAIN_OPT, batches=batches))
        save("train32", dict(cfg=tcfg32, seed=SEED + 18, opt=TRAIN_OPT, batches=batches[:1]))
        e, e32 = zip(*[(r["train"], r["train32"]) for r in
                       mesh_lib.run_ranks(dist_rank, _dist_mesh(dev, (2, 2)), (tmp, ("train", "train32")))])
        for r in e:
            diff = [abs(x - y) for x, y in zip(r["losses"], want_losses)]
            require(max(diff) <= DIST_LOSS_TOL, f"16 E: losses {r['losses']} vs {want_losses}")
            if on_card:
                require(r["launches"]["flash_attention"] > 0, f"16 E: a rank launched no K4: {r['launches']}")
                require(r["excess"] is not None and r["excess"] <= 1,
                        f"16 E: a K4 call {r['excess']} times its rule off its plain version")
        require(e[0]["param_diff"] <= DIST_PARAM_TOL, f"16 E: parameters {e[0]['param_diff']:.3g} off after step 1")
        require(step_held(e[0]["step1"]), f"16 E: step 1 against the single process's: {e[0]['step1']} (rules: "
                f"moments {DIST_MU_TOL}, parameters apart {DIST_UPDATE_SHARE}, some moved)")
        report("E", e, losses=[r["losses"] for r in e], want_losses=want_losses, param_diff=e[0]["param_diff"],
               step1=e[0]["step1"], controls=controls, step_ms=[r["step_ms"] for r in e],
               k4_excess=[r["excess"] for r in e])
        require(step_held(e32[0]["step1"], f32=True), f"16 E f32: step 1 against the single process's: "
                f"{e32[0]['step1']} (rules: moments {DIST_F32_MU_TOL}, parameters apart {DIST_F32_UPDATE_SHARE})")
        report("E f32", e32, losses=[r["losses"] for r in e32], step1=e32[0]["step1"],
               step_ms=[r["step_ms"] for r in e32])
    return launches


class Children:
    """Child processes of phases 17 and 18, each writing its standard output
    and error to files in ``tmp``: ``start`` one, ``wait`` for it (its exit
    code and output), ``close`` ends those still running.  Host-only
    children see no card (``CUDA_VISIBLE_DEVICES`` empty) and run one thread
    each, so the card's phases can run beside them."""

    def __init__(self, tmp):
        self.tmp, self.procs = tmp, {}

    def start(self, key, cmd, host_only=False):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        if host_only:
            env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        files = [open(os.path.join(self.tmp, f"{key}.{ext}"), "w") for ext in ("out", "err")]
        self.procs[key] = (subprocess.Popen(cmd, stdout=files[0], stderr=files[1], env=env, cwd=ROOT), files)

    def wait(self, key, timeout=900):
        proc, files = self.procs.pop(key)
        rc = proc.wait(timeout)
        for f in files:
            f.close()
        out, err = (Path(self.tmp, f"{key}.{ext}").read_text() for ext in ("out", "err"))
        return rc, out, err

    def close(self):
        for proc, files in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            for f in files:
                f.close()
        self.procs.clear()


def start_host_children(children, tiny=False, cells=DRYRUN_CELLS, kinds=tuple(GROUND_SHAPES)):
    """Start phase 17's host-only children (A's dry-run cells, B's meta
    half) and phase 18's ``bandwidth_adaptation`` in ``children``."""
    for arch, shape, mk in cells:
        children.start(f"dryrun.{arch}.{shape}.{mk}", [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                                                       arch, "--shape", shape, "--mesh", mk, "--out", children.tmp],
                       host_only=True)
    children.start("ground", [sys.executable, "-c", GROUND_META, str(ROOT), os.path.join(children.tmp, "ground.json"),
                              "tiny" if tiny else "full", *kinds], host_only=True)
    children.start("example.bandwidth_adaptation", [sys.executable, "-c", EXAMPLE_COUNTED,
                                                    str(ROOT / "examples" / "torch" / "bandwidth_adaptation.py")],
                   host_only=True)


def _ground_cfg(tiny):
    cfg = registry.get(GROUND_ARCH)
    return cfg.tiny() if tiny else cfg


def ground_cell(cfg, kind, mesh, shapes=GROUND_SHAPES):
    """``launch.specs.make_cell`` at ``shapes[kind]``, added to ``SHAPES`` for
    the call (as the reference's launch test overrides ``SHAPES``)."""
    from repro_torch.launch import specs

    name = f"ground_{kind}"
    specs.SHAPES[name] = shapes[kind]
    try:
        return specs.make_cell(cfg, name, mesh)
    finally:
        del specs.SHAPES[name]


def _counted_line(flops, st, args_bytes, **extra):
    return dict(flops=flops, counts=st.counts, result_bytes=st.total_result_bytes,
                wire_bytes=st.total_wire_bytes, args=args_bytes, **extra)


def ground_meta(tiny=False, kinds=tuple(GROUND_SHAPES)):
    """17 B's meta half (in a child process): each cell run once on meta
    tensors as rank 0 of a fake group of world 1 (``launch.dryrun``)."""
    from repro_torch.launch import dryrun

    mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
    cfg, out = _ground_cfg(tiny), {}
    for kind in kinds:
        cell = ground_cell(cfg, kind, mesh)
        _, flops, st, temp, trace_s = dryrun.run_counted(cell, mesh, 1)
        out[kind] = _counted_line(flops, st, dryrun.local_bytes(cell.inputs), temp=temp, trace_s=round(trace_s, 2))
    return out


def _real_like(tree, dev, gen, high):
    """Each meta tensor of ``tree`` as a real one of its shape and dtype on
    ``dev`` (a DTensor with its placements): normal floats, integers in
    ``[0, high)``."""
    from torch.distributed.tensor import distribute_tensor

    def one(x):
        if x.is_floating_point():
            full = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
        else:
            full = torch.randint(0, high, x.shape, generator=gen, device=dev).to(x.dtype)
        if isinstance(x, DTensor):
            return distribute_tensor(full, x.device_mesh, x.placements, src_data_rank=None)
        return full

    return tree_map(one, tree)


def ground_rank(rank, dm, tmp):
    """17 B's real half, on one rank of a process group of world 1: each
    cell's step on real inputs (the model's own initialisation for the
    weights, random batches and caches from a seed) under the same counters
    as the dry run, with the kernels' launches and the card's peak memory."""
    from repro_torch.launch import dryrun, hlo_stats

    args = _dist_args(tmp, "ground")
    dev = _dist_rank_start(args)
    cfg = _ground_cfg(args["tiny"])
    model = build(cfg)
    gen = torch.Generator(dev).manual_seed(SEED + 26)
    out = {}
    for kind in args["kinds"]:
        cell = ground_cell(cfg, kind, dm)
        with sharding.use_rules(dm, cell.rules):
            if kind == "train":
                inputs = (distribute_state(model, init_train_state(model, gen, dev)),
                          _real_like(cell.inputs[1], dev, gen, cfg.vocab_size))
            else:
                params = sharding.distribute_tree(model.init_params(gen, dev), model.param_specs())
                inputs = (params,) + tuple(_real_like(t, dev, gen, high) for t, high in
                                           zip(cell.inputs[1:], (cfg.vocab_size, GROUND_SHAPES[kind]["seq"] - 1)))
        _sync(dev)
        ops.reset_launch_counts()
        before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        flops, colls = hlo_stats.FlopCounter(), hlo_stats.CollectiveCounter()
        t0 = time.perf_counter()
        with sharding.use_rules(dm, cell.rules), colls, flops:
            res = cell.fn(*inputs)
        _sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        value = _full(res[1]["loss"]) if kind == "train" else _full(res[0])
        require(bool(torch.isfinite(value.float()).all()), f"17 B {kind}: the real step's output is not finite")
        out[kind] = _counted_line(flops.flops, hlo_stats.collective_stats(colls.records, dm.size()),
                                  dryrun.local_bytes(inputs), launches=ops.launch_counts(), wall_ms=round(wall_ms, 1),
                                  before=before, peak=torch.cuda.max_memory_allocated(dev) if before is not None else None,
                                  loss=float(value) if kind == "train" else None)
        del res, inputs, cell
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def drive_dryrun_path(dev, children, phase=lambda name: contextlib.nullcontext(), card="cpu", tiny=False,
                      cells=DRYRUN_CELLS, kinds=tuple(GROUND_SHAPES)):
    """Phase 17: the dry-run tooling.  ``children`` holds the host-only
    children of :func:`start_host_children` (started with the same
    ``cells``, ``tiny`` and ``kinds``).

    A. each dry-run cell's child must exit 0 and its record be ``ok``; one
       JSON line a cell: FLOPs, collective counts and wire bytes, a rank's
       argument bytes, the activation peak, the trace's seconds;
    B. for each kind, the meta run (the child's) and the real run on one
       rank of ``dev`` (``launch.mesh.run_ranks``: NCCL on the card) must
       count the same FLOPs and collectives, and the meta run's argument
       bytes must equal the real tensors' bytes; on the card the real run
       must launch ``GROUND_KERNELS[kind]``; one JSON line a kind with the
       dry run's ``temp_size_in_bytes`` beside the card's
       ``max_memory_allocated`` (recorded, not held).
    Returns B's real runs' launches, summed."""
    on_card = dev.type == "cuda"
    launches = dict.fromkeys(ops.KERNELS, 0)
    with phase("dryrun"), tempfile.TemporaryDirectory(prefix="chip_smoke_ground_") as tmp:
        for arch, shape, mk in cells:
            key = f"dryrun.{arch}.{shape}.{mk}"
            rc, out, err = children.wait(key)
            require(rc == 0, f"17 A: {key} exited {rc}: {err[-2000:]}")
            rec = json.loads(Path(children.tmp, f"{arch}.{shape}.{mk}.json").read_text())
            require(rec["status"] == "ok", f"17 A: {key} is {rec['status']}: {rec.get('error')} "
                    f"{rec.get('traceback', '')[-2000:]}")
            print(json.dumps({"phase": "17 A", "arch": arch, "shape": shape, "mesh": mk, "flops": rec["cost"]["flops"],
                              "counts": {k: v for k, v in rec["collectives"]["counts"].items() if v},
                              "wire_bytes": rec["collectives"]["total_wire_bytes"],
                              "argument_bytes": rec["memory"].get("argument_size_in_bytes"),
                              "temp_bytes": rec["memory"].get("temp_size_in_bytes"),
                              "trace_s": rec["trace_s"]}), flush=True)
        rc, out, err = children.wait("ground")
        require(rc == 0, f"17 B: the meta run exited {rc}: {err[-2000:]}")
        meta = json.loads(Path(children.tmp, "ground.json").read_text())
        torch.save(dict(lib=_build.load_library()._name if on_card else None, tiny=tiny, kinds=list(kinds)),
                   os.path.join(tmp, "ground.pt"))
        real = mesh_lib.run_ranks(ground_rank, _dist_mesh(dev, (1, 1)), (tmp,))[0]
        for kind in kinds:
            m, r = meta[kind], real[kind]
            for k in launches:
                launches[k] += r["launches"][k]
            require(m["flops"] == r["flops"], f"17 B {kind}: the dry run counts {m['flops']} FLOPs, the card "
                    f"{r['flops']}")
            require(m["counts"] == r["counts"], f"17 B {kind}: collectives {m['counts']} vs {r['counts']}")
            require(m["args"] == r["args"], f"17 B {kind}: a rank's argument bytes {m['args']} vs the real "
                    f"tensors' {r['args']}")
            if on_card:
                for name in GROUND_KERNELS[kind]:
                    require(r["launches"][name] > 0, f"17 B {kind}: {name} was not launched: {r['launches']}")
            temp = m["temp"]
            print(json.dumps({"phase": "17 B", "kind": kind, "shape": GROUND_SHAPES[kind], "flops": r["flops"],
                              "counts": {k: v for k, v in r["counts"].items() if v}, "argument_bytes": r["args"],
                              "launches": {k: v for k, v in r["launches"].items() if v},
                              "temp_bytes": temp, "max_memory_allocated": r["peak"], "allocated_before": r["before"],
                              "temp_over_peak": (temp / r["peak"] if r["peak"] and isinstance(temp, int) else None),
                              "temp_over_step_peak": (temp / (r["peak"] - r["before"]) if r["peak"]
                                                      and isinstance(temp, int) and r["peak"] > r["before"] else None),
                              "meta_trace_s": m["trace_s"], "real_wall_ms": r["wall_ms"], "loss": r["loss"],
                              "card": card}), flush=True)
    return launches


def _example_lines(name, out):
    """``out``'s lines but the launch counts, each held to the example's
    patterns; returns (lines, the example's wall seconds, launch counts)."""
    lines = [ln for ln in out.splitlines() if ln.strip()]
    counted = [ln for ln in lines if ln.startswith("[launch counts] ")]
    require(len(counted) == 1, f"18 {name}: no launch counts printed")
    lines = [ln for ln in lines if not ln.startswith("[launch counts] ")]
    pats = [re.compile(p) for p in EXAMPLE_LINES[name]]
    for ln in lines:
        require(any(p.fullmatch(ln) for p in pats), f"18 {name}: a line not of its reference's: {ln!r}")
    for p in pats:
        require(any(p.fullmatch(ln) for ln in lines), f"18 {name}: no line like {p.pattern!r}")
    if name == "bandwidth_adaptation":
        require("\n".join(lines) == BANDWIDTH_TIMELINE, f"18 {name}: the timeline is not the reference's:\n"
                + "\n".join(lines))
    counts = json.loads(counted[0][len("[launch counts] "):])
    return lines, counts.pop("wall_s"), counts


def start_examples(dev, children, examples=None):
    """Start the examples of ``examples`` (name -> arguments; by default
    ``EXAMPLES``, with ``--device cpu`` off the card) that are not running
    yet, each in a child process (``EXAMPLE_COUNTED``)."""
    for name, args in (EXAMPLES if examples is None else examples).items():
        if f"example.{name}" not in children.procs:
            children.start(f"example.{name}", [sys.executable, "-c", EXAMPLE_COUNTED,
                                               str(ROOT / "examples" / "torch" / f"{name}.py"), *args]
                           + ([] if dev.type == "cuda" or name == "bandwidth_adaptation" else ["--device", "cpu"]))


def drive_examples_path(dev, children, phase=lambda name: contextlib.nullcontext(), card="cpu", examples=None):
    """Phase 18: the port's four examples at ``examples`` (as
    :func:`start_examples`, which started them beside phase 17 on the card;
    ``bandwidth_adaptation`` from :func:`start_host_children`).  Each must
    exit 0, print its reference example's lines (:func:`_example_lines`)
    and, on the card, launch ``EXAMPLE_KERNELS``.  Returns the launches,
    summed."""
    examples = dict(EXAMPLES if examples is None else examples)
    on_card = dev.type == "cuda"
    launches = dict.fromkeys(ops.KERNELS, 0)
    with phase("examples"):
        start_examples(dev, children, examples)
        for name in examples:
            rc, out, err = children.wait(f"example.{name}")
            require(rc == 0, f"18 {name} exited {rc}: {err[-3000:]}")
            lines, wall_s, counts = _example_lines(name, out)
            for k in launches:
                launches[k] += counts[k]
            if on_card:
                for k in EXAMPLE_KERNELS[name]:
                    require(counts[k] > 0, f"18 {name}: {k} was not launched: {counts}")
            print(json.dumps({"phase": "18", "example": name, "args": examples[name],
                              "launches": {k: v for k, v in counts.items() if v}, "wall_s": round(wall_s, 1),
                              "card": card}), flush=True)
            for ln in lines:
                print(f"  {ln}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    phase_ms = {}

    gen = torch.Generator(device=dev)

    # ------------------------------------------------------------------ 1 env
    with Phase("env", phase_ms):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
        print(smi)
        print(f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")

    # ---------------------------------------------------------------- 2 build
    with Phase("build", phase_ms):
        t0 = time.perf_counter()
        _build.load_library()
        print(f"built and loaded the kernel library in {time.perf_counter() - t0:.1f} s")

    # phases 17 and 18's child processes (host-only ones start after phase 10)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_children_") as tmp:
        children = Children(tmp)
        try:
            return _card_phases(dev, gen, phase_ms, smi, children)
        finally:
            children.close()


def _card_phases(dev, gen, phase_ms, smi, children) -> int:
    """Phases 3-18 (main's body after the build)."""

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def randint(lo, hi, *shape, dtype=torch.uint16):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(dtype)

    # channels a kernel moves per access where C and alignment allow: one
    # 16-byte store of its output (kvquant.vector_width)
    widest = {torch.float32: 4, torch.bfloat16: 8}

    def took(v, want, kernel):
        require(v == want, f"{kernel} takes {v} channels an access, not {want}")

    def misaligned(t, offset=1):
        """A contiguous copy of ``t`` that starts ``offset`` elements into its
        buffer, so K1/K2/K5/K6 must take a narrower access than 16 bytes."""
        view = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)[offset:].view(t.shape)
        return view.copy_(t)

    # -------------------------------------------------------------- 3 kernels
    cfg = registry.get("smollm-360m")
    L, Hq, Hkv, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    C, g = Hkv * D, codec.CodecConfig().group_size
    G = -(-CHUNK // g)
    report, excess, controls = {}, {}, {}
    with Phase("kernels", phase_ms):
        gen.manual_seed(SEED + 7)

        # K1: the serve phase's lossy chunks (4 chunks x L x 2), bf16 out;
        # ragged: a 1464-token chunk (G = 147) and f32 out; C = 36 (V = 4)
        # and inputs one element off their 16-byte alignment (V = 1).
        # Planted faults: one group's anchor off by one bin, and channels 2
        # and 3 (one vector) swapped everywhere
        tol1 = ops.BF16_TOL["kv_dequant_tokens"]

        def k1_case(B, Gc, out_dtype, Cc=C, offset=0, V=None):
            d = randint(0, 255, B, Gc, g - 1, Cc)
            a = randn(B, Gc, Cc, dtype=torch.float32)
            if offset:
                d, a = misaligned(d, offset), misaligned(a, offset)
            bins = torch.rand(B, generator=gen, device=dev) * 0.2 + 0.01
            got = kv_dequant_tokens_cuda(d, a, bins, qmax=127, out_dtype=out_dtype)
            took(vector_width(Cc, d, a, out=got), V or widest[out_dtype], "K1")
            want = kv_dequant_tokens_plain(d, a, bins, qmax=127, out_dtype=out_dtype)
            err = (got.float() - want.float()).abs().max().item()
            if out_dtype == torch.bfloat16:
                x = ops.bf16_ulp_excess(got, want, **tol1)
                require(x <= 1, f"K1 bf16 is {x:.3g} times its tolerance off ({err})")
                excess["kv_dequant_tokens"] = max(excess.get("kv_dequant_tokens", 0.0), x)
            else:
                require(err <= 2e-5, f"K1 f32 error {err} > 2e-5")
            return (d, a, bins), want, err

        (d, a, bins), want, e1 = k1_case(4 * L * 2, G, torch.bfloat16)
        errs1 = [e1] + [k1_case(L * 2, 147, dt)[2] for dt in (torch.float32, torch.bfloat16)]
        errs1 += [k1_case(L * 2, 147, dt, Cc=36, V=4)[2] for dt in (torch.float32, torch.bfloat16)]
        errs1 += [k1_case(L * 2, G, dt, offset=1, V=1)[2] for dt in (torch.float32, torch.bfloat16)]
        a_bad = a.clone()
        a_bad[3, 5] += bins[3]
        swapped = want.clone()
        swapped[..., [2, 3]] = want[..., [3, 2]]
        controls["kv_dequant_tokens"] = {
            "anchor off by one bin": ops.bf16_ulp_excess(
                kv_dequant_tokens_plain(d, a_bad, bins, qmax=127, out_dtype=torch.bfloat16), want, **tol1),
            "channels 2 and 3 swapped": ops.bf16_ulp_excess(swapped, want, **tol1),
        }
        require(min(controls["kv_dequant_tokens"].values()) > 1,
                f"K1's rule misses a planted fault: {controls['kv_dequant_tokens']}")
        del want, a_bad, swapped
        B = d.shape[0]
        nb = d.numel() * 2 + a.numel() * 4 + bins.numel() * 4 + B * G * g * C * 2
        report["kv_dequant_tokens"] = dict(
            max_abs_err=max(errs1),
            ms=time_ms(lambda: kv_dequant_tokens_cuda(d, a, bins, qmax=127, out_dtype=torch.bfloat16)),
            device_ms=device_ms(lambda: kv_dequant_tokens_cuda(d, a, bins, qmax=127, out_dtype=torch.bfloat16),
                                "dequant_tokens_kernel"),
            plain_ms=time_ms(lambda: kv_dequant_tokens_plain(d, a, bins, qmax=127, out_dtype=torch.bfloat16)),
            library_ms=None,
            bound=bound(nb, 3 * d.numel()),
            shape=f"d_sym {tuple(d.shape)} uint16 -> bf16",
        )

        # K2: the serve phase's level-0 chunks (3 x L x 2); ragged G = 52;
        # C = 36 (V = 4) and inputs one element off their alignment (V = 1)
        def k2_case(B, Gc, out_dtype, Cc=C, offset=0, V=None):
            d = randint(0, 509, B, Gc, g - 1, Cc)
            a = randint(1, 256, B, Gc, Cc)
            if offset:
                d, a = misaligned(d, offset), misaligned(a, offset)
            s = (torch.rand(B, Gc, generator=gen, device=dev) * 0.05 + 1e-3).half().float()
            got = kv_lossless_tokens_cuda(d, a, s, out_dtype=out_dtype)
            took(vector_width(Cc, d, a, out=got), V or widest[out_dtype], "K2")
            want = kv_lossless_tokens_plain(d, a, s, out_dtype=out_dtype)
            require(torch.equal(got, want), f"K2 is not bit-exact ({out_dtype}, G={Gc}, C={Cc}, offset {offset})")
            return (d, a, s), (got.float() - want.float()).abs().max().item()

        (d, a, s), e1 = k2_case(3 * L * 2, G, torch.bfloat16)
        errs2 = [e1, k2_case(L * 2, 52, torch.float32)[1]]
        for dt in (torch.float32, torch.bfloat16):
            errs2 += [k2_case(L * 2, 52, dt, Cc=36, V=4)[1], k2_case(L * 2, G, dt, offset=1, V=1)[1]]
        B = d.shape[0]
        nb = d.numel() * 2 + a.numel() * 2 + s.numel() * 4 + B * G * g * C * 2
        report["kv_lossless_tokens"] = dict(
            max_abs_err=max(errs2),
            ms=time_ms(lambda: kv_lossless_tokens_cuda(d, a, s, out_dtype=torch.bfloat16)),
            device_ms=device_ms(lambda: kv_lossless_tokens_cuda(d, a, s, out_dtype=torch.bfloat16),
                                "lossless_tokens_kernel"),
            plain_ms=time_ms(lambda: kv_lossless_tokens_plain(d, a, s, out_dtype=torch.bfloat16)),
            library_ms=None,
            bound=bound(nb, 2 * a.numel() + 3 * d.numel()),
            shape=f"d_sym {tuple(d.shape)} uint16 -> bf16, C = 36 and misaligned cases",
        )

        # K3: 4 rows of the 4096-slot cache at the first generated token's
        # lengths; ragged lengths at tile and split edges.  Timed over 8
        # layer slices (168 MB of K/V) so every launch reads its cache from
        # HBM.
        sdpa = torch.nn.functional.scaled_dot_product_attention
        gqa_ok = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
        Bd = len(CONTEXTS)
        kc = randn(8, Bd, CAPACITY, Hkv, D)
        vc = randn(8, Bd, CAPACITY, Hkv, D)
        q = randn(Bd, Hq, D)
        lens_main = torch.tensor([t + 1 for t in CONTEXTS], dtype=torch.int32, device=dev)
        split = split_size(CAPACITY, Bd, Hkv, torch.cuda.get_device_properties(dev).multi_processor_count)
        tol3 = ops.BF16_TOL["decode_attention"]
        kf, vf = kc[0].float(), vc[0].float()
        err3 = 0.0
        ragged = ([0, 1, 2999, 4096], [TILE - 1, TILE, split + 1, CAPACITY - 1])
        for lens in [torch.tensor(r, dtype=torch.int32, device=dev) for r in ragged] + [lens_main]:
            got = decode_attention_cuda(q, kc[0], vc[0], lens)
            want = decode_attention_plain(q.float(), kf, vf, lens)
            require(not got[lens == 0].float().any(), "K3: a row with kv_len 0 must output 0")
            x = ops.bf16_ulp_excess(got, want, **tol3)
            require(x <= 1, f"K3 is {x:.3g} times its tolerance off its plain version")
            err3 = max(err3, (got.float() - want).abs().max().item())
            excess["decode_attention"] = max(excess.get("decode_attention", 0.0), x)
        # planted faults the rule must catch, on the main lengths (want is
        # theirs): the split of keys from 1024 skipped, one key masked off,
        # and the ragged last tile dropped (kv_len rounded down to the tile)
        cut = lambda x: torch.cat([x[:, :1024], x[:, 1024 + split:]], dim=1)  # noqa: E731
        faults = {
            "split skipped": decode_attention_plain(q.float(), cut(kf), cut(vf), lens_main - split),
            "kv_len - 1": decode_attention_plain(q.float(), kf, vf, lens_main - 1),
            "last tile dropped": decode_attention_plain(q.float(), kf, vf, lens_main // TILE * TILE),
        }
        controls["decode_attention"] = {n: ops.bf16_ulp_excess(f.bfloat16(), want, **tol3)
                                        for n, f in faults.items()}
        require(min(controls["decode_attention"].values()) > 1,
                f"K3's rule misses a planted fault: {controls['decode_attention']}")
        del kf, vf, faults
        it = itertools.count()

        def k3():
            i = next(it) % 8
            return decode_attention_cuda(q, kc[i], vc[i], lens_main)

        def k3_lib():
            i = next(it) % 8
            mask = (torch.arange(CAPACITY, device=dev)[None, :] < lens_main[:, None])[:, None, None, :]
            return sdpa(q[:, :, None], kc[i].transpose(1, 2), vc[i].transpose(1, 2),
                        attn_mask=mask, enable_gqa=True)

        n_tok = int(lens_main.sum())
        nb = q.numel() * 2 * 2 + n_tok * Hkv * D * 2 * 2 + Bd * 4
        report["decode_attention"] = dict(
            max_abs_err=err3,
            ms=time_ms(k3, iters=40),
            device_ms=device_ms(k3, "decode_split_kernel", "decode_combine_kernel", iters=16),
            plain_ms=time_ms(lambda: decode_attention_plain(q, kc[0], vc[0], lens_main)),
            library_ms=time_ms(k3_lib, iters=40) if gqa_ok else None,
            bound=bound(nb, 4 * Hq * D * n_tok),
            shape=f"q {tuple(q.shape)} vs cache {tuple(kc[0].shape)} bf16, kv_len {lens_main.tolist()}, "
                  f"split {split}",
        )

        # K4: one request's 3072-token prefill; the store's 6144; ragged
        # T = 3000; prefix-LM.  The rule admits the bf16 rounding of the
        # weights up to 2^-8 of flash_attention_magnitude (kernels/ops.py).
        tol4 = ops.BF16_TOL["flash_attention"]

        def k4_case(B, T, prefix=None, heads=(Hq, Hkv, D), causal=True):
            hq, hkv, dh = heads
            qq, kk, vv = randn(B, T, hq, dh), randn(B, T, hkv, dh), randn(B, T, hkv, dh)
            plen = None if prefix is None else torch.tensor(prefix, dtype=torch.int32, device=dev)
            got = flash_attention_cuda(qq, kk, vv, plen, causal=causal)
            want = flash_attention_plain(qq.float(), kk.float(), vv.float(), plen, causal=causal)
            mag = flash_attention_magnitude(qq, kk, vv, plen, causal=causal)
            x = ops.bf16_ulp_excess(got, want, scale=mag, **tol4)
            require(x <= 1, f"K4 is {x:.3g} times its tolerance off its plain version (B={B}, T={T}, "
                    f"prefix={prefix}, causal={causal})")
            excess["flash_attention"] = max(excess.get("flash_attention", 0.0), x)
            return (qq, kk, vv), (want, mag), (got.float() - want).abs().max().item()

        (qq, kk, vv), (want, mag), e1 = k4_case(1, CONTEXTS[0])
        T = CONTEXTS[0]
        # planted faults: the last 64 query rows skip the 32-key tile at
        # 1024; the diagonal tiles' mask off by one (every query but the
        # last also sees its next key)
        cut = lambda x: torch.cat([x[:, :1024], x[:, 1024 + 32:]], dim=1).float()  # noqa: E731
        nxt = lambda x: torch.cat([x, x[:, :1]], dim=1).float()  # noqa: E731
        skipped = want.clone()
        skipped[:, T - 64:] = flash_attention_plain(qq[:, T - 64:].float(), cut(kk), cut(vv))
        seen = flash_attention_plain(qq.float(), nxt(kk), nxt(vv))
        seen[:, T - 1] = want[:, T - 1]
        controls["flash_attention"] = {name: ops.bf16_ulp_excess(f.bfloat16(), want, scale=mag, **tol4)
                                       for name, f in (("tile skipped", skipped), ("next key seen", seen))}
        require(min(controls["flash_attention"].values()) > 1,
                f"K4's rule misses a planted fault: {controls['flash_attention']}")
        del want, mag, skipped, seen
        (q6, k6, v6), _, e2 = k4_case(1, STORE_CHUNKS * CHUNK)
        _, _, e3 = k4_case(1, 3000)
        _, _, e4 = k4_case(2, 1024, [100, 700])

        def k4_timing(qq, kk, vv, causal=True):
            b, n, hq, dh = qq.shape
            pairs = n * (n + 1) // 2 if causal else n * n  # the (query, key) pairs a row computes
            return dict(
                ms=time_ms(lambda: flash_attention_cuda(qq, kk, vv, causal=causal)),
                device_ms=device_ms(lambda: flash_attention_cuda(qq, kk, vv, causal=causal),
                                    "flash_tc_wide_kernel" if dh > 256 else "flash_tc_kernel"),
                library_ms=time_ms(lambda: sdpa(qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                                                is_causal=causal, enable_gqa=True)) if gqa_ok else None,
                bound=bound((qq.numel() * 2 + kk.numel() + vv.numel()) * 2, b * 4 * dh * hq * pairs),
            )

        t6 = k4_timing(q6, k6, v6)
        print(f"flash_attention at the store shape q {tuple(q6.shape)} causal: kernel {t6['ms']:.4f} ms  "
              f"(device time {t6['device_ms']} ms)  library {t6['library_ms']}  "
              f"bound {t6['bound'][0]:.4f} ms ({t6['bound'][1]})")
        del q6, k6, v6
        report["flash_attention"] = dict(
            max_abs_err=max(e1, e2, e3, e4),
            plain_ms=time_ms(lambda: flash_attention_plain(qq, kk, vv), iters=3, warmup=1),
            shape=f"q {tuple(qq.shape)} k/v {tuple(kk.shape)} bf16 causal",
            **k4_timing(qq, kk, vv),
        )
        # K5: the store's shape, (L * 2, 154, 10, 320) f32 grouped tokens,
        # at each lossy level's bins (a random delta scale); ragged G = 147;
        # then planted deltas of exactly k + 1/2 bins, which rintf rounds to
        # even and roundf away from zero, and deltas past +-qmax bins
        cc = codec.CodecConfig()
        qmax = cc.delta_qmax
        dscale = (torch.rand(L, 2, generator=gen, device=dev) + 0.5).cpu().numpy()
        level_bins = [torch.as_tensor(quant.effective_bins(L, cc.layer_group_bins, m, dscale), device=dev).reshape(-1)
                      for m in cc.level_mults]

        def k5_case(Gc, bins, Cc=C, offset=0, V=8):
            kv = torch.randn(L * 2, Gc, g, Cc, generator=gen, device=dev).cumsum(dim=2)  # token-correlated
            if offset:
                kv = misaligned(kv, offset)
            got = kv_quant_cuda(kv, bins, qmax=qmax)
            took(vector_width(Cc, kv, out=got), V, "K5")
            require(torch.equal(got, kv_quant_plain(kv, bins, qmax=qmax)),
                    f"K5 is not bit-exact with its plain version (G={Gc}, C={Cc}, offset {offset})")
            return kv

        for bins in level_bins:
            kv5 = k5_case(G, bins)
        k5_case(147, level_bins[0])
        k5_case(147, level_bins[1], Cc=36, V=4)
        k5_case(G, level_bins[2], offset=1, V=1)
        halves = [k + 0.5 for k in range(-8, 8)]
        clipped = [qmax + 0.5, qmax + 40.0, -qmax - 0.5, -1e6]
        t = torch.tensor([halves[j % len(halves)] for j in range(C)])
        u = torch.tensor([clipped[j % len(clipped)] for j in range(C)])
        kv = torch.full((2, 1, g, C), 3.0)
        kv[0, 0, 1:] += t * 0.25  # bin 0.25: every value and delta exact in f32
        kv[1, 0, 1:] += u * 0.25
        bins = torch.full((2,), 0.25, device=dev)
        got = kv_quant_cuda(kv.to(dev), bins, qmax=qmax)
        want = torch.tensor([[max(-qmax, min(qmax, round(x))) + qmax for x in row.tolist()] for row in (t, u)])
        require(torch.equal(got[:, 0].int().cpu(), want[:, None, :].expand(2, g - 1, C).int()),
                "K5 does not round half to even or clip as the reference does")
        require(torch.equal(got, kv_quant_plain(kv.to(dev), bins, qmax=qmax)), "K5 planted ties: kernel != plain")
        B = kv5.shape[0]
        nb = kv5.numel() * 4 + B * 4 + B * G * (g - 1) * C * 2
        report["kv_quant"] = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: kv_quant_cuda(kv5, level_bins[0], qmax=qmax)),
            device_ms=device_ms(lambda: kv_quant_cuda(kv5, level_bins[0], qmax=qmax), "quant_kernel"),
            plain_ms=time_ms(lambda: kv_quant_plain(kv5, level_bins[0], qmax=qmax)),
            library_ms=None,
            bound=bound(nb, 6 * B * G * (g - 1) * C),
            shape=f"kv {tuple(kv5.shape)} f32 -> uint16, 4 levels' bins, ties and clips planted, "
                  "C = 36 and misaligned cases",
        )
        del kv5

        # K6: the store's shape, f32 out (the unfused decode's) and bf16,
        # both bit for bit (bf16 is one cast of the same f32 value); ragged
        # G = 147; C = 36 (V = 4) and inputs one element off their
        # alignment (V = 1); planted fault: one group's anchor off by one bin
        tol6 = ops.BF16_TOL["kv_dequant"]

        def k6_case(Gc, out_dtype, Cc=C, offset=0, V=None):
            d = randint(0, 2 * qmax + 1, L * 2, Gc, g - 1, Cc)
            a = randn(L * 2, Gc, Cc, dtype=torch.float32)
            if offset:
                d, a = misaligned(d, offset), misaligned(a, offset)
            bins = level_bins[1]
            got = kv_dequant_cuda(d, a, bins, qmax=qmax, out_dtype=out_dtype)
            took(vector_width(Cc, d, a, out=got), V or widest[out_dtype], "K6")
            want = kv_dequant_plain(d, a, bins, qmax=qmax, out_dtype=out_dtype)
            require(torch.equal(got, want),
                    f"K6 is not bit-exact with its plain version ({out_dtype}, G={Gc}, C={Cc}, offset {offset})")
            return (d, a, bins), want, (got.float() - want.float()).abs().max().item()

        (d6, a6, b6), _, e1 = k6_case(G, torch.float32)
        errs6 = [e1, k6_case(G, torch.bfloat16)[2]]
        for dt in (torch.float32, torch.bfloat16):
            errs6 += [k6_case(147, dt)[2], k6_case(147, dt, Cc=36, V=4)[2], k6_case(G, dt, offset=1, V=1)[2]]
        want = kv_dequant_plain(d6, a6, b6, qmax=qmax, out_dtype=torch.bfloat16)
        a_bad = a6.clone()
        a_bad[3, 5] += b6[3]
        bad = kv_dequant_plain(d6, a_bad, b6, qmax=qmax, out_dtype=torch.bfloat16)
        controls["kv_dequant"] = {"anchor off by one bin": ops.bf16_ulp_excess(bad, want, **tol6)}
        require(controls["kv_dequant"]["anchor off by one bin"] > 1,
                f"K6's rule misses a planted fault: {controls['kv_dequant']}")
        del want, a_bad, bad
        B = d6.shape[0]
        nb = d6.numel() * 2 + a6.numel() * 4 + B * 4 + d6.numel() * 4
        report["kv_dequant"] = dict(
            max_abs_err=max(errs6),
            ms=time_ms(lambda: kv_dequant_cuda(d6, a6, b6, qmax=qmax, out_dtype=torch.float32)),
            device_ms=device_ms(lambda: kv_dequant_cuda(d6, a6, b6, qmax=qmax, out_dtype=torch.float32),
                                "dequant_kernel"),
            plain_ms=time_ms(lambda: kv_dequant_plain(d6, a6, b6, qmax=qmax, out_dtype=torch.float32)),
            library_ms=None,
            bound=bound(nb, 3 * d6.numel()),
            shape=f"d_sym {tuple(d6.shape)} uint16 -> f32, bf16 too, C = 36 and misaligned cases",
        )
        del d6, a6

        # K7 and K8, the rANS coder's scans, on random skewed tables built on
        # the card (precision 12, one table a lane, as profile builds them),
        # symbols drawn from each lane's table, all held with torch.equal:
        # a stacked wave of the serve phase, 4 chunks of 1536 tokens at
        # levels 0-3 (81,920 lanes): anchors over the anchor stack (154
        # steps), deltas over the alphabet-padded delta_decode_stack (1,382
        # steps); K8 over encode_all_levels' lossy delta stack (4 x 20,480
        # lanes) with its unused tail; phase 10's qwen2-moe chunk (98,304
        # lanes, 77 and 691 steps, delta tables at 2.0e9 slots); a lane whose
        # cum row starts past 2^31 bytes; ragged: 20,481 lanes, n_sym = 1 (no
        # word: an empty payload).  Planted faults: one word flipped
        # (check=True must raise), one lane's table_idx off by one, one
        # emitted word dropped from K8's stream, one staged cum entry off by
        # one in one table (K7 and K8).
        rk, n_lossy = cc.precision, len(cc.level_mults)
        r_lanes = L * 2 * C
        r_idx = torch.arange(r_lanes, dtype=torch.int32, device=dev)
        wave_levels = (0, 1, 2, 3)
        anchor_stack = coder_stack([(r_lanes, quant.ANCHOR_ALPHABET)] * 2, rk, dev, gen)
        t_a = torch.cat([r_idx + (r_lanes if lvl == 0 else 0) for lvl in wave_levels])
        a_args, _, a_dec = held_rans(anchor_stack, t_a, coder_symbols(anchor_stack, t_a, G, gen), "wave anchors")
        d_stack = coder_stack([(r_lanes, cc.delta_alphabet)] * n_lossy + [(r_lanes, quant.lossless_delta_alphabet())],
                              rk, dev, gen)
        t_d = torch.cat([r_idx + r_lanes * (n_lossy if lvl == 0 else lvl - 1) for lvl in wave_levels])
        d_syms = coder_symbols(d_stack, t_d, CHUNK - G, gen)
        d_args, _, d_want = held_rans(d_stack, t_d, d_syms, "wave deltas")
        rans_faults = {}
        payload, n_w, offs, st, t_dd = d_args[:5]
        lane = int(n_w.argmax())
        bad = payload.clone()
        bad[int(offs[lane]) + int(n_w[lane]) // 2] ^= 0x5A5A
        rans_faults["rans_decode: one word flipped"] = torch.equal(rans_decode_cuda(bad, *d_args[1:])[0], d_want[0])
        try:
            rans.decode_payload(bad, n_w, st, t_dd, d_stack, CHUNK - G, check=True)
            rans_faults["rans_decode: check=True passes a flipped word"] = True
        except ValueError:
            pass
        t_bad = t_dd.clone()
        t_bad[0] += 1
        rans_faults["rans_decode: table_idx off by one"] = torch.equal(
            rans_decode_cuda(payload, n_w, offs, st, t_bad, *d_args[5:])[0], d_want[0])
        # one staged cum entry off by one: lane 0's table at its most frequent symbol
        t0 = int(t_dd[0])
        cum_bad = d_stack.cums.clone()
        cum_bad[t0, max(int(d_stack.freqs[t0].argmax()), 1)] += 1
        bad_stack = rans.CoderTables(d_stack.freqs, cum_bad, d_stack.slot2sym, rk)
        rans_faults["rans_decode: a staged cum entry off by one"] = torch.equal(
            rans_decode_cuda(payload, n_w, offs, st, t_dd, bad_stack, CHUNK - G)[0], d_want[0])
        del bad, t_bad, payload, n_w, offs, st, t_dd, cum_bad, bad_stack
        # K8 at encode_all_levels' shape: the lossy delta stack, unpadded
        lossy_stack = rans.CoderTables(d_stack.freqs[:n_lossy * r_lanes, :cc.delta_alphabet].contiguous(),
                                       d_stack.cums[:n_lossy * r_lanes, :cc.delta_alphabet + 1].contiguous(),
                                       d_stack.slot2sym[:n_lossy * r_lanes], rk)
        t_l = torch.cat([r_idx + r_lanes * j for j in range(n_lossy)])
        l_syms = coder_symbols(lossy_stack, t_l, CHUNK - G, gen)
        l_got = rans_encode_cuda(l_syms, t_l, lossy_stack)
        l_want = rans_encode_plain(l_syms, t_l, lossy_stack)
        require(all(torch.equal(a, b) for a, b in zip(l_got, l_want)),
                "K8 differs from its plain version at encode_all_levels' lossy delta stack")
        tail = l_got[0].gather(1, l_got[1].long().clamp(max=CHUNK - G - 1)[:, None])
        require(bool((tail != 0).any()), "K8's unused tail holds no word: the case does not reach it")
        lane = int(l_want[1].argmax())  # one emitted word dropped: the lane's first, its count one less
        w_bad, n_bad = l_want[0].clone(), l_want[1].clone()
        w_bad[lane, :-1] = l_want[0][lane, 1:]
        n_bad[lane] -= 1
        rans_faults["rans_encode: one emitted word dropped"] = torch.equal(l_got[0], w_bad) and torch.equal(
            l_got[1], n_bad)
        t0 = int(t_l[0])
        cum_bad = lossy_stack.cums.clone()
        cum_bad[t0, max(int(lossy_stack.freqs[t0].argmax()), 1)] += 1
        rans_faults["rans_encode: a staged cum entry off by one"] = torch.equal(rans_encode_cuda(
            l_syms, t_l, rans.CoderTables(lossy_stack.freqs, cum_bad, lossy_stack.slot2sym, rk))[0], l_want[0])
        del w_bad, n_bad, cum_bad
        # ragged: a lane count no multiple of the block, n_sym = 1 (no lane
        # emits a word: an empty payload)
        small = coder_stack([(64, cc.delta_alphabet)], rk, dev, gen)
        t_r = torch.randint(0, 64, (r_lanes + 1,), generator=gen, device=dev, dtype=torch.int32)
        held_rans(small, t_r, coder_symbols(small, t_r, G, gen), "20,481 lanes")
        one = coder_symbols(small, t_r, 1, gen)
        _, n1, x1 = rans_encode_cuda(one, t_r, small)
        require(not n1.any(), "one symbol a lane emitted a word")
        zero = (torch.zeros((0,), dtype=torch.int16, device=dev), n1, torch.zeros_like(n1, dtype=torch.int64),
                rans.wire_bits(x1, 32, dev), t_r, small, 1)
        require(all(torch.equal(a, b) for a, b in zip(rans_decode_cuda(*zero), rans_decode_plain(*zero))),
                "K7 differs from its plain version on an empty payload")
        require(torch.equal(rans_decode_cuda(*zero)[0], one), "K7 does not invert K8 at n_sym = 1")
        del small, zero, one
        n_read = int(d_args[1].sum())
        d_bound, d_sector = rans_bound("decode", t_d.numel(), CHUNK - G, table_pairs(t_d, d_syms, d_stack.alphabet),
                                       n_read)
        a_bound, a_sector = rans_bound("decode", t_a.numel(), G, table_pairs(t_a, a_dec[0], anchor_stack.alphabet),
                                       int(a_args[1].sum()))
        l_bound, l_sector = rans_bound("encode", t_l.numel(), CHUNK - G, table_pairs(t_l, l_syms, lossy_stack.alphabet))
        report["rans_decode"] = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: rans_decode_cuda(*d_args), iters=5, warmup=1),
            device_ms=device_ms(lambda: rans_decode_cuda(*d_args), "rans_decode_kernel", iters=3),
            plain_ms=time_ms(lambda: rans_decode_plain(*d_args), iters=1, warmup=0),
            library_ms=None,
            bound=d_bound,
            sector_ms=d_sector,
            anchors_ms=time_ms(lambda: rans_decode_cuda(*a_args), iters=5, warmup=1),
            anchors_bound=a_bound,
            anchors_sector_ms=a_sector,
            info={f"A = {A}": rans_kernel_info("decode", A) for A in (d_stack.alphabet, anchor_stack.alphabet)},
            shape=f"a wave's deltas: {t_d.numel()} lanes x {CHUNK - G} steps over {d_stack.n_tables} padded tables "
                  f"(levels {list(wave_levels)}), {n_read} words; its anchors {t_a.numel()} x {G}; ragged and "
                  "2^31 cases",
        )
        report["rans_encode"] = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: rans_encode_cuda(l_syms, t_l, lossy_stack), iters=5, warmup=1),
            device_ms=device_ms(lambda: rans_encode_cuda(l_syms, t_l, lossy_stack), "rans_encode_kernel", iters=3),
            plain_ms=time_ms(lambda: rans_encode_plain(l_syms, t_l, lossy_stack), iters=1, warmup=0),
            library_ms=None,
            bound=l_bound,
            sector_ms=l_sector,
            info={f"A = {lossy_stack.alphabet}": rans_kernel_info("encode", lossy_stack.alphabet)},
            shape=f"encode_all_levels' lossy deltas: {t_l.numel()} lanes x {CHUNK - G} steps over "
                  f"{lossy_stack.n_tables} tables, {int(l_got[1].sum())} words",
        )
        # the wide kernels on the same wave and lossy stack (A = 509 and 255,
        # where the staged ones run): equal, and timed beside them
        require(all(torch.equal(a, b) for a, b in zip(rans_decode_wide_cuda(*d_args), d_want)),
                "the wide K7 differs from its plain version on the wave's deltas")
        require(all(torch.equal(a, b) for a, b in zip(rans_encode_wide_cuda(l_syms, t_l, lossy_stack), l_want)),
                "the wide K8 differs from its plain version on the lossy delta stack")
        wide_at_staged = dict(
            decode_ms=time_ms(lambda: rans_decode_wide_cuda(*d_args), iters=3, warmup=1),
            encode_ms=time_ms(lambda: rans_encode_wide_cuda(l_syms, t_l, lossy_stack), iters=3, warmup=1))
        del anchor_stack, d_stack, lossy_stack, a_args, a_dec, d_args, d_want, d_syms, l_syms, l_got, l_want
        # phase 10's qwen2-moe-a2.7b chunk: 24 x 2 x 2048 lanes, one table a lane
        qcfg = registry.get(MOE_ARCH)
        q_lanes = qcfg.n_layers * 2 * qcfg.n_kv_heads * qcfg.d_head
        qG = -(-MOE_CHUNK // g)
        q_idx = torch.arange(q_lanes, dtype=torch.int32, device=dev)
        q_anchor = coder_stack([(q_lanes, quant.ANCHOR_ALPHABET)] * 2, rk, dev, gen)
        qa_args, _, _ = held_rans(q_anchor, q_idx + q_lanes, coder_symbols(q_anchor, q_idx + q_lanes, qG, gen),
                                  f"{MOE_ARCH} anchors")
        qa_ms = time_ms(lambda: rans_decode_cuda(*qa_args), iters=5, warmup=1)
        del q_anchor, qa_args
        q_stack = coder_stack([(q_lanes, cc.delta_alphabet)] * n_lossy + [(q_lanes, quant.lossless_delta_alphabet())],
                              rk, dev, gen)
        q_t = q_idx + n_lossy * q_lanes  # level 0: the stack's last set
        require((int(q_t.max()) << rk) > 2.0e9, "the qwen2-moe case does not reach 2.0e9 slots")
        qd_args, _, qd_dec = held_rans(q_stack, q_t, coder_symbols(q_stack, q_t, MOE_CHUNK - qG, gen),
                                       f"{MOE_ARCH} deltas")
        qd_bound, qd_sector = rans_bound("decode", q_lanes, MOE_CHUNK - qG,
                                         table_pairs(q_t, qd_dec[0], q_stack.alphabet), int(qd_args[1].sum()))
        moe_rans = dict(
            lanes=q_lanes, anchors_ms=qa_ms, deltas_ms=time_ms(lambda: rans_decode_cuda(*qd_args), iters=5, warmup=1),
            deltas_bound=qd_bound, deltas_sector_ms=qd_sector,
            slots=(int(q_t.max()) + 1) << rk, words=int(qd_args[1].sum()))
        del q_stack, qd_args, qd_dec
        # the lane whose cum row starts past 2^31 bytes (the only table
        # offset the kernels compute): an alphabet-padded stack of 509
        # symbols (510 int64 cums a row) and 526,346 tables, 16 lossless ones
        # drawn at its start and 16 lossy ones (255 symbols, padded) at its
        # end, lanes at both
        la = quant.lossless_delta_alphabet()
        n_far = -(-(1 << 31) // ((la + 1) * 8)) + 1
        far = coder_stack([(16, la), (n_far - 16, cc.delta_alphabet)], rk, dev, gen,
                          fill=[(0, 16), (n_far - 16, n_far)])
        t_f = torch.randint(0, 16, (4096,), generator=gen, device=dev, dtype=torch.int32)
        t_f[1::2] += n_far - 16
        t_f[1] = n_far - 1
        require(int(t_f.max()) * (far.alphabet + 1) * 8 >= 1 << 31,
                "the far case's last cum row does not start past 2^31 bytes")
        held_rans(far, t_f, coder_symbols(far, t_f, 300, gen), "a cum row past 2^31 bytes")
        del far
        require(not any(rans_faults.values()), f"a planted rANS fault held equal: {rans_faults}")

        # The wide K7 and K8 (alphabets past the staged rows' caps), on tables
        # built on the card: the codec at delta_qmax 1023, a wave of 4 chunks
        # at levels 0-3 over its alphabet-padded 2,047-symbol decode stack
        # (81,920 lanes x 1,382 steps) and K8 over its lossy delta stack (4 x
        # 20,480 lanes); 4,096 = 2^12 symbols, and 16,384 = 2^14 at precision
        # 14 (every symbol one slot).  Planted faults, each changed in place
        # and put back: a word flipped, a lane's table off by one, a cum entry
        # off by one (K7 and K8), a lane's payload offset moved one word on
        # (K7), one emitted word dropped (K8).
        wcc = codec.CodecConfig(**WIDE_CODEC)
        wA = wcc.delta_alphabet
        w_stack = coder_stack([(r_lanes, wA)] * n_lossy + [(r_lanes, quant.lossless_delta_alphabet())], rk, dev, gen)
        w_syms = coder_symbols(w_stack, t_d, CHUNK - G, gen)
        w_args, _, w_want = held_rans(w_stack, t_d, w_syms, f"the wave over the {wA}-symbol decode stack")
        wide_faults = {}
        payload, n_w, offs, st, t_w = w_args[:5]
        lane = int(n_w.argmax())
        bad = payload.clone()
        bad[int(offs[lane]) + int(n_w[lane]) // 2] ^= 0x5A5A
        wide_faults["rans_decode_wide: one word flipped"] = torch.equal(
            rans_decode_wide_cuda(bad, *w_args[1:])[0], w_want[0])
        t_bad = t_w.clone()
        t_bad[0] += 1
        wide_faults["rans_decode_wide: table_idx off by one"] = torch.equal(
            rans_decode_wide_cuda(payload, n_w, offs, st, t_bad, *w_args[5:])[0], w_want[0])
        t0 = int(t_w[0])
        s_hot = max(int(w_stack.freqs[t0].argmax()), 1)
        w_stack.cums[t0, s_hot] += 1
        wide_faults["rans_decode_wide: a cum entry off by one"] = torch.equal(
            rans_decode_wide_cuda(*w_args)[0], w_want[0])
        w_stack.cums[t0, s_hot] -= 1
        o_bad = offs.clone()
        o_bad[lane] += 1  # the lane with the most words reads from one word on
        wide_faults["rans_decode_wide: a lane's payload offset moved"] = torch.equal(
            rans_decode_wide_cuda(payload, n_w, o_bad, *w_args[3:])[0], w_want[0])
        del bad, t_bad, o_bad, payload, n_w, offs, st, t_w
        n_wl = n_lossy * r_lanes
        wl_stack = rans.CoderTables(w_stack.freqs[:n_wl], w_stack.cums[:n_wl], w_stack.slot2sym[:n_wl], rk)
        wl_syms = coder_symbols(wl_stack, t_l, CHUNK - G, gen)
        wl_got = rans_encode_wide_cuda(wl_syms, t_l, wl_stack)
        wl_want = rans_encode_plain(wl_syms, t_l, wl_stack)
        require(all(torch.equal(a, b) for a, b in zip(wl_got, wl_want)),
                f"the wide K8 differs from its plain version at the {wA}-symbol lossy delta stack")
        lane = int(wl_want[1].argmax())
        w_bad, n_bad = wl_want[0].clone(), wl_want[1].clone()
        w_bad[lane, :-1] = wl_want[0][lane, 1:]
        n_bad[lane] -= 1
        wide_faults["rans_encode_wide: one emitted word dropped"] = torch.equal(wl_got[0], w_bad) and torch.equal(
            wl_got[1], n_bad)
        t0 = int(t_l[0])
        s_hot = max(int(wl_stack.freqs[t0].argmax()), 1)
        w_stack.cums[t0, s_hot] += 1
        wide_faults["rans_encode_wide: a cum entry off by one"] = torch.equal(
            rans_encode_wide_cuda(wl_syms, t_l, wl_stack)[0], wl_want[0])
        w_stack.cums[t0, s_hot] -= 1
        del w_bad, n_bad
        require(not any(wide_faults.values()), f"a planted fault of the wide kernels held equal: {wide_faults}")
        for A_, k_ in ((1 << 12, 12), (1 << 14, 14)):
            small = coder_stack([(64, A_)], k_, dev, gen)
            t_r = torch.randint(0, 64, (4096,), generator=gen, device=dev, dtype=torch.int32)
            held_rans(small, t_r, coder_symbols(small, t_r, 300, gen), f"A = {A_} at precision {k_}")
        del small, t_r
        n_read = int(w_args[1].sum())
        wd_bound, wd_sector = rans_bound("decode", t_d.numel(), CHUNK - G, table_pairs(t_d, w_syms, wA), n_read)
        we_bound, we_sector = rans_bound("encode", t_l.numel(), CHUNK - G, table_pairs(t_l, wl_syms, wA))
        report["rans_decode_wide"] = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: rans_decode_wide_cuda(*w_args), iters=3, warmup=1),
            device_ms=device_ms(lambda: rans_decode_wide_cuda(*w_args), "rans_decode_wide_kernel", iters=2),
            plain_ms=time_ms(lambda: rans_decode_plain(*w_args), iters=1, warmup=0),
            library_ms=None,
            bound=wd_bound,
            sector_ms=wd_sector,
            info={f"A = {wA}": rans_kernel_info("decode", wA, wide=True, precision=rk)},
            shape=f"a wave's deltas at delta_qmax {wcc.delta_qmax}: {t_d.numel()} lanes x {CHUNK - G} steps over "
                  f"{w_stack.n_tables} padded {wA}-symbol tables, {n_read} words; A = 4,096 and 16,384 (k 14) held",
        )
        report["rans_encode_wide"] = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: rans_encode_wide_cuda(wl_syms, t_l, wl_stack), iters=3, warmup=1),
            device_ms=device_ms(lambda: rans_encode_wide_cuda(wl_syms, t_l, wl_stack), "rans_encode_wide_kernel",
                                iters=2),
            plain_ms=time_ms(lambda: rans_encode_plain(wl_syms, t_l, wl_stack), iters=1, warmup=0),
            library_ms=None,
            bound=we_bound,
            sector_ms=we_sector,
            info={f"A = {wA}": rans_kernel_info("encode", wA, wide=True, precision=rk)},
            shape=f"encode_all_levels' lossy deltas at delta_qmax {wcc.delta_qmax}: {t_l.numel()} lanes x "
                  f"{CHUNK - G} steps over {wl_stack.n_tables} {wA}-symbol tables, {int(wl_got[1].sum())} words",
        )
        del w_stack, wl_stack, w_args, w_want, w_syms, wl_syms, wl_got, wl_want

        # phase 10's shapes, qwen2-moe-a2.7b (MHA, 16 heads of 128, C =
        # 2048): K1 and K2 over its four 768-token chunks, K3 over its 1-row
        # cache of 3105 slots (8 layer slices, 204 MB of K/V, so every
        # launch reads HBM) at the first generated token's kv_len, K4 over
        # its 3072-token prefill
        mcfg = registry.get(MOE_ARCH)
        mL, mH, mD = mcfg.n_layers, mcfg.n_heads, mcfg.d_head
        mC, mG = mcfg.n_kv_heads * mD, -(-MOE_CHUNK // g)
        moe_report = {}
        (d, a, bins), _, e1 = k1_case(4 * mL * 2, mG, torch.bfloat16, Cc=mC)
        B = d.shape[0]
        moe_report["kv_dequant_tokens"] = dict(
            max_abs_err=e1,
            ms=time_ms(lambda: kv_dequant_tokens_cuda(d, a, bins, qmax=127, out_dtype=torch.bfloat16)),
            device_ms=device_ms(lambda: kv_dequant_tokens_cuda(d, a, bins, qmax=127, out_dtype=torch.bfloat16),
                                "dequant_tokens_kernel"),
            plain_ms=time_ms(lambda: kv_dequant_tokens_plain(d, a, bins, qmax=127, out_dtype=torch.bfloat16)),
            library_ms=None,
            bound=bound(d.numel() * 2 + a.numel() * 4 + B * 4 + B * mG * g * mC * 2, 3 * d.numel()),
            shape=f"d_sym {tuple(d.shape)} uint16 -> bf16",
        )
        (d, a, s2), e1 = k2_case(4 * mL * 2, mG, torch.bfloat16, Cc=mC)
        moe_report["kv_lossless_tokens"] = dict(
            max_abs_err=e1,
            ms=time_ms(lambda: kv_lossless_tokens_cuda(d, a, s2, out_dtype=torch.bfloat16)),
            device_ms=device_ms(lambda: kv_lossless_tokens_cuda(d, a, s2, out_dtype=torch.bfloat16),
                                "lossless_tokens_kernel"),
            plain_ms=time_ms(lambda: kv_lossless_tokens_plain(d, a, s2, out_dtype=torch.bfloat16)),
            library_ms=None,
            bound=bound(d.numel() * 2 + a.numel() * 2 + s2.numel() * 4 + B * mG * g * mC * 2,
                        2 * a.numel() + 3 * d.numel()),
            shape=f"d_sym {tuple(d.shape)} uint16 -> bf16",
        )
        del d, a, bins, s2
        m_cap = MOE_CTX + GEN_TOKENS + 1
        mk, mv, mq = randn(8, 1, m_cap, mH, mD), randn(8, 1, m_cap, mH, mD), randn(1, mH, mD)
        m_lens = torch.tensor([MOE_CTX + 1], dtype=torch.int32, device=dev)
        got = decode_attention_cuda(mq, mk[0], mv[0], m_lens)
        want = decode_attention_plain(mq.float(), mk[0].float(), mv[0].float(), m_lens)
        x = ops.bf16_ulp_excess(got, want, **tol3)
        require(x <= 1, f"K3 at the moe shape is {x:.3g} times its tolerance off its plain version")
        excess["decode_attention"] = max(excess["decode_attention"], x)
        m_it = itertools.count()

        def mk3():
            i = next(m_it) % 8
            return decode_attention_cuda(mq, mk[i], mv[i], m_lens)

        def mk3_lib():
            i = next(m_it) % 8
            mask = (torch.arange(m_cap, device=dev)[None, :] < m_lens[:, None])[:, None, None, :]
            return sdpa(mq[:, :, None], mk[i].transpose(1, 2), mv[i].transpose(1, 2), attn_mask=mask)

        n_tok = MOE_CTX + 1
        moe_report["decode_attention"] = dict(
            max_abs_err=(got.float() - want).abs().max().item(),
            ms=time_ms(mk3, iters=40),
            device_ms=device_ms(mk3, "decode_split_kernel", "decode_combine_kernel", iters=16),
            plain_ms=time_ms(lambda: decode_attention_plain(mq, mk[0], mv[0], m_lens)),
            library_ms=time_ms(mk3_lib, iters=40),
            bound=bound(mq.numel() * 2 * 2 + n_tok * mH * mD * 2 * 2 + 4, 4 * mH * mD * n_tok),
            shape=f"q {tuple(mq.shape)} vs cache {tuple(mk[0].shape)} bf16, kv_len {m_lens.tolist()}, "
                  f"split {split_size(m_cap, 1, mH, torch.cuda.get_device_properties(dev).multi_processor_count)}",
        )
        del mk, mv
        (mqq, mkk, mvv), _, e1 = k4_case(1, MOE_CTX, heads=(mH, mcfg.n_kv_heads, mD))
        moe_report["flash_attention"] = dict(
            max_abs_err=e1,
            plain_ms=time_ms(lambda: flash_attention_plain(mqq, mkk, mvv), iters=3, warmup=1),
            shape=f"q/k/v {tuple(mqq.shape)} bf16 causal",
            **k4_timing(mqq, mkk, mvv),
        )
        del mqq, mkk, mvv

        # phase 11's shapes, paligemma-3b (MQA 8:1, head dim 256, 256 image
        # rows before a 3072-token context): K4 over its prefix-LM prefill
        # and a B = 2 ragged case with one prefix and one causal row; K3 over
        # its 1-row cache of 3361 slots (8 layer slices, 27 MB of K/V, read
        # from HBM in turns) at the first generated token's kv_len and a
        # 4-row ragged case; an f32 case of each, timed (no main path sends
        # f32).  Planted faults of the prefix mask must fail K4's rule.
        vcfg = registry.get(VLM_ARCH)
        vH, vKV, vD, vP = vcfg.n_heads, vcfg.n_kv_heads, vcfg.d_head, vcfg.n_prefix_tokens
        v_rows = vP + VLM_CTX
        vlm_report = {}
        (vqq, vkk, vvv), (want, mag), e1 = k4_case(1, v_rows, [vP], heads=(vH, vKV, vD))
        # the prefix one key short (query rows below it lose key vP - 1) and
        # the prefix ignored (plain causal: image rows lose the later image
        # keys)
        vq, vk, vv = vqq.float(), vkk.float(), vvv.float()
        short = torch.tensor([vP - 1], dtype=torch.int32, device=dev)
        controls["flash_attention at D = 256"] = {
            name: ops.bf16_ulp_excess(f.bfloat16(), want, scale=mag, **tol4)
            for name, f in (("prefix one key short", flash_attention_plain(vq, vk, vv, short)),
                            ("prefix ignored", flash_attention_plain(vq, vk, vv)))}
        require(min(controls["flash_attention at D = 256"].values()) > 1,
                f"K4's rule misses a planted prefix fault: {controls['flash_attention at D = 256']}")
        del want, mag, vq, vk, vv
        _, _, e2 = k4_case(2, VLM_CTX - 72, [vP, 0], heads=(vH, vKV, vD))
        vprefix = torch.tensor([vP], dtype=torch.int32, device=dev)
        vq32, vk32, vv32 = vqq.float(), vkk.float(), vvv.float()
        got = flash_attention_cuda(vq32, vk32, vv32, vprefix)
        e32 = (got - flash_attention_plain(vq32, vk32, vv32, vprefix)).abs().max().item()
        require(e32 <= 1e-4, f"K4 f32 at D = 256 is {e32} off its plain version")
        n_pairs = v_rows * (v_rows + 1) // 2 + vP * (vP - 1) // 2  # causal pairs and the prefix's extra ones
        vlm_report["flash_attention"] = dict(
            max_abs_err=max(e1, e2),
            ms=time_ms(lambda: flash_attention_cuda(vqq, vkk, vvv, vprefix)),
            device_ms=device_ms(lambda: flash_attention_cuda(vqq, vkk, vvv, vprefix), "flash_tc_kernel"),
            plain_ms=time_ms(lambda: flash_attention_plain(vqq, vkk, vvv, vprefix), iters=3, warmup=1),
            library_ms=time_ms(lambda: sdpa(vqq.transpose(1, 2), vkk.transpose(1, 2), vvv.transpose(1, 2),
                                            is_causal=True, enable_gqa=True)) if gqa_ok else None,
            bound=bound((vqq.numel() * 2 + vkk.numel() + vvv.numel()) * 2, 4 * vD * vH * n_pairs),
            f32_ms=time_ms(lambda: flash_attention_cuda(vq32, vk32, vv32, vprefix), iters=3, warmup=1),
            shape=f"q {tuple(vqq.shape)} k/v {tuple(vkk.shape)} bf16 causal, prefix {vP}; B = 2 ragged "
                  f"T = {VLM_CTX - 72} with prefixes [{vP}, 0]; f32 {e32:.3g} off (library: causal SDPA, no prefix)",
        )
        del vqq, vkk, vvv, vq32, vk32, vv32
        v_cap = v_rows + GEN_TOKENS + 1
        vk_c, vv_c, vq_d = randn(8, 1, v_cap, vKV, vD), randn(8, 1, v_cap, vKV, vD), randn(1, vH, vD)
        v_lens = torch.tensor([v_rows + 1], dtype=torch.int32, device=dev)
        err_v3 = 0.0
        cases = [(vq_d, vk_c[0], vv_c[0], v_lens)]
        rag_k, rag_v, rag_q = randn(4, v_cap, vKV, vD), randn(4, v_cap, vKV, vD), randn(4, vH, vD)
        cases.append((rag_q, rag_k, rag_v, torch.tensor([v_rows + 1, 0, TILE + 1, v_cap], dtype=torch.int32,
                                                        device=dev)))
        for cq, ck, cv, cl in cases:
            got = decode_attention_cuda(cq, ck, cv, cl)
            want = decode_attention_plain(cq.float(), ck.float(), cv.float(), cl)
            require(not got[cl == 0].float().any(), "K3 at D = 256: a row with kv_len 0 must output 0")
            x = ops.bf16_ulp_excess(got, want, **tol3)
            require(x <= 1, f"K3 at D = 256 is {x:.3g} times its tolerance off its plain version")
            excess["decode_attention"] = max(excess["decode_attention"], x)
            err_v3 = max(err_v3, (got.float() - want).abs().max().item())
        del rag_k, rag_v, rag_q
        vk32_c, vv32_c, vq32_d = vk_c[0].float(), vv_c[0].float(), vq_d.float()
        e32 = (decode_attention_cuda(vq32_d, vk32_c, vv32_c, v_lens)
               - decode_attention_plain(vq32_d, vk32_c, vv32_c, v_lens)).abs().max().item()
        require(e32 <= 1e-4, f"K3 f32 at D = 256 is {e32} off its plain version")
        v_it = itertools.count()

        def vk3():
            i = next(v_it) % 8
            return decode_attention_cuda(vq_d, vk_c[i], vv_c[i], v_lens)

        def vk3_lib():
            i = next(v_it) % 8
            mask = (torch.arange(v_cap, device=dev)[None, :] < v_lens[:, None])[:, None, None, :]
            return sdpa(vq_d[:, :, None], vk_c[i].transpose(1, 2), vv_c[i].transpose(1, 2), attn_mask=mask,
                        enable_gqa=True)

        n_tok = v_rows + 1
        vlm_report["decode_attention"] = dict(
            max_abs_err=err_v3,
            ms=time_ms(vk3, iters=40),
            device_ms=device_ms(vk3, "decode_split_kernel", "decode_combine_kernel", iters=16),
            plain_ms=time_ms(lambda: decode_attention_plain(vq_d, vk_c[0], vv_c[0], v_lens)),
            library_ms=time_ms(vk3_lib, iters=40) if gqa_ok else None,
            bound=bound(vq_d.numel() * 2 * 2 + n_tok * vKV * vD * 2 * 2 + 4, 4 * vH * vD * n_tok),
            f32_ms=time_ms(lambda: decode_attention_cuda(vq32_d, vk32_c, vv32_c, v_lens), iters=40),
            shape=f"q {tuple(vq_d.shape)} vs cache {tuple(vk_c[0].shape)} bf16, kv_len {v_lens.tolist()}, "
                  f"split {split_size(v_cap, 1, vKV, torch.cuda.get_device_properties(dev).multi_processor_count)}; "
                  f"4 ragged rows; f32 {e32:.3g} off",
        )
        del vk_c, vv_c, vk32_c, vv32_c

        # phase 12's shapes, zamba2-2.7b's shared attention (MHA, 32 heads
        # of 80: the kernels' column pairs and padded panel): K4 over its
        # 3072-token causal prefill and a B = 2 ragged case; K3 over its
        # 1-row cache of 3104 slots (8 layer slices, 254 MB of K/V, read from
        # HBM in turns) at the first generated token's kv_len and 4 ragged
        # rows; an f32 case of each, timed.  Planted fault: the output's
        # columns 64-79 zeroed (what lanes owning D / 32 columns would drop).
        hcfg = registry.get(HYBRID_ARCH)
        hH, hKV, hD = hcfg.n_heads, hcfg.n_kv_heads, hcfg.d_head
        hybrid_report = {}
        (hqq, hkk, hvv), (want, mag), e1 = k4_case(1, SSM_CTX, heads=(hH, hKV, hD))
        tail_zeroed = want.clone()
        tail_zeroed[..., 64:] = 0
        controls[f"flash_attention at D = {hD}"] = {
            "columns 64-79 zeroed": ops.bf16_ulp_excess(tail_zeroed.bfloat16(), want, scale=mag, **tol4)}
        del want, mag, tail_zeroed
        _, _, e2 = k4_case(2, SSM_CTX - 72, heads=(hH, hKV, hD))
        hq32, hk32, hv32 = hqq.float(), hkk.float(), hvv.float()
        e32 = (flash_attention_cuda(hq32, hk32, hv32) - flash_attention_plain(hq32, hk32, hv32)).abs().max().item()
        require(e32 <= 1e-4, f"K4 f32 at D = {hD} is {e32} off its plain version")
        hybrid_report["flash_attention"] = dict(
            max_abs_err=max(e1, e2),
            plain_ms=time_ms(lambda: flash_attention_plain(hqq, hkk, hvv), iters=3, warmup=1),
            f32_ms=time_ms(lambda: flash_attention_cuda(hq32, hk32, hv32), iters=3, warmup=1),
            shape=f"q/k/v {tuple(hqq.shape)} bf16 causal; B = 2 ragged T = {SSM_CTX - 72}; f32 {e32:.3g} off",
            **k4_timing(hqq, hkk, hvv),
        )
        del hqq, hkk, hvv, hq32, hk32, hv32
        h_cap = SSM_CTX + GEN_TOKENS
        hk_c, hv_c, hq_d = randn(8, 1, h_cap, hKV, hD), randn(8, 1, h_cap, hKV, hD), randn(1, hH, hD)
        h_lens = torch.tensor([SSM_CTX + 1], dtype=torch.int32, device=dev)
        err_h3 = 0.0
        rag_k, rag_v, rag_q = randn(4, h_cap, hKV, hD), randn(4, h_cap, hKV, hD), randn(4, hH, hD)
        cases = [(hq_d, hk_c[0], hv_c[0], h_lens),
                 (rag_q, rag_k, rag_v, torch.tensor([SSM_CTX + 1, 0, TILE + 1, h_cap], dtype=torch.int32,
                                                    device=dev))]
        for cq, ck, cv, cl in cases:
            got = decode_attention_cuda(cq, ck, cv, cl)
            want = decode_attention_plain(cq.float(), ck.float(), cv.float(), cl)
            require(not got[cl == 0].float().any(), f"K3 at D = {hD}: a row with kv_len 0 must output 0")
            x = ops.bf16_ulp_excess(got, want, **tol3)
            require(x <= 1, f"K3 at D = {hD} is {x:.3g} times its tolerance off its plain version")
            excess["decode_attention"] = max(excess["decode_attention"], x)
            err_h3 = max(err_h3, (got.float() - want).abs().max().item())
        tail_zeroed = want.clone()
        tail_zeroed[..., 64:] = 0
        controls[f"decode_attention at D = {hD}"] = {
            "columns 64-79 zeroed": ops.bf16_ulp_excess(tail_zeroed.bfloat16(), want, **tol3)}
        del rag_k, rag_v, rag_q, tail_zeroed
        hk32_c, hv32_c, hq32_d = hk_c[0].float(), hv_c[0].float(), hq_d.float()
        e32 = (decode_attention_cuda(hq32_d, hk32_c, hv32_c, h_lens)
               - decode_attention_plain(hq32_d, hk32_c, hv32_c, h_lens)).abs().max().item()
        require(e32 <= 1e-4, f"K3 f32 at D = {hD} is {e32} off its plain version")
        h_it = itertools.count()

        def hk3():
            i = next(h_it) % 8
            return decode_attention_cuda(hq_d, hk_c[i], hv_c[i], h_lens)

        def hk3_lib():
            i = next(h_it) % 8
            mask = (torch.arange(h_cap, device=dev)[None, :] < h_lens[:, None])[:, None, None, :]
            return sdpa(hq_d[:, :, None], hk_c[i].transpose(1, 2), hv_c[i].transpose(1, 2), attn_mask=mask)

        n_tok = SSM_CTX + 1
        hybrid_report["decode_attention"] = dict(
            max_abs_err=err_h3,
            ms=time_ms(hk3, iters=40),
            device_ms=device_ms(hk3, "decode_split_kernel", "decode_combine_kernel", iters=16),
            plain_ms=time_ms(lambda: decode_attention_plain(hq_d, hk_c[0], hv_c[0], h_lens)),
            library_ms=time_ms(hk3_lib, iters=40),
            bound=bound(hq_d.numel() * 2 * 2 + n_tok * hKV * hD * 2 * 2 + 4, 4 * hH * hD * n_tok),
            f32_ms=time_ms(lambda: decode_attention_cuda(hq32_d, hk32_c, hv32_c, h_lens), iters=40),
            shape=f"q {tuple(hq_d.shape)} vs cache {tuple(hk_c[0].shape)} bf16, kv_len {h_lens.tolist()}, "
                  f"split {split_size(h_cap, 1, hKV, torch.cuda.get_device_properties(dev).multi_processor_count)}; "
                  f"4 ragged rows; f32 {e32:.3g} off",
        )
        del hk_c, hv_c, hk32_c, hv32_c
        for name in (f"flash_attention at D = {hD}", f"decode_attention at D = {hD}"):
            require(min(controls[name].values()) > 1, f"{name}: the rule misses a planted fault: {controls[name]}")

        # phase 13's shapes, seamless-m4t-large-v2 (MHA, 16 heads of 64: one
        # query head a KV head): K4 over its encoder's bidirectional
        # self-attention, 2 rows of 3072 frames, and a ragged 2 x 3000 (the
        # last key tile masked at key >= Tk), f32 timed; its decoder's causal
        # 2 x 1024 prompt; K3 over its decoder's 2-row cache of 1056 slots
        # (8 layer slices, 69 MB of K/V, read from HBM in turns) at the first
        # and the last generated token's kv_len, 4 ragged rows, f32 timed.
        # Planted faults of the bidirectional path: the last 64 query rows
        # skip the 32-key tile at 1024, a causal mask applied; in the ragged
        # case the last tile's keys up to the next 64 read past Tk (the next
        # row's first keys, zeros after the last row), and that tile dropped;
        # K3's: kv_len one short, and the ragged last tile dropped.
        ecfg = registry.get(ENCDEC_ARCH)
        eH, eKV, eD = ecfg.n_heads, ecfg.n_kv_heads, ecfg.d_head
        encdec_report = {}
        drop = lambda x: torch.cat([x[:, :1024], x[:, 1024 + 32:]], dim=1).float()  # noqa: E731
        (eqq, ekk, evv), (want, mag), e1 = k4_case(ENCDEC_BATCH, ENCDEC_SRC, heads=(eH, eKV, eD), causal=False)
        eq, ek, ev = eqq.float(), ekk.float(), evv.float()
        skipped = want.clone()
        skipped[:, -64:] = flash_attention_plain(eq[:, -64:], drop(ekk), drop(evv), causal=False)
        faults = {"tile skipped": skipped, "causal mask applied": flash_attention_plain(eq, ek, ev)}
        (rq, rk, rv), (rwant, rmag), e2 = k4_case(ENCDEC_BATCH, ENCDEC_SRC - 72, heads=(eH, eKV, eD), causal=False)
        n_pad, n_full = -(ENCDEC_SRC - 72) % 64, (ENCDEC_SRC - 72) // 64 * 64

        def past(x):  # each row's keys followed by the next row's first n_pad keys
            nxt = torch.cat([x[1:, :n_pad], x.new_zeros(1, n_pad, *x.shape[2:])])
            return torch.cat([x, nxt], dim=1).float()

        controls["flash_attention bidirectional"] = {
            name: ops.bf16_ulp_excess(f.bfloat16(), want, scale=mag, **tol4) for name, f in faults.items()}
        for name, (fk, fv) in ((f"{n_pad} keys past Tk seen", (past(rk), past(rv))),
                               ("ragged last tile dropped", (rk[:, :n_full].float(), rv[:, :n_full].float()))):
            controls["flash_attention bidirectional"][name] = ops.bf16_ulp_excess(
                flash_attention_plain(rq.float(), fk, fv, causal=False).bfloat16(), rwant, scale=rmag, **tol4)
        del want, mag, skipped, faults, rq, rk, rv, rwant, rmag
        _, _, e3 = k4_case(ENCDEC_BATCH, ENCDEC_PROMPT, heads=(eH, eKV, eD))
        e32 = (flash_attention_cuda(eq, ek, ev, causal=False)
               - flash_attention_plain(eq, ek, ev, causal=False)).abs().max().item()
        require(e32 <= 1e-4, f"K4 f32 bidirectional is {e32} off its plain version")
        encdec_report["flash_attention"] = dict(
            max_abs_err=max(e1, e2, e3),
            plain_ms=time_ms(lambda: flash_attention_plain(eqq, ekk, evv, causal=False), iters=3, warmup=1),
            f32_ms=time_ms(lambda: flash_attention_cuda(eq, ek, ev, causal=False), iters=3, warmup=1),
            shape=f"q/k/v {tuple(eqq.shape)} bf16 bidirectional; B = 2 ragged T = {ENCDEC_SRC - 72}; the decoder's "
                  f"({ENCDEC_BATCH},{ENCDEC_PROMPT},{eH},{eD}) causal; f32 {e32:.3g} off (library: SDPA, is_causal=False)",
            **k4_timing(eqq, ekk, evv, causal=False),
        )
        del eqq, ekk, evv, eq, ek, ev
        e_cap = ENCDEC_PROMPT + GEN_TOKENS
        ek_c, ev_c = randn(8, ENCDEC_BATCH, e_cap, eKV, eD), randn(8, ENCDEC_BATCH, e_cap, eKV, eD)
        eq_d = randn(ENCDEC_BATCH, eH, eD)
        e_lens = torch.tensor([ENCDEC_PROMPT + 1, e_cap], dtype=torch.int32, device=dev)
        err_e3 = 0.0
        rag_k, rag_v, rag_q = randn(4, e_cap, eKV, eD), randn(4, e_cap, eKV, eD), randn(4, eH, eD)
        cases = [(rag_q, rag_k, rag_v, torch.tensor([ENCDEC_PROMPT + 1, 0, TILE + 1, e_cap], dtype=torch.int32,
                                                    device=dev)),
                 (eq_d, ek_c[0], ev_c[0], e_lens)]
        for cq, ck, cv, cl in cases:
            got = decode_attention_cuda(cq, ck, cv, cl)
            want = decode_attention_plain(cq.float(), ck.float(), cv.float(), cl)
            require(not got[cl == 0].float().any(), "K3 at MHA 16 x 64: a row with kv_len 0 must output 0")
            x = ops.bf16_ulp_excess(got, want, **tol3)
            require(x <= 1, f"K3 at MHA 16 x 64 is {x:.3g} times its tolerance off its plain version")
            excess["decode_attention"] = max(excess["decode_attention"], x)
            err_e3 = max(err_e3, (got.float() - want).abs().max().item())
        ekf, evf = ek_c[0].float(), ev_c[0].float()  # want is the main lengths'
        controls["decode_attention at MHA 16 x 64"] = {
            name: ops.bf16_ulp_excess(decode_attention_plain(eq_d.float(), ekf, evf, lens).bfloat16(), want, **tol3)
            for name, lens in (("kv_len - 1", e_lens - 1), ("last tile dropped", e_lens // TILE * TILE))}
        del rag_k, rag_v, rag_q
        eq32_d = eq_d.float()
        e32 = (decode_attention_cuda(eq32_d, ekf, evf, e_lens)
               - decode_attention_plain(eq32_d, ekf, evf, e_lens)).abs().max().item()
        require(e32 <= 1e-4, f"K3 f32 at MHA 16 x 64 is {e32} off its plain version")
        e_it = itertools.count()

        def ek3():
            i = next(e_it) % 8
            return decode_attention_cuda(eq_d, ek_c[i], ev_c[i], e_lens)

        def ek3_lib():
            i = next(e_it) % 8
            mask = (torch.arange(e_cap, device=dev)[None, :] < e_lens[:, None])[:, None, None, :]
            return sdpa(eq_d[:, :, None], ek_c[i].transpose(1, 2), ev_c[i].transpose(1, 2), attn_mask=mask)

        n_tok = int(e_lens.sum())
        encdec_report["decode_attention"] = dict(
            max_abs_err=err_e3,
            ms=time_ms(ek3, iters=40),
            device_ms=device_ms(ek3, "decode_split_kernel", "decode_combine_kernel", iters=16),
            plain_ms=time_ms(lambda: decode_attention_plain(eq_d, ek_c[0], ev_c[0], e_lens)),
            library_ms=time_ms(ek3_lib, iters=40),
            bound=bound(eq_d.numel() * 2 * 2 + n_tok * eKV * eD * 2 * 2 + ENCDEC_BATCH * 4, 4 * eH * eD * n_tok),
            f32_ms=time_ms(lambda: decode_attention_cuda(eq32_d, ekf, evf, e_lens), iters=40),
            shape=f"q {tuple(eq_d.shape)} vs cache {tuple(ek_c[0].shape)} bf16, kv_len {e_lens.tolist()}, split "
                  f"{split_size(e_cap, ENCDEC_BATCH, eKV, torch.cuda.get_device_properties(dev).multi_processor_count)}"
                  f"; 4 ragged rows; f32 {e32:.3g} off",
        )
        del ek_c, ev_c, ekf, evf
        for name in ("flash_attention bidirectional", "decode_attention at MHA 16 x 64"):
            require(min(controls[name].values()) > 1, f"{name}: the rule misses a planted fault: {controls[name]}")

        # the reference's whole attention domain: K3 and K4 at Phi-3-mini's
        # attention (MHA 32 x 96, on the plan of 128: 96 columns loaded, the
        # rest zeros), K3 at Falcon-7B's (71 query heads on one KV head: 5
        # groups of at most 16, each reading the head's K/V again) and at 32:1
        # (2 groups), and both at head dims 48 (the plan of 64), 96 and 100 (of
        # 128; 100 has no whole 16-byte chunks in bf16: the element loads),
        # 160 and 192 (of 256); each held to its plain version under BF16_TOL and timed
        # beside its bound and SDPA.  K3's caches are 8 layer slices, read
        # from HBM in turns.
        shapes_report = {}
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

        def k3_shape(what, B_, hq, hkv, dh, cap, lens_list):
            kc_, vc_, qd = randn(8, B_, cap, hkv, dh), randn(8, B_, cap, hkv, dh), randn(B_, hq, dh)
            lens_ = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            got = decode_attention_cuda(qd, kc_[0], vc_[0], lens_)
            want = decode_attention_plain(qd.float(), kc_[0].float(), vc_[0].float(), lens_)
            require(not got[lens_ == 0].float().any(), f"K3 {what}: a row with kv_len 0 must output 0")
            x = ops.bf16_ulp_excess(got, want, **tol3)
            require(x <= 1, f"K3 {what} is {x:.3g} times its tolerance off its plain version")
            excess["decode_attention"] = max(excess["decode_attention"], x)
            it_ = itertools.count()

            def run():
                i = next(it_) % 8
                return decode_attention_cuda(qd, kc_[i], vc_[i], lens_)

            def lib():
                i = next(it_) % 8
                mask = (torch.arange(cap, device=dev)[None, :] < lens_[:, None])[:, None, None, :]
                return sdpa(qd[:, :, None], kc_[i].transpose(1, 2), vc_[i].transpose(1, 2), attn_mask=mask,
                            enable_gqa=hq != hkv)

            n_tok = sum(min(n, cap) for n in lens_list)
            split_ = split_size(cap, B_, hkv, n_sm, dh)
            shapes_report[f"decode_attention {what}"] = dict(
                max_abs_err=(got.float() - want).abs().max().item(), excess=x,
                ms=time_ms(run, iters=20),
                device_ms=device_ms(run, "decode_wide_kernel" if dh > 256 else "decode_split_kernel",
                                    "decode_combine_kernel", iters=8),
                plain_ms=time_ms(lambda: decode_attention_plain(qd, kc_[0], vc_[0], lens_), iters=3, warmup=1),
                library_ms=time_ms(lib, iters=20) if gqa_ok or hq == hkv else None,
                bound=bound(qd.numel() * 2 * 2 + n_tok * hkv * dh * 2 * 2 + B_ * 4, 4 * hq * dh * n_tok),
                shape=f"q {tuple(qd.shape)} vs cache {tuple(kc_[0].shape)} bf16, kv_len {lens_list}, split {split_}",
                library_backend=sdpa_backends(lib) if dh > 256 else None,
            )

        def k4_shape(what, B_, T_, hq, hkv, dh, prefix=None):
            (qq_, kk_, vv_), (want, mag), err = k4_case(B_, T_, prefix, heads=(hq, hkv, dh))
            x = ops.bf16_ulp_excess(flash_attention_cuda(qq_, kk_, vv_, None if prefix is None else torch.tensor(
                prefix, dtype=torch.int32, device=dev)), want, scale=mag, **tol4)
            shapes_report[f"flash_attention {what}"] = dict(
                max_abs_err=err, excess=x,
                plain_ms=time_ms(lambda: flash_attention_plain(qq_, kk_, vv_), iters=2, warmup=1),
                shape=f"q {tuple(qq_.shape)} k/v {tuple(kk_.shape)} bf16 causal"
                      + (f", prefix {prefix} (timed without)" if prefix else ""),
                library_backend=sdpa_backends(lambda: sdpa(qq_.transpose(1, 2), kk_.transpose(1, 2),
                                                           vv_.transpose(1, 2), is_causal=True, enable_gqa=True))
                if dh > 256 else None,
                **k4_timing(qq_, kk_, vv_),
            )

        cap3 = SSM_CTX + GEN_TOKENS + 1
        k3_shape("Phi-3-mini MHA 32 x 96", 1, 32, 32, 96, cap3, [SSM_CTX + 1])
        k3_shape("Falcon-7B 71:1 x 64", 1, 71, 1, 64, cap3, [SSM_CTX + 1])
        k3_shape("32:1 x 64", 1, 32, 1, 64, cap3, [SSM_CTX + 1])
        k4_shape("Phi-3-mini MHA 32 x 96", 1, SSM_CTX, 32, 32, 96)
        for dh in SHAPE_HEAD_DIMS + WIDE_HEAD_DIMS:
            k3_shape(f"D = {dh}", 4, 8, 2, dh, 2080, [2049, 2080, TILE + 1, 0])
            k4_shape(f"D = {dh}", 1, 2048, 8, 2, dh, [256] if dh in (160, 300) else None)
        # past 256 at the main path's lengths: K4 over a 3,072-token prefill
        # with a 256-row prefix, K3 at 32:1 over a 3,106-slot cache
        k4_shape("D = 512, T = 3072", 1, SSM_CTX, 8, 2, 512, [256])
        k3_shape("32:1 x 512", 1, 32, 1, 512, cap3, [SSM_CTX + 1])

        # K4 under autograd at phase 14's training shape (smollm-360m, 8 rows
        # of 1,024 tokens, causal): the Function's forward (K4) and backward
        # (the plain version's VJP, one query chunk here), SDPA's forward +
        # backward on the same inputs with K/V expanded to the query heads
        # (the yardstick of a later hand-written backward), and the
        # Function's gradients against the f32 plain version's
        tq, tk, tv = randn(TRAIN_BATCH, TRAIN_SEQ, Hq, D), randn(TRAIN_BATCH, TRAIN_SEQ, Hkv, D), \
            randn(TRAIN_BATCH, TRAIN_SEQ, Hkv, D)
        tdo = randn(TRAIN_BATCH, TRAIN_SEQ, Hq, D)
        tgrads, tworst, terr = flash_grad_check(tq, tk, tv, tdo)
        require(tworst <= TRAIN_YARDSTICK, f"K4 under autograd: gradients {tworst:.3g}x the plain bf16 path's "
                f"distance from the f32 plain version's")
        del tgrads
        sq, sk, sv, sdo = (x.transpose(1, 2).contiguous() for x in
                           (tq, tk.repeat_interleave(Hq // Hkv, dim=2), tv.repeat_interleave(Hq // Hkv, dim=2), tdo))
        sleaves = [x.detach().requires_grad_() for x in (sq, sk, sv)]

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(*sleaves, is_causal=True), sleaves, sdo)

        pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
        fwd_flops = TRAIN_BATCH * 4 * D * Hq * pairs
        train_k4 = dict(
            max_abs_err=terr, worst=tworst,
            ms=time_ms(lambda: flash_attention_cuda(tq, tk, tv)),
            device_ms=device_ms(lambda: flash_attention_cuda(tq, tk, tv), "flash_tc_kernel"),
            bwd_ms=time_ms(lambda: flash_attention_vjp(tq, tk, tv, None, tdo), iters=5, warmup=1),
            library_ms=time_ms(lambda: sdpa(sq, sk, sv, is_causal=True)),
            library_fwd_bwd_ms=time_ms(sdpa_fwd_bwd),
            # forward: each input read once, the output written once; backward:
            # q, k, v, dO read, dq, dk, dv written, five products (S again, dP,
            # dV, dQ, dK) to the forward's two
            bound=bound((tq.numel() * 2 + tk.numel() + tv.numel()) * 2, fwd_flops),
            bwd_bound=bound((tq.numel() * 4 + tk.numel() * 2 + tv.numel() * 2) * 2, fwd_flops * 5 // 2),
        )
        del tq, tk, tv, tdo, sq, sk, sv, sdo, sleaves
        require(t6["device_ms"] is not None, "the profiler holds no device time for K4 at the store shape")
        for name, r in report.items():
            require(r["device_ms"] is not None, f"the profiler holds no device time for {name}'s kernels")
            if name in controls:
                print(f"{name}: worst error {excess.get(name, 0.0):.3f} of the tolerance {ops.BF16_TOL[name]}; "
                      f"planted faults {controls[name]}")
            print(f"{name}: {r['shape']}  max_abs_err {r['max_abs_err']:.3g}  kernel {r['ms']:.4f} ms  "
                  f"(device time {r['device_ms']} ms)  "
                  f"plain {r['plain_ms']:.4f} ms  library {r['library_ms']}  "
                  f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}, {r['bound'][0] / r['ms']:.1%} of it reached)")
        for name in ("rans_decode", "rans_encode", "rans_decode_wide", "rans_encode_wide"):
            r = report[name]
            print(f"{name}: at one 32-byte sector a table gather {r['sector_ms']:.4f} ms "
                  f"({r['sector_ms'] / r['ms']:.1%} of the kernel ms; no bound)")
            print(f"{name}: registers, shared memory a block, blocks an SM, lanes a block: {r['info']}")
        r = report["rans_decode"]
        print(f"rans_decode: the wave's anchors {r['anchors_ms']:.4f} ms (bound {r['anchors_bound'][0]:.4f} ms "
              f"({r['anchors_bound'][1]}), sector time {r['anchors_sector_ms']:.4f} ms); "
              f"{MOE_ARCH}'s chunk of {MOE_CHUNK} tokens ({moe_rans['lanes']} lanes): anchors "
              f"{moe_rans['anchors_ms']:.4f} ms, deltas {moe_rans['deltas_ms']:.4f} ms (bound "
              f"{moe_rans['deltas_bound'][0]:.4f} ms ({moe_rans['deltas_bound'][1]}), sector time "
              f"{moe_rans['deltas_sector_ms']:.4f} ms, {moe_rans['words']} words, tables to {moe_rans['slots']:.3g} "
              f"slots); a cum row past 2^31 bytes held; planted faults held equal: {rans_faults}")
        for name, r in moe_report.items():
            require(r["device_ms"] is not None, f"the profiler holds no device time for {name} at the moe shape")
            print(f"{name} at {MOE_ARCH}'s shape: {r['shape']}  max_abs_err {r['max_abs_err']:.3g}  kernel "
                  f"{r['ms']:.4f} ms  (device time {r['device_ms']} ms)  plain {r['plain_ms']:.4f} ms  library "
                  f"{r['library_ms']}  bound {r['bound'][0]:.4f} ms ({r['bound'][1]}, {r['bound'][0] / r['ms']:.1%} "
                  f"of it reached, {r['bound'][0] / r['device_ms']:.1%} of device time)")
        for name, r in vlm_report.items():
            require(r["device_ms"] is not None, f"the profiler holds no device time for {name} at the vlm shape")
            print(f"{name} at {VLM_ARCH}'s shape: {r['shape']}  max_abs_err {r['max_abs_err']:.3g}  kernel "
                  f"{r['ms']:.4f} ms  (device time {r['device_ms']} ms)  plain {r['plain_ms']:.4f} ms  library "
                  f"{r['library_ms']}  f32 kernel {r['f32_ms']:.4f} ms  bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]}, {r['bound'][0] / r['ms']:.1%} of it reached, "
                  f"{r['bound'][0] / r['device_ms']:.1%} of device time)")
        print(f"flash_attention at D = 256: planted faults {controls['flash_attention at D = 256']}")
        for name, r in hybrid_report.items():
            require(r["device_ms"] is not None, f"the profiler holds no device time for {name} at the hybrid shape")
            print(f"{name} at {HYBRID_ARCH}'s shape: {r['shape']}  max_abs_err {r['max_abs_err']:.3g}  kernel "
                  f"{r['ms']:.4f} ms  (device time {r['device_ms']} ms)  plain {r['plain_ms']:.4f} ms  library "
                  f"{r['library_ms']}  f32 kernel {r['f32_ms']:.4f} ms  bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]}, {r['bound'][0] / r['ms']:.1%} of it reached, "
                  f"{r['bound'][0] / r['device_ms']:.1%} of device time)")
            print(f"{name} at D = {hD}: planted faults {controls[f'{name} at D = {hD}']}")
        for name, r in encdec_report.items():
            require(r["device_ms"] is not None, f"the profiler holds no device time for {name} at the encdec shape")
            print(f"{name} at {ENCDEC_ARCH}'s shape: {r['shape']}  max_abs_err {r['max_abs_err']:.3g}  kernel "
                  f"{r['ms']:.4f} ms  (device time {r['device_ms']} ms)  plain {r['plain_ms']:.4f} ms  library "
                  f"{r['library_ms']}  f32 kernel {r['f32_ms']:.4f} ms  bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]}, {r['bound'][0] / r['ms']:.1%} of it reached, "
                  f"{r['bound'][0] / r['device_ms']:.1%} of device time)")
        for name in ("flash_attention bidirectional", "decode_attention at MHA 16 x 64"):
            print(f"{name}: planted faults {controls[name]}")
        print(f"rans_decode_wide / rans_encode_wide at the staged kernels' inputs (the wave's A = 509 deltas, the "
              f"lossy A = 255 stack): {wide_at_staged['decode_ms']:.4f} / {wide_at_staged['encode_ms']:.4f} ms "
              f"(staged {report['rans_decode']['ms']:.4f} / {report['rans_encode']['ms']:.4f}); planted faults "
              f"held equal: {wide_faults}")
        for name, r in shapes_report.items():
            require(r["device_ms"] is not None, f"the profiler holds no device time for {name}")
            print(f"{name}: {r['shape']}  max_abs_err {r['max_abs_err']:.3g} ({r['excess']:.3f} of its rule)  "
                  f"kernel {r['ms']:.4f} ms  (device time {r['device_ms']} ms)  plain {r['plain_ms']:.4f} ms  "
                  f"library {r['library_ms']}"
                  + (f" (SDPA's backends that take it: {r['library_backend']})" if r["library_backend"] else "")
                  + f"  bound {r['bound'][0]:.4f} ms ({r['bound'][1]}, "
                  f"{r['bound'][0] / r['ms']:.1%} of it reached, {r['bound'][0] / r['device_ms']:.1%} of device time)")
        r = train_k4
        require(r["device_ms"] is not None, "the profiler holds no device time for K4 at the training shape")
        print(f"flash_attention under autograd at {TRAIN_ARCH}'s training shape: q ({TRAIN_BATCH},{TRAIN_SEQ},{Hq},{D}) "
              f"k/v ({TRAIN_BATCH},{TRAIN_SEQ},{Hkv},{D}) bf16 causal  forward (K4) {r['ms']:.4f} ms (device time "
              f"{r['device_ms']} ms, bound {r['bound'][0]:.4f} ms, {r['bound'][1]})  backward (the plain VJP) "
              f"{r['bwd_ms']:.4f} ms (bound {r['bwd_bound'][0]:.4f} ms)  SDPA forward {r['library_ms']:.4f} ms, "
              f"forward + backward {r['library_fwd_bwd_ms']:.4f} ms (K/V expanded to {Hq} heads)  gradients "
              f"max_abs_err {r['max_abs_err']:.3g} against the f32 plain version's, {r['worst']:.3g}x the plain "
              f"bf16 path's distance (rule {TRAIN_YARDSTICK}x)")
        del kc, vc

    # --------------------------------------------------------- 4 serve, 5 text
    ops.reset_launch_counts()
    served = drive_main_path(cfg, dev, gen, phase=lambda name: Phase(name, phase_ms))
    paths = {"serve + text": ops.launch_counts()}

    # --------------------------------------------------------------- 6 store
    ops.reset_launch_counts()
    stored = drive_store_path(cfg, dev, gen, served, phase=lambda name: Phase(name, phase_ms))
    paths["store"] = ops.launch_counts()

    # ---------------------------------------------- 19 wide codec (phase 4's weights)
    ops.reset_launch_counts()
    drive_wide_codec_path(cfg, dev, gen, served, phase=lambda name: Phase(name, phase_ms))
    paths["wide codec"] = ops.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- 20 shapes
    ops.reset_launch_counts()
    drive_shapes_path(dev, gen, phase=lambda name: Phase(name, phase_ms))
    paths["shapes"] = ops.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 7 session
    ops.reset_launch_counts()
    sessioned = drive_session_path(cfg, stored, phase=lambda name: Phase(name, phase_ms))
    paths["session"] = ops.launch_counts()

    # ------------------------------------------------------------- 8 serving
    ops.reset_launch_counts()
    served_rows = drive_serving_path(cfg, stored, sessioned, phase=lambda name: Phase(name, phase_ms))
    paths["serving"] = ops.launch_counts()

    # ------------------------------------------------------------ 9 launcher
    ops.reset_launch_counts()
    drive_launcher_path(dev, phase=lambda name: Phase(name, phase_ms))
    paths["launcher"] = ops.launch_counts()

    # ----------------------------------------- 15 mesh (on phases 6-8's state)
    ops.reset_launch_counts()
    drive_mesh_path(cfg, stored, served_rows, phase=lambda name: Phase(name, phase_ms), card=smi)
    paths["mesh"] = ops.launch_counts()

    # ----------------------------------------------------------------- 10 moe
    del served, stored, sessioned, served_rows
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    drive_moe_path(registry.get(MOE_ARCH), dev, gen, phase=lambda name: Phase(name, phase_ms),
                   pinned_ctx=MOE_PINNED_CTX)
    paths["moe"] = ops.launch_counts()
    # phases 17 and 18's host-only children run beside phases 11-16, after
    # the most host-bound ones (9, 15, 10)
    start_host_children(children)

    # ----------------------------------------------------------------- 11 vlm
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    drive_vlm_path(registry.get(VLM_ARCH), dev, gen, phase=lambda name: Phase(name, phase_ms))
    paths["vlm"] = ops.launch_counts()

    # ------------------------------------------------------ 12 ssm + hybrid
    for arch, path in ((SSM_ARCH, "ssm"), (HYBRID_ARCH, "hybrid")):
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        drive_recurrent_path(registry.get(arch), dev, gen, phase=lambda name: Phase(name, phase_ms))
        paths[path] = ops.launch_counts()

    # -------------------------------------------------------------- 13 encdec
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    drive_encdec_path(registry.get(ENCDEC_ARCH), dev, gen, phase=lambda name: Phase(name, phase_ms), card=smi)
    paths["encdec"] = ops.launch_counts()

    # --------------------------------------------------------------- 14 train
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    drive_train_path(registry.get(TRAIN_ARCH), dev, phase=lambda name: Phase(name, phase_ms), card=smi)
    paths["train"] = ops.launch_counts()
    ops.reset_launch_counts()
    drive_train_sweep(dev, phase=lambda name: Phase(name, phase_ms))
    paths["train sweep"] = ops.launch_counts()
    ops.reset_launch_counts()
    paths["train launcher"] = drive_train_launcher(dev, phase=lambda name: Phase(name, phase_ms))["launches"]
    require(ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0), "the train launcher launched in this process")

    # --------------------------------------------------------- 16 distributed
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    paths["distributed"] = drive_distributed_path(dev, phase=lambda name: Phase(name, phase_ms), card=smi)
    require(ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0),
            "the distributed path's single-process references were counted in this process")

    # ------------------------------------------------------------- 17 dryrun
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    start_examples(dev, children)  # phase 18's examples run beside phase 17 (each counts its own launches)
    paths["dryrun"] = drive_dryrun_path(dev, children, phase=lambda name: Phase(name, phase_ms), card=smi)

    # ----------------------------------------------------------- 18 examples
    paths["examples"] = drive_examples_path(dev, children, phase=lambda name: Phase(name, phase_ms), card=smi)
    require(ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0),
            "the dryrun and examples paths launched in this process")

    # --------------------------------------------------------------- summary
    runs = {"serve + text": ALL_KERNELS, "store": ALL_KERNELS, "wide codec": WIDE_CODEC_KERNELS,
            "shapes": SHAPES_KERNELS, "session": SESSION_KERNELS,
            "serving": SERVING_KERNELS, "launcher": LAUNCHER_KERNELS, "mesh": MESH_KERNELS, "moe": MOE_KERNELS, "vlm": VLM_KERNELS,
            "ssm": SSM_KERNELS, "hybrid": HYBRID_KERNELS, "encdec": ENCDEC_KERNELS, "train": TRAIN_KERNELS,
            "train sweep": TRAIN_KERNELS, "train launcher": TRAIN_KERNELS, "distributed": DIST_KERNELS,
            "dryrun": tuple(sorted(set(itertools.chain(*GROUND_KERNELS.values())))),
            "examples": tuple(sorted(set(itertools.chain(*EXAMPLE_KERNELS.values()))))}
    require(set().union(*runs.values()) == set(ops.KERNELS), "the paths do not cover every kernel")
    require(not any(paths["ssm"].values()), f"the attention-free ssm path launched kernels: {paths['ssm']}")
    for path, counts in paths.items():
        print(f"launches on the {path} path:", counts)
        for name in runs[path]:
            require(counts[name] > 0, f"kernel {name} was not launched on the {path} path")
    counts = {name: sum(c[name] for c in paths.values()) for name in ops.KERNELS}
    print("phase ms:", {k: round(v, 1) for k, v in phase_ms.items()})
    meta = {
        "kv_dequant_tokens": ("kvquant.cu", "src/repro/kernels/kvquant.py:116"),
        "kv_lossless_tokens": ("kvquant.cu", "src/repro/kernels/kvquant.py:166"),
        "decode_attention": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:85"),
        "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:109"),
        "kv_quant": ("kvquant.cu", "src/repro/kernels/kvquant.py:209"),
        "kv_dequant": ("kvquant.cu", "src/repro/kernels/kvquant.py:76"),
        "rans_decode": ("rans.cu", "src/repro/core/rans.py:110"),
        "rans_encode": ("rans.cu", "src/repro/core/rans.py:65"),
        "rans_decode_wide": ("rans.cu", "src/repro/core/rans.py:110"),
        "rans_encode_wide": ("rans.cu", "src/repro/core/rans.py:65"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"], "device_ms": r["device_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
