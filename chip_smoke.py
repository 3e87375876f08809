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
           B. ``serve.run --arch qwen2-moe-a2.7b --full-width --ctx-len 3072
              --check-sim`` three times, each freed before the next: a wave
              of ``--requests 4 --concurrency 4`` as the simulator decides,
              then waves of 2 pinned with ``--fixed-level 0`` and
              ``--fixed-level 1`` (level 0 and lossy chunks load through the
              launcher's batched decode); every request must make the
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

The kernels' launch counters are zeroed before phase 4 and read after phase
5, then zeroed before each of phases 6, 7, 8, 9, 10, 11, 12 A, 12 B and 13
and read after it; the run fails if a kernel that a path runs was not
launched in it (all six on the serve + text and store paths; K1, K2 and K3
on the session and serving paths; K1-K5 on the launcher, moe and vlm
paths; K3 and K4 on the hybrid and encdec paths), or if the ssm path
launched any.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels,
with launches summed over the paths.  Needs
one CUDA card; exits 2 with no result when there is none.
"""
import contextlib
import dataclasses
import gc
import itertools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import codec, quant  # noqa: E402
from repro_torch.kernels import _build, ops, timing  # noqa: E402
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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build, encdec, lm, mamba2, moe  # noqa: E402
from repro_torch.models.common import apply_norm  # noqa: E402
from repro_torch.models.lm import Caches  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.generation import GenerationSpec  # noqa: E402
from repro_torch.serving.kv_layout import caches_to_codec_kv  # noqa: E402
from repro_torch.serving.scheduler import ConcurrentScheduler, ContinuousScheduler, SessionRequest  # noqa: E402
from repro_torch.serving.session import ServeSession  # noqa: E402
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
ALL_KERNELS = tuple(ops.KERNELS)
SESSION_KERNELS = ("kv_dequant_tokens", "kv_lossless_tokens", "decode_attention")
SERVING_KERNELS = SESSION_KERNELS
LAUNCHER_KERNELS = SESSION_KERNELS + ("flash_attention", "kv_quant")
MOE_KERNELS = LAUNCHER_KERNELS  # the unfused K6 runs only in its checks
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
            "first": first, "fused_tokens": outs[0], "chunk": chunk}


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
    engine, streamer, tokens = stored["engine"], stored["streamer"], stored["tokens"]
    plan, chunk = stored["plan"], stored["chunk"]
    metas, n_ctx, cap = plan.metas, plan.metas[-1].end, engine.capacity
    clean = sessioned["clean"]
    first = int(stored["first"][0])
    k1_tol = ops.BF16_TOL["kv_dequant_tokens"]
    dev = engine.device

    def request(start_t=0.0, generation=None):
        session = ServeSession(streamer, engine, slo_s=SLO_S, decode_bytes_per_s=DECODE_BYTES_PER_S,
                               recompute_s=lambda n, p: RECOMPUTE_S_PER_CHUNK * n / chunk)
        return SessionRequest(session, "ctx", tokens, NetworkModel(BandwidthTrace.steps(DIP_S, [DIP_GBPS, LINK_GBPS])),
                              prior_throughput_gbps=LINK_GBPS, start_t=start_t, generation=generation)

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
    device: f32 arithmetic from the same inputs, the result in their dtype."""
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
    The plain versions launch nothing."""
    decode_k, flash_k = ops.decode_attention, ops.flash_attention

    def decode(q, k, v, kv_len, *, scale=None):
        out = decode_k(q, k, v, kv_len, scale=scale)
        want = decode_attention_plain(q.float(), k.float(), v.float(), kv_len, scale=scale)
        excess.append(("decode_attention",
                       ops.bf16_ulp_excess(out, want, **ops.BF16_TOL["decode_attention"])))
        return out

    def flash(q, k, v, prefix_len=None, *, causal=True, scale=None):
        out = flash_k(q, k, v, prefix_len, causal=causal, scale=scale)
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
                   chunk=MOE_CHUNK, gen_tokens=GEN_TOKENS, launcher_ctx=MOE_CTX, full_width=True):
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
    B: ``serve.run`` with ``--check-sim`` at ``launcher_ctx`` tokens
    (``--full-width`` if ``full_width``): one wave of ``MOE_REQUESTS`` as
    the simulator decides, then one of ``MOE_PINNED`` at level 0 and one at
    level ``MOE_LOSSY``; every request must make the simulator's decisions
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
        resident = sum(t.numel() * t.element_size() for t in _leaves(params))
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
        base = ["--arch", MOE_ARCH, "--ctx-len", str(launcher_ctx), "--check-sim", "--device", str(dev)]
        base += ["--full-width"] if full_width else []
        waves = {"decided": (MOE_REQUESTS, None), "level 0": (MOE_PINNED, 0),
                 f"level {MOE_LOSSY}": (MOE_PINNED, MOE_LOSSY)}
        launched, totals = {}, {"level 0": 0, "lossy": 0, "TEXT": 0}
        for name, (n_req, level) in waves.items():
            argv = base + ["--requests", str(n_req), "--concurrency", str(n_req)]
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
            kinds, worst_text = match_materialize(run, run["sessions"], what, launcher_ctx, replayed)
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
        resident = sum(t.numel() * t.element_size() for t in _leaves(params))
        print(f"vlm: {cfg.name} weights {resident / 1e9:.2f} GB resident ({cfg.dtype}), "
              f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B parameters")
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
    p = lm._layer(params, 0)
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
        resident = sum(t.numel() * t.element_size() for t in _leaves(params))
        print(f"{name}: {cfg.name} weights {resident / 1e9:.2f} GB resident ({cfg.dtype}), "
              f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B parameters")
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
        params32 = _tree_map(lambda t: t.float(), params)
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
        leaves = list(_leaves(params))
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
            params32 = _tree_map(lambda t: t.float(), params)
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


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    phase_ms = {}

    gen = torch.Generator(device=dev)

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
                device_ms=device_ms(lambda: flash_attention_cuda(qq, kk, vv, causal=causal), "flash_tc_kernel"),
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
        del kc, vc

    # --------------------------------------------------------- 4 serve, 5 text
    ops.reset_launch_counts()
    served = drive_main_path(cfg, dev, gen, phase=lambda name: Phase(name, phase_ms))
    paths = {"serve + text": ops.launch_counts()}

    # --------------------------------------------------------------- 6 store
    ops.reset_launch_counts()
    stored = drive_store_path(cfg, dev, gen, served, phase=lambda name: Phase(name, phase_ms))
    paths["store"] = ops.launch_counts()

    # ------------------------------------------------------------- 7 session
    ops.reset_launch_counts()
    sessioned = drive_session_path(cfg, stored, phase=lambda name: Phase(name, phase_ms))
    paths["session"] = ops.launch_counts()

    # ------------------------------------------------------------- 8 serving
    ops.reset_launch_counts()
    drive_serving_path(cfg, stored, sessioned, phase=lambda name: Phase(name, phase_ms))
    paths["serving"] = ops.launch_counts()

    # ------------------------------------------------------------ 9 launcher
    ops.reset_launch_counts()
    drive_launcher_path(dev, phase=lambda name: Phase(name, phase_ms))
    paths["launcher"] = ops.launch_counts()

    # ----------------------------------------------------------------- 10 moe
    del served, stored, sessioned
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    drive_moe_path(registry.get(MOE_ARCH), dev, gen, phase=lambda name: Phase(name, phase_ms))
    paths["moe"] = ops.launch_counts()

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

    # --------------------------------------------------------------- summary
    runs = {"serve + text": ALL_KERNELS, "store": ALL_KERNELS, "session": SESSION_KERNELS,
            "serving": SERVING_KERNELS, "launcher": LAUNCHER_KERNELS, "moe": MOE_KERNELS, "vlm": VLM_KERNELS,
            "ssm": SSM_KERNELS, "hybrid": HYBRID_KERNELS, "encdec": ENCDEC_KERNELS}
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
