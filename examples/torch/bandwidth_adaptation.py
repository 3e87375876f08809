"""Reproduce the paper's Fig. 7 adaptation timeline on a synthetic trace.

Port of ``examples/bandwidth_adaptation.py`` onto ``repro_torch``.  Streams
one context under the paper's illustrative bandwidth trace (2 Gbps -> 0.2
Gbps -> 1 Gbps) and prints the per-chunk decision timeline — showing the
switch to text-recompute during the outage and back to fine encoding
levels when bandwidth recovers.  It plans on the host only (no model, no
card): its lines equal the reference example's.

Usage:  PYTHONPATH=src python examples/torch/bandwidth_adaptation.py
"""
import numpy as np

from repro_torch.streaming.adaptation import TEXT, AdaptationPolicy
from repro_torch.streaming.network import BandwidthTrace, NetworkModel
from repro_torch.streaming.pipeline import simulate_stream
from repro_torch.streaming.storage import ChunkMeta


def main() -> None:
    # a 9.6K-token context in 1.5K chunks; sizes are the reference's
    # bytes/token of a qwen-110b-scale cache (level 0 163 KB/tok ... level
    # 4 36 KB/tok)
    n_chunks, toks = 7, 1440
    bpt = {0: 162690.0, 1: 84790.0, 2: 67368.0, 3: 50439.0, 4: 35719.0}
    metas = [
        ChunkMeta("ctx", i, i * toks, (i + 1) * toks,
                  sizes={l: int(toks * b) for l, b in bpt.items()},
                  text_bytes=toks * 4)
        for i in range(n_chunks)
    ]
    # paper Fig. 7 trace: 2 Gbps, drops to 0.2 at t=2s, recovers to 1 at t=4s
    # (SLO 5s for the 110B-scale cache; the paper illustrates a 7B cache)
    trace = BandwidthTrace(np.array([0.0, 2.0, 4.0]), np.array([2.0, 0.2, 1.0]))
    net = NetworkModel(trace)
    policy = AdaptationPolicy(
        levels_quality_order=[0, 1, 2, 3, 4], slo_s=5.0, default_level=1,
        prior_throughput_gbps=2.0,
    )
    res = simulate_stream(
        metas, policy, net, decode_bytes_per_s=4e9,
        recompute_s=lambda t, p: 0.9,  # 110B prefill per 1.5K chunk, 8 chips
    )
    names = {TEXT: "TEXT"}
    print(f"{'chunk':>5} {'config':>7} {'fetch':>14} {'compute':>16} {'MB':>7}")
    for t in res.timelines:
        print(
            f"{t.chunk_idx:>5} {names.get(t.config, f'L{t.config}'):>7} "
            f"{t.fetch_start:6.2f}-{t.fetch_end:6.2f} "
            f"{t.compute_start:7.2f}-{t.compute_end:7.2f} {t.nbytes/1e6:7.2f}"
        )
    print(f"TTFT = {res.ttft_s:.2f}s (SLO {res.slo_s}s, violated={res.slo_violated})")


if __name__ == "__main__":
    main()
