"""The serving ladder's fitter (port of ``serve_ladder_from_sizes`` and
``ladder_waste`` from slate_tpu/tune/autotune.py).

The live server's online retune (serve/server.py ``retune_now``) fits a
bucket ladder to the request sizes it observed and hot-swaps it when the
fit wastes less padding.  Rungs are chosen to minimize the total padded
area (the sum over requests of rung^2) by dynamic programming over the
distinct tile-rounded sizes.  Pure Python, the same ladder as the
reference's from the same sizes.  The kernel sweeps and the persisted
plan cache of the reference's module come with the telemetry slice
(ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import collections


def serve_ladder_from_sizes(sizes, max_rungs: int = 8,
                            base: int = 32) -> tuple:
    """Padded-area-optimal bucket ladder (<= ``max_rungs`` rungs) for a
    request-size sample.  Sizes round up to ``base`` multiples (the tile
    edge: finer rungs cannot change the packed shapes); each rung is one
    of the distinct rounded sizes and the top rung covers the largest, so
    every recorded request buckets without doubling."""
    pad = [max(base, -(-int(s) // base) * base) for s in sizes if int(s) > 0]
    if not pad:
        raise ValueError("serve_ladder_from_sizes: no positive sizes")
    hist = collections.Counter(pad)
    edges = sorted(hist)
    ne = len(edges)
    if ne <= max_rungs:
        return tuple(edges)
    # cost[lo][hi]: every request in edges[lo..hi] served at edges[hi]
    cost = [[0.0] * ne for _ in range(ne)]
    for lo in range(ne):
        cnt = 0
        for hi in range(lo, ne):
            cnt += hist[edges[hi]]
            cost[lo][hi] = cnt * edges[hi] ** 2
    inf = float("inf")
    dp = [[inf] * ne for _ in range(max_rungs + 1)]
    cut = [[-1] * ne for _ in range(max_rungs + 1)]
    for hi in range(ne):
        dp[1][hi] = cost[0][hi]
    for r in range(2, max_rungs + 1):
        for hi in range(r - 1, ne):
            for mid in range(r - 2, hi):
                c = dp[r - 1][mid] + cost[mid + 1][hi]
                if c < dp[r][hi]:
                    dp[r][hi] = c
                    cut[r][hi] = mid
    best_r = min(range(1, max_rungs + 1), key=lambda r: dp[r][ne - 1])
    rungs, r, hi = [], best_r, ne - 1
    while r > 1:
        rungs.append(edges[hi])
        hi = cut[r][hi]
        r -= 1
    rungs.append(edges[hi])
    return tuple(sorted(rungs))


def ladder_waste(sizes, ladder) -> float:
    """Padding waste (1 - live/padded area) of serving ``sizes`` square
    problems on ``ladder`` (a serve.bucket.BucketLadder)."""
    live = padded = 0
    for s in sizes:
        s = int(s)
        if s <= 0:
            continue
        b = ladder.bucket_for(s)
        live += s * s
        padded += b * b
    return 1.0 - live / padded if padded else 0.0
