"""What the drivers share: waiting for the device, and the worst-leaf
comparison of norms."""

from __future__ import annotations

import torch


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def leaf_gaps(got: dict, want: dict, ref_grads: dict, floor: float = 1e-3) -> dict:
    """``{k: | |got_k| - |want_k| | / max(|want_k|, median_j |want_j|)}`` over
    the leaves whose reference gradient is at least ``floor`` times the
    median leaf's (the others move by round-off alone)."""
    norm = lambda t: float(torch.linalg.norm(t.double()))
    g = {k: norm(v) for k, v in ref_grads.items()}
    g_med = sorted(g.values())[len(g) // 2]
    keep = [k for k in want if g[k] >= floor * g_med]
    w = {k: norm(want[k]) for k in keep}
    w_med = sorted(w.values())[len(w) // 2]
    return {k: abs(norm(got[k]) - w[k]) / max(w[k], w_med, 1e-30) for k in keep}


def median(values) -> float:
    values = sorted(values)
    return values[len(values) // 2]
