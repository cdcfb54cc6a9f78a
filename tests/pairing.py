"""Pairing of two packages' detections of one image, for the port's tests.

Two forwards that sum their convolutions in other orders give scores that
differ in the last bits, so two detections whose scores tie within that
error can come out of NMS in the other order. A rank-by-rank comparison
then fails on a swap that is not a fault. These helpers pair each of one
side's detections, in its own order, with the first unpaired detection of
the other side that fits it (same class, same TP row where there is one,
box and score within their bars): the rule of `chip_smoke.py`'s
`pair_detections`, which keeps its own copy. NMS keeps no two boxes of a
class that close, so the partner is unique.
"""

from __future__ import annotations

import numpy as np


def pair(n_want, n_got, fits):
    """order[i] = the index of want paired with got's item i, taking the
    first unpaired j with fits(j, i); None when the counts differ or an
    item finds no partner."""
    if n_want != n_got:
        return None
    free, order = list(range(n_want)), []
    for i in range(n_got):
        for j in free:
            if fits(j, i):
                free.remove(j)
                order.append(j)
                break
        else:
            return None
    return order


def reordered(order):
    """Pairs whose two items sit at other ranks."""
    return sum(j != i for i, j in enumerate(order))


def pair_detections(want, got, box_tol, score_tol):
    """want, got: (boxes (n, 4), classes (n,), scores (n,)[, TP rows (n, m)])
    of one image. Returns (order, max box error, max score error), or None
    where an item finds no partner."""
    wb, wc, ws, *wt = want
    gb, gc, gs, *gt = got
    wb, gb = np.asarray(wb, np.float64), np.asarray(gb, np.float64)

    def fits(j, i):
        return (wc[j] == gc[i]
                and float(np.abs(wb[j] - gb[i]).max()) <= box_tol
                and abs(float(ws[j]) - float(gs[i])) <= score_tol
                and (not wt or np.array_equal(wt[0][j], gt[0][i])))
    order = pair(len(wc), len(gc), fits)
    if order is None:
        return None
    box_err = max((float(np.abs(wb[j] - gb[i]).max())
                   for i, j in enumerate(order)), default=0.0)
    score_err = max((abs(float(ws[j]) - float(gs[i]))
                     for i, j in enumerate(order)), default=0.0)
    return order, box_err, score_err


def assert_paired(want, got, box_tol, score_tol, what=""):
    """pair_detections or an AssertionError naming `what`, with the counts
    and, rank by rank, the largest box and score gaps."""
    out = pair_detections(want, got, box_tol, score_tol)
    if out is None:
        n = min(len(want[1]), len(got[1]))
        msg = f"{what}: counts {len(want[1])} / {len(got[1])}"
        if n:
            db = np.abs(np.asarray(want[0][:n], np.float64)
                        - np.asarray(got[0][:n], np.float64)).max()
            ds = np.abs(np.asarray(want[2][:n], np.float64)
                        - np.asarray(got[2][:n], np.float64)).max()
            msg += f"; rank by rank: box {db:.3g} px, score {ds:.3g}"
        raise AssertionError(f"{msg}; some detection has no partner within "
                             f"box {box_tol} and score {score_tol}")
    return out


def assert_results_paired(want, got, box_tol, score_tol):
    """Two predictors' Results lists, image by image: equal shapes and
    counts, each port detection paired with a JAX one. Returns the number
    of pairs at another rank, which it prints."""
    assert len(got) == len(want)
    moved = 0
    for k, (w, g) in enumerate(zip(want, got)):
        assert g.orig_shape == w.orig_shape and len(g) == len(w), k
        order, _, _ = assert_paired(
            (w.boxes.xyxy, w.boxes.cls, w.boxes.conf),
            (g.boxes.xyxy, g.boxes.cls, g.boxes.conf), box_tol, score_tol,
            f"image {k}")
        moved += reordered(order)
    print(f"paired: {moved} pairs at another rank")
    return moved
