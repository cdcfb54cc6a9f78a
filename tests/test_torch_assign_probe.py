"""tools/assign_probe.py: the recorded assigner returns what the assigner
returns, its margins are the gaps it states, and `flips` counts the
anchors two recordings assigned otherwise."""

import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu_torch.losses import detection, tal  # noqa: E402
from dedark_yolo_tpu_torch.tools import assign_probe  # noqa: E402


def _inputs(seed, b=2, m=3, n=64, nc=3):
    g = torch.Generator().manual_seed(seed)
    anc = torch.stack(torch.meshgrid(torch.arange(8.0), torch.arange(8.0),
                                     indexing="xy"), -1).reshape(-1, 2) + 0.5
    xy = torch.rand(b, m, 2, generator=g) * 4
    gt = torch.cat([xy, xy + 2 + torch.rand(b, m, 2, generator=g) * 3], -1)
    pxy = anc[None].expand(b, n, 2) - torch.rand(b, n, 2, generator=g) * 2
    pd = torch.cat([pxy, pxy + 1 + torch.rand(b, n, 2, generator=g) * 3], -1)
    return (torch.rand(b, n, nc, generator=g), pd, anc,
            torch.randint(0, nc, (b, m), generator=g).float(), gt,
            torch.ones(b, m), nc)


def test_record_passes_the_assignment_through():
    args = _inputs(0)
    want = tal.task_aligned_assign(*args)
    with assign_probe.record() as calls:
        got = detection.task_aligned_assign(*args)
    assert detection.task_aligned_assign is tal.task_aligned_assign
    for w, o in zip(want, got):
        torch.testing.assert_close(o, w, rtol=0, atol=0)
    assert len(calls) == 1 and torch.equal(calls[0]["fg"], want.fg_mask)
    assert assign_probe.flips(calls, calls) == [0]


def test_margins_are_the_stated_gaps():
    args = _inputs(1)
    _, topk, claim = assign_probe.margins(*args, topk=4)
    pd_scores, pd_bboxes, anc, labels, gt, mask_gt, _ = args
    _, overlaps, metric = tal.align_metrics(
        pd_scores, pd_bboxes, anc, labels.long(), gt, mask_gt)
    top = metric.sort(-1, descending=True).values
    hi, lo = top[..., 3], top[..., 4]
    want = ((hi - lo) / hi)[hi > 0].min()
    assert topk == pytest.approx(float(want), rel=1e-6)
    assert 0 <= claim <= 1 or claim == float("inf")


def test_flips_count_the_anchors_assigned_otherwise():
    with assign_probe.record() as a:
        detection.task_aligned_assign(*_inputs(2))
    b = [{**a[0], "fg": a[0]["fg"].clone(), "gt": a[0]["gt"].clone()}]
    fg = b[0]["fg"].nonzero()
    b[0]["fg"][tuple(fg[0])] = False                     # one anchor dropped
    b[0]["gt"][tuple(fg[1])] += 1                        # one to another GT
    assert assign_probe.flips(a, b) == [2]
