"""tools/c14_split.py on the CPU: `train_parity` (the smoke's card-vs-CPU
train measurement) of the tiny model with both sides on the CPU reads
zero errors and holds TRAIN_TOL, with the kernel's and with the plain
layer-0 forward; `plain_layer0_forward` swaps FusedEnhance's forward for
the plain chain only inside its block; the split covers the four
variants of ROADMAP C14 at the seeds asked."""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu_torch.ops import enhance_kernel as K  # noqa: E402
from dedark_yolo_tpu_torch.tools import c14_split  # noqa: E402

TINY = str(Path(__file__).resolve().parent / "tiny_model.yaml")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("plain", [False, True])
def test_train_parity_cpu_against_cpu(plain):
    measure = (c14_split.train_parity_plain_layer0 if plain
               else c14_split.train_parity)
    rec = measure(TINY, imgsz=64, seed=1, device="cpu")
    assert rec["ok"] and rec["seed"] == 1
    assert rec["layer0_forward"] == ("plain" if plain else "kernel")
    assert rec["items_max_rel_err"] == rec["grad_norm_rel_err"] == 0.0
    assert rec["move_max_rel_err"] <= 0.0
    assert rec["assign_flips"] == [0, 0] and len(rec["assign_least_margins"]) == 2
    assert rec["updates_gpu"] == rec["updates_cpu"] == (1, 1)


def test_plain_layer0_forward_only_inside_its_block():
    kernel = K.fused_enhance
    with c14_split.plain_layer0_forward():
        assert K.fused_enhance is K.fused_enhance_reference
    assert K.fused_enhance is kernel


def test_split_runs_each_variant_at_each_seed(monkeypatch):
    calls = []
    for fn, plain in (("train_parity", False),
                      ("train_parity_plain_layer0", True)):
        monkeypatch.setattr(c14_split, fn, lambda *a, plain=plain, **kw:
                            calls.append((a, plain)) or {"ok": True})
    out = c14_split.split((0, 3), "abcd", device="cpu")
    assert [r["variant"] for r in out] == list("aabbccdd")
    assert calls[::2] == [
        (("yolov8l.yaml", 128, 0), False), (("yolov8l-dedark.yaml", 128, 0), False),
        (("yolov8l.yaml", 128, 0), True), (("yolov8l.yaml", 256, 0), False)]
    assert c14_split.TRAIN_TOL == {"items_rel": 5e-3, "grad_rel": 5e-2,
                                   "move_rel": 5e-2, "stats_abs": 1e-3}
