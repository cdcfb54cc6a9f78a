"""Torch port as a package: it imports nothing of JAX, its entry points run
on cuda unless told otherwise, its config and letterbox behave as the JAX
package's, and nothing is compiled until a kernel is needed."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dedark_yolo_tpu_torch import YOLO  # noqa: E402
from dedark_yolo_tpu_torch.cfg import get_cfg, model_yaml_load  # noqa: E402
from dedark_yolo_tpu_torch.data.augment import letterbox  # noqa: E402
from dedark_yolo_tpu_torch.engine.predictor import (  # noqa: E402
    DetectionPredictor, matmul_precision)
from dedark_yolo_tpu_torch.ops import _build  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_predicts_on_cpu():
    """A fresh interpreter builds the flagship, runs a CPU predict, and
    never loads jax, flax, the JAX package, yaml or cv2."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from dedark_yolo_tpu_torch import YOLO
        m = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=0)
        x = np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8)
        r = m.predict([x], device="cpu", imgsz=64, batch=1, conf=0.001)
        assert len(r) == 1 and r[0].boxes.data.shape[1] == 6
        bad = sorted(k for k in sys.modules if k.split(".")[0] in
                     ("jax", "jaxlib", "flax", "dedark_yolo_tpu", "yaml", "cv2"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists; the no-device error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YOLO("yolov8l.yaml", nc=3)
    m = YOLO("yolov8l.yaml", nc=3, device="cpu")
    x = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.predict(x, imgsz=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionPredictor(args=get_cfg(), model=m.model)


def test_state_dict_round_trip_and_seeded_init():
    a = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=1)
    b = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=2)
    sd = a.state_dict()
    assert not any("num_batches_tracked" in k for k in sd)
    assert "model.23.weight_levels.weight" in sd
    assert "model.0.extractor.fc1.weight" in sd
    assert not torch.equal(sd["model.1.conv.weight"],
                           b.state_dict()["model.1.conv.weight"])
    b.load_state_dict(sd)
    for k, v in b.state_dict().items():
        assert torch.equal(v, sd[k]), k
    again = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=1).state_dict()
    assert all(torch.equal(again[k], v) for k, v in sd.items())


def test_model_yaml_load_resolves_scale():
    d = model_yaml_load("yolov8l.yaml")
    assert d["scale"] == "l" and d["backbone"][0][2] == "lowlight_recovery"
    d = model_yaml_load("yolov8ori.yaml")
    assert d["scale"] == "" and d["backbone"][0][2] == "Conv"
    assert model_yaml_load("yolov8n.yaml")["scale"] == "n"
    # a file on disk is read with yaml
    d = model_yaml_load(REPO / "dedark_yolo_tpu" / "cfg" / "models" /
                        "yolov8s.yaml")
    assert d["scale"] == "s" and d["backbone"][0][2] == "lowlight_recovery"
    with pytest.raises(FileNotFoundError):
        model_yaml_load("nothing_like_this.yaml")


def test_get_cfg_checks_keys_and_types():
    a = get_cfg(overrides={"conf": 0.1, "half": True, "imgsz": 320})
    assert a.conf == 0.1 and a.half and a.iou == 0.7 and a.max_nms == 2048
    with pytest.raises(SyntaxError):
        get_cfg(overrides={"confidence": 0.1})
    with pytest.raises(TypeError):
        get_cfg(overrides={"half": 1})
    with pytest.raises(ValueError):
        get_cfg(overrides={"imgsz": 100})
    with pytest.raises(ValueError):
        get_cfg(overrides={"matmul_precision": "bfloat8"})


def test_matmul_precision_sets_and_restores_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    with matmul_precision("float32"):
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    with matmul_precision("default"):
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == prev


@pytest.mark.parametrize("shape", [(480, 640, 3), (96, 128, 3), (37, 200, 3)])
def test_letterbox_matches_jax(shape):
    from dedark_yolo_tpu.data.augment import letterbox as jax_letterbox
    img = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    size = 640 if shape[1] == 640 else 128
    got, want = letterbox(img, size), jax_letterbox(img, size)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_kernel_build_is_lazy_and_keyed_on_source():
    assert not _build._libs
    p = _build.lib_path("fused_enhance")
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p == _build.lib_path("fused_enhance")


def test_no_module_of_the_port_or_the_smoke_imports_jax():
    """Static check over every import statement of the package and of
    chip_smoke.py: no jax, flax or dedark_yolo_tpu (the JAX package)."""
    import ast
    files = sorted((REPO / "dedark_yolo_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "dedark_yolo_tpu"), (f, name)


def test_half_stages_layer0_in_bf16_and_promotes():
    """half=True: the bf16 image runs layer 0 in bf16 (the kernel's
    staging) and the graph promotes to the f32 params after it, as flax
    does; predict then keeps as many detections as the f32 run."""
    m = YOLO("yolov8l.yaml", nc=3, device="cpu", seed=0)
    x = torch.rand(1, 64, 64, 3).to(torch.bfloat16)
    with torch.no_grad():
        assert m.model.model[0](x).dtype == torch.bfloat16
        assert all(r.dtype == torch.float32 for r in m.model(x))
    frames = [np.random.default_rng(i).integers(0, 256, (64, 64, 3), np.uint8)
              for i in range(2)]
    kw = dict(device="cpu", imgsz=64, batch=2, conf=0.001)
    f32 = m.predict(frames, **kw)
    bf16 = m.predict(frames, half=True, **kw)
    assert [len(r) for r in bf16] == [len(r) for r in f32]
