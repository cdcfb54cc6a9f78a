"""The JAX package's native letterbox library in a known state for the
port's comparisons.

JAX's predictor and server letterbox through JAX's native library when it
loads, and through OpenCV when it does not (JAX engine/predictor.py:
282-300); the two resample a frame differently. JAX builds the library
into $TMPDIR/dedark_native at its first use and keeps a failed load for the
life of the process (JAX native/__init__.py:27-76). Under xdist the workers
collect at once, so several build it at once (tests/test_native.py asks
for it at collection), and a worker that opens another's half-written
file keeps the OpenCV path for the rest of its run: its JAX predictions
move (the layer-0 segment graph's scores by ~1e-5) while the port's, which
always letterbox natively, do not. `ensure_jax_native` loads the library
again after such a failure, once the other build has finished, and raises
if it still cannot; the autouse fixture runs it before each test of a
module that imports it.
"""

import time

import pytest

from dedark_yolo_tpu import native as jax_native


def ensure_jax_native(timeout=120.0):
    """Load JAX's native library, retrying a load that failed earlier in
    this process for up to `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while not jax_native.available():
        if time.monotonic() > deadline:
            raise RuntimeError("the JAX package's native letterbox library "
                               "does not load")
        time.sleep(0.5)
        jax_native._tried = False      # forget the cached failure


@pytest.fixture(autouse=True)
def jax_native_letterbox():
    ensure_jax_native()
