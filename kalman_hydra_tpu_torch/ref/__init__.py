"""OpenCV/NumPy oracle of the port (CPU): the parity target and the
throughput denominator.

The port's own copy of `kalman_hydra_tpu/ref/`, function for function and
name for name (`tests/test_torch_ref.py` holds the two equal bit for bit).
It is cv2 and NumPy only, and shares no code with what it measures: it
imports the port's `config` and `io.export` and nothing else of the port.
`import kalman_hydra_tpu_torch` does not import it, so the port runs on a
host without cv2; `chip_smoke.py` (phase OC) and the tests import it.
"""
from . import ekf, imgproc, pipeline

__all__ = ["ekf", "imgproc", "pipeline"]
