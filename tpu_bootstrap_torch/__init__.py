"""PyTorch / CUDA port of ``tpu_bootstrap`` for one NVIDIA H100: the slice
workload (``tpu_bootstrap_torch.workload``) and the controller's harness.

The JAX package stays the reference; this package mirrors its module
names so each piece has an obvious counterpart: the workload under
``workload``, and at the top level ``telemetry`` (metrics and the span
trace plane), ``nativelib`` (the ctypes bridge that builds the native
daemons from ``native/`` into ``build/native/``), ``fakeapi`` (the fake
Kubernetes API server) and ``fakeadmission`` (its write-path admission).
Together they drive a UserBootstrap through admission, reconciliation and
a served worker without the JAX package. It imports ``torch`` and never
``jax`` or anything of ``tpu_bootstrap``. Importing it loads nothing
heavy: each module is imported on its own.
"""
