"""Low-level ops: the GPU kNN kernel, Morton keys, double-float arithmetic.

``knn_gpu`` is a Pallas kernel (Triton route) for NVIDIA GPUs; it has a
plain-XLA equivalent (``neighbors.bruteforce._knn_xla``) that runs on the CPU
and serves as its reference.
"""
