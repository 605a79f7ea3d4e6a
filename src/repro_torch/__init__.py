"""NFL learned index on PyTorch and CUDA (Hopper).

A port of ``repro`` (JAX + Pallas), module for module: ``core/`` holds
the flow, the flat index and the two-stage ``NFL`` framework,
``kernels/`` the hand-written CUDA kernels (``csrc/``) with their plain
PyTorch twins, ``data/`` the dataset and workload generators.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU device they raise.
"""
