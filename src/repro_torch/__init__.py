"""repro_torch — S/C (Speeding up Data Materialization with Bounded Memory)
on PyTorch and CUDA, for NVIDIA Hopper.

The counterpart of the JAX package ``repro``, module for module: the same
planner, the same refresh engine, and the same bitwise data-plane contract,
with tables held as ``dict[str, torch.Tensor]`` on one device and the
data-plane kernels written by hand in CUDA C++ (``csrc/``). Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
