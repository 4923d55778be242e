"""PyTorch/CUDA port of `repro` for one NVIDIA H100.

Module names mirror the JAX package: `repro_torch.core.rmw` is the port of
`repro.core.rmw`, and so on.  The port imports torch and numpy, never JAX
and nothing of `repro`.  Entry points take a ``device`` and default to
``"cuda"``; a CPU run happens only when the caller asks for it.

The three RMW kernels of the local atomics tier are hand-written CUDA for
``sm_90a`` (`repro_torch.kernels.rmw.csrc/rmw.cu`), built at first use.
"""
