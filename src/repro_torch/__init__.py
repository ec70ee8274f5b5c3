"""MalStone on PyTorch and CUDA: the port of the ``repro`` JAX package.

The P nodes of the JAX mesh are a leading ``[P]`` axis of tensors on one
device; the Pallas kernels of the main path are hand-written CUDA kernels
(``repro_torch.kernels``). Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
