"""The port's kernel layer: the precision policy, the plain PyTorch versions
(``ref``), the CUDA kernels for Hopper (``csrc/``, built by ``build``) and
the wrappers that dispatch between them by device (``ops``)."""
