"""PyTorch/CUDA port of the distributed kernel k-means system, for one H100.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``kernels/``, ``core/``, ``data/``) and its public names. It imports
``torch``, numpy and scipy only — never ``jax`` and nothing of ``repro``.

Entry points take ``device=``: ``None`` means ``"cuda"``, and without a
CUDA device they raise instead of running on the CPU; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
