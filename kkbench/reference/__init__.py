"""The plain reference: mini-batch kernel k-means and its RFF variant in
plain PyTorch (float64 sums, TF32 off), written from the paper's
equations. It imports neither ``jax``, the JAX package ``repro``, nor the
port ``repro_torch``, and takes nothing the program made: it draws what the
program draws from the same seeds by the same published recipe
(``draws.py``) and works out every Gram block again from the rows."""
