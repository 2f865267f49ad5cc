"""The benchmark's plain reference: float32 PyTorch, written from the
models' equations.

It imports neither JAX, nor the JAX package, nor anything of the program
under test (``repro_torch``), and it takes nothing that program made: the
benchmark hands it the weights, tokens and cache history it drew itself,
and the reference works out again whatever the program derived from them.
Every product runs through ``ops.mm`` at one of ``ops.PRECISIONS``: float32
for the reference, float8 for the control that ``correct`` must reject.
"""
