"""The benchmark's plain reference: PyTorch and NumPy only, importing
neither JAX, the JAX package nor anything of the program under test. It
works out again, from the inputs the benchmark hands to both sides, what
the timed path produced, so that `correct` can judge it."""
