"""The plain reference of the benchmark's cells (``lda.py``): PyTorch
operations only, written from the paper's equations; it imports nothing of
the program."""
