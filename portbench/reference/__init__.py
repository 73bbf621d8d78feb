"""Plain references the benchmark judges the program against. A module
here imports NumPy and the standard library only: nothing of the
program, nothing of JAX."""
