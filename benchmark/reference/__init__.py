"""The plain reference the benchmark judges the port by: plain PyTorch and
NumPy only, importing nothing of the program."""
