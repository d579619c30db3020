"""The plain reference the benchmark's check holds the program to: plain
PyTorch, importing nothing of the program."""
