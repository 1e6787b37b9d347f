"""The plain reference that decides a run's ``correct``: NumPy and plain
PyTorch, importing nothing of the port."""
