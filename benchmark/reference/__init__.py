"""The plain float32 reference of the benchmark's configurations: plain PyTorch, nothing of the program."""
