"""Plain PyTorch references: no kernel, no cache, no batching tricks, and nothing of the program."""
