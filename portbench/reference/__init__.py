"""The plain references: float32 PyTorch, no kernel, no part of the
program under test."""
