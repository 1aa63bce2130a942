"""The benchmark's plain reference: PyTorch and numpy only, nothing of the
program under test."""
