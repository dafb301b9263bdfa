"""The benchmark of dsptpu_torch (see README.md)."""
