"""Tests of the benchmark (CPU; the `cuda` ones run on the card)."""
