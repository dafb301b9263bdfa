"""Plain references of the configurations (no import of the program)."""
