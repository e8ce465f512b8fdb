"""Logical-axis partition rules and their placement on a device mesh."""
