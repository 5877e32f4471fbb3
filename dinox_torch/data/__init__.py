"""Data constants shared by preprocessing."""
