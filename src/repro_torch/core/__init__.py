"""Drafter inference and speculative verification."""
