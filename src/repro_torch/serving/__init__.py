"""Whole-batch speculative serving engine and cache commit."""
