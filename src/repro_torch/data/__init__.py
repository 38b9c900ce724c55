"""Synthetic corpora and sequence packing (numpy)."""
