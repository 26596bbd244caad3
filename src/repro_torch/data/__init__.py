"""Synthetic token data of the port."""
