"""Simulated read sets."""
