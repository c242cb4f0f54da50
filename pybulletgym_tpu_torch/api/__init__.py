"""Env registry and gymnasium adapters."""
