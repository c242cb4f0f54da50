"""Env registry."""
