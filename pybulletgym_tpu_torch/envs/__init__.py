"""Env layer: batched env state, auto-reset, tasks."""
