"""Run reports."""
