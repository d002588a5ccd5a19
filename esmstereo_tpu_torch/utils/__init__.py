"""Metrics and running meters."""
