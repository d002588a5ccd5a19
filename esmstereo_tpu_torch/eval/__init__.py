"""Eval-mode inference runner."""
