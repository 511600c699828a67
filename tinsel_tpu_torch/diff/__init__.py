"""Differentiable rendering: losses and their gradients (``gradients``)."""
