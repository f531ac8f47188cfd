"""Padding helper shared by the trial engine and the LogReg packed path
(the one piece of the JAX package's ``parallel/mesh.py`` the single-device
port needs)."""

from __future__ import annotations


def pad_to_multiple(n: int, multiple: int) -> int:
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple
