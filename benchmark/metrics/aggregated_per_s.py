"""Nested proofs settled into returned wrapper proofs in the window, per
second from the window's start to the last completion."""

from .common import rate as read  # noqa: F401
