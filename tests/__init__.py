"""Test suite (a package, so `tests.*` imports resolve to this checkout)."""
