"""Architecture configs (plain dataclasses, copied from the reference)."""
