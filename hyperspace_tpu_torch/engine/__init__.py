"""Execution engine: columnar query execution over numpy (host lane) and
torch tensors on the session's device (device lane)."""
