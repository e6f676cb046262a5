"""Solves completed in the window (diverged ones left out) over the
window's seconds, on the host's clock."""


def read(rec):
    return rec.completed / rec.window_s if rec.window_s > 0 else None
