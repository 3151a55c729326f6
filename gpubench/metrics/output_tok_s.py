"""Tokens generated in the window (each row's prefill token and every
decode step's) over the window's seconds."""


def read(run):
    if not run.batches:
        return None
    return sum(len(row) for b in run.batches for row in b.served) / run.window_s
