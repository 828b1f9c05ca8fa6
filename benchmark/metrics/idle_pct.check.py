"""Share of the traced window in which no operation runs on the card."""

from harness import readers


def read(run):
    return readers.idle_pct(run)
