"""Seconds from the start of the process to the opening of the window:
loading, the request pool, keys made or loaded, the warm-up request. The
reference's own set-up work (``Run.apart``) is left out."""


def read(run):
    return run.setup_s
