"""Process start to the window's opening (s)."""


def read(run):
    return run.setup_s
