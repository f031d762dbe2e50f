"""Seconds the served loop slept to modeled slot ends (the program's
``wait`` tuples with cause ``slot``) over the window (%)."""
from ecobench.harness import program


def read(run):
    return program.slot_wait_share(run.events, run.window_s)
