"""Arrivals that the system queued (the program's ``refuse`` tuples:
every instance refused them by an Algorithm 2 constraint) over the
window's arrivals (%)."""
from ecobench.harness import program


def read(run):
    return program.queued_arrival_share(run.events)
