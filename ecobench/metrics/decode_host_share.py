"""The engines' host seconds to each decode step's device wait over the
seconds the decode slots executed (the program's decode ``run`` tuples,
``ServingEngine.host_s``) (%)."""
from ecobench.harness import program


def read(run):
    return program.decode_host_share(run.events)
